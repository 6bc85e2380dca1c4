"""Where the SQuAD finetuning step and prediction time go, on the card, with
the LayerNorm forward in plain PyTorch and in the hand-written kernel.

    python -m bert_pytorch_tpu_torch.tools.profile_squad \\
        [--order plain,kernel,kernel,plain] [--dtype bfloat16,float16]

Builds ``BertForQuestionAnswering`` at BERT-large width
(configs/bert_large_uncased_config.json, seeded random weights) through
run_squad's own functions (bf16, or each of the comma-separated
``--dtype``s in turn, fp16 with its dynamic loss scale; dense attention,
AdamW without bias correction and global-norm clipping, the recipe's
batch of 32 features at max_seq_length 384, doc_stride 128), on features
of a seeded synthetic SQuAD file. For each dtype, one model; for each
LayerNorm backend of ``--order`` in turn (the backend is switched on the
model's LayerNorm modules, so both read the same kind of weights) it
prints one JSON line with:

* ``step_ms`` — host clock around a train step that ends in a device
  synchronize (median of ITERS after two of warmup) and ``seq_per_s``;
* ``predict_ms`` — the same for one prediction forward of
  ``--predict_batch_size`` features (no grad);
* ``device_ms`` / ``predict_device_ms`` — device time of one step / one
  prediction forward by ``torch.profiler`` (CUDA activity),
  ``device_busy`` = device_ms / step_ms, and ``device_launches``, the
  kernels the step launched;
* ``layer_norm`` — device ms and launches of kernel #6 in the step and in
  the prediction forward (zero on the plain backend, whose LayerNorm runs
  as generic elementwise and reduction kernels);
* ``kernels`` — the step's top kernels by device time.

Turns alternate in one process on one card, so the two backends are
compared under the same clocks and neighbours. Needs a CUDA card (the
measurement has no CPU mode).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time

import torch

from bert_pytorch_tpu_torch.tools.profile_train import device_rows

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "configs", "bert_large_uncased_config.json")
LN_KERNEL = "layer_norm_fwd_kernel"
ITERS = 5


def build(tmp: str, predict_batch_size: int, dtype: str = "bfloat16"):
    """(model, step, train batches, predict batch) from run_squad's own
    functions at BERT-large width in ``dtype``."""
    from bert_pytorch_tpu_torch import run_squad, squad
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
        write_squad_json, write_trace_vocab)

    vocab = write_trace_vocab(os.path.join(tmp, "vocab.txt"))
    train = write_squad_json(os.path.join(tmp, "train.json"), 21, 8)
    args = run_squad.parse_args([
        "--config_file", CONFIG, "--vocab_file", vocab, "--do_lower_case",
        "--train_file", train, "--predict_file", train, "--do_train",
        "--do_predict", "--output_dir", os.path.join(tmp, "out"),
        "--skip_checkpoint", "--skip_cache", "--dtype", dtype,
        "--max_steps", "100", "--seed", "0", "--predict_batch_size",
        str(predict_batch_size)])
    device = run_squad.setup_device(args)
    model, _ = run_squad.build_model(args, device)
    features = squad.convert_examples_to_features(
        squad.read_squad_examples(train, True, False),
        run_squad.build_tokenizer(args), args.max_seq_length,
        args.doc_stride, args.max_query_length, True)
    optimizer = run_squad.make_optimizer(args, model, args.max_steps)
    step = run_squad.make_train_step(model, optimizer, args.max_grad_norm,
                                     torch.Generator().manual_seed(0))
    bs = args.train_batch_size
    batches = [run_squad.features_to_tensors(features[i:i + bs], True,
                                             device)
               for i in range(0, len(features) - bs + 1, bs)][:3]
    predict = run_squad.features_to_tensors(
        features[:predict_batch_size], False, device)
    return model, step, batches, predict, bs


def profile_turn(model, step, batches, predict, backend: str,
                 batch_size: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from bert_pytorch_tpu_torch.models.bert import LayerNorm

    for module in model.modules():
        if isinstance(module, LayerNorm):
            module.backend = backend

    def run(i):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step(batches[i % len(batches)])["loss"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    @torch.no_grad()
    def forward():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start, _ = model(predict["input_ids"], predict["segment_ids"],
                         predict["input_mask"])
        start.float().cpu()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for i in range(2):
        run(i)
        forward()
    step_ms = statistics.median(run(i) for i in range(ITERS))
    predict_ms = statistics.median(forward() for _ in range(ITERS))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(0)
    rows = device_rows(prof)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_predict:
        forward()
    predict_rows = device_rows(prof_predict)
    device_ms = sum(r[1] for r in rows)

    def ln(rs):
        hits = [r for r in rs if LN_KERNEL in r[0]]
        return {"ms": sum(r[1] for r in hits),
                "launches": sum(r[2] for r in hits)}

    return {
        "layer_norm_backend": backend, "batch": batch_size,
        "step_ms": step_ms, "seq_per_s": batch_size / step_ms * 1e3,
        "predict_ms": predict_ms, "device_ms": device_ms,
        "device_busy": device_ms / step_ms,
        "device_launches": sum(r[2] for r in rows),
        "predict_device_ms": sum(r[1] for r in predict_rows),
        "layer_norm": {"step": ln(rows), "predict": ln(predict_rows)},
        "kernels": [{"name": n[:90], "ms": ms, "calls": c,
                     "share": ms / device_ms} for n, ms, c in rows[:8]],
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--order", default="plain,kernel,kernel,plain",
                        help="comma-separated LayerNorm backends, profiled "
                             "in this order on one model")
    parser.add_argument("--predict_batch_size", type=int, default=8)
    parser.add_argument("--dtype", default="bfloat16",
                        help="comma-separated model dtypes, each built and "
                             "profiled over --order in turn")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_squad needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    for dtype in args.dtype.split(","):
        with tempfile.TemporaryDirectory() as tmp:
            model, step, batches, predict, bs = build(
                tmp, args.predict_batch_size, dtype)
            for backend in args.order.split(","):
                print(json.dumps(dict(profile_turn(
                    model, step, batches, predict, backend, bs),
                    dtype=dtype)), flush=True)
            del model, step, batches, predict
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
