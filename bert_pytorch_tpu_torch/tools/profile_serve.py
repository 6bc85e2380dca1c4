"""Where the serving time goes, on the card: one line per (task, bucket,
packing) with the host and device phases of a full batch, and the device
kernels that fill the forward.

    python -m bert_pytorch_tpu_torch.tools.profile_serve \
        [--model_config_file configs/bert_large_uncased_config.json] \
        [--buckets 128,512] [--max_batch_size 8] [--dtype bfloat16] \
        [--attention_backend flash_infer] [--iters 5] \
        [--tasks fill_mask,classify,squad,ner] \
        [--quantize none|bf16|int8] [--fuse_epilogues] [--epilogue_slots 8]

Per (task, bucket, packed) it stages one full batch of seeded demo-vocab
requests sized for that bucket (squad: a four-word question and a context
filling the rest) and reports, in milliseconds:

* ``stage_ms`` / ``execute_ms`` / ``demux_ms`` / ``postprocess_ms`` — the
  engine's three steps and the handlers' decode (host clock; ``execute``
  ends in a device synchronize), medians over ``--iters`` runs;
* ``kernels`` — device time per kernel name over one forward, from the
  kernel events of its ``torch.profiler`` trace
  (``profile_train.kernel_rows``), largest first, with each kernel's
  share of the forward's device time; ``attention_ms`` sums the fused
  attention kernels (``flash_infer*``) and ``gemm_ms`` the library GEMMs
  (cuBLAS/cuBLASLt kernel names), ``int8_gemm_ms`` those of them on int8
  operands.

``fused`` says whether the batch took its head's fused epilogue: the
fill_mask gather (each request here carries one [MASK], so a packed row
of four fits the default eight slots) or squad's stacked span output.

Weights are seeded random (demo mode); the widths are the config's. Needs
a CUDA card unless ``--device cpu`` (then no kernel table is taken).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch


def _requests(engine, task, bucket, packed, rng):
    """Requests that fill one batch of ``bucket``: one per row sized to the
    bucket unpacked, four per row packed."""
    from bert_pytorch_tpu_torch.serve.batcher import Request
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import TRACE_WORDS

    per_row = engine.max_requests_per_pack if packed else 1
    words = max(1, bucket // per_row - 3)
    handler = engine.tasks[task].handler
    reqs = []
    for _ in range(engine.max_batch_size * per_row):
        text = [str(w) for w in rng.choice(TRACE_WORDS, words)]
        if task == "fill_mask":
            text[len(text) // 2] = "[MASK]"
        if task == "squad":
            payload = {"question": " ".join(text[:4]),
                       "context": " ".join(text[4:] or text)}
        else:
            payload = {"text": " ".join(text)}
        reqs.append(Request(task, handler.prepare(payload, bucket), payload))
    return reqs


# Kernel-name fragments of the library GEMMs (cuBLAS, cuBLASLt and the
# CUTLASS kernels they dispatch to), and of those on int8 operands.
_GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma", "imma")
_INT8_NAMES = ("s8", "i8", "int8", "imma")


def _kernel_table(engine, staged):
    from torch.profiler import ProfilerActivity, profile

    from bert_pytorch_tpu_torch.tools.profile_train import device_rows

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.execute_staged(staged)
    rows = device_rows(prof)
    total = sum(r[1] for r in rows) or 1.0
    gemms = [r for r in rows if any(f in r[0].lower() for f in _GEMM_NAMES)]
    return total, {
        "attention_ms": sum(r[1] for r in rows if "flash_infer" in r[0]),
        "gemm_ms": sum(r[1] for r in gemms),
        "int8_gemm_ms": sum(r[1] for r in gemms if any(
            f in r[0].lower() for f in _INT8_NAMES)),
        "kernels": [{"name": name[:90], "ms": ms, "calls": calls,
                     "share": ms / total} for name, ms, calls in rows[:12]]}


def main(argv=None) -> int:
    from bert_pytorch_tpu_torch.config import BertConfig
    from bert_pytorch_tpu_torch.data.tokenization import BertTokenizer
    from bert_pytorch_tpu_torch.serve import InferenceEngine
    from bert_pytorch_tpu_torch.serve.cli import DTYPES, add_fast_path_args
    from bert_pytorch_tpu_torch.serve.engine import BatchPlan
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
        write_trace_vocab)

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model_config_file", default=os.path.join(
        "configs", "bert_large_uncased_config.json"))
    parser.add_argument("--buckets", default="128,512")
    parser.add_argument("--max_batch_size", type=int, default=8)
    parser.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    parser.add_argument("--attention_backend", default="flash_infer")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tasks", default="fill_mask,classify,squad,ner",
                        help="comma-separated serving heads to profile")
    add_fast_path_args(parser)
    args = parser.parse_args(argv)

    config = BertConfig.from_json_file(args.model_config_file)
    config.vocab_size = config.padded_vocab_size(8)
    if torch.cuda.is_available():
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(json.dumps({"card": card, "torch": torch.__version__,
                          "quantize": args.quantize,
                          "attention_backend": args.attention_backend,
                          "fuse_epilogues": args.fuse_epilogues}),
              flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        tokenizer = BertTokenizer(write_trace_vocab(
            os.path.join(tmp, "vocab.txt")))
    engine = InferenceEngine(
        config, tokenizer, {task: {} for task in args.tasks.split(",")},
        buckets=[int(b) for b in args.buckets.split(",")],
        max_batch_size=args.max_batch_size, max_requests_per_pack=4,
        dtype=DTYPES[args.dtype], seed=args.seed,
        attention_backend=args.attention_backend, device=args.device,
        quantize=args.quantize, fuse_epilogues=args.fuse_epilogues,
        epilogue_slots=args.epilogue_slots)
    engine.warmup()
    rng = np.random.default_rng(args.seed)
    for task in engine.tasks:
        handler = engine.tasks[task].handler
        for bucket in engine.buckets:
            for packed in (False, True):
                reqs = _requests(engine, task, bucket, packed, rng)
                per_row = len(reqs) // engine.max_batch_size
                plan = BatchPlan(bucket, [reqs[i:i + per_row] for i in range(
                    0, len(reqs), per_row)], [], packed)
                times = {"stage": [], "execute": [], "demux": [],
                         "postprocess": []}
                for _ in range(args.iters):
                    t0 = time.perf_counter()
                    staged = engine.stage(task, plan)
                    t1 = time.perf_counter()
                    out, _ = engine.execute_staged(staged)
                    t2 = time.perf_counter()
                    outputs = engine.demux(staged, out)
                    t3 = time.perf_counter()
                    for req, o in zip(plan.requests, outputs):
                        handler.postprocess(req.features, o, req.payload)
                    t4 = time.perf_counter()
                    for key, dt in zip(times, (t1 - t0, t2 - t1, t3 - t2,
                                               t4 - t3)):
                        times[key].append(dt * 1e3)
                line = {"task": task, "bucket": bucket, "packed": packed,
                        "fused": staged.fused,
                        "requests": len(plan.requests),
                        "real_tokens": sum(r.length for r in plan.requests)}
                line.update({f"{k}_ms": statistics.median(v)
                             for k, v in times.items()})
                if engine.device.type == "cuda":
                    total, table = _kernel_table(engine, staged)
                    line.update(device_ms=total, **table)
                print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
