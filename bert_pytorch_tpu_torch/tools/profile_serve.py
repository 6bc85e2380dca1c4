"""Where the serving time goes, on the card: one line per (task, bucket,
packing) with the host and device phases of a full batch, and the device
kernels that fill the forward.

    python -m bert_pytorch_tpu_torch.tools.profile_serve \
        [--model_config_file configs/bert_large_uncased_config.json] \
        [--buckets 128,512] [--max_batch_size 8] [--dtype bfloat16] \
        [--attention_backend flash_infer] [--iters 5]

Per (task, bucket, packed) it stages one full batch of seeded demo-vocab
requests sized for that bucket and reports, in milliseconds:

* ``stage_ms`` / ``execute_ms`` / ``demux_ms`` / ``postprocess_ms`` — the
  engine's three steps and the handlers' decode (host clock; ``execute``
  ends in a device synchronize), medians over ``--iters`` runs;
* ``kernels`` — device time per kernel name over one forward, from
  ``torch.profiler`` (CUDA activity), largest first, with each kernel's
  share of the forward's device time.

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
        payload = {"text": " ".join(text)}
        reqs.append(Request(task, handler.prepare(payload, bucket), payload))
    return reqs


def _kernel_table(engine, staged):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.execute_staged(staged)
    rows = []
    for evt in prof.key_averages():
        # Device-side events only: the CPU-side aten ops carry their
        # kernels' time too and would count it twice.
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        device_us = getattr(evt, "self_device_time_total", None)
        if device_us is None:
            device_us = evt.self_cuda_time_total
        if device_us > 0:
            rows.append((evt.key, device_us / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows) or 1.0
    return total, [{"name": name[:90], "ms": ms, "calls": calls,
                    "share": ms / total} for name, ms, calls in rows[:8]]


def main(argv=None) -> int:
    from bert_pytorch_tpu_torch.config import BertConfig
    from bert_pytorch_tpu_torch.data.tokenization import BertTokenizer
    from bert_pytorch_tpu_torch.serve import InferenceEngine
    from bert_pytorch_tpu_torch.serve.cli import DTYPES
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
    args = parser.parse_args(argv)

    config = BertConfig.from_json_file(args.model_config_file)
    config.vocab_size = config.padded_vocab_size(8)
    if torch.cuda.is_available():
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(json.dumps({"card": card, "torch": torch.__version__}),
              flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        tokenizer = BertTokenizer(write_trace_vocab(
            os.path.join(tmp, "vocab.txt")))
    engine = InferenceEngine(
        config, tokenizer, {"fill_mask": {}, "classify": {}},
        buckets=[int(b) for b in args.buckets.split(",")],
        max_batch_size=args.max_batch_size, max_requests_per_pack=4,
        dtype=DTYPES[args.dtype], seed=args.seed,
        attention_backend=args.attention_backend, device=args.device)
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
                        "requests": len(plan.requests),
                        "real_tokens": sum(r.length for r in plan.requests)}
                line.update({f"{k}_ms": statistics.median(v)
                             for k, v in times.items()})
                if engine.device.type == "cuda":
                    total, kernels = _kernel_table(engine, staged)
                    line.update(device_ms=total, kernels=kernels)
                print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
