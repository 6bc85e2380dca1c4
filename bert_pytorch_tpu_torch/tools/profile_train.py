"""Where the pretraining step's time goes, on the card.

    python -m bert_pytorch_tpu_torch.tools.profile_train \\
        [--attention_backend flash,dense] [--remat dots,none]

Builds the phase-2 recipe (configs/bert_pretraining_phase2_config.json:
seq 512, max_pred 80, LAMB with poly warmup) at BERT-large width
(configs/bert_large_uncased_config.json, seeded random weights) through the
runner's own setup functions (bf16, local batch 8 x accumulation 2, as
chip_smoke.py trains), feeds it seeded synthetic batches masked by
the port's dataset code, and prints one JSON line per (remat policy,
backend) with:

* ``step_ms`` — host clock around a whole optimizer step that ends in a
  device synchronize (median of ITERS steps after two of warmup),
  and ``seq_per_s`` from it;
* ``optimizer_ms`` — the share of the step spent in ``optimizer.step()``
  (host clock, synchronised before and after), and ``fwd_bwd_ms``, the
  rest;
* ``device_ms`` — device time of one step by ``torch.profiler`` (CUDA
  activity) and ``device_busy`` = device_ms / step_ms;
* ``attention`` — the three training kernels' device time, launches
  (and those on the tensor-core route) and share of device_ms; ``largest_gemm`` — the largest cuBLAS GEMM kernel
  by total time; ``kernels`` — the top kernels by device time;
* ``host`` — the top operators by self CPU time in the same step (where
  the host spends the time the card waits).

Needs a CUDA card (the measurement has no CPU mode).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# The device kernels of each training attention kernel, by route: the
# CUDA-core kernel and the tensor-core one.
ATTENTION_KERNELS = {
    "flash_attention_fwd": ("flash_fwd_kernel", "flash_fwd_wgmma_kernel"),
    "flash_attention_dq": ("flash_dq_kernel", "flash_dq_wgmma_kernel"),
    "flash_attention_dkv": ("flash_dkv_kernel", "flash_dkv_wgmma_kernel"),
}
GEMM_MARKERS = ("gemm", "xmma", "cutlass", "nvjet", "sm90")
LOCAL_BATCH, ACCUMULATION_STEPS, ITERS = 8, 2, 5


def device_rows(prof):
    """(kernel name, device ms, launches), largest first. Annotations that
    the profiler mirrors onto the device timeline (``Optimizer.step#...``)
    span other kernels and would count them twice: they are left out."""
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(evt, "is_user_annotation", False) or "#" in evt.key:
            continue
        device_us = getattr(evt, "self_device_time_total", None)
        if device_us is None:
            device_us = evt.self_cuda_time_total
        if device_us > 0:
            rows.append((evt.key, device_us / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    return rows


def profile_backend(backend: str, remat: str, iters: int = ITERS) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from bert_pytorch_tpu_torch import pretrain, run_pretraining
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
        synthetic_pretraining_batch)

    out = tempfile.mkdtemp(prefix="profile_train_")  # no save happens
    args = run_pretraining.setup_training(run_pretraining.parse_arguments([
        "--output_dir", out,
        "--config_file", os.path.join(REPO, "configs",
                                      "bert_pretraining_phase2_config.json"),
        "--model_config_file", os.path.join(
            REPO, "configs", "bert_large_uncased_config.json"),
        "--steps", "1", "--skip_final_checkpoint", "--seed", "0",
        "--attention_backend", backend, "--remat", remat,
        "--dtype", "bfloat16", "--local_batch_size", str(LOCAL_BATCH),
        "--global_batch_size", str(LOCAL_BATCH * ACCUMULATION_STEPS)]))
    model, config = run_pretraining.prepare_model(args)
    optimizer, schedule = run_pretraining.prepare_optimizer(args, model)
    step = run_pretraining.make_step(args, model, optimizer, schedule,
                                     config)
    batches = [pretrain.to_device(pretrain.stack_microbatches(
        synthetic_pretraining_batch(i, args.global_batch_size, 512,
                                    config.vocab_size,
                                    args.max_predictions_per_seq),
        args.accumulation_steps), args.device) for i in range(3)]

    def run(i):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(batches[i % len(batches)])
        float(metrics["loss"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for i in range(2):
        run(i)
    step_ms = statistics.median(run(i) for i in range(iters))

    inner = optimizer.step
    opt_ms = []

    def timed_step(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner(*a, **kw)
        torch.cuda.synchronize()
        opt_ms.append((time.perf_counter() - t0) * 1e3)

    optimizer.step = timed_step
    split_ms = statistics.median(run(i) for i in range(iters))
    optimizer.step = inner
    optimizer_ms = statistics.median(opt_ms)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(0)
    rows = device_rows(prof)
    device_ms = sum(r[1] for r in rows)
    host = sorted(((evt.key, evt.self_cpu_time_total / 1e3, evt.count)
                   for evt in prof.key_averages()
                   if evt.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda r: -r[1])
    attention = {}
    for label, names in ATTENTION_KERNELS.items():
        hits = [r for r in rows if any(n in r[0] for n in names)]
        ms = sum(r[1] for r in hits)
        attention[label] = {
            "ms": ms, "launches": sum(r[2] for r in hits),
            "tensor_core_launches": sum(r[2] for r in hits
                                        if "wgmma" in r[0]),
            "share": ms / device_ms if device_ms else 0.0}
    gemms = [r for r in rows if any(m in r[0].lower() for m in GEMM_MARKERS)
             and not any(n in r[0] for names in ATTENTION_KERNELS.values()
                         for n in names)]
    largest = gemms[0] if gemms else None
    result = {
        "backend": backend, "dtype": args.dtype, "remat": args.remat,
        "local_batch": args.local_batch_size,
        "accumulation_steps": args.accumulation_steps,
        "step_ms": step_ms,
        "seq_per_s": args.global_batch_size / step_ms * 1e3,
        "optimizer_ms": optimizer_ms,
        "fwd_bwd_ms": split_ms - optimizer_ms,
        "device_ms": device_ms, "device_busy": device_ms / step_ms,
        "attention": attention,
        "attention_share": sum(a["ms"] for a in attention.values())
        / device_ms if device_ms else 0.0,
        "gemm_ms": sum(r[1] for r in gemms),
        "largest_gemm": None if largest is None else {
            "name": largest[0][:90], "ms": largest[1], "calls": largest[2],
            "share": largest[1] / device_ms},
        "kernels": [{"name": n[:90], "ms": ms, "calls": c,
                     "share": ms / device_ms} for n, ms, c in rows[:10]],
        "host": [{"name": n[:60], "self_ms": ms, "calls": c}
                 for n, ms, c in host[:10]],
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    del model, optimizer, step, batches
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--attention_backend", default="flash",
                        help="comma-separated backends to profile in turn")
    parser.add_argument("--remat", default="dots",
                        help="comma-separated remat policies, each profiled "
                             "with every backend")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    for remat in args.remat.split(","):
        for backend in args.attention_backend.split(","):
            print(json.dumps(profile_backend(backend, remat)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
