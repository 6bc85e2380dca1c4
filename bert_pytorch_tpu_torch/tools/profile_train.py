"""Where the pretraining step's time goes, on the card.

    python -m bert_pytorch_tpu_torch.tools.profile_train \\
        [--attention_backend flash,dense] [--remat dots,none] \\
        [--dtype bfloat16,float16,float16,bfloat16] [--kfac] [--telemetry]

Builds the phase-2 recipe (configs/bert_pretraining_phase2_config.json:
seq 512, max_pred 80, LAMB with poly warmup) at BERT-large width
(configs/bert_large_uncased_config.json, seeded random weights) through the
runner's own setup functions (bf16, or each of the comma-separated
``--dtype``s in turn, fp16 with its dynamic loss scale; local batch 8 x
accumulation 2, as chip_smoke.py trains), feeds it seeded synthetic
batches masked by the port's dataset code, and prints one JSON line per
(remat policy, backend, dtype) with:

* ``step_ms`` — host clock around a whole optimizer step that ends in a
  device synchronize (median of ITERS steps after two of warmup),
  and ``seq_per_s`` from it;
* ``optimizer_ms`` — the share of the step spent in ``optimizer.step()``
  (host clock, synchronised before and after), and ``fwd_bwd_ms``, the
  rest;
* ``device_ms`` — device time of one step: the kernel events of its
  ``torch.profiler`` Chrome trace (:func:`kernel_rows`), and
  ``device_busy`` = device_ms / step_ms;
* ``attention`` — the three training kernels' device time, launches
  (and those on the tensor-core route) and share of device_ms; ``largest_gemm`` — the largest cuBLAS GEMM kernel
  by total time; ``kernels`` — the top kernels by device time;
* ``host`` — the top operators by self CPU time in the same step (where
  the host spends the time the card waits);
* in fp16, ``loss_scales`` and ``skipped``: the scale of every step run
  and how many of them overflowed (a skipped step runs its forward and
  backward but no optimizer update).

``--kfac`` adds one JSON line (flash, remat dots) for K-FAC
(``--kfac``, fused capture, factors and inverses due on every step: the
heaviest step) beside the plain step of the same model, in turns (K-FAC,
plain, plain, K-FAC): each step's wall time (host clock to a synchronize,
unprofiled), then each step's device time and, for the K-FAC steps, the
device time of the K-FAC profiler ranges (``kfac.capture``: the taps'
statistics in the backward; ``kfac.ema``; ``kfac.inverses``: 24 Cholesky
inverses of each stacked factor; ``kfac.precondition``), the amortised
step at the runner's default intervals (factors every 10 steps, inverses
every 100), the state's bytes, and the inverse update's library calls
on one factor of each size (1024², 1025², 4097²; CUDA events): the
Cholesky factorization, ``cholesky_inverse`` and ``eigh`` (the eigen
method's update is 24 layers of 5 + 2 + 1 of them).

``--telemetry`` adds one JSON line (flash, remat dots) for the runner
telemetry's own cost: the plain step against the step that computes the
grad-health block (``--grad_stats_every 1``) and against the plain step
threaded through the ``TrainTelemetry`` facade (event marks, a sync, the
allocator read, a JSONL record per step) in turns (plain, health,
facade, facade, health, plain): wall times, then each step's device
time (``torch.profiler``).

Needs a CUDA card (the measurement has no CPU mode).
"""

from __future__ import annotations

import argparse
import bisect
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


def load_trace(path: str) -> list:
    """The events of a ``torch.profiler`` Chrome trace file."""
    with open(path, encoding="utf-8") as f:
        return json.load(f)["traceEvents"]


def trace_events(prof) -> list:
    """The events of a finished ``torch.profiler`` run's Chrome trace
    (written to a temporary file and read back)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return load_trace(path)
    finally:
        os.remove(path)


def kernel_rows(events: list) -> list:
    """(kernel name, device ms, launches), largest first, over the kernel
    events of a Chrome trace: the repo's one reading of device time
    (``chip_smoke.py`` reads its runners' trace windows with it too).
    Profiler ranges mirrored onto the device timeline span other kernels;
    they are not kernel events, so nothing counts twice."""
    by_name: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            ms, n = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (ms + e.get("dur", 0) / 1e3, n + 1)
    return sorted(((name, ms, n) for name, (ms, n) in by_name.items()),
                  key=lambda r: -r[1])


def device_rows(prof) -> list:
    """:func:`kernel_rows` of a finished ``torch.profiler`` run."""
    return kernel_rows(trace_events(prof))


def recipe_args(out: str, backend: str = "flash", remat: str = "dots",
                extra=(), dtype: str = "bfloat16"):
    """The runner's arguments for the phase-2 recipe at BERT-large width
    (``dtype``, local batch 8 x 2, no save, no grad-health block: the step
    alone, as this script has always timed it)."""
    from bert_pytorch_tpu_torch import run_pretraining

    return run_pretraining.setup_training(run_pretraining.parse_arguments([
        "--output_dir", out,
        "--config_file", os.path.join(REPO, "configs",
                                      "bert_pretraining_phase2_config.json"),
        "--model_config_file", os.path.join(
            REPO, "configs", "bert_large_uncased_config.json"),
        "--steps", "1", "--skip_final_checkpoint", "--seed", "0",
        "--grad_stats_every", "0",
        "--attention_backend", backend, "--remat", remat,
        "--dtype", dtype, "--local_batch_size", str(LOCAL_BATCH),
        "--global_batch_size", str(LOCAL_BATCH * ACCUMULATION_STEPS),
        *extra]))


def recipe_batches(args, config, count: int = 3) -> list:
    from bert_pytorch_tpu_torch import pretrain
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
        synthetic_pretraining_batch)

    return [pretrain.to_device(pretrain.stack_microbatches(
        synthetic_pretraining_batch(i, args.global_batch_size, 512,
                                    config.vocab_size,
                                    args.max_predictions_per_seq),
        args.accumulation_steps), args.device) for i in range(count)]


def timed_ms(step, batch, scales=None) -> float:
    """Host clock around one step that ends in a synchronize; the step's
    (loss scale, finite) go to ``scales`` when a list is given and the
    step reports a loss scale (fp16)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = step(batch)
    float(metrics["loss"])
    torch.cuda.synchronize()
    elapsed = (time.perf_counter() - t0) * 1e3
    if scales is not None and "loss_scale" in metrics:
        scales.append((float(metrics["loss_scale"]),
                       float(metrics["finite"])))
    return elapsed


def profile_backend(backend: str, remat: str, iters: int = ITERS,
                    dtype: str = "bfloat16") -> dict:
    from torch.profiler import ProfilerActivity, profile

    from bert_pytorch_tpu_torch import run_pretraining

    out = tempfile.mkdtemp(prefix="profile_train_")  # no save happens
    args = recipe_args(out, backend, remat, dtype=dtype)
    model, config = run_pretraining.prepare_model(args)
    optimizer, schedule = run_pretraining.prepare_optimizer(args, model)
    step = run_pretraining.make_step(args, model, optimizer, schedule,
                                     config)
    batches = recipe_batches(args, config)
    scales: list = []

    def run(i):
        return timed_ms(step, batches[i % len(batches)], scales)

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
    if scales:
        result["loss_scales"] = [s for s, _ in scales]
        result["skipped"] = sum(1 for _, f in scales if f != 1.0)
    del model, optimizer, step, batches
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return result


def range_device_ms(events: list, name: str) -> float:
    """Device time (ms) of the kernels that run inside the profiler range
    ``name`` on the device timeline: the range's device-side annotations
    in a Chrome trace (the profiler mirrors each ``record_function`` range
    there, from its first kernel's start to its last kernel's end)
    intersected with every kernel event. 0.0 when the trace holds no such
    annotation."""
    windows = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") == "gpu_user_annotation"
               and e.get("name") == name]
    kernels = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                     if e.get("cat") == "kernel")
    starts = [k[0] for k in kernels]
    total = 0.0
    for lo, hi in windows:
        i = max(bisect.bisect_left(starts, lo) - 1, 0)
        while i < len(kernels) and kernels[i][0] < hi:
            total += max(0.0, min(hi, kernels[i][1]) - max(lo,
                                                           kernels[i][0]))
            i += 1
    return total / 1e3


def linalg_ms(n: int, device) -> dict:
    """CUDA-event ms of the inverse update's library calls on one damped
    n x n SPD fp32 matrix (the second of two calls each): its Cholesky
    factorization, ``cholesky_inverse`` of the factor (what
    ``KFAC.inverse_factors`` runs), ``cholesky_solve`` of the identity
    (the same inverse by two triangular solves, as the JAX package's
    ``cho_solve``), and ``eigh`` (the eigen method)."""
    gen = torch.Generator(device=device).manual_seed(n)
    x = torch.randn(2 * n, n, generator=gen, device=device)
    spd = x.t() @ x / (2 * n) + 0.05 * torch.eye(n, device=device)
    chol = torch.linalg.cholesky_ex(spd)[0]
    eye = torch.eye(n, device=device)
    calls = {"cholesky": lambda: torch.linalg.cholesky_ex(spd),
             "cholesky_inverse": lambda: torch.cholesky_inverse(chol),
             "cholesky_solve": lambda: torch.cholesky_solve(eye, chol),
             "eigh": lambda: torch.linalg.eigh(spd)}
    out = {}
    for label, call in calls.items():
        call()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        out[label] = start.elapsed_time(end)
    return out


def kfac_turns(args, model, optimizer, schedule, config, kfac, kfac_state,
               batches) -> dict:
    """The K-FAC step (fused capture, factors and inverses due every step)
    and the plain step of the same model in turns (K-FAC, plain, plain,
    K-FAC): wall times unprofiled, then device times and the K-FAC ranges
    profiled. ``args`` are the runner's (``--kfac``); the model trains
    on."""
    from torch.profiler import ProfilerActivity, profile

    from bert_pytorch_tpu_torch import run_pretraining
    from bert_pytorch_tpu_torch.models.bert import KFAC_CAPTURE_RANGE

    saved = (args.kfac_capture, args.kfac_factor_interval,
             args.kfac_inv_interval, args.grad_stats_every)
    args.kfac_capture, args.kfac_factor_interval = "train", 1
    args.kfac_inv_interval, args.grad_stats_every = 1, 0
    steps = {"kfac": run_pretraining.make_step(
        args, model, optimizer, schedule, config, kfac, kfac_state),
        "plain": run_pretraining.make_step(args, model, optimizer,
                                           schedule, config)}
    (args.kfac_capture, args.kfac_factor_interval, args.kfac_inv_interval,
     args.grad_stats_every) = saved
    order = ("kfac", "plain", "plain", "kfac")
    for i, name in enumerate(order[:2]):  # warm-up
        timed_ms(steps[name], batches[i % len(batches)])
    wall = {"kfac": [], "plain": []}
    for i, name in enumerate(order):
        wall[name].append(timed_ms(steps[name], batches[i % len(batches)]))
    device = {"kfac": [], "plain": []}
    ranges = {key: [] for key in (KFAC_CAPTURE_RANGE, "kfac.ema",
                                  "kfac.inverses", "kfac.precondition")}
    for i, name in enumerate(order):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            timed_ms(steps[name], batches[i % len(batches)])
        events = trace_events(prof)
        device[name].append(sum(r[1] for r in kernel_rows(events)))
        if name == "kfac":
            for key in ranges:
                ranges[key].append(range_device_ms(events, key))
    med = {key: statistics.median(v) for key, v in ranges.items()}
    plain_ms = statistics.median(device["plain"])
    kfac_ms = statistics.median(device["kfac"])
    capture_ms = med[KFAC_CAPTURE_RANGE] + med["kfac.ema"]
    return {
        "wall_ms": wall, "device_ms": device, "ranges_ms": ranges,
        "capture_ms": capture_ms, "inverses_ms": med["kfac.inverses"],
        "precondition_ms": med["kfac.precondition"],
        "kfac_minus_plain_device_ms": kfac_ms - plain_ms,
        # Factors every 10 steps, inverses every 100: the runner's defaults.
        "amortised_default_device_ms": plain_ms + med["kfac.precondition"]
        + capture_ms / 10 + med["kfac.inverses"] / 100,
        "state_bytes": kfac_state.nbytes(),
        "linalg_ms": {n: linalg_ms(n, kfac_state.count.device)
                      for n in (1024, 1025, 4097)},
        "kfac_count": int(kfac_state.count)}


def profile_kfac() -> dict:
    from bert_pytorch_tpu_torch import run_pretraining

    out = tempfile.mkdtemp(prefix="profile_train_")  # no save happens
    args = recipe_args(out, extra=["--kfac"])
    model, config = run_pretraining.prepare_model(args)
    optimizer, schedule = run_pretraining.prepare_optimizer(args, model)
    kfac, kfac_state = run_pretraining.prepare_kfac(args, model, config)
    result = kfac_turns(args, model, optimizer, schedule, config, kfac,
                        kfac_state, recipe_batches(args, config))
    result.update(backend=args.attention_backend, remat=args.remat,
                  dtype=args.dtype, local_batch=args.local_batch_size,
                  accumulation_steps=args.accumulation_steps,
                  peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del model, optimizer, kfac, kfac_state
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    return result


def profile_telemetry() -> dict:
    from torch.profiler import ProfilerActivity, profile

    from bert_pytorch_tpu_torch import run_pretraining, telemetry

    out = tempfile.mkdtemp(prefix="profile_train_")
    args = recipe_args(out)
    model, config = run_pretraining.prepare_model(args)
    optimizer, schedule = run_pretraining.prepare_optimizer(args, model)
    batches = recipe_batches(args, config)
    plain = run_pretraining.make_step(args, model, optimizer, schedule,
                                      config)
    args.grad_stats_every = 1
    health = run_pretraining.make_step(args, model, optimizer, schedule,
                                       config)
    tele = telemetry.TrainTelemetry(
        jsonl_path=os.path.join(out, "telemetry.jsonl"), window=1,
        sync_every=1, seq_per_step=args.global_batch_size,
        device=args.device)

    def facade(batch):
        tele.timer.data_start()
        tele.timer.data_end()
        metrics = plain(batch)
        tele.dispatch_done()
        tele.step_done(opt_step(), metrics)
        return metrics

    def opt_step():
        return int(optimizer.param_groups[0]["count"])

    steps = {"plain": plain, "health": health, "facade": facade}
    order = ("plain", "health", "facade", "facade", "health", "plain")
    for i, name in enumerate(order[:3]):  # warm-up
        timed_ms(steps[name], batches[i % len(batches)])
    wall = {name: [] for name in steps}
    for i, name in enumerate(order):
        wall[name].append(timed_ms(steps[name], batches[i % len(batches)]))
    device = {name: [] for name in steps}
    for i, name in enumerate(order):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            timed_ms(steps[name], batches[i % len(batches)])
        device[name].append(sum(r[1] for r in device_rows(prof)))
    tele.close()
    del model, optimizer, steps, plain, health, batches
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"backend": args.attention_backend, "remat": args.remat,
            "dtype": args.dtype, "order": order, "wall_ms": wall,
            "device_ms": device}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--attention_backend", default="flash",
                        help="comma-separated backends to profile in turn")
    parser.add_argument("--remat", default="dots",
                        help="comma-separated remat policies, each profiled "
                             "with every backend")
    parser.add_argument("--dtype", default="bfloat16",
                        help="comma-separated dtypes (bfloat16, float16, "
                             "float32), each profiled in turn with every "
                             "backend; repeat them to alternate")
    parser.add_argument("--kfac", action="store_true",
                        help="also the K-FAC step against the plain one")
    parser.add_argument("--telemetry", action="store_true",
                        help="also the plain step against the grad-health "
                             "step and the step through the telemetry "
                             "facade")
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
            for dtype in args.dtype.split(","):
                print(json.dumps(profile_backend(backend, remat,
                                                 dtype=dtype)), flush=True)
    if args.kfac:
        print(json.dumps({"kfac": profile_kfac()}), flush=True)
    if args.telemetry:
        print(json.dumps({"telemetry": profile_telemetry()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
