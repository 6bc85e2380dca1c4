#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root, on a CUDA machine

Phases (any failure exits non-zero and prints no result line):

1. the card: name and power limit (``nvidia-smi``); no CUDA device = fail;
2. build every CUDA kernel of the serving path from the sources in the
   checkout (one ``nvcc`` per source, all started together);
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it (B=8, H=16, D=64, S in {128, 512}, bf16
   and fp32, padded rows and packed rows);
4. time each kernel, its plain version and the one PyTorch call that
   computes the same function (CUDA events), beside the least time the
   card could take for the same work;
5. the main path: ``run_server.build_service`` at full BERT-large width
   (configs/bert_large_uncased_config.json, seeded random weights, a demo
   vocab) serving fill_mask and classify over HTTP, packed and unpacked,
   over both buckets; every kernel launch counter must move, and the
   fused-attention kernel must launch once per encoder layer per forward.
   Then one staged fp32 fill_mask batch through a ``flash_infer`` engine
   and a ``dense`` engine with the same seeded weights must agree.

The last three lines of standard output are the kernels JSON, the card's
name and power limit (``nvidia-smi``), and the JSON result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 CUDA cores,
# HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
# Kernel-vs-plain tolerances: fp32 differs only in summation order; bf16
# rounds P to bf16 before PV at tile-local maxima (the plain version rounds
# at the row maximum) and rounds the output to bf16.
ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# fp32 logits of the flash and dense engines over 24 layers: the same
# math, summed in another order.
ENGINE_ATOL = 1e-3
B, H, D = 8, 16, 64
SEQS = (128, 512)
CONFIG = os.path.join(REPO, "configs", "bert_large_uncased_config.json")
REPLACES = "bert_pytorch_tpu/ops/pallas/attention.py:512"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_inputs(seq: int, dtype, packed: bool, gen: torch.Generator):
    """q, k, v [B, S, H, D] and either the [B, 1, 1, S] key bias of rows
    with random lengths, or [B, S] sequence ids of 1-4 packed segments per
    row followed by id-0 pad."""
    q, k, v = (torch.randn(B, seq, H, D, device="cuda", generator=gen)
               .to(dtype) for _ in range(3))
    if not packed:
        lens = torch.randint(1, seq + 1, (B,), device="cuda", generator=gen)
        mask = torch.arange(seq, device="cuda")[None, :] < lens[:, None]
        bias = ((1.0 - mask.float()) * -10000.0)[:, None, None, :]
        return q, k, v, {"bias": bias}
    rng = np.random.default_rng(int(torch.randint(
        0, 2**31 - 1, (1,), generator=gen, device="cuda")))
    sids = np.zeros((B, seq), np.int32)
    for row in range(B):
        n_seg = int(rng.integers(1, 5))
        room = int(rng.integers(n_seg, seq + 1))  # the rest is pad
        cuts = np.sort(rng.choice(np.arange(1, room), n_seg - 1,
                                  replace=False)) if n_seg > 1 else []
        bounds = [0, *cuts, room]
        for s in range(n_seg):
            sids[row, bounds[s]:bounds[s + 1]] = s + 1
    return q, k, v, {"sequence_ids": torch.from_numpy(sids).cuda()}


def library_call(q, k, v, kwargs):
    """The one PyTorch call computing the same function (a yardstick only;
    the port never calls it): scaled_dot_product_attention with the same
    additive mask."""
    if "bias" in kwargs:
        mask = kwargs["bias"].to(q.dtype)
    else:
        sids = kwargs["sequence_ids"]
        same = (sids[:, :, None] == sids[:, None, :]) & (sids[:, :, None] > 0)
        mask = torch.where(same, 0.0, -10000.0)[:, None].to(q.dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask)


def bound_ms(seq: int, dtype) -> tuple:
    """(least time in ms, what bounds it): q, k, v read once and out written
    once (+ the [B, S] fp32 key bias), against 4*B*H*S^2*D operations."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = 4 * B * seq * H * D * elem + B * seq * 4
    flops = 4 * B * H * seq * seq * D
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_and_time_attention() -> dict:
    """Phases 3 and 4 for the fused-attention kernel."""
    from bert_pytorch_tpu_torch.ops.kernels.attention import (
        flash_attention_infer, flash_attention_infer_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    cases = []
    for seq in SEQS:
        for dtype in (torch.bfloat16, torch.float32):
            for packed in (False, True):
                q, k, v, kw = attention_inputs(seq, dtype, packed, gen)
                out = flash_attention_infer(q, k, v, **kw)
                torch.cuda.synchronize()
                ref = flash_attention_infer_reference(q, k, v, **kw)
                err = (out.float() - ref.float()).abs().max().item()
                finite = bool(torch.isfinite(out).all())
                name = (f"S={seq} {str(dtype)[6:]} "
                        f"{'packed' if packed else 'padded'}")
                log(f"[check] flash_attention_infer {name}: max_abs_err "
                    f"{err:.3e} (atol {ATOL[dtype]:g}), finite {finite}")
                if not finite or not err <= ATOL[dtype]:
                    raise AssertionError(
                        f"flash_attention_infer disagrees with its plain "
                        f"version at {name}: {err} > {ATOL[dtype]}")
                max_err = max(max_err, err)
                t_kernel = cuda_time_ms(
                    lambda: flash_attention_infer(q, k, v, **kw))
                t_plain = cuda_time_ms(
                    lambda: flash_attention_infer_reference(q, k, v, **kw))
                t_lib = cuda_time_ms(library_call(q, k, v, kw))
                t_bound, by = bound_ms(seq, dtype)
                log(f"[time] {name}: kernel {t_kernel:.4f} ms, plain "
                    f"{t_plain:.4f} ms, library {t_lib:.4f} ms, bound "
                    f"{t_bound:.4f} ms ({by})")
                cases.append({"seq": seq, "dtype": str(dtype)[6:],
                              "packed": packed, "max_abs_err": err,
                              "ms": t_kernel, "plain_ms": t_plain,
                              "library_ms": t_lib, "bound_ms": t_bound,
                              "bound_by": by})
    # The headline numbers: the serving dtype at the larger bucket, padded.
    head = next(c for c in cases if c["seq"] == max(SEQS)
                and c["dtype"] == "bfloat16" and not c["packed"])
    return {"name": "flash_attention_infer", "route": "cuda",
            "source": "bert_pytorch_tpu_torch/csrc/flash_attention_infer.cu",
            "replaces": REPLACES, "launches": None, "max_abs_err": max_err,
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "cases": cases}


def serve_args(vocab: str, dtype: str, backend: str, tasks: str):
    from bert_pytorch_tpu_torch import run_server

    return run_server.parse_arguments([
        "--model_config_file", CONFIG, "--vocab_file", vocab,
        "--device", "cuda", "--dtype", dtype,
        "--attention_backend", backend, "--tasks", tasks,
        "--buckets", "128,512", "--max_batch_size", "8",
        "--pack_requests", "--max_wait_ms", "20", "--port", "0",
        "--trace_sample_rate", "0"])


def request_waves() -> list:
    """Two waves of concurrent requests for both heads: short ones (packed
    several to a row in the 128 bucket), then long ones (the 512 bucket)."""
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import TRACE_WORDS

    rng = np.random.default_rng(7)

    def wave(lo, hi, n):
        out = []
        for _ in range(n):
            words = [str(w) for w in rng.choice(TRACE_WORDS, int(
                rng.integers(lo, hi)))]
            cut = len(words) // 2
            out.append(("fill_mask", {"text": " ".join(
                words[:cut] + ["[MASK]"] + words[cut:]), "top_k": 5}))
            out.append(("classify", {"text": " ".join(words)}))
        return out

    return [wave(4, 24, 8), wave(200, 420, 4)]


def post(port: int, task: str, payload: dict) -> tuple:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/{task}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=180) as resp:
            body = json.loads(resp.read())
            return resp.status, body, time.perf_counter() - t0
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode(), time.perf_counter() - t0


def check_body(task: str, body, labels) -> None:
    if task == "fill_mask":
        masks = body["masks"]
        if len(masks) != 1 or len(masks[0]) != 5:
            raise AssertionError(f"fill_mask body malformed: {body}")
        for slot in masks[0]:
            if not (isinstance(slot["token"], str)
                    and 0.0 <= slot["score"] <= 1.0
                    and math.isfinite(slot["score"])):
                raise AssertionError(f"fill_mask slot malformed: {slot}")
    else:
        if body["label"] not in labels or abs(
                sum(body["scores"].values()) - 1.0) > 1e-4:
            raise AssertionError(f"classify body malformed: {body}")


def drive_main_path(vocab: str, kernels: dict) -> dict:
    """Phase 5a: serve fill_mask + classify over HTTP at BERT-large width."""
    from bert_pytorch_tpu_torch import run_server
    from bert_pytorch_tpu_torch.serve import make_server

    args = serve_args(vocab, "bfloat16", "flash_infer", "fill_mask,classify")
    service = run_server.build_service(args)
    engine = service.engine
    layers = engine.config.num_hidden_layers
    t0 = time.perf_counter()
    engine.warmup()
    log(f"[serve] warmup {engine.startup} in "
        f"{time.perf_counter() - t0:.2f}s")
    plans = []
    execute_staged = engine.execute_staged

    def recording(staged):
        plans.append((staged.task, staged.plan.bucket, staged.plan.packed,
                      max(len(row) for row in staged.plan.rows)))
        return execute_staged(staged)

    engine.execute_staged = recording
    labels = args.classify_labels.split(",")
    waves = request_waves()
    # Counts to zero just before the main path, read just after.
    for kernel in kernels.values():
        kernel.launches = 0
    engine.forwards = 0
    service.start()
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        payloads, results = [], []
        for wave in waves:
            with ThreadPoolExecutor(max_workers=len(wave)) as pool:
                results += list(pool.map(lambda tp: post(port, *tp), wave))
            payloads += wave
        # The unpacked forward (key-bias path of the kernel): the offline
        # scoring entry point runs one request alone in a row.
        direct = {task: engine.run_direct(task, payload)
                  for task, payload in (waves[0][0], waves[0][1])}
    finally:
        server.shutdown()
        server.server_close()
        service.stop()
        thread.join(timeout=30)
    launches = {name: k.launches for name, k in kernels.items()}
    forwards = engine.forwards
    for (task, _), (status, body, _) in zip(payloads, results):
        if status != 200:
            raise AssertionError(f"{task} answered {status}: {body}")
        check_body(task, body, labels)
    for task, body in direct.items():
        check_body(task, body, labels)
    latencies = sorted(r[2] for r in results)
    buckets = sorted({p[1] for p in plans})
    packed_rows = max(p[3] for p in plans if p[2])
    log(f"[serve] {len(results)} requests answered 200 over {forwards} "
        f"forwards; plans (task, bucket, packed, max requests/row): {plans}")
    if buckets != [128, 512] or packed_rows < 2 or all(p[2] for p in plans):
        raise AssertionError(f"traffic did not cover both buckets, packed "
                             f"and unpacked rows: {plans}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    if launches["flash_attention_infer"] != layers * forwards:
        raise AssertionError(
            f"flash_attention_infer launched {launches} times over "
            f"{forwards} forwards; expected {layers} per forward")
    return {"requests": len(results), "forwards": forwards,
            "launches": launches, "p50_ms": statistics.median(latencies) * 1e3,
            "max_ms": latencies[-1] * 1e3, "cold_start_s":
            engine.startup["cold_start_s"]}


def check_flash_vs_dense(vocab: str) -> float:
    """Phase 5b: the same seeded fp32 weights through a flash_infer engine
    and a dense engine; one staged fill_mask batch, packed and unpacked."""
    from bert_pytorch_tpu_torch import run_server
    from bert_pytorch_tpu_torch.serve.batcher import Request

    payloads = [p for wave in request_waves() for t, p in wave
                if t == "fill_mask"][:8]
    outs = {}
    for backend in ("flash_infer", "dense"):
        engine = run_server.build_service(
            serve_args(vocab, "float32", backend, "fill_mask")).engine
        handler = engine.tasks["fill_mask"].handler
        reqs = [Request("fill_mask", handler.prepare(p, engine.max_len()), p)
                for p in payloads]
        outs[backend] = []
        for packed in (False, True):
            plan = engine.plan_batch(reqs, packed=packed)
            results, _ = engine.execute("fill_mask", plan)
            outs[backend].extend(results)
        del engine
        torch.cuda.empty_cache()
    err = max(float(np.abs(a - b).max())
              for a, b in zip(outs["flash_infer"], outs["dense"]))
    finite = all(np.isfinite(a).all() for a in outs["flash_infer"])
    log(f"[check] fp32 fill_mask logits, flash_infer vs dense engine: "
        f"max_abs_err {err:.3e} (atol {ENGINE_ATOL:g}), finite {finite}")
    if not finite or not err <= ENGINE_ATOL:
        raise AssertionError(f"flash_infer and dense engines disagree: {err}")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from bert_pytorch_tpu_torch.ops.kernels import build
    from bert_pytorch_tpu_torch.ops.kernels.attention import (
        flash_attention_infer)

    # fp32 matmuls in full fp32 for every comparison below (TF32 keeps
    # about three decimal digits).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    device = torch.cuda.get_device_name(0)
    log(f"[card] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    built = build.build()
    log(f"[build] {built} in {time.perf_counter() - t0:.2f}s")
    kernels = {"flash_attention_infer": flash_attention_infer}
    entries = {"flash_attention_infer": check_and_time_attention()}
    with tempfile.TemporaryDirectory() as tmp:
        from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
            write_trace_vocab)

        vocab = write_trace_vocab(os.path.join(tmp, "vocab.txt"))
        served = drive_main_path(vocab, kernels)
        log(f"[serve] {served['requests']} requests served, p50 "
            f"{served['p50_ms']:.1f} ms, max {served['max_ms']:.1f} ms on "
            f"{card}")
        engine_err = check_flash_vs_dense(vocab)
    for name, entry in entries.items():
        entry["launches"] = served["launches"][name]
    log(f"[result] {json.dumps(dict(served, engine_fp32_max_abs_err=engine_err))}")
    print(json.dumps({"kernels": list(entries.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
