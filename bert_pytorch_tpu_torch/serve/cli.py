"""Shared CLI surface of the serving entry point (the port of the JAX
package's ``serve/cli.py``): the device, kernel, dispatch, fast-path and
tracing flags, and the dispatch-mode names the service validates against.
"""

from __future__ import annotations

import argparse

import torch

ATTENTION_BACKENDS = ("flash_infer", "flash_infer_int8", "dense")
QUANTIZE_CHOICES = ("none", "bf16", "int8")
DISPATCH_MODES = ("pipelined", "serial")
AUTOTUNE_MODES = ("off", "load", "measure")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(name: str) -> torch.device:
    """The torch device an entry point runs on. ``cuda`` (the default of
    every entry point) raises where no CUDA device exists: nothing quietly
    carries on on the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            "False; pass --device cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return device


def add_device_args(parser: argparse.ArgumentParser) -> None:
    """Device, compute dtype and attention kernel of the engine."""
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device: cuda (default; raises without a card) or cpu")
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=sorted(DTYPES))
    parser.add_argument(
        "--attention_backend", type=str, default="flash_infer",
        choices=ATTENTION_BACKENDS,
        help="encoder attention: flash_infer is the forward-only fused "
             "CUDA kernel (its plain PyTorch version on the CPU), "
             "flash_infer_int8 its int8-QK^T twin (per-head symmetric "
             "scales); dense materializes the [B, H, S, S] scores with "
             "plain tensor ops")


def add_dispatch_args(parser: argparse.ArgumentParser) -> None:
    """The dispatch-plane knob (serve/service.py), spelled as in the JAX
    package."""
    parser.add_argument(
        "--dispatch_mode", type=str, default="pipelined",
        choices=DISPATCH_MODES,
        help="pipelined (default) runs the three-stage continuous-"
             "batching plane: an assembler admits late arrivals into "
             "the forming batch while the executor keeps the device "
             "busy and a completion stage decodes off the device "
             "thread; serial is the flush-then-wait loop, kept for "
             "A/B measurement")


def add_fast_path_args(parser: argparse.ArgumentParser) -> None:
    """The serving fast-path engine options (ops/quant.py, the fused
    fill_mask gather), spelled as in the JAX package. The engine takes
    ``args.quantize`` verbatim and reads "none" as None."""
    parser.add_argument(
        "--quantize", type=str, default="none", choices=QUANTIZE_CHOICES,
        help="inference weight format: bf16 halves the Dense weight "
             "bytes, int8 quarters them and serves int8 GEMMs (per-tensor "
             "symmetric weight scales, per-token activation scales); "
             "embeddings and LayerNorm stay fp32")
    parser.add_argument(
        "--fuse_epilogues", action="store_true",
        help="fold each head's output extraction into the forward: "
             "fill_mask gathers its [MASK] rows before the vocab "
             "projection, so [B, epilogue_slots, V] logits cross to the "
             "host instead of [B, S, V]")
    parser.add_argument(
        "--epilogue_slots", type=int, default=8,
        help="per-row gather quota for fused epilogues; a batch whose "
             "rows carry more positions of interest runs the unfused "
             "forward")
    parser.add_argument(
        "--autotune", type=str, default="off", choices=AUTOTUNE_MODES,
        help="measured tile geometry of the flash_infer* attention "
             "kernels (ops/kernels/autotune.py): 'load' reads the "
             "winners in --autotune_cache, 'measure' also times the "
             "candidates of buckets without one at start-up and writes "
             "the winners back")
    parser.add_argument(
        "--autotune_cache", type=str, default="",
        help="autotune winners JSON, kept beside --compile_cache_dir: a "
             "restart that loads it serves the same geometry, measuring "
             "and building nothing")


def add_tracing_args(parser: argparse.ArgumentParser) -> None:
    """The request-tracing / metrics-plane knobs (serve/tracing.py)."""
    parser.add_argument(
        "--trace_sample_rate", type=float, default=0.01,
        help="fraction of requests traced as span trees (deterministic "
             "head sampling on the request id; requests over the SLO are "
             "ALWAYS traced). 0 disables trace export while the phase "
             "aggregates and /metricsz keep working")
    parser.add_argument(
        "--slo_p99_ms", type=float, default=500.0,
        help="per-request latency SLO target (ms): drives the "
             "always-sample-slow rule and the over-SLO counters on "
             "/metricsz. 0 disables SLO accounting")
    parser.add_argument(
        "--slo_error_budget", type=float, default=0.01,
        help="fraction of requests allowed over the SLO target before "
             "the error budget is burned")


def build_tracer(args, emit=None, window: int = 64):
    """One TraceCollector from the add_tracing_args flags."""
    from bert_pytorch_tpu_torch.serve.tracing import TraceCollector

    return TraceCollector(
        emit=emit,
        sample_rate=args.trace_sample_rate,
        slo_p99_ms=args.slo_p99_ms or None,
        error_budget=args.slo_error_budget,
        window=window)
