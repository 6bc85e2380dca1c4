"""Shared telemetry CLI surface for the port's runners (the port of the JAX
package's ``telemetry/cli.py``).

Every runner exposes the same flag set via :func:`add_cli_args`, with the
JAX names and defaults, and builds its
:class:`~bert_pytorch_tpu_torch.telemetry.runner.TrainTelemetry` via
:func:`from_args`. Per-runner knobs are constructor arguments
(``window_default``: pretraining logs denser windows than the short
finetune runs; ``sync_every_default``: the finetune runners keep the full
per-step decomposition, the pretraining loop samples it).

The debug planes come with the JAX flags and defaults: ``--debug_port``
(the live introspection server, 0 disables), ``--debug_stale_after_s``
(its /healthz bound) and ``--postmortem_file`` (the crash flight
recorder, armed at ``<output_dir>/postmortem.json`` by default).
``--telemetry_cost_analysis`` (``auto``, ``off``, ``full``; default
``auto``) sets the mode of the ``compile_cost`` records the instrumented
step functions emit (telemetry/memory.py).
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import torch


def add_cli_args(parser, window_default: int = 50,
                 sync_every_default: int = 4) -> None:
    """Register the telemetry flags."""
    parser.add_argument("--profile_steps", type=str, default="0",
                        help="capture a torch.profiler trace: 'N' traces N "
                             "steady-state steps (after the first step), "
                             "'N:M' traces the explicit step range [N, M). "
                             "Auto-stops at the range end (or end of run). "
                             "'0' disables")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="profiler trace output directory; default "
                             "<output_dir>/profile")
    parser.add_argument("--telemetry_jsonl", type=str, default="",
                        help="JSONL telemetry sink path; default "
                             "<output_dir>/<prefix>_telemetry.jsonl (no "
                             "sink without an output dir)")
    parser.add_argument("--telemetry_window", type=int,
                        default=window_default,
                        help="steps per telemetry window record "
                             "(step-time percentiles + MFU)")
    parser.add_argument("--telemetry_sync_every", type=int,
                        default=sync_every_default,
                        help="device-sync cadence for the step-time "
                             "decomposer: 1 = wait for every step's work "
                             "(full data/host/device split, step-exact "
                             "sentinel), N = sample every Nth step, 0 = "
                             "never sync (data/host only)")
    parser.add_argument("--sentinel_policy", type=str, default="continue",
                        choices=["continue", "abort"],
                        help="non-finite loss/grad-norm policy: 'continue' "
                             "logs a sentinel record per observed bad step; "
                             "'abort' raises after --sentinel_patience "
                             "consecutive observed bad steps")
    parser.add_argument("--sentinel_patience", type=int, default=3,
                        help="consecutive OBSERVED non-finite steps before "
                             "'abort' raises. The sentinel observes on the "
                             "sync/log cadence, so detection lag scales "
                             "with --telemetry_sync_every; pass 1 there for "
                             "step-exact abort")
    parser.add_argument("--heartbeat_file", type=str, default="",
                        help="rank-0 liveness file (step/wallclock/"
                             "last_loss/counter, atomically replaced); "
                             "default <output_dir>/heartbeat.json")
    parser.add_argument("--debug_port", type=int, default=0,
                        help="live training introspection plane "
                             "(telemetry/introspect.py): serve /healthz "
                             "(heartbeat-backed step liveness), /statsz "
                             "(live window/grad-health/compile snapshot), "
                             "/metricsz (Prometheus text, consistent with "
                             "the JSONL windows per metric name) and POST "
                             "/profilez (on-demand capture) on "
                             "127.0.0.1:<port>. 0 (default) disables")
    parser.add_argument("--debug_stale_after_s", type=float, default=0.0,
                        help="debug-plane /healthz staleness bound: 503 "
                             "once no step completed for this many "
                             "seconds. 0 (default) follows "
                             "--watchdog_timeout_s when set, else 60 — "
                             "size it above the worst healthy step time")
    parser.add_argument("--postmortem_file", type=str, default="",
                        help="crash flight recorder (telemetry/"
                             "flightrec.py): bounded ring of the last "
                             "telemetry records + log lines, flushed "
                             "atomically here on fault/divergence/crash "
                             "(and periodically, so even a SIGKILLed "
                             "process leaves forensics); default "
                             "<output_dir>/postmortem.json, disabled "
                             "without an output dir. A clean run removes "
                             "the file")
    parser.add_argument("--grad_stats_every", type=int, default=-1,
                        help="grad-health cadence (per-layer-group grad/"
                             "param norms + update:weight ratios, "
                             "telemetry/model_stats.py): N computes every "
                             "Nth optimizer step, 0 disables, -1 (default) "
                             "follows --telemetry_sync_every")
    parser.add_argument("--grad_spike_factor", type=float, default=10.0,
                        help="divergence early-warning: warn when the "
                             "global grad norm exceeds this factor x its "
                             "own EMA (0 disables). Warnings follow "
                             "--sentinel_policy/--sentinel_patience")
    parser.add_argument("--update_ratio_max", type=float, default=1.0,
                        help="divergence early-warning: warn when the "
                             "global update:weight ratio exceeds this "
                             "absolute bound (0 disables)")
    parser.add_argument("--watchdog_timeout_s", type=float, default=0.0,
                        help="hung-step watchdog: flag (one fault record + "
                             "warning; never a kill) when no step completes "
                             "for this many seconds. Arms at the FIRST "
                             "completed step. 0 (default) disables")
    parser.add_argument("--telemetry_cost_analysis", type=str,
                        default="auto", choices=["auto", "off", "full"],
                        help="per-step-function cost attribution "
                             "(compile_cost records: FLOPs, bytes "
                             "accessed, argument/output bytes) counted "
                             "over the first call of each shapes digest. "
                             "'auto' counts the ops and the kernels' "
                             "notes; 'full' also reads the CUDA "
                             "allocator's peak over that call "
                             "(temp_bytes); 'off' emits none")


def stats_every(args) -> int:
    """Resolve --grad_stats_every: -1 follows the sync cadence (the host
    can only READ the block on synced steps, so computing it off-cadence
    would spend device time on values nobody reads)."""
    every = getattr(args, "grad_stats_every", 0)
    if every is None or every < 0:
        return max(0, int(getattr(args, "telemetry_sync_every", 0)))
    return int(every)


def default_jsonl_path(args, output_dir: Optional[str],
                       prefix: str) -> Optional[str]:
    """Resolve the JSONL sink path (None = no sink)."""
    if args.telemetry_jsonl:
        return args.telemetry_jsonl
    if output_dir:
        return os.path.join(output_dir, f"{prefix}_telemetry.jsonl")
    return None


def device_kind(device) -> str:
    """``torch.cuda.get_device_name`` of a ``cuda`` device, else ``"cpu"``
    (no known peak: MFU reads 0.0)."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def from_args(args, sink=None, seq_per_step: Optional[int] = None,
              flops_per_seq: Optional[float] = None,
              tokens_per_step: Optional[int] = None,
              output_dir: Optional[str] = None, device="cpu",
              process: str = "train", logger=None,
              is_primary: bool = True, n_devices: int = 1):
    """Build a TrainTelemetry from the :func:`add_cli_args` namespace.

    ``output_dir`` anchors the profile-dir, heartbeat and postmortem
    fallbacks; without one, traces go to ``./profile`` and the heartbeat
    and flight recorder are disabled unless the flags name paths.
    ``device`` is the training device (its name picks the peak for MFU; on
    ``cuda`` the device time comes from CUDA events). ``process`` labels
    the runner in the debug plane's exports and the postmortem
    ("pretrain", "glue", ...). ``logger`` (a ``utils/logging.Logger``), when
    given, tees its log lines into the flight recorder's ring. With
    ``--debug_port`` the debug server starts here; a port already held
    costs the debug plane (a line on standard error), never the run.
    ``is_primary`` (rank 0 of a multi-rank run) gates the artifacts: only
    the primary writes the heartbeat, traces and flight recorder and
    serves the debug plane; ``n_devices`` (the world size) makes MFU per
    card."""
    from bert_pytorch_tpu_torch.telemetry.runner import TrainTelemetry

    profile_dir = args.profile_dir or (
        os.path.join(output_dir, "profile") if output_dir else "profile")
    heartbeat = args.heartbeat_file or (
        os.path.join(output_dir, "heartbeat.json") if output_dir else None)
    postmortem = getattr(args, "postmortem_file", "") or (
        os.path.join(output_dir, "postmortem.json") if output_dir else None)
    recorder = None
    if postmortem and is_primary:
        from bert_pytorch_tpu_torch.telemetry.flightrec import FlightRecorder

        recorder = FlightRecorder(
            postmortem, process=process).install_exit_hooks()
        if logger is not None:
            # Log lines tee into the ring too (the runner initialized its
            # handlers before building telemetry, so append).
            logger.handlers.append(recorder.log_handler())
    introspect = None
    if getattr(args, "debug_port", 0) and is_primary:
        from bert_pytorch_tpu_torch.telemetry.introspect import \
            IntrospectionHub

        stale_after = getattr(args, "debug_stale_after_s", 0.0) or \
            getattr(args, "watchdog_timeout_s", 0.0) or 60.0
        introspect = IntrospectionHub(process=process,
                                      stale_after_s=stale_after)
    tele = TrainTelemetry(
        sink=sink,
        is_primary=is_primary,
        n_devices=n_devices,
        window=args.telemetry_window,
        sync_every=args.telemetry_sync_every,
        seq_per_step=seq_per_step,
        flops_per_seq=flops_per_seq,
        tokens_per_step=tokens_per_step,
        device_kind=device_kind(device),
        profile_steps=args.profile_steps,
        profile_dir=profile_dir,
        sentinel_policy=args.sentinel_policy,
        sentinel_patience=args.sentinel_patience,
        heartbeat_path=heartbeat,
        watchdog_timeout_s=getattr(args, "watchdog_timeout_s", 0.0),
        grad_spike_factor=args.grad_spike_factor,
        update_ratio_max=args.update_ratio_max,
        device=device,
        introspect=introspect,
        flight_recorder=recorder,
        cost_analysis=getattr(args, "telemetry_cost_analysis", "auto"))
    if introspect is not None:
        from bert_pytorch_tpu_torch.telemetry.introspect import \
            start_debug_server

        try:
            tele.debug_server = start_debug_server(
                introspect, port=int(args.debug_port))
        except OSError as exc:
            # Observability must never take the run down: a port already
            # held (a second runner on the host, a stale process) costs
            # the debug plane, not the training job.
            print(f"telemetry: debug plane DISABLED — could not bind port "
                  f"{args.debug_port}: {exc}", file=sys.stderr, flush=True)
        else:
            host, port = tele.debug_server.server_address[:2]
            print(f"telemetry: debug plane on http://{host}:{port} "
                  "(/healthz /statsz /metricsz /profilez)", file=sys.stderr,
                  flush=True)
    return tele
