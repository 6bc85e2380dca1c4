"""Online inference server of the port — the serving entry point::

    python -m bert_pytorch_tpu_torch.run_server \
        --model_config_file configs/bert_large_uncased_config.json \
        --vocab_file vocab.txt --tasks fill_mask,classify,squad,ner \
        --fill_mask_checkpoint out/ --squad_checkpoint squad/ckpt_0.msgpack \
        --buckets 128,512 --max_batch_size 8 --pack_requests --port 8000

    # the fast path: int8 weights, int8-score attention, fused fill_mask
    python -m bert_pytorch_tpu_torch.run_server ... --quantize int8 \
        --attention_backend flash_infer_int8 --fuse_epilogues

    # measure the attention kernels' tile geometry once, then reuse it
    python -m bert_pytorch_tpu_torch.run_server ... --compile_cache_dir D \
        --autotune measure --autotune_cache D/autotune.json
    python -m bert_pytorch_tpu_torch.run_server ... --compile_cache_dir D \
        --autotune load --autotune_cache D/autotune.json

    curl -s localhost:8000/v1/fill_mask -d '{"text": "paris is [MASK]"}'
    curl -s localhost:8000/v1/squad \
        -d '{"question": "who wrote hamlet", "context": "shakespeare wrote hamlet"}'
    curl -s localhost:8000/v1/ner -d '{"text": "paris is in france"}'
    curl -s localhost:8000/swapz \
        -d '{"task": "classify", "checkpoint": "ckpt_9.msgpack", "version": "v2"}'
    curl -s localhost:8000/healthz
    curl -s localhost:8000/statsz
    curl -s localhost:8000/metricsz   # Prometheus text format
    curl -s -X POST localhost:8000/profilez -d '{"duration_s": 2}'

It runs on the CUDA card unless ``--device cpu`` is given, and raises where
no card exists. Each ``--<task>_checkpoint`` names a JAX package
checkpoint (a ``ckpt_*.msgpack`` file, or a directory whose newest one is
taken) whose ``model`` subtree is that head's params, read params-only;
a failed load fails the start-up. A task with neither a checkpoint nor
in-memory weights (``build_service(args, weights=...)``, from
``models.convert.from_jax_params``) serves seeded RANDOMLY-INITIALIZED
weights (demo mode) and says so. ``--save_init_checkpoint DIR`` writes the
first task's served params there as ``ckpt_0.msgpack`` (with its
manifest) before serving. The vocab is padded to a multiple of 8
(30522 -> 30528), as the JAX package's server does.

With ``--output_dir`` the replica keeps the JAX server's debug planes
there: the serve telemetry JSONL (``serve_window``/``serve_summary``/
``serve_cold_start``/``compile`` records, schema v1; ``--telemetry_jsonl``
names another path), the heartbeat the dispatch plane beats
(``heartbeat.json``, or ``--heartbeat_file``), the crash flight recorder
(``postmortem.json``, or ``--postmortem_file``: written on a fault, a
crash and periodically, removed by a clean exit, kept by a SIGTERM
drain), and ``POST /profilez`` captures (a host-thread sample and a
``torch.profiler`` trace of the card under ``<output_dir>/profile``;
without an output dir a capture is sampler-only). A SIGTERM drains the
replica, emits the preemption ``fault`` record and exits 75.

The tokenizer is the JAX server's rule: ``--tokenizer`` (default: the
model config's ``"tokenizer"``, else ``wordpiece``; ``bpe`` for a
byte-level BPE ``vocab.json`` with its ``merges.txt`` beside it, as the
RoBERTa config names), on the C++ core, lower-cased unless
``--uppercase`` (the config's ``"lowercase"`` is not read, as the JAX
server does not read it). Missing tokenizer files are refused by name at
argument parsing, before anything loads.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
from typing import Dict, Optional

import torch

logger = logging.getLogger("bert_pytorch_tpu_torch.run_server")

# A SIGTERM-initiated drain exits with this code, the preemption contract
# the JAX package's runners and supervisor share.
EXIT_PREEMPTED = 75
TASKS = ("fill_mask", "classify", "squad", "ner")


def parse_arguments(argv=None) -> argparse.Namespace:
    from bert_pytorch_tpu_torch.ops.kernels import build
    from bert_pytorch_tpu_torch.serve.cli import (add_device_args,
                                                  add_dispatch_args,
                                                  add_fast_path_args,
                                                  add_tracing_args)

    parser = argparse.ArgumentParser(description="BERT inference server "
                                     "(PyTorch / CUDA)")
    parser.add_argument("--model_config_file", type=str, required=True)
    parser.add_argument("--vocab_file", type=str, default=None)
    parser.add_argument("--tokenizer", type=str, default=None,
                        choices=["wordpiece", "bpe"],
                        help="default: the model config's \"tokenizer\"; "
                             "only wordpiece is ported")
    parser.add_argument("--uppercase", action="store_true",
                        help="keep case (the tokenizer lower-cases "
                             "without it)")
    parser.add_argument("--tasks", type=str,
                        default="fill_mask,classify,squad,ner",
                        help="comma-separated task heads to serve")
    for task in TASKS:
        parser.add_argument(f"--{task}_checkpoint", type=str, default=None,
                            help=f"params checkpoint for the {task} head "
                                 "(file or run output dir); omitted = "
                                 "random init (demo mode)")
    parser.add_argument("--classify_labels", type=str, default="0,1",
                        help="comma-separated labels for classify")
    parser.add_argument("--ner_labels", type=str,
                        default="O,B-PER,I-PER,B-LOC,I-LOC,B-ORG,I-ORG,"
                                "B-MISC,I-MISC",
                        help="comma-separated NER tag set (ids 1-based)")
    parser.add_argument("--serving_version", type=str, default="v0",
                        help="version name of the weights served (what "
                             "/healthz and /statsz report until a "
                             "/swapz changes it)")
    parser.add_argument("--save_init_checkpoint", type=str, default="",
                        help="write the first task's served params as "
                             "ckpt_0.msgpack (+ manifest) into this "
                             "directory before serving")
    parser.add_argument("--buckets", type=str, default="32,64,128",
                        help="length buckets; each batch is padded to the "
                             "smallest bucket that fits it")
    parser.add_argument("--max_batch_size", type=int, default=8)
    parser.add_argument("--max_wait_ms", type=float, default=5.0,
                        help="micro-batch deadline: a partial batch "
                             "dispatches when its oldest request has "
                             "waited this long")
    add_device_args(parser)
    add_dispatch_args(parser)
    add_fast_path_args(parser)
    add_tracing_args(parser)
    parser.add_argument("--pack_requests", action="store_true",
                        help="pack several short requests per row with "
                             "block-diagonal attention")
    parser.add_argument("--max_requests_per_pack", type=int, default=4)
    parser.add_argument("--max_pending", type=int, default=1024,
                        help="pending-queue cap; submissions beyond it "
                             "shed with HTTP 503 instead of growing "
                             "memory/latency without bound")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--request_timeout_s", type=float, default=30.0)
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights of heads served "
                             "without a checkpoint")
    parser.add_argument("--output_dir", type=str, default=None,
                        help="telemetry/heartbeat/postmortem/profile "
                             "anchor dir")
    parser.add_argument("--telemetry_jsonl", type=str, default="",
                        help="serve telemetry JSONL sink; default "
                             "<output_dir>/serve_telemetry.jsonl")
    parser.add_argument("--heartbeat_file", type=str, default="",
                        help="liveness file the dispatch plane maintains "
                             "(telemetry/sentinels.py Heartbeat, the file "
                             "the training runners write); default "
                             "<output_dir>/heartbeat.json, disabled "
                             "without an output_dir")
    parser.add_argument("--telemetry_window", type=int, default=64,
                        help="requests per serve_window record")
    parser.add_argument("--postmortem_file", type=str, default="",
                        help="crash flight recorder flush target "
                             "(telemetry/flightrec.py): the bounded ring "
                             "of this replica's last telemetry records + "
                             "log lines, written atomically on fault/"
                             "crash and periodically (so a SIGKILLed "
                             "replica leaves forensics); default "
                             "<output_dir>/postmortem.json, disabled "
                             "without an output_dir")
    build.add_cli_args(parser)
    args = parser.parse_args(argv)
    from bert_pytorch_tpu_torch.data.tokenization import \
        check_tokenizer_files

    with open(args.model_config_file) as f:
        configs = json.load(f)
    if args.vocab_file is None:
        args.vocab_file = configs.get("vocab_file")
        if args.vocab_file is None:
            raise ValueError("vocab_file must be in model config or CLI")
    if args.tokenizer is None:
        args.tokenizer = configs.get("tokenizer", "wordpiece")
    check_tokenizer_files(args.tokenizer, args.vocab_file)
    return args


def resolve_ckpt(path: Optional[str]) -> Optional[str]:
    """A ``--<task>_checkpoint`` value as a file: a directory gives its
    newest ``ckpt_*.msgpack`` (``FileNotFoundError`` if it holds none)."""
    from bert_pytorch_tpu_torch.utils import checkpoint as ckpt_util

    if not path:
        return None
    if os.path.isdir(path):
        found = ckpt_util.latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"no ckpt_*.msgpack under {path}")
        return found
    return path


def build_service(args: argparse.Namespace,
                  weights: Optional[Dict[str, Dict[str, torch.Tensor]]] = None):
    """The :class:`ServingService` for ``args``, warmed up lazily by
    ``start()``, wired as the JAX server's ``build_service`` wires it:
    the JSONL sink teed into the flight recorder, serve telemetry and the
    request tracer emitting through it, the heartbeat, the ``/profilez``
    capture controller and the compile monitor. Each task loads its
    ``--<task>_checkpoint``; ``weights`` maps task -> state dict (from
    ``from_jax_params``) for tasks without one; the rest serve seeded
    random weights. ``--compile_cache_dir`` names the directory the kernel
    libraries are built into and found in (``ops/kernels/build.py``
    ``set_build_dir``). The tokenizer lowercases unless ``--uppercase``, as
    the JAX server's. The service carries ``telemetry_sink`` (the JSONL
    handler or None), ``flight_recorder`` (or None) and
    ``compile_monitor``; :func:`close_planes` closes the first two."""
    from bert_pytorch_tpu_torch.config import BertConfig
    from bert_pytorch_tpu_torch.data.tokenization import get_tokenizer
    from bert_pytorch_tpu_torch.ops.kernels import build
    from bert_pytorch_tpu_torch.serve import (Batcher, InferenceEngine,
                                              ServeTelemetry, ServingService)
    from bert_pytorch_tpu_torch.serve.cli import DTYPES, build_tracer
    from bert_pytorch_tpu_torch.telemetry.compile_events import \
        CompileMonitor
    from bert_pytorch_tpu_torch.telemetry.flightrec import FlightRecorder
    from bert_pytorch_tpu_torch.telemetry.profiler import ProfilerWindow
    from bert_pytorch_tpu_torch.telemetry.sampler import CaptureController
    from bert_pytorch_tpu_torch.telemetry.sentinels import Heartbeat
    from bert_pytorch_tpu_torch.utils.logging import JSONLHandler

    # The kernel libraries' directory: --compile_cache_dir, else the
    # package's build/ (set on every call, so a service built in the same
    # process after another never inherits its directory).
    build.set_build_dir(getattr(args, "compile_cache_dir", "") or None)
    config = BertConfig.from_json_file(args.model_config_file)
    config.vocab_size = config.padded_vocab_size(8)
    lowercase = not args.uppercase
    tokenizer = get_tokenizer(args.tokenizer, args.vocab_file,
                              uppercase=not lowercase)
    weights = weights or {}
    tasks = {}
    for task in (t.strip() for t in args.tasks.split(",")):
        if not task:
            continue
        options = {"checkpoint": resolve_ckpt(
            getattr(args, f"{task}_checkpoint", None))}
        if options["checkpoint"] is None:
            options["weights"] = weights.get(task)
        if task == "classify":
            options["labels"] = args.classify_labels.split(",")
        elif task == "ner":
            options["labels"] = args.ner_labels.split(",")
        elif task == "squad":
            options["do_lower_case"] = lowercase
        tasks[task] = options
        if options["checkpoint"] is None and options.get("weights") is None:
            logger.warning("task %s: no checkpoint and no weights given — "
                           "serving randomly initialized weights (demo "
                           "mode)", task)

    def under_output(name: str) -> Optional[str]:
        return os.path.join(args.output_dir, name) if args.output_dir \
            else None

    telemetry_jsonl = args.telemetry_jsonl or under_output(
        "serve_telemetry.jsonl")
    sink = JSONLHandler(telemetry_jsonl) if telemetry_jsonl else None
    # Crash flight recorder: every telemetry record tees into a bounded
    # ring, flushed to postmortem.json on fault/crash and periodically.
    postmortem = args.postmortem_file or under_output("postmortem.json")
    recorder = (FlightRecorder(postmortem, process="serve")
                .install_exit_hooks() if postmortem else None)
    emit = sink.write_record if sink else None
    if recorder is not None:
        emit = recorder.tee(emit)
    monitor = CompileMonitor(emit=emit)
    engine = InferenceEngine(
        config,
        tokenizer,
        tasks,
        buckets=[int(b) for b in args.buckets.split(",")],
        max_batch_size=args.max_batch_size,
        max_requests_per_pack=(args.max_requests_per_pack
                               if args.pack_requests else 1),
        dtype=DTYPES[args.dtype],
        seed=args.seed,
        attention_backend=args.attention_backend,
        device=args.device,
        quantize=args.quantize,
        fuse_epilogues=args.fuse_epilogues,
        epilogue_slots=args.epilogue_slots,
        version=args.serving_version,
        monitor=monitor,
        autotune=args.autotune,
        autotune_cache=args.autotune_cache or None,
    )
    batcher = Batcher(
        max_batch_size=args.max_batch_size,
        max_wait_ms=args.max_wait_ms,
        max_requests_per_pack=engine.max_requests_per_pack,
        max_pending=args.max_pending)
    heartbeat_path = args.heartbeat_file or under_output("heartbeat.json")
    heartbeat = Heartbeat(heartbeat_path) if heartbeat_path else None
    telemetry = ServeTelemetry(emit=emit, window=args.telemetry_window)

    def hold(seconds: float) -> None:
        # A trace's collection holds the interpreter for seconds: the
        # beat tells the fleet watchdog how long to wait.
        heartbeat.beat(telemetry.request_count(), hold_s=seconds)

    # On-demand profiling plane: POST /profilez arms a bounded host-sampler
    # + torch.profiler capture; the dispatch plane ticks it per boundary
    # with position = requests served. The ProfilerWindow has no startup
    # spec: it exists for the on-demand begin/end alone.
    profile_dir = under_output("profile")
    capture = CaptureController(
        source="replica", covered_unit="requests",
        window=(ProfilerWindow(None, profile_dir, device=engine.device)
                if profile_dir else None),
        trace_dir=profile_dir, emit=emit,
        hold=hold if heartbeat is not None else None)
    service = ServingService(
        engine, batcher, telemetry,
        tracer=build_tracer(args, emit=emit, window=args.telemetry_window),
        heartbeat=heartbeat, capture=capture,
        dispatch_mode=args.dispatch_mode)
    service.telemetry_sink = sink
    service.flight_recorder = recorder
    service.compile_monitor = monitor
    return service


def close_planes(service, exc: Optional[BaseException] = None) -> None:
    """Close what :func:`build_service` opened beside the service: the
    JSONL sink, then the flight recorder — flushed with ``exc``'s
    traceback when an exception ends the replica, else closed clean
    (which removes the postmortem unless an incident, such as the
    preemption ``fault`` record, was flushed during the run)."""
    if service.telemetry_sink is not None:
        service.telemetry_sink.close()
    recorder = service.flight_recorder
    if recorder is not None:
        if exc is not None and not isinstance(exc, KeyboardInterrupt):
            recorder.flush("crash", exc=exc)
        else:
            recorder.close(clean=True)


class _RingLogHandler(logging.Handler):
    """Tees the replica's ``logging`` lines into the flight recorder's
    ring (through its ``utils/logging`` handler)."""

    def __init__(self, recorder):
        super().__init__()
        self._handler = recorder.log_handler()
        self.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(message)s"))

    def emit(self, record: logging.LogRecord) -> None:
        self._handler.write_message(self.format(record))


def save_init_checkpoint(engine, output_dir: str) -> str:
    """Write the first (sorted) task's served params into ``output_dir``
    as ``ckpt_0.msgpack`` ``{"model": <JAX-layout params>, "epoch": 0}``
    plus its manifest, as the JAX server's ``--save_init_checkpoint``
    does; returns the path. A quantized engine writes its quantized
    params."""
    from bert_pytorch_tpu_torch.models.convert import to_jax_params
    from bert_pytorch_tpu_torch.utils import checkpoint as ckpt_util

    task = sorted(engine.tasks)[0]
    params = to_jax_params(engine.tasks[task].model.state_dict(),
                           engine.config, task)
    path = ckpt_util.save_checkpoint(output_dir, 0,
                                     {"model": params, "epoch": 0})
    logger.info("init checkpoint for task %s: %s", task, path)
    return path


def main(args: argparse.Namespace) -> int:
    """Serve until interrupted; returns the process exit code: 0 after
    Ctrl-C, :data:`EXIT_PREEMPTED` after a SIGTERM drain (every accepted
    request answered, the preemption ``fault`` record emitted through the
    flight recorder's tee, so the postmortem stays on disk)."""
    from bert_pytorch_tpu_torch.serve import make_server

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    service = build_service(args)
    engine = service.engine
    # The process's compile monitor: builds at any point of its life
    # become compile records (the warmup's count as start-up's).
    service.compile_monitor.install()
    ring_log = None
    if service.flight_recorder is not None:
        # Log lines tee into the ring too: a postmortem carries the
        # replica's last words, not just its last records.
        ring_log = _RingLogHandler(service.flight_recorder)
        logging.getLogger().addHandler(ring_log)
    preempted = {"signaled": False}
    server = None
    try:
        if args.save_init_checkpoint:
            save_init_checkpoint(engine, args.save_init_checkpoint)
        logger.info("warming %d task heads over buckets %s on %s (%s, "
                    "attention=%s, quantize=%s, fuse_epilogues=%s, pack=%d)",
                    len(engine.tasks), engine.buckets, engine.device,
                    args.dtype, engine.attention_backend, args.quantize,
                    engine.fuse_epilogues, engine.max_requests_per_pack)
        for record in engine.autotune_records:
            logger.info("autotune %s s=%d bh=%d: %s %s", record["kernel"],
                        record["seq"], record["bh"], record["source"],
                        record.get("winner", "default (64, 64, 1)"))
        engine.warmup()
        startup = engine.startup
        logger.info("warmup done in %ss: %s cold kernel builds / %s "
                    "already built; weight bytes %d",
                    startup["cold_start_s"], startup["compiles_cold"],
                    startup["compiles_warm"], startup["weight_bytes"])
        service.start()
        server = make_server(service, host=args.host, port=args.port,
                             request_timeout_s=args.request_timeout_s)
        host, port = server.server_address[:2]
        logger.info("serving %s (version %s) on http://%s:%s (POST "
                    "/v1/<task>, /swapz, /profilez; GET /healthz, /statsz, "
                    "/metricsz) — dispatch %s", sorted(engine.tasks),
                    engine.version(), host, port, service.dispatch_mode)

        def shutdown(signum, frame):
            # Flip /healthz to 503 first, then unwind through the finally
            # below, which drains in-flight requests before stopping. Only
            # a SIGTERM-initiated drain is a preemption (Ctrl-C stays 0).
            preempted["signaled"] = True
            service.begin_drain()
            raise KeyboardInterrupt

        signal.signal(signal.SIGTERM, shutdown)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
    finally:
        logger.info("draining: rejecting new requests, flushing in-flight "
                    "batches, then shutting down")
        if preempted["signaled"] and service.telemetry.emit is not None:
            # The training runners' preemption fault record, serve flavor
            # (step = requests served at the signal), through the teed
            # path so the flight recorder flushes its postmortem with it.
            service.telemetry.emit({
                "kind": "fault", "tag": "serve", "fault": "preemption",
                "signal": "SIGTERM", "injected": False,
                "step": service.telemetry.request_count(),
            })
        if server is not None:
            server.shutdown()
            server.server_close()
        service.stop()  # drain + dispatch-thread join + telemetry summary
        service.compile_monitor.uninstall()
        if ring_log is not None:
            logging.getLogger().removeHandler(ring_log)
        close_planes(service, sys.exc_info()[1])
    return EXIT_PREEMPTED if preempted["signaled"] else 0


if __name__ == "__main__":
    sys.exit(main(parse_arguments()))
