"""Online inference server of the port — the serving entry point::

    python -m bert_pytorch_tpu_torch.run_server \
        --model_config_file configs/bert_large_uncased_config.json \
        --vocab_file vocab.txt --tasks fill_mask,classify \
        --buckets 128,512 --max_batch_size 8 --pack_requests --port 8000

    curl -s localhost:8000/v1/fill_mask -d '{"text": "paris is [MASK]"}'
    curl -s localhost:8000/healthz
    curl -s localhost:8000/statsz
    curl -s localhost:8000/metricsz   # Prometheus text format

It runs on the CUDA card unless ``--device cpu`` is given, and raises where
no card exists. Without weights (``build_service(args, weights=...)``, from
``models.convert.from_jax_params``) every task serves seeded
RANDOMLY-INITIALIZED weights (demo mode) and says so. The vocab is padded
to a multiple of 8 (30522 -> 30528), as the JAX package's server does.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import sys
from typing import Dict, Optional

import torch

logger = logging.getLogger("bert_pytorch_tpu_torch.run_server")

# A SIGTERM-initiated drain exits with this code, the preemption contract
# the JAX package's runners and supervisor share.
EXIT_PREEMPTED = 75


def parse_arguments(argv=None) -> argparse.Namespace:
    from bert_pytorch_tpu_torch.serve.cli import (add_device_args,
                                                  add_tracing_args)

    parser = argparse.ArgumentParser(description="BERT inference server "
                                     "(PyTorch / CUDA)")
    parser.add_argument("--model_config_file", type=str, required=True)
    parser.add_argument("--vocab_file", type=str, default=None)
    parser.add_argument("--tasks", type=str, default="fill_mask,classify",
                        help="comma-separated task heads to serve")
    parser.add_argument("--classify_labels", type=str, default="0,1",
                        help="comma-separated labels for classify")
    parser.add_argument("--buckets", type=str, default="32,64,128",
                        help="length buckets; each batch is padded to the "
                             "smallest bucket that fits it")
    parser.add_argument("--max_batch_size", type=int, default=8)
    parser.add_argument("--max_wait_ms", type=float, default=5.0,
                        help="micro-batch deadline: a partial batch "
                             "dispatches when its oldest request has "
                             "waited this long")
    add_device_args(parser)
    add_tracing_args(parser)
    parser.add_argument("--pack_requests", action="store_true",
                        help="pack several short requests per row with "
                             "block-diagonal attention")
    parser.add_argument("--max_requests_per_pack", type=int, default=4)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--request_timeout_s", type=float, default=30.0)
    args = parser.parse_args(argv)
    if args.vocab_file is None:
        with open(args.model_config_file) as f:
            args.vocab_file = json.load(f).get("vocab_file")
        if args.vocab_file is None:
            raise ValueError("vocab_file must be in model config or CLI")
    return args


def build_service(args: argparse.Namespace,
                  weights: Optional[Dict[str, Dict[str, torch.Tensor]]] = None):
    """The :class:`ServingService` for ``args``, warmed up lazily by
    ``start()``. ``weights`` maps task -> state dict (from
    ``from_jax_params``); tasks without one serve seeded random weights.
    The tokenizer lowercases unless the model config says
    ``"lowercase": false``."""
    from bert_pytorch_tpu_torch.config import BertConfig
    from bert_pytorch_tpu_torch.data.tokenization import BertTokenizer
    from bert_pytorch_tpu_torch.serve import (Batcher, InferenceEngine,
                                              ServeTelemetry, ServingService)
    from bert_pytorch_tpu_torch.serve.cli import DTYPES, build_tracer

    config = BertConfig.from_json_file(args.model_config_file)
    config.vocab_size = config.padded_vocab_size(8)
    tokenizer = BertTokenizer(args.vocab_file,
                              do_lower_case=getattr(config, "lowercase", True))
    weights = weights or {}
    tasks = {}
    for task in (t.strip() for t in args.tasks.split(",")):
        if not task:
            continue
        options = {"weights": weights.get(task)}
        if task == "classify":
            options["labels"] = args.classify_labels.split(",")
        tasks[task] = options
        if options["weights"] is None:
            logger.warning("task %s: no weights given — serving randomly "
                           "initialized weights (demo mode)", task)
    engine = InferenceEngine(
        config,
        tokenizer,
        tasks,
        buckets=[int(b) for b in args.buckets.split(",")],
        max_batch_size=args.max_batch_size,
        max_requests_per_pack=(args.max_requests_per_pack
                               if args.pack_requests else 1),
        dtype=DTYPES[args.dtype],
        attention_backend=args.attention_backend,
        device=args.device,
    )
    batcher = Batcher(
        max_batch_size=args.max_batch_size,
        max_wait_ms=args.max_wait_ms,
        max_requests_per_pack=engine.max_requests_per_pack)
    return ServingService(engine, batcher, ServeTelemetry(),
                          tracer=build_tracer(args))


def main(args: argparse.Namespace) -> int:
    """Serve until interrupted; returns the process exit code (0 after
    Ctrl-C, :data:`EXIT_PREEMPTED` after a SIGTERM drain)."""
    from bert_pytorch_tpu_torch.serve import make_server

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    service = build_service(args)
    engine = service.engine
    logger.info("warming %d task heads over buckets %s on %s (%s, "
                "attention=%s, pack=%d)", len(engine.tasks), engine.buckets,
                engine.device, args.dtype, engine.attention_backend,
                engine.max_requests_per_pack)
    engine.warmup()
    logger.info("warmup done in %ss", engine.startup["cold_start_s"])
    service.start()
    server = make_server(service, host=args.host, port=args.port,
                         request_timeout_s=args.request_timeout_s)
    host, port = server.server_address[:2]
    logger.info("serving %s on http://%s:%s (POST /v1/<task>, GET "
                "/healthz, /statsz, /metricsz)", sorted(engine.tasks),
                host, port)
    preempted = {"signaled": False}

    def shutdown(signum, frame):
        # Flip /healthz to 503 first, then unwind through the finally
        # below, which drains in-flight requests before stopping.
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
        server.shutdown()
        server.server_close()
        service.stop()
    return EXIT_PREEMPTED if preempted["signaled"] else 0


if __name__ == "__main__":
    sys.exit(main(parse_arguments()))
