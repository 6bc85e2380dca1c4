"""Offline batch inference: file-in / file-out scoring through the same
engine the online server runs (the port of the JAX package's
``tools/batch_infer.py``).

Input is a JSONL request file::

    {"id": 0, "task": "fill_mask", "payload": {"text": "... [MASK] ..."}}

(``arrival_s`` and other keys are ignored). Output is one JSONL line per
request: ``{"id", "task", "result"}`` (or ``"error"``), in input order.
Consecutive requests of one task are grouped and run through the SAME
bucketed, optionally packed batched path as the server (serve/engine.py
``plan_batch``/``execute``), so offline results equal served ones. The
engine flags are ``run_server``'s (serve/cli.py: ``--attention_backend``,
``--quantize``, ``--fuse_epilogues``, the tasks and their checkpoints,
``--tokenizer``), and so is its default device, ``cuda``.

::

    python -m bert_pytorch_tpu_torch.tools.batch_infer \\
        --model_config_file configs/roberta_large_cased_config.json \\
        --vocab_file vocab/vocab.json --tasks fill_mask,classify \\
        --fill_mask_checkpoint ckpts/ --input requests.jsonl \\
        --output scored.jsonl

The last line on standard error is ``{"batch_infer": {"requests",
"errors", "wall_s", "forwards", "quantize"[, "cold_start_s"]}}``
(``forwards``: the engine's forwards, its warmup's included).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def run_offline(service, lines, out_stream) -> dict:
    """Score decoded request dicts through the service's engine, writing
    one result line each to ``out_stream`` in input order; returns
    ``{"requests", "errors"}``. The service's batcher and dispatch thread
    are not used: the engine runs each group of consecutive same-task
    requests directly, in submission order."""
    from bert_pytorch_tpu_torch.serve.batcher import Request

    engine = service.engine
    results = {}
    errors = 0
    pending: list = []

    def failed(idx, line, task, message: str) -> None:
        nonlocal errors
        results[idx] = {"id": line.get("id", idx), "task": task,
                        "error": message}
        errors += 1

    def flush() -> None:
        group, pending[:] = list(pending), []
        if not group:
            return
        task = group[0][1]["task"]
        spec = engine.tasks[task]
        line_of = {}
        todo = []
        for idx, line in group:
            payload = line.get("payload", {})
            try:
                features = spec.handler.prepare(payload, engine.max_len())
            except Exception as exc:
                failed(idx, line, task, f"{type(exc).__name__}: {exc}")
                continue
            req = Request(task, features, payload)
            line_of[req.id] = (idx, line)
            todo.append(req)
        while todo:
            plan = engine.plan_batch(todo)
            outputs, _ = engine.execute(task, plan)
            for req, out in zip(plan.requests, outputs):
                idx, line = line_of[req.id]
                try:
                    results[idx] = {
                        "id": line.get("id", idx), "task": task,
                        "result": spec.handler.postprocess(
                            req.features, out, req.payload)}
                except Exception as exc:
                    failed(idx, line, task, f"{type(exc).__name__}: {exc}")
            done = {r.id for r in plan.requests}
            todo = [r for r in todo if r.id not in done]

    for idx, line in enumerate(lines):
        task = line.get("task")
        if task not in engine.tasks:
            failed(idx, line, task, f"unknown task {task!r}")
            continue
        if pending and pending[-1][1]["task"] != task:
            flush()
        pending.append((idx, line))
    flush()

    for idx in sorted(results):
        out_stream.write(json.dumps(results[idx]) + "\n")
    return {"requests": len(results), "errors": errors}


def split_argv(argv) -> tuple:
    """(``--input``, ``--output``, the rest: ``run_server``'s flags)."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                     allow_abbrev=False)
    parser.add_argument("--input", required=True,
                        help="JSONL request file ({task, payload} lines)")
    parser.add_argument("--output", required=True,
                        help="JSONL results file (- for standard output)")
    own, engine_argv = parser.parse_known_args(argv)
    return own.input, own.output, engine_argv


def main(argv=None) -> dict:
    """Score ``--input`` into ``--output`` through a service built from
    the rest of ``argv`` (``run_server.build_service``); returns the
    summary."""
    from bert_pytorch_tpu_torch import run_server

    src, dst, engine_argv = split_argv(
        sys.argv[1:] if argv is None else argv)
    args = run_server.parse_arguments(engine_argv)
    service = run_server.build_service(args)
    with open(src, "r", encoding="utf-8") as f:
        lines = [json.loads(line) for line in f if line.strip()]
    exc = None
    try:
        service.engine.warmup()
        t0 = time.perf_counter()
        out = (sys.stdout if dst == "-"
               else open(dst, "w", encoding="utf-8"))
        try:
            stats = run_offline(service, lines, out)
        finally:
            if out is not sys.stdout:
                out.close()
        stats["wall_s"] = round(time.perf_counter() - t0, 3)
        stats["forwards"] = service.engine.forwards
    except BaseException as err:
        exc = err
        raise
    finally:
        # A clean run leaves no postmortem; a crash keeps its traceback.
        run_server.close_planes(service, exc)
    startup = service.engine.startup or {}
    stats["quantize"] = startup.get("quantize", args.quantize)
    if startup.get("cold_start_s") is not None:
        stats["cold_start_s"] = startup["cold_start_s"]
    print(json.dumps({"batch_infer": stats}), file=sys.stderr)
    return stats


if __name__ == "__main__":
    main()
