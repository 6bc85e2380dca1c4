#!/usr/bin/env python
"""Fleet observatory collector CLI (docs/observability.md): the port's
counterpart of the repo-root ``tools/obs_collect.py``, over the port's
``telemetry/collector.py``.

Scrapes every registered endpoint — trainer debug planes
(``--debug_port``, telemetry/introspect.py), serving replicas'
``/metricsz``, the router's ``/statsz`` — and tails their JSONL sinks,
merging everything into ONE ordered fleet-timeline JSONL with schema-v1
``obs_scrape`` (per-target sample + staleness) and ``obs_fleet_window``
(healthy/total counts, fleet req/s, worst-replica p99, trainer step
rate, error-budget burn) records. ``telemetry-report`` summarizes the
timeline and gates on "fleet scrape staleness" and "fleet worst-replica
p99" by name.

Usage::

    python bert_pytorch_tpu_torch/tools/obs_collect.py \
        --target trainer:pretrain=http://127.0.0.1:9100 \
        --target replica:r0=http://127.0.0.1:8001 \
        --target router:front=http://127.0.0.1:8100 \
        --tail trainer=out/pretrain_telemetry.jsonl \
        --tail fleet=out/fleet_telemetry.jsonl \
        --out fleet_timeline.jsonl --interval_s 1 --duration_s 60

``--target`` is ``kind:name=url`` with kind in trainer/replica/router;
``--tail`` is ``name=path``. Scrape targets named with ``--target`` are
static; under an elastic fleet (serve/autoscaler.py) add
``--fleet fleet=out/fleet_telemetry.jsonl`` and membership follows the
supervisor's own event stream instead — replicas spawned mid-run join
the scrape set, drained ones leave it rather than counting as stale
scrape failures forever. Bounded by ``--duration_s`` or
``--passes`` (whichever lands first; Ctrl-C stops cleanly either way).
``--trace <id>`` skips collecting entirely and prints the stitched
span tree of one trace id out of an existing timeline (``--out`` names
the file to read): the router's admission/attempt/backoff spans, each
attempt's replica phases nested under it, and the stitch verdict.
``--profile`` fires ONE coordinated fleet-wide capture before the pass
loop: ``POST /profilez`` to every trainer/replica target concurrently
(the windows align on the same wall-clock slice), one trigger
``obs_scrape`` record per target in the timeline; the resulting
``profile_window`` records arrive through the tailed sinks
(docs/observability.md "Profiling plane").
The output is schema-linted by default at exit (exit 1 on violations) —
the collector's own artifact is held to the same bar as everything it
collects; ``--no-lint`` skips that.

torch-free like every fleet tool here: the collector engine loads by
FILE PATH (tools/_bootstrap.py), so this process keeps collecting even
while the CUDA processes it watches are hung.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__:
    from bert_pytorch_tpu_torch.tools._bootstrap import (REPO_ROOT,
                                                         load_by_path)
else:
    from _bootstrap import REPO_ROOT, load_by_path

collector_mod = load_by_path(
    "_torchobs_collector", "telemetry", "collector.py")
schema = load_by_path("_torchobs_schema", "telemetry", "schema.py")


def parse_target(spec: str):
    kind, sep, rest = spec.partition(":")
    name, sep2, url = rest.partition("=")
    if not sep or not sep2 or not name or not url:
        raise argparse.ArgumentTypeError(
            f"--target wants kind:name=url, got {spec!r}")
    if kind not in schema.OBS_TARGET_KINDS:
        raise argparse.ArgumentTypeError(
            f"target kind must be one of {schema.OBS_TARGET_KINDS}, "
            f"got {kind!r}")
    return kind, name, url


def parse_tail(spec: str):
    name, sep, path = spec.partition("=")
    if not sep or not name or not path:
        raise argparse.ArgumentTypeError(
            f"--tail wants name=path, got {spec!r}")
    return name, path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="obs-collect",
        description="scrape the fleet's endpoints + tail its JSONL "
                    "sinks into one ordered timeline "
                    "(docs/observability.md)")
    parser.add_argument("--target", action="append", default=[],
                        type=parse_target, metavar="KIND:NAME=URL",
                        help="scrape target (trainer/replica/router); "
                             "repeatable")
    parser.add_argument("--tail", action="append", default=[],
                        type=parse_tail, metavar="NAME=PATH",
                        help="JSONL sink to tail into the timeline; "
                             "repeatable")
    parser.add_argument("--fleet", type=parse_tail, default=None,
                        metavar="NAME=PATH",
                        help="supervisor fleet-telemetry JSONL to read "
                             "fleet MEMBERSHIP from: replicas the "
                             "autoscaler spawns mid-run join the scrape "
                             "set as NAME-<index> targets, drained or "
                             "gave-up replicas leave it (instead of "
                             "counting as stale scrape failures "
                             "forever)")
    parser.add_argument("--fleet_host", type=str, default="127.0.0.1",
                        help="host the replicas announced by --fleet "
                             "events are scraped at")
    parser.add_argument("--out", type=str, default="fleet_timeline.jsonl",
                        help="timeline output JSONL (appended)")
    parser.add_argument("--interval_s", type=float, default=1.0,
                        help="seconds between collector passes")
    parser.add_argument("--duration_s", type=float, default=0.0,
                        help="stop after this much wall time "
                             "(0 = unbounded; Ctrl-C always stops "
                             "cleanly)")
    parser.add_argument("--passes", type=int, default=0,
                        help="stop after this many passes (0 = unbounded)")
    parser.add_argument("--scrape_timeout_s", type=float, default=2.0,
                        help="per-target scrape transport timeout")
    parser.add_argument("--slo_error_budget", type=float, default=0.01,
                        help="over-SLO fraction allowed before the "
                             "fleet error-budget burn exceeds 1")
    parser.add_argument("--no-lint", action="store_true",
                        help="skip schema-linting the timeline at exit")
    parser.add_argument("--profile", action="store_true",
                        help="fire one coordinated fleet-wide capture "
                             "(POST /profilez to every trainer/replica "
                             "target) before the pass loop; keep "
                             "collecting past the capture duration so "
                             "the profile_window records reach the "
                             "timeline through the tailed sinks")
    parser.add_argument("--profile_duration_s", type=float, default=2.0,
                        help="bounded capture window per target for "
                             "--profile")
    parser.add_argument("--trace", type=str, default=None,
                        metavar="TRACE_ID",
                        help="print the stitched span tree of one trace "
                             "id from the existing --out timeline and "
                             "exit (no collecting)")
    args = parser.parse_args(argv)

    if args.trace:
        # Read-only mode: render one stitched trace out of an already
        # collected timeline (the chaos harness / operator drill-down).
        if not os.path.exists(args.out):
            print(f"obs-collect: {args.out}: no such timeline",
                  file=sys.stderr)
            return 2
        records = []
        with open(args.out, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    records.append(rec)
        tree = collector_mod.stitch_tree(records, args.trace)
        print(tree)
        return 0 if "not found" not in tree.splitlines()[0] else 1

    if not args.target and not args.tail and not args.fleet:
        parser.error("need at least one --target, --tail, or --fleet")
    targets = [collector_mod.Target(name, kind, url,
                                    timeout_s=args.scrape_timeout_s)
               for kind, name, url in args.target]
    tails = [collector_mod.JsonlTailer(path, name)
             for name, path in args.tail]
    coll = collector_mod.FleetCollector(
        targets, tails=tails, out_path=args.out,
        interval_s=args.interval_s,
        slo_error_budget=args.slo_error_budget)
    membership = None
    if args.fleet:
        # Membership rides the supervisor's OWN event stream (spawn /
        # drain_complete / gave_up) on a dedicated tailer — independent
        # offset from any --tail of the same file, which keeps tailing
        # those records into the timeline too.
        fleet_name, fleet_path = args.fleet
        membership = collector_mod.FleetMembership(
            coll, collector_mod.JsonlTailer(fleet_path, fleet_name),
            host=args.fleet_host, prefix=fleet_name,
            timeout_s=args.scrape_timeout_s)
    deadline = (time.monotonic() + args.duration_s
                if args.duration_s > 0 else None)
    if args.profile:
        triggers = coll.trigger_profile(
            duration_s=args.profile_duration_s)
        armed = sum(1 for t in triggers if t["ok"])
        print(f"profile: armed {armed}/{len(triggers)} targets "
              f"({args.profile_duration_s:g}s window)")
        for t in triggers:
            if not t["ok"]:
                print(f"profile: {t['target']}: "
                      f"{t.get('error', 'unreachable')}", file=sys.stderr)
    done = 0
    try:
        while True:
            if membership is not None:
                delta = membership.sync()
                for name in delta["joined"]:
                    print(f"fleet: {name} joined the scrape set")
                for name in delta["left"]:
                    print(f"fleet: {name} left the scrape set")
            window = coll.collect_once()
            done += 1
            if window is not None:
                print(f"pass {done}: healthy "
                      f"{window['targets_healthy']}/"
                      f"{window['targets_total']}, max staleness "
                      f"{window['max_staleness_s']:.1f}s")
            if args.passes and done >= args.passes:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(args.interval_s)
    except KeyboardInterrupt:
        pass
    finally:
        # close(), not stop(): this loop already ran its final pass —
        # stop()'s drain pass (background-thread mode) would append an
        # uncounted extra round, blocking on any dead target again.
        coll.close()
    if args.no_lint:
        return 0
    # The collector's own artifact is held to the schema bar by default
    # (the check_all/check_telemetry_schema contract): a timeline that
    # fails its own lint must not exit 0.
    errors = schema.validate_file(args.out)
    rel = os.path.relpath(args.out, REPO_ROOT) \
        if args.out.startswith(REPO_ROOT) else args.out
    if errors:
        for lineno, err in errors[:20]:
            print(f"{rel}:{lineno}: {err}", file=sys.stderr)
        print(f"obs-collect: timeline FAILED schema lint "
              f"({len(errors)} errors)", file=sys.stderr)
        return 1
    print(f"obs-collect: {rel}: ok ({done} passes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
