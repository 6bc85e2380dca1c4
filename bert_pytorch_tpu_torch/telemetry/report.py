"""Offline telemetry reporting: human summary + baseline-diff regression
verdict over the JSONL artifacts the telemetry layer writes — a copy of
the JAX package's ``telemetry/report.py``, gate for gate
(``tests/test_torch_fleet.py`` holds the two to the same ``--format
json`` verdicts on the same artifacts).

``summarize_file`` folds one artifact's records (``step_window``,
``compile``, ``sentinel``, ``grad_health``, ``divergence``, ``memory``,
``serve_*`` — including the request-tracing ``serve_phase``/
``serve_trace`` decomposition and its SLO verdict — the cross-tier
``router_trace``/``trace_stitch`` records with their per-tier latency
shares and the "router overhead share" / "orphan span share" gates, and
``run_summary``) into a flat summary; ``compare`` diffs two summaries
against relative tolerances and returns named regressions. The CLI
(``bert_pytorch_tpu_torch/tools/telemetry_report.py``) prints
the summary — and, given a baseline, the diff table — and exits nonzero
when any regression trips, which is what lets bench/CI gate on "did this
change make training slower, hungrier, or less healthy" instead of
eyeballing JSON.

Aggregation note: window records carry per-window percentiles, not raw
per-step samples, so the file-level ``step_p50_s`` is the
window-steps-weighted median of window p50s (robust to a cold-compile
first window) and ``step_p95_s`` is the max of window p95s (a tail
regression anywhere in the run must not average away). Throughput is the
harmonic aggregate — total steps over total window wall time.

This module imports stdlib only. The port's shim
(``bert_pytorch_tpu_torch/tools/telemetry_report.py``) loads it by file
path — bypassing the ``telemetry`` package ``__init__`` chain, which
imports torch — so the tool runs on any machine, and the fleet's parent
process never imports torch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

# Relative tolerances (fraction of the baseline value) per check; chosen
# so real regressions (a +25% step time, say) trip
# clearly while window-to-window noise on a busy host does not.
DEFAULT_TOLERANCES = {
    "step": 0.10,    # step-time p50 / throughput / seq-per-sec
    "p95": 0.25,     # step-time p95 (noisier tail)
    "mfu": 0.10,     # MFU drop
    "mem": 0.05,     # peak device memory growth
    "grad": 1.00,    # grad-health envelope (2x the baseline max)
}


def _weighted_median(pairs):
    """Median of (value, weight) pairs; None when empty."""
    pairs = sorted((p for p in pairs if p[1] > 0), key=lambda p: p[0])
    total = sum(w for _, w in pairs)
    if not total:
        return None
    acc = 0.0
    for value, weight in pairs:
        acc += weight
        if acc >= total / 2.0:
            return value
    return pairs[-1][0]


def iter_records(path: str):
    """Decoded records of one JSONL artifact; silently skips blank and
    undecodable lines (the schema linter owns strictness)."""
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                yield rec


def last_run_records(records):
    """Trim an append-mode artifact to its FINAL run. Runs are terminated
    by ``run_summary`` records, so the final run is everything after the
    penultimate run_summary (including any trailing records of an
    unfinished newer run — those are the freshest evidence either way).
    With fewer than two run_summary records there is nothing to trim."""
    recs = list(records)
    ends = [i for i, rec in enumerate(recs)
            if rec.get("kind") == "run_summary"]
    if len(ends) >= 2:
        return recs[ends[-2] + 1:]
    return recs


def summarize_file(path: str, last_run: bool = False) -> dict:
    records = iter_records(path)
    if last_run:
        records = last_run_records(records)
    return summarize_records(records, name=os.path.basename(path))


def summarize_records(records, name: str = "") -> dict:
    windows = []
    compiles = []
    sentinels = []
    divergences = []
    grad_health = []
    memory = []
    serve_windows = []
    serve_cold_starts = []
    serve_phases = []
    serve_traces = []
    faults = []
    resumes = []
    router_windows = []
    router_traces = []
    trace_stitches = []
    fleet_events = []
    registry_events = []
    rollout_windows = []
    scale_events = []
    obs_scrapes = []
    obs_windows = []
    profile_windows = []
    compile_costs = []
    serve_summary: Optional[dict] = None
    router_summary: Optional[dict] = None
    run_summary: Optional[dict] = None
    n_records = 0
    for rec in records:
        n_records += 1
        kind = rec.get("kind")
        if kind == "step_window":
            windows.append(rec)
        elif kind == "compile":
            compiles.append(rec)
        elif kind == "sentinel":
            sentinels.append(rec)
        elif kind == "divergence":
            divergences.append(rec)
        elif kind == "grad_health":
            grad_health.append(rec)
        elif kind == "memory":
            memory.append(rec)
        elif kind == "serve_window":
            serve_windows.append(rec)
        elif kind == "serve_cold_start":
            serve_cold_starts.append(rec)
        elif kind == "serve_phase":
            serve_phases.append(rec)
        elif kind == "serve_trace":
            serve_traces.append(rec)
        elif kind == "serve_summary":
            serve_summary = rec
        elif kind == "fault":
            faults.append(rec)
        elif kind == "resume":
            resumes.append(rec)
        elif kind == "router_window":
            router_windows.append(rec)
        elif kind == "router_summary":
            router_summary = rec
        elif kind == "router_trace":
            router_traces.append(rec)
        elif kind == "trace_stitch":
            trace_stitches.append(rec)
        elif kind == "fleet_event":
            fleet_events.append(rec)
        elif kind == "registry_event":
            registry_events.append(rec)
        elif kind == "rollout_window":
            rollout_windows.append(rec)
        elif kind == "scale_event":
            scale_events.append(rec)
        elif kind == "obs_scrape":
            obs_scrapes.append(rec)
        elif kind == "obs_fleet_window":
            obs_windows.append(rec)
        elif kind == "profile_window":
            profile_windows.append(rec)
        elif kind == "compile_cost":
            compile_costs.append(rec)
        elif kind == "run_summary":
            run_summary = rec

    out: dict = {"name": name, "records": n_records}

    if windows:
        steps = sum(int(w.get("window_steps", 0)) for w in windows)
        wall = sum(
            int(w["window_steps"]) / float(w["steps_per_sec"])
            for w in windows
            if w.get("steps_per_sec") and float(w["steps_per_sec"]) > 0)
        out["steps"] = steps
        out["windows"] = len(windows)
        if wall > 0:
            out["wall_s"] = round(wall, 3)
            out["steps_per_sec"] = round(steps / wall, 4)
        for key in ("step_p50_s", "data_wait_p50_s", "h2d_wait_p50_s",
                    "host_p50_s", "device_p50_s"):
            med = _weighted_median(
                [(float(w[key]), int(w.get("window_steps", 1)))
                 for w in windows if key in w])
            if med is not None:
                out[key] = round(med, 6)
        # The step-0 compile lands in the FIRST window (its tail AND its
        # wall-basis MFU), so a cold run diffed against a warm baseline
        # would flag bogus p95/MFU regressions that are only cache
        # temperature; with more than one window the steady-state tail
        # is what the gate should compare.
        tail = windows[1:] if len(windows) > 1 else windows
        p95s = [float(w["step_p95_s"]) for w in tail if "step_p95_s" in w]
        if p95s:
            out["step_p95_s"] = round(max(p95s), 6)
        # Checkpoint-step accounting (step_timer.py note_ckpt_stall):
        # steps that carried a save, with the save's host stall folded in.
        # Aggregated over ALL windows — saves are sparse, and dropping the
        # first window could drop the only flagged one in a short run.
        # ``ckpt_step_p95_s`` vs ``step_p95_s`` is the async-checkpoint
        # acceptance comparison (docs/telemetry.md): blocking saves hold
        # it at a multiple of the steady-state tail; async saves collapse
        # it toward parity.
        ckpt_windows = [w for w in windows if w.get("ckpt_steps")]
        if ckpt_windows:
            out["ckpt_steps"] = sum(
                int(w["ckpt_steps"]) for w in ckpt_windows)
            vals = [float(w["ckpt_step_p95_s"]) for w in ckpt_windows
                    if "ckpt_step_p95_s" in w]
            if vals:
                out["ckpt_step_p95_s"] = round(max(vals), 6)
        mfus = [(float(w["mfu"]), int(w.get("window_steps", 1)))
                for w in tail
                if w.get("mfu") and w.get("mfu_basis") not in (None, "none")]
        if mfus:
            total_w = sum(w for _, w in mfus)
            out["mfu"] = round(
                sum(v * w for v, w in mfus) / total_w, 4)
        # Padding-aware accounting (step_timer.py): steady-state real-token
        # rate and the window-weighted padding efficiency it divides by.
        effs = [(float(w["padding_efficiency"]),
                 int(w.get("window_steps", 1)))
                for w in tail if w.get("padding_efficiency")]
        if effs:
            total_w = sum(w for _, w in effs)
            out["padding_efficiency"] = round(
                sum(v * w for v, w in effs) / total_w, 4)
        tok = _weighted_median(
            [(float(w["tokens_per_s"]), int(w.get("window_steps", 1)))
             for w in tail
             if w.get("tokens_per_s")
             and w.get("tokens_per_s_basis") == "real"])
        if tok is not None:
            out["tokens_per_s"] = round(tok, 2)

    if compiles:
        by_cache: dict = {}
        for rec in compiles:
            by_cache[rec.get("cache", "?")] = (
                by_cache.get(rec.get("cache", "?"), 0) + 1)
        out["compiles"] = len(compiles)
        out["compile_s"] = round(
            sum(float(rec.get("compile_s", 0.0)) for rec in compiles), 3)
        out["compile_cache"] = by_cache
        out["cold_start"] = bool(
            by_cache.get("miss", 0) + by_cache.get("uncached", 0))

    out["nonfinite_steps"] = len(sentinels)
    if sentinels:
        out["nonfinite_max_consecutive"] = max(
            int(rec.get("consecutive_nonfinite", 1)) for rec in sentinels)

    out["divergence_warnings"] = len(divergences)
    if divergences:
        out["divergence_reasons"] = sorted(
            {rec.get("reason", "?") for rec in divergences})

    if grad_health:
        norms = [float(rec["grad_norm"]) for rec in grad_health
                 if rec.get("grad_norm") is not None]
        ratios = [float(rec["update_ratio"]) for rec in grad_health
                  if rec.get("update_ratio") is not None]
        out["grad_health_records"] = len(grad_health)
        if norms:
            out["grad_norm_last"] = round(norms[-1], 6)
            out["grad_norm_max"] = round(max(norms), 6)
        if ratios:
            out["update_ratio_last"] = round(ratios[-1], 8)
            out["update_ratio_max"] = round(max(ratios), 8)

    supported = [rec for rec in memory if rec.get("memory_supported")]
    if memory:
        out["memory_supported"] = bool(supported)
    if supported:
        out["peak_bytes_in_use"] = max(
            int(rec.get("peak_bytes_in_use", 0)) for rec in supported)
        out["bytes_in_use_last"] = int(supported[-1].get("bytes_in_use", 0))
        limits = [int(rec.get("bytes_limit", 0)) for rec in supported]
        if any(limits):
            out["bytes_limit"] = max(limits)

    # -- recovery section (docs/fault_tolerance.md) ---------------------
    # Fault/resume records are operational history, not performance: the
    # report names what went wrong (split injected vs real — a chaos-run
    # artifact full of injected faults is healthy) and what every resume
    # skipped, so "did the run recover cleanly" is answerable offline.
    if faults:
        out["faults"] = len(faults)
        out["faults_injected"] = sum(
            1 for rec in faults if rec.get("injected"))
        out["fault_kinds"] = sorted(
            {str(rec.get("fault", "?")) for rec in faults})
    if resumes:
        out["resumes"] = len(resumes)
        out["resume_last_step"] = int(resumes[-1].get("step", 0))
        skipped = [entry for rec in resumes
                   for entry in (rec.get("skipped") or [])]
        out["resume_skipped_checkpoints"] = len(skipped)
        if skipped:
            out["resume_skipped_steps"] = sorted(
                {int(entry.get("step", -1)) for entry in skipped})

    # -- serve record family (serve/stats.py, docs/serving.md) ----------
    # The serve_summary record carries exact run-level percentiles; when a
    # run died before finish(), fall back to aggregating the windows with
    # the step-window conventions (weighted-median p50, max-of-window
    # tails — a latency spike anywhere in the run must not average away).
    if serve_summary is not None:
        for src, dst in (("requests", "serve_requests"),
                         ("requests_per_sec", "serve_rps"),
                         ("latency_p50_ms", "serve_latency_p50_ms"),
                         ("latency_p95_ms", "serve_latency_p95_ms"),
                         ("latency_p99_ms", "serve_latency_p99_ms"),
                         ("device_p50_ms", "serve_device_p50_ms"),
                         ("batch_occupancy", "serve_occupancy"),
                         ("compiles", "serve_compiles"),
                         ("errors", "serve_errors"),
                         # Continuous-batching gauges (docs/serving.md):
                         # the executor-gap share behind the "serve
                         # device idle share" gate, and the
                         # admission-window win count.
                         ("device_idle_share", "serve_device_idle_share"),
                         ("admitted_late", "serve_admitted_late")):
            if serve_summary.get(src) is not None:
                out[dst] = serve_summary[src]
    elif serve_windows:
        reqs = sum(int(w.get("window_requests", 0)) for w in serve_windows)
        out["serve_requests"] = reqs
        p50 = _weighted_median(
            [(float(w["latency_p50_ms"]), int(w.get("window_requests", 1)))
             for w in serve_windows if "latency_p50_ms" in w])
        if p50 is not None:
            out["serve_latency_p50_ms"] = round(p50, 3)
        for pct in ("p95", "p99"):
            vals = [float(w[f"latency_{pct}_ms"]) for w in serve_windows
                    if f"latency_{pct}_ms" in w]
            if vals:
                out[f"serve_latency_{pct}_ms"] = round(max(vals), 3)
        occs = [(float(w["batch_occupancy"]),
                 int(w.get("window_requests", 1)))
                for w in serve_windows if w.get("batch_occupancy")]
        if occs:
            total_w = sum(w for _, w in occs)
            out["serve_occupancy"] = round(
                sum(v * w for v, w in occs) / total_w, 4)
        out["serve_compiles"] = sum(
            int(w.get("compiles", 0)) for w in serve_windows)
        out["serve_admitted_late"] = sum(
            int(w.get("admitted_late", 0)) for w in serve_windows)
        # Window fallback for the executor-gap share: request-weighted
        # mean (each window's share already normalizes by its own busy
        # basis; a dead-air window anywhere must still pull the run's
        # number up, which a min/max would over- or under-state).
        idles = [(float(w["device_idle_share"]),
                  int(w.get("window_requests", 1)))
                 for w in serve_windows
                 if w.get("device_idle_share") is not None]
        if idles:
            total_w = sum(w for _, w in idles)
            out["serve_device_idle_share"] = round(
                sum(v * w for v, w in idles) / total_w, 4)

    # -- request-tracing section (serve/tracing.py, docs/serving.md) ----
    # serve_phase windows carry the latency DECOMPOSITION the coarse
    # serve_window records can't: where a request's time went (queue vs
    # execute vs postprocess), the queue-wait share a router balances
    # on, and the rolling-window SLO accounting. Aggregation follows the
    # step-window conventions: request-weighted means for shares, max
    # over windows for tails (a p99 breach anywhere in the run must not
    # average away).
    if serve_phases:
        reqs = sum(int(w.get("window_requests", 1)) for w in serve_phases)
        shares = [(float(w["queue_wait_share"]),
                   int(w.get("window_requests", 1)))
                  for w in serve_phases if "queue_wait_share" in w]
        if shares:
            total_w = sum(w for _, w in shares)
            out["serve_queue_wait_share"] = round(
                sum(v * w for v, w in shares) / total_w, 4)
        for phase in ("queue", "assembly", "execute", "postprocess"):
            vals = [float(w[f"{phase}_p95_ms"]) for w in serve_phases
                    if f"{phase}_p95_ms" in w]
            if vals:
                out[f"serve_{phase}_p95_ms"] = round(max(vals), 3)
        p99s = [float(w["total_p99_ms"]) for w in serve_phases
                if "total_p99_ms" in w]
        if p99s:
            # The metric behind the "serve SLO p99" gate: worst window
            # tail of the traced decomposition.
            out["serve_slo_p99_ms"] = round(max(p99s), 3)
        targets = [float(w["slo_target_ms"]) for w in serve_phases
                   if w.get("slo_target_ms")]
        if targets:
            target = targets[-1]
            over = sum(int(w.get("over_slo", 0)) for w in serve_phases)
            budgets = [float(w["slo_budget"]) for w in serve_phases
                       if w.get("slo_budget")]
            budget_frac = budgets[-1] if budgets else 0.01
            out["serve_slo_target_ms"] = target
            out["serve_slo_over"] = over
            allowed = budget_frac * reqs
            if allowed > 0:
                # >1 = the error budget for this run is spent.
                out["serve_slo_budget_burn"] = round(over / allowed, 4)
            p99 = out.get("serve_slo_p99_ms")
            out["serve_slo_verdict"] = (
                "breach" if (p99 is not None and p99 > target)
                or out.get("serve_slo_budget_burn", 0) > 1.0 else "ok")
    if serve_traces:
        out["serve_traces"] = len(serve_traces)
        out["serve_traces_slow"] = sum(
            1 for t in serve_traces if t.get("sample_reason") == "slow")
        # Critical path of the slowest decile: among the worst 10% of
        # sampled traces by total latency, which phase dominated each —
        # the "what do I fix first" summary ("The Tail at Scale").
        by_total = sorted(
            (t for t in serve_traces if t.get("spans")),
            key=lambda t: float(t.get("total_ms", 0.0)), reverse=True)
        decile = by_total[: max(1, len(by_total) // 10)] if by_total else []
        path: dict = {}
        for t in decile:
            spans = [s for s in t["spans"]
                     if isinstance(s, dict) and "dur_ms" in s]
            if not spans:
                continue
            worst = max(spans, key=lambda s: float(s["dur_ms"]))
            path[worst["name"]] = path.get(worst["name"], 0) + 1
        if path:
            out["serve_critical_path"] = dict(
                sorted(path.items(), key=lambda kv: -kv[1]))

    if serve_cold_starts:
        # A multi-start artifact (e.g. the BENCH_SERVE quant leg runs
        # fp32 then int8 engines) gates on the WORST start; the cold
        # compile count sums — the warm-restart acceptance is "zero cold
        # compiles", and any start that compiled breaks it.
        out["serve_cold_start_s"] = round(max(
            float(r.get("cold_start_s", 0.0)) for r in serve_cold_starts), 3)
        out["serve_compiles_cold"] = sum(
            int(r.get("compiles_cold", 0)) for r in serve_cold_starts)
        out["serve_compiles_warm"] = sum(
            int(r.get("compiles_warm", 0)) for r in serve_cold_starts)
        modes = sorted({str(r["quantize"]) for r in serve_cold_starts
                        if r.get("quantize")})
        if modes:
            out["serve_quantize"] = ",".join(modes)

    # -- fleet record family (serve/router.py, serve/supervisor.py) -----
    # Router traffic follows the serve conventions: the run-level
    # router_summary is exact when the router stopped cleanly; otherwise
    # aggregate the windows (sums for counters, weighted-median p50,
    # max for tails — a failover spike anywhere in the run must not
    # average away). ``router_failover_p95_ms`` is the metric behind the
    # "router failover" gate: the client-visible latency of requests
    # that needed a different replica than first chosen.
    if router_summary is not None:
        for src, dst in (("requests", "router_requests"),
                         ("ok", "router_ok"),
                         ("sheds", "router_sheds"),
                         ("errors", "router_errors"),
                         ("retries", "router_retries"),
                         ("hedges", "router_hedges"),
                         ("hedge_wins", "router_hedge_wins"),
                         ("hedge_wasted_ms", "router_hedge_wasted_ms"),
                         ("failovers", "router_failovers"),
                         ("latency_p50_ms", "router_latency_p50_ms"),
                         ("latency_p95_ms", "router_latency_p95_ms"),
                         ("failover_p95_ms", "router_failover_p95_ms")):
            if router_summary.get(src) is not None:
                out[dst] = router_summary[src]
    elif router_windows:
        for src, dst in (("window_requests", "router_requests"),
                         ("ok", "router_ok"),
                         ("sheds", "router_sheds"),
                         ("errors", "router_errors"),
                         ("retries", "router_retries"),
                         ("hedges", "router_hedges"),
                         ("hedge_wins", "router_hedge_wins"),
                         ("failovers", "router_failovers")):
            out[dst] = sum(int(w.get(src, 0)) for w in router_windows)
        wasted = sum(float(w.get("hedge_wasted_ms", 0.0))
                     for w in router_windows)
        if wasted or out.get("router_hedges"):
            out["router_hedge_wasted_ms"] = round(wasted, 3)
        p50 = _weighted_median(
            [(float(w["latency_p50_ms"]), int(w.get("window_requests", 1)))
             for w in router_windows if "latency_p50_ms" in w])
        if p50 is not None:
            out["router_latency_p50_ms"] = round(p50, 3)
        for key, dst in (("latency_p95_ms", "router_latency_p95_ms"),
                         ("failover_p95_ms", "router_failover_p95_ms")):
            vals = [float(w[key]) for w in router_windows if key in w]
            if vals:
                out[dst] = round(max(vals), 3)
    # -- end-to-end trace section (telemetry/collector.py stitching,
    # docs/observability.md "Trace propagation") ------------------------
    # trace_stitch records decompose each sampled client request into
    # router overhead + network gap + replica time. Shares are
    # aggregate ratios (sum of parts over sum of client totals), NOT
    # means of per-trace ratios — a 1 ms request with 50% overhead must
    # not outweigh a 100 ms request with 5%. ``trace_orphans`` counts
    # the stitches whose other tier never showed up: zero on a healthy
    # fleet, and any new one is the propagation or the collector
    # breaking (the "orphan span share" gate).
    if router_traces:
        out["router_traces"] = len(router_traces)
    if trace_stitches:
        out["trace_stitches"] = len(trace_stitches)
        orphans = sum(1 for s in trace_stitches if s.get("orphan"))
        out["trace_orphans"] = orphans
        out["trace_orphan_share"] = round(
            orphans / len(trace_stitches), 4)
        complete = [s for s in trace_stitches
                    if not s.get("orphan")
                    and s.get("client_total_ms") is not None
                    and s.get("router_overhead_ms") is not None
                    and s.get("replica_ms") is not None]
        total = sum(float(s["client_total_ms"]) for s in complete)
        if complete and total > 0:
            out["trace_router_overhead_share"] = round(
                sum(float(s["router_overhead_ms"]) for s in complete)
                / total, 4)
            out["trace_network_gap_share"] = round(
                sum(max(0.0, float(s.get("network_gap_ms", 0.0)))
                    for s in complete) / total, 4)
            out["trace_replica_share"] = round(
                sum(float(s["replica_ms"]) for s in complete) / total, 4)
        inconsistent = sum(1 for s in complete
                           if s.get("consistent") is False)
        if inconsistent:
            out["trace_inconsistent"] = inconsistent
        # Cross-tier critical path of the slowest decile: which TIER
        # dominated each of the worst 10% of stitched requests — and
        # when the replica did, its own dominant phase (carried on the
        # stitch record) names the hop, so "where do I look first" spans
        # tiers in one answer.
        by_total = sorted(complete,
                          key=lambda s: float(s["client_total_ms"]),
                          reverse=True)
        decile = by_total[: max(1, len(by_total) // 10)] if by_total \
            else []
        path: dict = {}
        for s in decile:
            parts = {
                "router_overhead": float(s["router_overhead_ms"]),
                "network_gap": max(0.0,
                                   float(s.get("network_gap_ms", 0.0))),
                "replica": float(s["replica_ms"]),
            }
            worst = max(parts, key=parts.get)
            if worst == "replica" and s.get("replica_critical_phase"):
                worst = f"replica:{s['replica_critical_phase']}"
            path[worst] = path.get(worst, 0) + 1
        if path:
            out["trace_critical_path"] = dict(
                sorted(path.items(), key=lambda kv: -kv[1]))

    # Supervisor history: operational counts by decision type — "how
    # often did something need restarting, and did anything get given up
    # on" is answerable offline from the artifact alone.
    if fleet_events:
        out["fleet_events"] = len(fleet_events)
        by_event: dict = {}
        for rec in fleet_events:
            name = str(rec.get("event", "?"))
            by_event[name] = by_event.get(name, 0) + 1
        out["fleet_event_kinds"] = dict(sorted(by_event.items()))
        out["fleet_spawns"] = by_event.get("spawn", 0)
        out["fleet_crash_restarts"] = sum(
            1 for rec in fleet_events
            if rec.get("event") == "restart_scheduled" and rec.get("crash"))
        out["fleet_wedged_kills"] = by_event.get("wedged_kill", 0)
        out["fleet_gave_up"] = by_event.get("gave_up", 0)
        out["fleet_swap_failures"] = by_event.get("swap_failed", 0)

    # -- deployment plane (serve/registry.py, serve/rollout.py, docs/
    # serving.md "Model registry & canary rollouts") ---------------------
    # rollout_window records are the canary's per-window SLO evidence;
    # the two counters behind the zero-tolerance gates are breaches
    # (slo_ok false anywhere) and torn serves (a request observed a
    # params flip mid-execution — structurally impossible under the
    # engine's atomic swap, which is exactly why telemetry counts it).
    if registry_events:
        out["registry_events"] = len(registry_events)
        by_ev: dict = {}
        for rec in registry_events:
            name = str(rec.get("event", "?"))
            by_ev[name] = by_ev.get(name, 0) + 1
        out["registry_event_kinds"] = dict(sorted(by_ev.items()))
        out["registry_rollbacks"] = sum(
            1 for rec in registry_events
            if rec.get("event") == "state_change"
            and rec.get("from_state") == "canary"
            and rec.get("state") == "staged")
    if rollout_windows:
        out["rollout_windows"] = len(rollout_windows)
        out["rollout_slo_breaches"] = sum(
            1 for w in rollout_windows if w.get("slo_ok") is False)
        out["rollout_rollbacks"] = sum(
            1 for w in rollout_windows if w.get("action") == "rollback")
        out["rollout_torn_serves"] = sum(
            int(w.get("torn_serves", 0)) for w in rollout_windows)
        out["rollout_max_share"] = max(
            float(w.get("canary_share", 0.0)) for w in rollout_windows)
        out["rollout_final_action"] = str(
            rollout_windows[-1].get("action", "?"))
        canary_reqs = sum(int(w.get("window_requests", 0))
                          for w in rollout_windows)
        out["rollout_canary_requests"] = canary_reqs
        p95s = [float(w["latency_p95_ms"]) for w in rollout_windows
                if w.get("latency_p95_ms") is not None]
        if p95s:
            out["rollout_canary_p95_ms"] = round(max(p95s), 3)
        burns = [float(w["budget_burn"]) for w in rollout_windows
                 if w.get("budget_burn") is not None]
        if burns:
            out["rollout_budget_burn"] = round(max(burns), 4)

    # -- elasticity plane section (serve/autoscaler.py, docs/serving.md
    # "Elastic fleet") ---------------------------------------------------
    # scale_event records are the autoscaler's decision stream. Two
    # zero-tolerance gates read it: "autoscaler thrash" (a direction
    # flip inside the cooldown window it is accountable to — the
    # controller's shared last-scale timestamp makes this structurally
    # impossible, so any occurrence is a control-loop bug) and "surge
    # client-visible errors" (elasticity must never burn a client
    # request; the controller's windows see every router error).
    if scale_events:
        out["scale_events"] = len(scale_events)
        by_dec: dict = {}
        for rec in scale_events:
            name = str(rec.get("decision", "?"))
            by_dec[name] = by_dec.get(name, 0) + 1
        out["scale_decision_kinds"] = dict(sorted(by_dec.items()))
        out["autoscaler_scale_ups"] = by_dec.get("scale_up", 0)
        out["autoscaler_scale_downs"] = by_dec.get("scale_down", 0)
        counts = [int(rec.get("replicas_after", 0))
                  for rec in scale_events]
        out["autoscaler_replicas_max"] = max(counts)
        out["autoscaler_replicas_last"] = counts[-1]
        thrash = 0
        last_dir = None
        for rec in scale_events:
            decision = rec.get("decision")
            if decision not in ("scale_up", "scale_down"):
                continue
            since = rec.get("since_last_scale_s")
            cool = rec.get("cooldown_s")
            if (last_dir is not None and decision != last_dir
                    and since is not None and cool is not None
                    and float(since) < float(cool)):
                thrash += 1
            last_dir = decision
        out["autoscaler_thrash"] = thrash
        out["surge_client_errors"] = sum(
            int(rec.get("window_errors", 0) or 0)
            for rec in scale_events)
        out["surge_sheds"] = sum(
            int(rec.get("window_sheds", 0) or 0)
            for rec in scale_events)

    # -- fleet observatory section (telemetry/collector.py, docs/
    # observability.md) --------------------------------------------------
    # The collector's timeline carries per-target scrape samples and
    # per-pass fleet aggregates. Aggregation follows the house
    # conventions: max over samples for staleness and worst-replica p99
    # (a dead scrape or a latency cliff anywhere in the run must not
    # average away), min over windows for the healthy count (the dip is
    # the signal), weighted medians for rates.
    if obs_scrapes:
        out["obs_scrapes"] = len(obs_scrapes)
        out["obs_targets"] = len({str(r.get("target")) for r in obs_scrapes})
        out["obs_scrape_failures"] = sum(
            1 for r in obs_scrapes if not r.get("ok"))
        stale = [float(r["staleness_s"]) for r in obs_scrapes
                 if r.get("staleness_s") is not None]
        if stale:
            # The metric behind the "fleet scrape staleness" gate.
            out["fleet_scrape_staleness_s"] = round(max(stale), 3)
    if obs_windows:
        out["fleet_windows"] = len(obs_windows)
        out["fleet_targets"] = max(
            int(w.get("targets_total", 0)) for w in obs_windows)
        out["fleet_healthy_min"] = min(
            int(w.get("targets_healthy", 0)) for w in obs_windows)
        p99s = [float(w["worst_replica_p99_ms"]) for w in obs_windows
                if w.get("worst_replica_p99_ms") is not None]
        if p99s:
            # The metric behind the "fleet worst-replica p99" gate.
            out["fleet_worst_replica_p99_ms"] = round(max(p99s), 3)
        rps = _weighted_median(
            [(float(w["fleet_rps"]), 1) for w in obs_windows
             if w.get("fleet_rps") is not None])
        if rps is not None:
            out["fleet_rps"] = round(rps, 3)
        rates = _weighted_median(
            [(float(w["trainer_steps_per_sec"]), 1) for w in obs_windows
             if w.get("trainer_steps_per_sec") is not None])
        if rates is not None:
            out["fleet_trainer_steps_per_sec"] = round(rates, 4)
        burns = [float(w["error_budget_burn"]) for w in obs_windows
                 if w.get("error_budget_burn") is not None]
        if burns:
            out["fleet_error_budget_burn"] = round(max(burns), 4)

    # -- profiling plane section (telemetry/sampler.py, docs/
    # observability.md "Profiling plane") -------------------------------
    # profile_window records carry the HOST view (thread-sampler self
    # time) of each on-demand capture; compile_cost records carry the
    # DEVICE view (static FLOP/byte attribution per jitted entry point).
    # The join names the dominant cost per phase in one place: the
    # hottest host frame across every capture, and the heaviest
    # compiled function it was feeding.
    if profile_windows:
        out["profile_windows"] = len(profile_windows)
        out["profile_samples"] = sum(
            int(w.get("samples", 0)) for w in profile_windows)
        out["profile_trace_bytes"] = sum(
            int(w.get("trace_bytes", 0)) for w in profile_windows)
        sources = sorted({str(w.get("source", "?"))
                          for w in profile_windows})
        out["profile_sources"] = ",".join(sources)
        covered: dict = {}
        for w in profile_windows:
            unit = str(w.get("covered_unit", "?"))
            covered[unit] = covered.get(unit, 0) + int(w.get("covered", 0))
        out["profile_covered"] = dict(sorted(covered.items()))
        # Aggregate host self time per leaf frame across every capture
        # (sample counts are comparable: all captures share the wall
        # clock, and a frame hot in two windows is hotter than one).
        frames: dict = {}
        for w in profile_windows:
            for row in w.get("top_frames") or []:
                if not isinstance(row, dict):
                    continue
                key = str(row.get("frame", "?"))
                frames[key] = frames.get(key, 0) + int(row.get("samples", 0))
        if frames:
            top = sorted(frames.items(), key=lambda kv: (-kv[1], kv[0]))
            out["profile_host_frames"] = dict(top[:5])
            out["profile_critical_host"] = top[0][0]
    if compile_costs:
        # The device side of the join: heaviest analyzed executable by
        # static FLOPs (bytes accessed breaks ties — a bandwidth-bound
        # fn can dominate at modest FLOPs).
        def _cost(rec):
            return (float(rec.get("flops", 0.0) or 0.0),
                    float(rec.get("bytes_accessed", 0.0) or 0.0))

        heaviest = max(compile_costs, key=_cost)
        if _cost(heaviest) > (0.0, 0.0):
            out["profile_critical_device"] = str(heaviest.get("fn", "?"))

    if run_summary:
        for key, value in run_summary.items():
            if key in ("schema", "ts", "kind", "tag"):
                continue
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                out.setdefault(key, value)
            elif key == "metric" and isinstance(value, str):
                # Bench runs stamp their config's metric name; consumers
                # (bench.py's regression gate) use it to refuse diffing
                # incomparable configurations.
                out.setdefault("metric", value)
    return out


# (summary key, pretty name, direction, tolerance key). Direction "up"
# means a larger NEW value is the regression.
_CHECKS = (
    ("step_p50_s", "step-time p50", "up", "step"),
    ("step_p95_s", "step-time p95", "up", "p95"),
    # Checkpoint-step tail: the number async checkpoint snapshots exist to
    # collapse — a revert to blocking saves trips this by name.
    ("ckpt_step_p95_s", "checkpoint-step p95", "up", "p95"),
    ("steps_per_sec", "throughput (steps/s)", "down", "step"),
    ("training_seq_per_sec", "training seq/s", "down", "step"),
    ("mfu", "MFU", "down", "mfu"),
    ("peak_bytes_in_use", "peak device memory", "up", "mem"),
    ("grad_norm_max", "grad-norm envelope", "up", "grad"),
    ("update_ratio_max", "update-ratio envelope", "up", "grad"),
    # serve record family (docs/serving.md): p95 is the tail gate; p50
    # is the INFERENCE-FAST-PATH gate — the quantized/fused-kernel work
    # targets the median forward, and a p50 regression there is the
    # optimization silently reverting even while the tail stays in tol.
    ("serve_latency_p50_ms", "serve p50 latency", "up", "p95"),
    ("serve_latency_p95_ms", "serve p95 latency", "up", "p95"),
    ("serve_rps", "serve throughput (req/s)", "down", "step"),
    ("serve_occupancy", "serve batch occupancy", "down", "step"),
    # Request-tracing gates (serve/tracing.py): the queue-wait share is
    # the admission-control signal — a dispatch/batching change that
    # parks requests in the queue moves it even when the device time is
    # unchanged; the SLO p99 is the worst traced-window tail, the number
    # the serving SLO is written against.
    ("serve_queue_wait_share", "serve queue-wait share", "up", "p95"),
    ("serve_slo_p99_ms", "serve SLO p99", "up", "p95"),
    # Continuous-batching gate (docs/serving.md "Continuous batching"):
    # the executor-gap (device idle) share between consecutive jitted
    # forwards. The pipelined dispatch plane exists to hold this down —
    # a regression means the device is idling through host-side
    # assembly/decode again (e.g. the pipeline silently serialized),
    # even when per-request latency still looks fine at low load.
    ("serve_device_idle_share", "serve device idle share", "up", "p95"),
    # Cold start: the built-kernel-library win. A regression here means a
    # restarted replica is running nvcc again (a library-hash drift, or
    # a --compile_cache_dir the fleet does not share).
    ("serve_cold_start_s", "serve cold start", "up", "p95"),
    # Fleet-tier gates (serve/router.py, docs/serving.md "Fleet tier"):
    # the "router failover" gate is the resilience acceptance — the
    # client-visible latency of requests that had to fail over to a
    # different replica. It growing past tolerance means recovery is
    # slipping (retry backoff too slow, health gate too stale, hedge not
    # firing) even while the healthy-path latency stays flat.
    ("router_failover_p95_ms", "router failover p95", "up", "p95"),
    ("router_latency_p95_ms", "router p95 latency", "up", "p95"),
    # Fleet observatory gates (telemetry/collector.py): staleness is
    # the collector's own health — a growing max means some endpoint
    # stopped answering (or the collector stopped keeping up), exactly
    # the blind spot the observatory exists to close; worst-replica p99
    # is the fleet-level tail the router's balancing is supposed to
    # hold down even while a replica dies and recovers.
    ("fleet_scrape_staleness_s", "fleet scrape staleness", "up", "p95"),
    ("fleet_worst_replica_p99_ms", "fleet worst-replica p99", "up", "p95"),
    # End-to-end trace gate (telemetry/collector.py stitching): the
    # router's share of each stitched request's client-observed total.
    # It growing means time moved INTO the routing tier — admission
    # queueing, retry backoff, hedge management — which per-tier p95s
    # can miss entirely when the replica got faster at the same time.
    ("trace_router_overhead_share", "router overhead share", "up", "p95"),
)


def compare(base: dict, new: dict, tolerances: Optional[dict] = None):
    """(regressions, checks): every comparable metric with a verdict.

    A check only runs when BOTH summaries carry the metric with a
    nonzero baseline — a metric appearing or disappearing (e.g. MFU on
    CPU) is reported as an ``"n/a"`` check, not a regression.
    """
    tol = dict(DEFAULT_TOLERANCES)
    tol.update(tolerances or {})
    checks = []
    regressions = []
    for key, label, direction, tol_key in _CHECKS:
        b, n = base.get(key), new.get(key)
        if b is None or n is None or not b:
            if b is not None or n is not None:
                checks.append({"metric": key, "label": label,
                               "verdict": "n/a", "base": b, "new": n})
            continue
        rel = (n - b) / abs(b)
        worse = rel > tol[tol_key] if direction == "up" \
            else rel < -tol[tol_key]
        entry = {
            "metric": key, "label": label, "base": b, "new": n,
            "change": round(rel, 4), "tolerance": tol[tol_key],
            "verdict": "regression" if worse else "ok",
        }
        checks.append(entry)
        if worse:
            regressions.append(entry)
    # Health counters: any NEW occurrence where the baseline had none is
    # a regression regardless of tolerance. serve_compiles_cold rides
    # here too: a warm-cache baseline (0 cold compiles) against a run
    # that recompiled is the cold-start acceptance breaking, no matter
    # how fast the recompiles happened to be.
    # router_errors (exhausted failover: a client saw a 5xx) and
    # fleet_gave_up (a replica crash-looped past the restart budget) are
    # zero in any healthy run, so any new occurrence is a regression.
    # trace_orphans rides the zero-tolerance loop (not the ratio
    # checks): a clean baseline has ZERO orphans, which the ratio path
    # would wave through as "n/a" — while a single new orphan means a
    # span went missing between tiers, which is exactly the regression
    # the "orphan span share" gate exists to name.
    # The deployment-plane pair rides here too: a canary window that
    # breached its SLO (rollout_slo_breaches) or a single torn-model
    # serve (rollout_torn_serves) is zero on any healthy rollout — the
    # breach gate is what the auto-rollback E2E proves fires, and the
    # torn gate is the atomic-swap invariant made falsifiable.
    # The elasticity-plane pair: a direction flip inside the cooldown
    # window (autoscaler_thrash) is structurally impossible under the
    # controller's shared last-scale timestamp, and a client-visible
    # error during elastic capacity change (surge_client_errors) means
    # scaling burned a request — both zero on any healthy surge, proven
    # live by tools/chaos_serve.py --surge.
    for key, label in (("nonfinite_steps", "non-finite steps"),
                       ("divergence_warnings", "divergence warnings"),
                       ("serve_compiles_cold", "serve cold compiles"),
                       ("router_errors", "router client-visible errors"),
                       ("fleet_gave_up", "fleet replicas given up"),
                       ("trace_orphans", "orphan span share"),
                       ("rollout_slo_breaches", "rollout canary SLO"),
                       ("rollout_torn_serves",
                        "rollout torn-model serves"),
                       ("autoscaler_thrash", "autoscaler thrash"),
                       ("surge_client_errors",
                        "surge client-visible errors")):
        b, n = int(base.get(key, 0)), int(new.get(key, 0))
        if n > b:
            entry = {"metric": key, "label": label, "base": b, "new": n,
                     "verdict": "regression"}
            checks.append(entry)
            regressions.append(entry)
        elif b or n:
            checks.append({"metric": key, "label": label, "base": b,
                           "new": n, "verdict": "ok"})
    return regressions, checks


def _fmt_value(key, value):
    if value is None:
        return "-"
    if key.endswith("bytes_in_use") or key in ("bytes_limit",):
        return f"{value / (1 << 20):.1f} MiB"
    if isinstance(value, float):
        return f"{value:.6g}"
    return str(value)


def format_summary(summary: dict) -> str:
    lines = [f"== {summary.get('name') or 'telemetry'} "
             f"({summary.get('records', 0)} records)"]
    order = ("steps", "wall_s", "steps_per_sec", "step_p50_s", "step_p95_s",
             "ckpt_steps", "ckpt_step_p95_s",
             "data_wait_p50_s", "h2d_wait_p50_s", "host_p50_s",
             "device_p50_s", "mfu",
             "training_seq_per_sec", "padding_efficiency", "tokens_per_s",
             "real_tokens_per_sec",
             "serve_requests", "serve_rps", "serve_latency_p50_ms",
             "serve_latency_p95_ms", "serve_latency_p99_ms",
             "serve_device_p50_ms", "serve_occupancy", "serve_compiles",
             "serve_errors", "serve_admitted_late",
             "serve_device_idle_share",
             "serve_cold_start_s", "serve_compiles_cold",
             "serve_compiles_warm", "serve_quantize",
             "serve_queue_wait_share", "serve_queue_p95_ms",
             "serve_assembly_p95_ms", "serve_execute_p95_ms",
             "serve_postprocess_p95_ms", "serve_traces",
             "serve_traces_slow", "serve_slo_target_ms", "serve_slo_p99_ms",
             "serve_slo_over", "serve_slo_budget_burn", "serve_slo_verdict",
             "router_requests", "router_ok", "router_sheds",
             "router_errors", "router_retries", "router_hedges",
             "router_hedge_wins", "router_hedge_wasted_ms",
             "router_failovers",
             "router_latency_p50_ms", "router_latency_p95_ms",
             "router_failover_p95_ms",
             "router_traces", "trace_stitches", "trace_orphans",
             "trace_orphan_share", "trace_inconsistent",
             "trace_router_overhead_share", "trace_network_gap_share",
             "trace_replica_share",
             "fleet_events", "fleet_spawns", "fleet_crash_restarts",
             "fleet_wedged_kills", "fleet_gave_up", "fleet_swap_failures",
             "registry_events", "registry_rollbacks",
             "rollout_windows", "rollout_canary_requests",
             "rollout_max_share", "rollout_canary_p95_ms",
             "rollout_budget_burn", "rollout_slo_breaches",
             "rollout_rollbacks", "rollout_torn_serves",
             "rollout_final_action",
             "scale_events", "autoscaler_scale_ups",
             "autoscaler_scale_downs", "autoscaler_replicas_max",
             "autoscaler_replicas_last", "autoscaler_thrash",
             "surge_client_errors", "surge_sheds",
             "obs_scrapes", "obs_targets", "obs_scrape_failures",
             "fleet_windows", "fleet_targets", "fleet_healthy_min",
             "fleet_scrape_staleness_s", "fleet_worst_replica_p99_ms",
             "fleet_rps", "fleet_trainer_steps_per_sec",
             "fleet_error_budget_burn",
             "profile_windows", "profile_samples", "profile_trace_bytes",
             "profile_sources", "profile_critical_host",
             "profile_critical_device",
             "compiles", "compile_s", "cold_start",
             "nonfinite_steps", "divergence_warnings", "grad_norm_last",
             "grad_norm_max", "update_ratio_max", "memory_supported",
             "peak_bytes_in_use", "bytes_in_use_last", "bytes_limit",
             "faults", "faults_injected", "resumes", "resume_last_step",
             "resume_skipped_checkpoints")
    for key in order:
        if key in summary:
            lines.append(f"  {key:>22}: {_fmt_value(key, summary[key])}")
    if summary.get("serve_critical_path"):
        lines.append(f"  {'serve_critical_path':>22}: "
                     + ", ".join(f"{k}={v}" for k, v
                                 in summary["serve_critical_path"].items())
                     + " (dominant phase, slowest decile)")
    if summary.get("trace_critical_path"):
        lines.append(f"  {'trace_critical_path':>22}: "
                     + ", ".join(f"{k}={v}" for k, v
                                 in summary["trace_critical_path"].items())
                     + " (dominant tier, slowest decile)")
    if summary.get("profile_host_frames"):
        lines.append(f"  {'profile_host_frames':>22}: "
                     + ", ".join(f"{k}={v}" for k, v
                                 in summary["profile_host_frames"].items())
                     + " (host self-time samples)")
    if summary.get("profile_covered"):
        lines.append(f"  {'profile_covered':>22}: "
                     + ", ".join(f"{v} {k}" for k, v
                                 in summary["profile_covered"].items()))
    if summary.get("fleet_event_kinds"):
        lines.append(f"  {'fleet_event_kinds':>22}: "
                     + ", ".join(f"{k}={v}" for k, v
                                 in summary["fleet_event_kinds"].items()))
    if summary.get("registry_event_kinds"):
        lines.append(f"  {'registry_event_kinds':>22}: "
                     + ", ".join(
                         f"{k}={v}" for k, v
                         in summary["registry_event_kinds"].items()))
    if summary.get("fault_kinds"):
        lines.append(f"  {'fault_kinds':>22}: "
                     + ", ".join(summary["fault_kinds"]))
    if summary.get("resume_skipped_steps"):
        lines.append(f"  {'resume_skipped_steps':>22}: "
                     + ", ".join(map(str, summary["resume_skipped_steps"])))
    if summary.get("compile_cache"):
        lines.append(f"  {'compile_cache':>22}: "
                     + ", ".join(f"{k}={v}" for k, v
                                 in sorted(summary["compile_cache"].items())))
    if summary.get("divergence_reasons"):
        lines.append(f"  {'divergence_reasons':>22}: "
                     + ", ".join(summary["divergence_reasons"]))
    return "\n".join(lines)


def format_checks(checks) -> str:
    lines = []
    for c in checks:
        mark = {"regression": "REGRESSION", "ok": "ok", "n/a": "n/a"}[
            c["verdict"]]
        if "change" in c:
            lines.append(
                f"  {mark:>10} {c['label']}: "
                f"{_fmt_value(c['metric'], c['base'])} -> "
                f"{_fmt_value(c['metric'], c['new'])} "
                f"({c['change']:+.1%}, tolerance {c['tolerance']:.0%})")
        else:
            lines.append(
                f"  {mark:>10} {c['label']}: "
                f"{_fmt_value(c['metric'], c.get('base'))} -> "
                f"{_fmt_value(c['metric'], c.get('new'))}")
    return "\n".join(lines)


def _load_ledger():
    """Ledger module both ways (the collector's _load_schema pattern):
    package import when report.py was imported normally, sibling
    file-path import when report.py was itself loaded by path
    (tools/telemetry_report.py in a torch-free process)."""
    if __package__:
        import importlib

        return importlib.import_module(
            "bert_pytorch_tpu_torch.telemetry.ledger")
    import importlib.util

    module = sys.modules.get("_torchreport_ledger")
    if module is not None:
        return module
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "ledger.py")
    spec = importlib.util.spec_from_file_location("_torchreport_ledger", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules["_torchreport_ledger"] = module
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="telemetry-report",
        description="Summarize a telemetry JSONL artifact; with a "
                    "baseline, diff the two and exit 1 on regression "
                    "(docs/telemetry.md).")
    parser.add_argument("run", nargs="?", default=None,
                        help="telemetry JSONL of the run under test "
                             "(optional with --ledger: a bare drift "
                             "check over the existing trajectory)")
    parser.add_argument("baseline", nargs="?", default=None,
                        help="baseline telemetry JSONL to diff against")
    parser.add_argument("--baseline", dest="baseline_flag", default=None,
                        help="alternative spelling of the baseline path")
    parser.add_argument("--json", action="store_true",
                        help="legacy machine-readable output (summaries + "
                             "checks + verdict) instead of the human "
                             "tables (the JAX package's bench.py reads "
                             "depends on its exact keys; --format json "
                             "is the stable-contract successor)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text", dest="out_format",
                        help="output format; 'json' emits one stable "
                             "versioned object ({\"version\": 1, ..., "
                             "\"rc\": N})")
    parser.add_argument("--ledger", default=None, metavar="PATH",
                        help="longitudinal perf ledger JSONL "
                             "(telemetry/ledger.py): append the run "
                             "under test as a ledger_entry, then gate "
                             "the newest entry of every (leg, config) "
                             "trajectory against its rolling median — "
                             "'perf ledger drift' by name, exit 1")
    parser.add_argument("--ledger-leg", default="report",
                        help="ledger leg name for the appended entry "
                             "(default %(default)s)")
    parser.add_argument("--ledger-window", type=int, default=None,
                        help="rolling-median history depth per "
                             "trajectory (default: the ledger module's)")
    parser.add_argument("--ledger-tol", type=float, default=None,
                        help="relative drift tolerance vs the rolling "
                             "median (default: the ledger module's)")
    parser.add_argument("--no-ledger-append", action="store_true",
                        help="gate the existing trajectory without "
                             "appending the run under test")
    parser.add_argument("--last-run", action="store_true",
                        help="summarize only each artifact's FINAL run "
                             "(append-mode artifacts accumulate runs, "
                             "delimited by run_summary records; blending "
                             "them poisons the medians/maxima the "
                             "regression checks compare)")
    parser.add_argument("--step-tol", type=float,
                        default=DEFAULT_TOLERANCES["step"],
                        help="relative tolerance for step-time p50 and "
                             "throughput (default %(default)s)")
    parser.add_argument("--p95-tol", type=float,
                        default=DEFAULT_TOLERANCES["p95"],
                        help="relative tolerance for step-time p95")
    parser.add_argument("--mfu-tol", type=float,
                        default=DEFAULT_TOLERANCES["mfu"],
                        help="relative tolerance for MFU drop")
    parser.add_argument("--mem-tol", type=float,
                        default=DEFAULT_TOLERANCES["mem"],
                        help="relative tolerance for peak-memory growth")
    parser.add_argument("--grad-tol", type=float,
                        default=DEFAULT_TOLERANCES["grad"],
                        help="relative tolerance for the grad-health "
                             "envelopes (1.0 = 2x the baseline max)")
    args = parser.parse_args(argv)
    baseline = args.baseline_flag or args.baseline
    if args.run is None and not args.ledger:
        parser.error("need a run artifact (or --ledger for a bare "
                     "drift check)")
    if args.run is None and baseline is not None:
        parser.error("a baseline needs a run artifact to diff against")

    for path in filter(None, (args.run, baseline)):
        if not os.path.exists(path):
            print(f"telemetry-report: {path}: no such file")
            return 2
    new = summarize_file(args.run, last_run=args.last_run) \
        if args.run else None
    base = summarize_file(baseline, last_run=args.last_run) \
        if baseline else None
    regressions: list = []
    checks: list = []
    if base is not None and new is not None:
        tolerances = {"step": args.step_tol, "p95": args.p95_tol,
                      "mfu": args.mfu_tol, "mem": args.mem_tol,
                      "grad": args.grad_tol}
        regressions, checks = compare(base, new, tolerances)

    # -- perf ledger gate (telemetry/ledger.py, docs/telemetry.md) ------
    # Append the run under test (one ledger_entry per report run — the
    # trajectory is the point), then gate the NEWEST entry of every
    # (leg, config) trajectory against its rolling median: the named
    # "perf ledger drift" regression a single hand-picked baseline can
    # never catch (a slow drift walks in one in-tolerance step at a
    # time).
    ledger_info = None
    if args.ledger:
        ledger = _load_ledger()
        window = args.ledger_window if args.ledger_window is not None \
            else ledger.DEFAULT_WINDOW
        tol = args.ledger_tol if args.ledger_tol is not None \
            else ledger.DEFAULT_TOLERANCE
        appended = None
        if new is not None and not args.no_ledger_append:
            metrics = ledger.metrics_from_summary(new)
            appended = ledger.append_entry(
                args.ledger, args.ledger_leg, metrics,
                extra={"source": new.get("name") or args.run})
        entries = ledger.read_entries(args.ledger)
        findings = ledger.check_drift(entries, window=window,
                                      tolerance=tol)
        ledger_info = {"path": args.ledger, "entries": len(entries),
                       "appended": appended is not None,
                       "findings": findings}
        for f in findings:
            entry = {
                "metric": f"ledger:{f['leg']}:{f['metric']}",
                "label": "perf ledger drift",
                "base": f["median"], "new": f["latest"],
                "change": f["change"], "tolerance": f["tolerance"],
                "verdict": "regression",
            }
            checks.append(entry)
            regressions.append(entry)

    verdict = "regression" if regressions else "ok"
    rc = 1 if regressions else 0

    if args.out_format == "json":
        # The stable machine contract: one versioned object, rc mirrored inside so a pipe consumer never
        # needs the process exit code.
        combined: dict = {"version": 1, "verdict": verdict,
                          "regressions": regressions, "checks": checks}
        if new is not None:
            combined["run"] = new
        if base is not None:
            combined["baseline"] = base
        if ledger_info is not None:
            combined["ledger"] = ledger_info
        combined["rc"] = rc
        print(json.dumps(combined, indent=2))
        return rc
    if args.json:
        # Legacy shapes, preserved exactly (bench.py parses them); the
        # ledger verdict rides as extra keys only when requested.
        if base is not None:
            out = {"verdict": verdict, "regressions": regressions,
                   "checks": checks, "run": new, "baseline": base}
        else:
            out = {"run": new} if new is not None else {}
            if args.ledger:
                out["verdict"] = verdict
                out["regressions"] = regressions
        if ledger_info is not None:
            out["ledger"] = ledger_info
        print(json.dumps(out))
        return rc

    if base is not None and new is not None:
        print(format_summary(base))
        print(format_summary(new))
        print(f"== regression check (run vs baseline: {verdict})")
        print(format_checks(checks))
    elif new is not None:
        print(format_summary(new))
    if ledger_info is not None:
        state = "DRIFT" if ledger_info["findings"] else "ok"
        print(f"== perf ledger ({ledger_info['path']}: "
              f"{ledger_info['entries']} entries, {state})")
        for f in ledger_info["findings"]:
            print(f"  REGRESSION perf ledger drift: "
                  f"{f['leg']}/{f['metric']} [{f['digest']}]: "
                  f"median {f['median']:g} -> {f['latest']:g} "
                  f"({f['change']:+.1%}, tolerance {f['tolerance']:.0%}, "
                  f"window {f['window']})")
    if regressions:
        names = ", ".join(dict.fromkeys(r["label"] for r in regressions))
        print(f"telemetry-report: REGRESSION in: {names}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
