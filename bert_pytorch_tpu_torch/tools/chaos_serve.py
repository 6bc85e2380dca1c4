#!/usr/bin/env python
"""Fleet chaos harness of the port: kill, wedge, and drain-kill serving
replicas under live traffic — and PROVE no client ever saw it
(docs/serving.md "Fleet tier", docs/fault_tolerance.md "Serve failover").

The port's counterpart of the repo-root ``tools/chaos_serve.py``, phase
for phase, over the port's fleet modules and the port's ``run_server``.
One invocation stands up the real fleet — a :class:`Supervisor` owning N
``python -m bert_pytorch_tpu_torch.run_server`` replica subprocesses
(each finding its CUDA kernel libraries in one shared
``--compile_cache_dir``, built there once under a per-library lock)
behind a :class:`Router` front tier — then drives a closed-loop client
burst through the router while injecting, in sequence:

1. **SIGKILL inside the admission window** — replica 0 is armed with
   ``admit_hold@N`` (testing/faults.py): its pipelined assembler emits
   an injection record and then HOLDS its forming batch open inside
   the admission window; the harness waits for that record and kills
   the replica while requests are provably captive in the forming
   batch (the continuous-batching stage a flush-then-wait server never
   had). The router's transport failures fail over to a different
   replica inside the retry budget; the supervisor reaps the exit and
   respawns with crash backoff; the restarted replica must report
   ``compiles_cold == 0`` (no ``nvcc`` run: the warm-restart property
   is what makes seconds-scale recovery real);
2. **wedged dispatch** — a replica armed with ``BERT_FAULTS=wedge@N``
   hangs its dispatch thread while ``/healthz`` keeps answering 200.
   Only the supervisor's heartbeat watchdog can catch this; meanwhile
   the router's hedged requests keep the stuck replica's traffic inside
   the latency budget until the watchdog kills it;
3. **kill during drain** — SIGTERM (graceful drain) followed by SIGKILL
   mid-drain. Requests the dying replica never answered are retried
   elsewhere; the supervisor classifies the exit as a crash;
4. **SIGKILL mid-swap** (docs/serving.md "Model registry & canary
   rollouts") — the fleet's own init checkpoint is published into a
   model registry, a replica is armed with ``swap_hold@1`` (the fault
   holds the hot-swap open between the new params finishing their load
   and the atomic flip), and the harness SIGKILLs it inside that held
   window under load. The kill must be invisible: zero client
   failures, the respawned replica boots the baseline version (a
   half-applied swap is structurally impossible — the flip either
   happened or it did not), and ``torn_serves`` stays 0 everywhere.
   Then the whole fleet converges onto the published version via the
   supervisor's ``/swapz`` control calls with ZERO cold builds — a
   same-geometry swap reuses the already-built kernel libraries, proven
   by the CompileMonitor's records, never wall clock.

Acceptance, asserted per phase and overall: ZERO client-visible
failures (every request answers 2xx, except explicit brownout sheds —
503 carrying ``Retry-After``); failover latency p95 within
``--failover_tolerance_ms`` (the same number telemetry-report's
"router failover" gate regresses on); the supervisor's restart within
the backoff budget; and every artifact (router/fleet events + each
replica's serve telemetry) schema-clean.

End-to-end tracing acceptance (docs/observability.md "Trace
propagation") rides the same run: the router samples EVERY request
(``trace_sample_rate=1``) while the replicas keep their local head
sampling at 0 — so every serve_trace that appears proves the router's
decision won fleet-wide — and every response (including a replica
probed directly with an unsampled context) must echo
``X-Bert-Trace-Id``. Post-hoc, a :class:`FleetCollector` stitches the
router + replica sinks into one timeline and the harness asserts:
every sampled client request resolves to exactly ONE stitched trace
tree, zero orphan stitches, every complete stitch's decomposition is
``consistent`` (client_total >= router overhead + replica time), the
phase-A failover request's tree shows attempt 1 on the killed replica
chaining to the surviving replica's serve_trace on attempt 2, and
``tools/obs_collect.py --trace <id>`` prints that tree. Finally the
report gates are proven live: a copy of the timeline doctored with a
router-side delay makes ``telemetry-report`` exit 1 naming "router
overhead share" while the clean timeline self-diffs green.

Verdict is one JSON line on stdout; exit 0 = every assertion held.

``--smoke`` is the documented one-command gate (2 replicas, small
bursts). The replicas run on the CUDA card unless ``--device cpu`` is
given; with no model flags they serve the tiny float32 recipe below, and
``--model_config_file``, ``--dtype``, ``--attention_backend``,
``--buckets`` and ``--max_batch_size`` set the replicas' model (the card
runs BERT-large)::

    python bert_pytorch_tpu_torch/tools/chaos_serve.py --smoke --device cpu
    python bert_pytorch_tpu_torch/tools/chaos_serve.py --smoke \
        --model_config_file configs/bert_large_uncased_config.json \
        --dtype bfloat16 --attention_backend flash_infer --buckets 128 \
        --max_batch_size 8

``--profile_s S`` adds one ``POST /profilez`` capture of S seconds on
replica 0 under a steady burst at the end of ``--smoke`` (its
``profile_window``, trace path and the replica's forward and kernel
launch counts before and after land in the verdict's ``profile``); every
mode's verdict carries the final replicas' kernel launch counts and
peak reserved card memory (``kernel_launches``, ``max_reserved_bytes``,
from their ``/statsz``) and the kernel builds of the first replicas
(``first_builds``: misses per library, at most one each).

``--canary`` runs the deployment-plane E2E instead of the kill/wedge
phases: a 2-replica fleet serving version v1, a new version published
into the registry and rolled out 1% -> 50% -> 100% by a live
:class:`RolloutController` (real router splits, real ``/swapz`` hot
swaps, SLO verdicts from the canary cohort's own outcome windows, zero
client-visible failures), followed by a deliberately DEGRADED version
whose first canary window breaches its latency SLO and must
auto-rollback — and the report gate is proven live: the artifact
carrying the breach makes ``telemetry-report`` exit 1 naming "rollout
canary SLO" against the pre-breach baseline, while the baseline
self-diffs green.

``--surge`` runs the elasticity-plane E2E (docs/serving.md "Elastic
fleet"): a 1-replica fleet behind a live :class:`AutoscalerController`,
a closed-loop burst ramping past the replica's brownout ceiling ->
warm scale-up (``compiles_cold == 0`` from the shared build dir) ->
sheds stop and p99 recovers at the same offered load; a SIGKILL lands
mid-surge and is absorbed as the SAME capacity (respawn, not growth);
load drops -> green windows + the down cooldown drain the elastic
replica through the SIGTERM -> rc-75 contract with zero stranded
requests — and the "autoscaler thrash" / "surge client-visible errors"
gates are proven to fire on a seeded artifact.

The parent is deliberately torch-free: supervisor/router/schema load by
FILE PATH (tools/_bootstrap.py), so the parent never takes a CUDA
context or card memory its replicas need, and a hung CUDA call can hang
a REPLICA — which the watchdog kills — never the harness itself.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse

if __package__:
    from bert_pytorch_tpu_torch.tools._bootstrap import (REPO_ROOT,
                                                         load_by_path)
else:
    from _bootstrap import REPO_ROOT, load_by_path

schema = load_by_path("_torchfleet_schema", "telemetry", "schema.py")
supervisor_mod = load_by_path(
    "_torchfleet_supervisor", "serve", "supervisor.py")
router_mod = load_by_path("_torchfleet_router", "serve", "router.py")
collector_mod = load_by_path(
    "_torchfleet_collector", "telemetry", "collector.py")
faults = load_by_path("_torchfleet_faults", "testing", "faults.py")
synth = load_by_path(
    "_torchfleet_synth", "tools", "make_synthetic_data.py")
registry_mod = load_by_path("_torchfleet_registry", "serve", "registry.py")
rollout_mod = load_by_path("_torchfleet_rollout", "serve", "rollout.py")
autoscaler_mod = load_by_path(
    "_torchfleet_autoscaler", "serve", "autoscaler.py")
# The port's own tools, run as subprocesses by the live gate checks.
TOOLS_DIR = os.path.join(REPO_ROOT, "bert_pytorch_tpu_torch", "tools")
# --smoke: sequential requests straight to replica 0, and as many through
# the router, in turns, on the idle fleet (the router's overhead on p50).
OVERHEAD_PROBES = 16


# Tiny fp32 model over the trace vocabulary: the gate's evidence is
# request outcomes and fleet/router records, not model quality — sized
# at the floor that still exercises the full serve path (tokenize ->
# batch -> forward -> postprocess) so replica warmup stays seconds, not
# minutes, on a throttled CPU. ``--model_config_file`` replaces it.
def tiny_model_config() -> dict:
    vocab = 5 + len(synth.TRACE_WORDS)
    vocab += (8 - vocab % 8) % 8
    return {
        "vocab_size": vocab, "hidden_size": 16, "num_hidden_layers": 1,
        "num_attention_heads": 2, "intermediate_size": 32,
        "max_position_embeddings": 32, "type_vocab_size": 2,
        "next_sentence": True, "mask_token_id": 4,
        "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
    }


def model_config(args) -> dict:
    """The replicas' model config: ``--model_config_file``'s, else the
    tiny recipe."""
    if args.model_config_file:
        with open(args.model_config_file) as f:
            return json.load(f)
    return tiny_model_config()


def replica_args(args, workdir: str, max_batch_size: int) -> list:
    """The run_server flags every replica of one scenario shares: the
    model (``--model_config_file``/``--dtype``/``--attention_backend``,
    else the tiny float32 recipe), ``--device``, one classify head over
    the trace vocabulary, and one ``--compile_cache_dir`` under the
    workdir, so the fleet builds each kernel library once."""
    vocab_path = synth.write_trace_vocab(os.path.join(workdir, "vocab.txt"))
    config_path = args.model_config_file
    if not config_path:
        config_path = os.path.join(workdir, "model.json")
        with open(config_path, "w") as f:
            json.dump(tiny_model_config(), f)
    out = [
        "--model_config_file", config_path, "--vocab_file", vocab_path,
        "--tasks", "classify", "--classify_labels", "neg,pos",
        "--buckets", args.buckets,
        "--max_batch_size", str(args.max_batch_size or max_batch_size),
        "--max_wait_ms", "5", "--dtype", args.dtype,
        "--device", args.device,
        "--compile_cache_dir", os.path.join(workdir, "compile_cache"),
        "--trace_sample_rate", "0", "--telemetry_window", "16",
        "--request_timeout_s", "10", "--serving_version", "v1",
    ]
    if args.attention_backend:
        out += ["--attention_backend", args.attention_backend]
    return out


PHRASES = (
    "paris is big", "the river runs through london",
    "william shakespeare wrote hamlet", "england is old",
    "the capital of france is paris", "hamlet was wrote in london",
)


# The surge's CPU replicas sleep this long off the CPU after each forward
# (the slow_forward fault point), a card's fixed service time: replicas on
# one box share its cores, so on a loaded box a second CPU replica added
# too little capacity for p99 to recover above the box's noise.
SURGE_CPU_FORWARD_MS = 50


class ChaosFailure(AssertionError):
    pass


def check(cond, what):
    if not cond:
        raise ChaosFailure(what)


class Sink:
    """Thread-safe schema-v1 JSONL sink + in-memory event index.

    The supervisor's monitor thread and every router request thread emit
    through ``write``; the harness polls ``count`` to sequence phases
    (e.g. "burst until the watchdog's wedged_kill lands"). Deliberately
    local: the package JSONLHandler imports the package chain on first
    write, which would drag torch into this torch-free parent.
    """

    def __init__(self, path: str):
        self._lock = threading.Lock()
        self._f = open(path, "a", encoding="utf-8")
        self.records = []

    def write(self, record: dict) -> None:
        rec = {"schema": schema.SCHEMA_VERSION, "ts": round(time.time(), 3)}
        rec.update(record)
        with self._lock:
            self.records.append(rec)
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def count(self, event: str) -> int:
        with self._lock:
            return sum(1 for r in self.records if r.get("event") == event)

    def close(self) -> None:
        with self._lock:
            self._f.close()


def make_spawn(log_dir: str):
    """A Popen factory that starts each replica from the repo root (the
    ``python -m bert_pytorch_tpu_torch.run_server`` command resolves
    there), strips any leaked fault spec from the inherited environment
    (spec.env re-arms faults deliberately), and tees replica output to a
    per-replica log for post-mortems. The device is the replicas' own
    ``--device`` flag: nothing here falls back to the CPU."""

    def spawn(spec):
        env = dict(os.environ)
        env.pop(faults.FAULTS_ENV, None)
        if spec.env:
            env.update(spec.env)
        with open(os.path.join(log_dir, f"replica_{spec.index}.log"),
                  "ab") as log:
            return subprocess.Popen(spec.cmd, env=env, stdout=log,
                                    stderr=subprocess.STDOUT,
                                    cwd=REPO_ROOT)

    return spawn


# -- the closed-loop client --------------------------------------------------

def drop_flag(cmd: list, flag: str) -> None:
    """Remove ``flag`` and its value from a replica's argv, in place (the
    supervisor spawns every later incarnation from the same list)."""
    if flag in cmd:
        i = cmd.index(flag)
        del cmd[i:i + 2]


def post(url: str, task: str, payload: dict, timeout_s: float,
         extra_headers: dict = None):
    parsed = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(parsed.hostname, parsed.port,
                                      timeout=timeout_s)
    headers = {"Content-Type": "application/json"}
    headers.update(extra_headers or {})
    try:
        conn.request("POST", f"/v1/{task}",
                     body=json.dumps(payload).encode("utf-8"),
                     headers=headers)
        resp = conn.getresponse()
        resp.read()
        return resp.status, dict(resp.getheaders())
    finally:
        conn.close()


def post_path(url: str, path: str, payload: dict, timeout_s: float):
    """POST a JSON control call (``/profilez``) and return (status,
    decoded body)."""
    parsed = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(parsed.hostname, parsed.port,
                                      timeout=timeout_s)
    try:
        conn.request("POST", path, body=json.dumps(payload).encode("utf-8"),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def header(headers: dict, name: str):
    """Case-insensitive response-header lookup (http.client preserves
    whatever case the server sent)."""
    lower = name.lower()
    for key, value in headers.items():
        if key.lower() == lower:
            return value
    return None


def get_json(url: str, path: str, timeout_s: float = 5.0) -> dict:
    """GET an introspection endpoint (/statsz, /healthz) as JSON."""
    parsed = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(parsed.hostname, parsed.port,
                                      timeout=timeout_s)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        check(resp.status == 200, f"GET {path} on {url} -> {resp.status}")
        return json.loads(body)
    finally:
        conn.close()


def get_text(url: str, path: str, timeout_s: float = 5.0) -> str:
    """GET a text endpoint (/metricsz)."""
    parsed = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(parsed.hostname, parsed.port,
                                      timeout=timeout_s)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read().decode("utf-8", "replace")
        check(resp.status == 200, f"GET {path} on {url} -> {resp.status}")
        return body
    finally:
        conn.close()


def run_burst(url: str, total: int, workers: int, timeout_s: float,
              outcomes: list, should_stop=None, mid=None) -> None:
    """Closed-loop burst: ``workers`` threads issue requests until
    ``total`` have been sent (or ``should_stop()`` says enough — the
    wedge phase stops on the watchdog's event, not a count). Each
    outcome is appended to the shared ``outcomes`` list.

    ``mid=(count, callback)`` fires ``callback`` exactly once, from
    whichever worker completes outcome number ``count`` — the fault
    injection is sequenced INSIDE the burst, so it lands mid-flight no
    matter how fast the box drains the request quota."""
    lock = threading.Lock()
    issued = [0]
    mid_fired = [False]

    def worker() -> None:
        while True:
            if should_stop is not None and should_stop():
                return
            with lock:
                if issued[0] >= total:
                    return
                issued[0] += 1
                seq = issued[0]
            payload = {"text": PHRASES[seq % len(PHRASES)]}
            t0 = time.monotonic()
            try:
                status, headers = post(url, "classify", payload, timeout_s)
            except Exception as exc:
                status, headers = None, {
                    "error": f"{type(exc).__name__}: {exc}"}
            fire = False
            with lock:
                outcomes.append({
                    "status": status,
                    "retry_after": headers.get("Retry-After"),
                    # The router's minted trace id, echoed on EVERY
                    # response (sampled or not) — the correlation handle
                    # the post-hoc stitch assertions join on.
                    "trace_id": header(headers, "X-Bert-Trace-Id"),
                    "latency_s": round(time.monotonic() - t0, 4),
                })
                if (mid is not None and not mid_fired[0]
                        and len(outcomes) >= mid[0]):
                    mid_fired[0] = True
                    fire = True
            if fire:
                mid[1]()

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def classify_outcomes(outcomes: list) -> dict:
    """ok / shed / failure decomposition of one burst. A shed is an
    EXPLICIT admission-control answer — 503 carrying Retry-After;
    everything else non-2xx (including the router's own deadline 503,
    which has no Retry-After) is a client-visible failure."""
    ok = shed = 0
    failures = []
    for o in outcomes:
        if o["status"] is not None and 200 <= o["status"] < 300:
            ok += 1
        elif o["status"] == 503 and o.get("retry_after"):
            shed += 1
        else:
            failures.append(o)
    return {"requests": len(outcomes), "ok": ok, "sheds": shed,
            "failures": len(failures), "failure_samples": failures[:5],
            "traced": sum(1 for o in outcomes if o.get("trace_id"))}


def check_traced(outcomes: list, phase: str) -> None:
    """Every ANSWERED request — ok or shed, sampled or not — must carry
    the router's echoed trace id (the correlation contract): the only
    excusable blanks are transport-level failures that never produced a
    response at all."""
    untraced = [o for o in outcomes
                if o["status"] is not None and not o.get("trace_id")]
    check(not untraced,
          f"{phase}: {len(untraced)} answered requests carried no "
          f"X-Bert-Trace-Id response header: {untraced[:3]}")


def wait_until(pred, timeout_s: float, what: str, poll_s: float = 0.25):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(poll_s)
    raise ChaosFailure(f"timed out after {timeout_s:g}s waiting for {what}")


def replica_records(out_dir: str) -> list:
    """Every record of one replica's serve telemetry, in file order
    (every incarnation of the replica appends to the same file)."""
    path = os.path.join(out_dir, "serve_telemetry.jsonl")
    records = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                if line.strip():
                    records.append(json.loads(line))
    return records


def cold_start_records(out_dir: str) -> list:
    return [r for r in replica_records(out_dir)
            if r.get("kind") == "serve_cold_start"]


def first_builds(workdir: str, indices) -> dict:
    """Kernel libraries the FIRST incarnation of each replica built
    (``compile`` records with ``cache: "miss"`` before its first
    ``serve_cold_start``), counted per library across the replicas. The
    shared ``--compile_cache_dir`` and its per-library build lock make
    each count at most 1: one replica runs ``nvcc``, the others wait and
    find the library built."""
    misses: dict = {}
    for idx in indices:
        for rec in replica_records(os.path.join(workdir, f"replica_{idx}")):
            if rec.get("kind") == "serve_cold_start":
                break
            if rec.get("kind") == "compile" and rec.get("cache") == "miss":
                misses[rec["fn"]] = misses.get(rec["fn"], 0) + 1
    check(all(n == 1 for n in misses.values()),
          f"the first replicas built one kernel library more than once "
          f"(the build lock did not hold): {misses}")
    return misses


def replica_counters(urls) -> dict:
    """What the live replicas' ``/statsz`` count of their own process:
    ``kernel_launches``, summed per kernel (launches of the CUDA kernels
    its forwards ran since it started; none on the CPU), and each
    replica's peak reserved card memory (``max_reserved_bytes``, on the
    card only)."""
    launches: dict = {}
    reserved = []
    for url in urls:
        stats = get_json(url, "/statsz")
        for name, n in (stats.get("kernel_launches") or {}).items():
            launches[name] = launches.get(name, 0) + int(n)
        if "cuda_memory" in stats:
            reserved.append(stats["cuda_memory"]["max_reserved_bytes"])
    return {"kernel_launches": launches, "max_reserved_bytes": reserved}


def report_tool() -> str:
    return os.path.join(TOOLS_DIR, "telemetry_report.py")


def lint(path: str) -> None:
    errors = schema.validate_file(path)
    check(errors == [], f"schema lint failed for {path}: {errors[:3]}")


def probe_overhead(router_url: str, replica_url: str, n: int,
                   timeout_s: float) -> dict:
    """``n`` sequential requests straight to one replica and ``n``
    through the router, in turns (replica, router, router, replica, ...),
    on an idle fleet: the p50 of each and their difference, the router's
    overhead on a request."""
    times = {"direct": [], "router": []}
    order = ("direct", "router", "router", "direct")
    for i in range(2 * n):
        which = order[i % 4]
        url = replica_url if which == "direct" else router_url
        t0 = time.monotonic()
        status, _ = post(url, "classify",
                         {"text": PHRASES[i % len(PHRASES)]}, timeout_s)
        check(status == 200, f"overhead probe via {which}: {status}")
        times[which].append(time.monotonic() - t0)
    out = {}
    for which, vals in times.items():
        vals.sort()
        out[f"{which}_p50_ms"] = round(1000.0 * vals[len(vals) // 2], 3)
    out["overhead_p50_ms"] = round(out["router_p50_ms"]
                                   - out["direct_p50_ms"], 3)
    out["probes"] = n
    return out


def profile_under_burst(args, router_url: str, replica_url: str, pid,
                        outcomes: list) -> dict:
    """One ``POST /profilez`` capture of ``--profile_s`` seconds on one
    replica while a steady closed-loop burst runs through the router;
    returns the capture's ``last`` summary (its ``trace_path``: a
    ``torch.profiler`` trace of the replica's forwards) beside the
    replica's ``/statsz`` forward and kernel launch counts read before
    the POST and after the capture was collected, so a reader can hold
    the trace's kernel events to the launches around its window, and
    ``wall_s``: from the POST to the capture seen collected (polled every
    0.25 s), the capture's length plus its start and collection, and
    ``polls_timed_out``: the polls the replica did not answer while it
    collected."""
    before = get_json(replica_url, "/statsz")
    done = before.get("profile", {}).get("captures", 0)
    polls = {"timed_out": 0}

    def collected() -> bool:
        # Stopping the profiler and writing its trace hold the replica's
        # interpreter for seconds on the card (it declares that hold to
        # the watchdog), so a /statsz poll may time out until it is done.
        try:
            stats = get_json(replica_url, "/statsz")
        except OSError:
            polls["timed_out"] += 1
            return False
        return stats.get("profile", {}).get("captures", 0) > done

    stop = {"flag": False}
    burst = threading.Thread(
        target=run_burst,
        args=(router_url, 10**9, args.burst_workers, args.client_timeout_s,
              outcomes),
        kwargs={"should_stop": lambda: stop["flag"]}, daemon=True)
    burst.start()
    t_post = time.monotonic()
    try:
        status, _ = post_path(replica_url, "/profilez",
                              {"duration_s": args.profile_s},
                              args.client_timeout_s)
        check(status == 200, f"POST /profilez answered {status}")
        wait_until(collected, args.profile_s + 60.0, "the capture collected")
        wall_s = round(time.monotonic() - t_post, 2)
    finally:
        stop["flag"] = True
        burst.join(timeout=60.0)
    check(not burst.is_alive(), "the capture's burst never drained")
    after = get_json(replica_url, "/statsz")
    summary = classify_outcomes(outcomes)
    check(summary["failures"] == 0,
          f"the capture's burst saw client-visible failures: {summary}")
    check_traced(outcomes, "capture burst")
    return {"pid": pid, "last": after["profile"]["last"],
            "requests": summary["requests"], "wall_s": wall_s,
            "polls_timed_out": polls["timed_out"],
            "forwards": [before.get("forwards"), after.get("forwards")],
            "kernel_launches": [before.get("kernel_launches"),
                                after.get("kernel_launches")]}


# -- the canary-rollout scenario ---------------------------------------------

def plan_burst(share: float, need: int, next_seq: int,
               minimum: int = 12) -> int:
    """Burst size whose canary-cohort membership yields at least
    ``need`` canary requests starting at router seq ``next_seq``.

    Cohort assignment is DETERMINISTIC — the router hashes its monotone
    request seq (serve/router.py ``_split_hash``) — so the harness can
    size each observation window exactly instead of waiting on luck for
    a 1% cohort to fill it."""
    n = 0
    hits = 0
    seq = next_seq
    while hits < need or n < minimum:
        if router_mod._split_hash(seq) < share:
            hits += 1
        n += 1
        seq += 1
        if n > 50000:
            raise ChaosFailure(
                f"no burst size under 50000 yields {need} canary "
                f"requests at share {share}")
    return n


def run_canary(args) -> int:
    """The deployment-plane E2E: registry publish -> canary swap ->
    SLO-gated 1% -> 50% -> 100% rollout -> promote, then a degraded
    version that must auto-rollback on its first full canary window —
    with zero client-visible failures throughout and the "rollout
    canary SLO" report gate proven to fire on the breach artifact."""
    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_canary_")
    os.makedirs(workdir, exist_ok=True)
    shared_args = replica_args(args, workdir, max_batch_size=4)
    template = supervisor_mod.ReplicaTemplate(shared_args, workdir)
    specs = []
    for i in range(args.replicas):
        extra_args = []
        if i == 0:
            extra_args = ["--save_init_checkpoint",
                          os.path.join(workdir, "init_ckpt")]
        specs.append(template.make_spec(i, extra_args=extra_args))

    fleet_jsonl = os.path.join(workdir, "fleet_telemetry.jsonl")
    sink = Sink(fleet_jsonl)
    sup = supervisor_mod.Supervisor(
        specs, emit=sink.write, spawn=make_spawn(workdir),
        policy=supervisor_mod.RetryPolicy(
            attempts=5, base_delay_s=0.4, max_delay_s=3.0,
            full_jitter=True),
        heartbeat_timeout_s=5.0,
        startup_grace_s=args.warmup_timeout_s,
        stable_reset_s=15.0, poll_interval_s=0.25, drain_grace_s=15.0)
    router = router_mod.Router(
        [s.url for s in specs], emit=sink.write, window=32,
        scrape_interval_s=0.25,
        deadline_s=args.router_deadline_s,
        retry_policy=router_mod.RetryPolicy(
            attempts=3, base_delay_s=0.05, max_delay_s=0.5,
            full_jitter=True),
        hedge_pctl=0.95, hedge_min_ms=30.0, hedge_min_samples=24,
        brownout_queue_depth=64, shed_retry_after_s=0.5,
        trace_sample_rate=1.0)
    router_server = router_mod.make_router_server(router, port=0)
    router_url = "http://%s:%d" % router_server.server_address[:2]

    t_start = time.monotonic()
    verdict = {"metric": "chaos_serve_canary_rollout",
               "workdir": workdir, "replicas": args.replicas,
               "router_url": router_url}
    canary_idx = args.replicas - 1

    def next_seq() -> int:
        # The router is in-process and quiescent between bursts, and
        # _mint_trace hands out the CURRENT counter value before
        # post-incrementing — so _trace_seq is exactly the next
        # request's cohort-hash input.
        return router._trace_seq

    def scrape_torn() -> int:
        total = 0
        for s in specs:
            try:
                total += int(get_json(s.url, "/statsz")
                             .get("torn_serves", 0))
            except (OSError, ValueError, ChaosFailure):
                pass
        return total

    def router_sees(idx: int, version: str) -> bool:
        return any(r["url"].endswith(f":{specs[idx].port}")
                   and r.get("version") == version and r["healthy"]
                   for r in router.snapshot()["replica_states"])

    def burst(n: int) -> dict:
        outcomes: list = []
        run_burst(router_url, n, args.burst_workers,
                  args.client_timeout_s, outcomes)
        summary = classify_outcomes(outcomes)
        check(summary["failures"] == 0,
              f"canary-mode burst saw client-visible failures: "
              f"{summary}")
        check_traced(outcomes, "canary burst")
        return summary

    try:
        sup.start()
        router.start()
        threading.Thread(target=router_server.serve_forever,
                         daemon=True).start()
        wait_until(lambda: router.healthy_count() == args.replicas,
                   args.warmup_timeout_s,
                   f"all {args.replicas} replicas healthy")
        verdict["startup_s"] = round(time.monotonic() - t_start, 2)
        verdict["first_builds"] = first_builds(workdir,
                                               range(args.replicas))

        # -- publish: the fleet's own init params become the registry's
        # versions (same geometry — the zero-compile swap property is
        # part of what this scenario proves).
        reg = registry_mod.ModelRegistry(
            os.path.join(workdir, "registry"), emit=sink.write)
        ckpt_src = os.path.join(workdir, "init_ckpt", "ckpt_0.msgpack")
        check(os.path.isfile(ckpt_src),
              "replica 0 wrote no init checkpoint "
              "(--save_init_checkpoint)")

        def publish(version: str) -> str:
            path = os.path.join(workdir, f"published_{version}.msgpack")
            shutil.copyfile(ckpt_src, path)
            reg.publish(version, task="classify", checkpoint=path,
                        geometry=registry_mod.geometry_from_config(
                            model_config(args)))
            return path

        publish("v1")
        reg.begin_canary("v1")
        reg.promote("v1")   # the audit trail starts at the booted truth
        ckpt_v2 = publish("v2")

        # -- happy path: v2 rolls 1% -> 50% -> 100% ---------------------
        info = sup.swap_replica(canary_idx, "classify", ckpt_v2, "v2")
        check(info.get("compiles_cold") == 0,
              f"canary-replica swap recompiled: {info}")
        swap_load_s = [info.get("load_s", 0.0)]
        wait_until(lambda: router_sees(canary_idx, "v2"), 15.0,
                   "router scrape to learn the canary replica's version")

        min_window = 3
        promoted = {"swapped": False}

        def on_promote() -> None:
            infos = sup.swap_all("classify", ckpt_v2, "v2",
                                 skip_indices=(canary_idx,))
            for i in infos:
                check(i.get("compiles_cold") == 0,
                      f"promote-swap recompiled: {i}")
                swap_load_s.append(i.get("load_s", 0.0))
            promoted["swapped"] = True

        ctrl = rollout_mod.RolloutController(
            router, reg, "classify", "v2",
            stages=(0.01, 0.50, 1.0),
            min_window_requests=min_window,
            green_windows_to_advance=1,
            error_budget=0.02,
            emit=sink.write, on_promote=on_promote,
            scrape_torn=scrape_torn)
        ctrl.start()
        windows = []
        for _ in range(8):
            status = ctrl.status()
            if status["state"] != "canary":
                break
            burst(plan_burst(status["share"], min_window, next_seq()))
            rec = ctrl.observe()
            windows.append({k: rec.get(k) for k in (
                "stage", "canary_share", "window_requests", "ok",
                "errors", "slo_ok", "action")})
            check(rec["action"] != "rollback",
                  f"happy-path rollout rolled back: {rec}")
        verdict["happy_windows"] = windows
        check(ctrl.status()["state"] == "promoted",
              f"rollout never promoted: {ctrl.status()} "
              f"(windows: {windows})")
        check(promoted["swapped"],
              "promotion never swapped the rest of the fleet")
        check(reg.get("v2")["state"] == "live",
              f"v2 not live after promote: {reg.get('v2')['state']}")
        check(reg.get("v1")["state"] == "retired",
              f"promote did not retire v1: {reg.get('v1')['state']}")
        for i in range(args.replicas):
            st = get_json(specs[i].url, "/statsz")
            check(st.get("version") == "v2",
                  f"replica {i} did not converge onto v2: "
                  f"{st.get('version')!r}")
        check(router.split_window() is None,
              "the split survived the promotion")

        # -- per-version counters: /metricsz and /statsz must render
        # the same snapshot (the no-drift contract).
        snap = router.snapshot()
        vreq = snap.get("version_requests") or {}
        check(vreq.get("v2", 0) > 0,
              f"router counted no v2 requests: {vreq}")
        metrics = get_text(router_url, "/metricsz")
        for version, count in sorted(vreq.items()):
            line = (f'bert_router_version_requests'
                    f'{{version="{version}"}} {count}')
            check(line in metrics,
                  f"/metricsz disagrees with the snapshot: missing "
                  f"{line!r}")
        stats = get_json(router_url, "/statsz")
        check(stats.get("version_requests") == vreq,
              f"/statsz version counters drifted from the snapshot: "
              f"{stats.get('version_requests')} != {vreq}")
        verdict["version_requests"] = vreq

        # -- degraded leg: v3 must breach and auto-rollback -------------
        ckpt_v3 = publish("v3")
        sup.swap_replica(canary_idx, "classify", ckpt_v3, "v3")
        wait_until(lambda: router_sees(canary_idx, "v3"), 15.0,
                   "router scrape to learn the degraded version")
        # The report gate's comparison point: everything up to (not
        # including) the breach.
        baseline_jsonl = os.path.join(
            workdir, "fleet_telemetry.baseline.jsonl")
        shutil.copyfile(fleet_jsonl, baseline_jsonl)

        rolled = {"reason": None}

        def on_rollback(reason: str) -> None:
            rolled["reason"] = reason
            sup.swap_replica(canary_idx, "classify", ckpt_v2, "v2")

        ctrl2 = rollout_mod.RolloutController(
            router, reg, "classify", "v3",
            stages=(0.01, 0.50, 1.0),
            min_window_requests=2, green_windows_to_advance=1,
            # An unmeetable latency SLO stands in for a degraded model:
            # the first full canary window MUST breach.
            slo_p95_ms=0.001, error_budget=0.5,
            emit=sink.write, on_rollback=on_rollback,
            scrape_torn=scrape_torn)
        ctrl2.start()
        burst(plan_burst(0.01, 2, next_seq()))
        rec = ctrl2.observe()
        verdict["degraded_window"] = {k: rec.get(k) for k in (
            "action", "slo_ok", "reason", "window_requests")}
        check(rec["action"] == "rollback" and rec["slo_ok"] is False,
              f"degraded canary did not roll back: {rec}")
        check("p95" in (rec.get("reason") or ""),
              f"rollback reason does not name the breached SLO: {rec}")
        check(ctrl2.status()["state"] == "rolled_back",
              f"controller not terminal after rollback: "
              f"{ctrl2.status()}")
        check(rolled["reason"], "on_rollback never fired")
        check(reg.get("v3")["state"] == "staged",
              f"v3 not rolled back to staged: {reg.get('v3')['state']}")
        check(router.split_window() is None,
              "the split survived the rollback")
        wait_until(lambda: router_sees(canary_idx, "v2"), 15.0,
                   "canary replica swapped back to v2 after rollback")
        burst(12)   # the fleet still serves, on the old version
        torn = scrape_torn()
        check(torn == 0, f"torn-model serves recorded: {torn}")
        verdict["torn_serves"] = torn
        verdict["swap_load_s"] = swap_load_s
        verdict.update(replica_counters([s.url for s in specs]))
        # Every watchdog kill of the run: none here, where no replica is
        # armed to wedge — a warming or swapping replica is never wedged.
        verdict["wedged_kills"] = sink.count("wedged_kill")
        check(verdict["wedged_kills"] == 0,
              f"the watchdog killed an unwedged replica: "
              f"{verdict['wedged_kills']} wedged_kill events")

        # -- teardown + artifacts ---------------------------------------
        drain = sup.stop()
        router_server.shutdown()
        router.stop()
        check(drain["drain_killed"] == 0,
              f"a replica ignored the drain SIGTERM: {drain}")
        sink.close()
        lint(fleet_jsonl)
        lint(baseline_jsonl)
        for i in range(args.replicas):
            lint(os.path.join(workdir, f"replica_{i}",
                              "serve_telemetry.jsonl"))

        # -- the report gate, proven live -------------------------------
        # The artifact carrying the breach must trip "rollout canary
        # SLO" against the pre-breach baseline; the baseline self-diffs
        # green (the gate is proven to FIRE, not just to exist).
        bad = subprocess.run(
            [sys.executable, report_tool(), fleet_jsonl, baseline_jsonl],
            capture_output=True, text=True)
        check(bad.returncode == 1
              and "rollout canary SLO" in bad.stdout,
              f"the canary breach did not trip the 'rollout canary "
              f"SLO' gate (rc {bad.returncode}):\n{bad.stdout}")
        clean = subprocess.run(
            [sys.executable, report_tool(), baseline_jsonl,
             baseline_jsonl],
            capture_output=True, text=True)
        check(clean.returncode == 0,
              f"pre-breach baseline failed its own self-diff (rc "
              f"{clean.returncode}):\n{clean.stdout}")
        verdict["report_gate"] = {"breach_rc": bad.returncode,
                                  "clean_rc": clean.returncode}

        verdict.update(ok=True,
                       wall_s=round(time.monotonic() - t_start, 1))
        print(json.dumps(verdict))
        if not args.workdir:
            shutil.rmtree(workdir, ignore_errors=True)
        return 0
    except (ChaosFailure, OSError, ValueError, KeyError,
            RuntimeError) as exc:
        verdict.update(ok=False, error=f"{type(exc).__name__}: {exc}")
        try:
            sup.stop()
            router_server.shutdown()
            router.stop()
        except Exception:
            pass
        print(json.dumps(verdict))
        print(f"chaos_serve --canary: FAILED — artifacts kept in "
              f"{workdir}", file=sys.stderr)
        return 1


# -- the surge (elastic capacity) scenario -----------------------------------

def run_surge(args) -> int:
    """The elasticity-plane E2E (docs/serving.md "Elastic fleet"): a
    1-replica fleet behind the router, driven by a live
    :class:`AutoscalerController`.

    Sequence: a closed-loop burst ramps past the seed replica's
    capacity (a deliberately LOW brownout ceiling makes "past capacity"
    mean explicit sheds, deterministically, on any box) -> the
    controller's red windows accumulate and it scales up -> the elastic
    replica finds its kernel libraries built in the shared
    ``--compile_cache_dir`` (``compiles_cold == 0``, its compile records
    are the authority) -> sheds stop and p99
    recovers at the SAME offered load. A SIGKILL lands mid-surge on the
    seed replica: its respawn is the same capacity, never growth (the
    membership chain lint would catch a double-count) and must not
    block correctness. Load then drops to a trickle -> green windows +
    the down cooldown -> scale-down drains the ELASTIC replica through
    the SIGTERM -> rc-75 contract (reaped without respawn, router
    target removed only after the supervisor confirms) with the trickle
    still being answered — zero stranded requests. Zero client-visible
    failures across every phase, and both elasticity report gates
    ("autoscaler thrash", "surge client-visible errors") are proven to
    FIRE on a seeded artifact while the real one self-diffs green.

    The harness drives ``ctrl.tick()`` itself instead of ``start()`` —
    phase boundaries stay deterministic, and every verdict lands in the
    same sink the lint replays."""
    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_surge_")
    os.makedirs(workdir, exist_ok=True)
    shared_args = replica_args(args, workdir, max_batch_size=2)
    forward_ms = SURGE_CPU_FORWARD_MS if args.device == "cpu" else 0
    template = supervisor_mod.ReplicaTemplate(
        shared_args, workdir,
        env=({faults.FAULTS_ENV: f"slow_forwardx{forward_ms}"}
             if forward_ms else None))
    specs = [template.make_spec(0)]

    fleet_jsonl = os.path.join(workdir, "fleet_telemetry.jsonl")
    sink = Sink(fleet_jsonl)
    sup = supervisor_mod.Supervisor(
        specs, emit=sink.write, spawn=make_spawn(workdir),
        policy=supervisor_mod.RetryPolicy(
            attempts=5, base_delay_s=0.4, max_delay_s=3.0,
            full_jitter=True),
        heartbeat_timeout_s=5.0,
        startup_grace_s=args.warmup_timeout_s,
        stable_reset_s=15.0, poll_interval_s=0.25, drain_grace_s=15.0)
    router = router_mod.Router(
        [s.url for s in specs], emit=sink.write, window=32,
        scrape_interval_s=0.2,
        deadline_s=args.router_deadline_s,
        retry_policy=router_mod.RetryPolicy(
            attempts=3, base_delay_s=0.05, max_delay_s=0.5,
            full_jitter=True),
        # Hedging off (unreachable sample floor): hedges ADD load, and
        # this scenario needs the offered load to be exactly what the
        # burst issues so "past one replica's capacity" is the
        # brownout ceiling, nothing else.
        hedge_pctl=0.95, hedge_min_ms=30.0, hedge_min_samples=10**6,
        brownout_queue_depth=args.surge_brownout_depth,
        shed_retry_after_s=0.2,
        trace_sample_rate=1.0)
    router_server = router_mod.make_router_server(router, port=0)
    router_url = "http://%s:%d" % router_server.server_address[:2]

    # The control loop under test. Signals are the router's own
    # windowed deltas (sheds/errors/requests + the scraped unfinished
    # gauge); the /statsz phases probe (queue-wait share, budget burn)
    # is a RUN-LEVEL rollup — cumulative, so a post-surge fleet would
    # never read "idle" again — and is exercised by the fake-fleet
    # units instead.
    fleet = autoscaler_mod.ElasticFleet(sup, router, template)
    signals = autoscaler_mod.RouterSignals(router)
    ctrl = autoscaler_mod.AutoscalerController(
        fleet, signals,
        min_replicas=1, max_replicas=2,
        red_windows_to_scale_up=2,
        green_windows_to_scale_down=4,
        up_cooldown_s=2.0, down_cooldown_s=args.surge_down_cooldown_s,
        min_window_requests=4,
        unfinished_high_per_replica=float(args.surge_brownout_depth),
        unfinished_low_per_replica=2.0,
        emit=sink.write)

    t_start = time.monotonic()
    verdict = {"metric": "chaos_serve_surge", "workdir": workdir,
               "router_url": router_url}

    def tick_until(pred, timeout_s: float, what: str,
                   tick_s: float = 0.3) -> None:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            ctrl.tick()
            if pred():
                return
            time.sleep(tick_s)
        raise ChaosFailure(
            f"timed out after {timeout_s:g}s waiting for {what} "
            f"(controller: {ctrl.status()})")

    def p99_ok_latency(outcomes: list):
        oks = sorted(o["latency_s"] for o in outcomes
                     if o["status"] is not None
                     and 200 <= o["status"] < 300)
        if not oks:
            return None
        return oks[min(len(oks) - 1, int(0.99 * len(oks)))]

    try:
        sup.start()
        router.start()
        threading.Thread(target=router_server.serve_forever,
                         daemon=True).start()
        wait_until(lambda: router.healthy_count() == 1,
                   args.warmup_timeout_s, "the seed replica healthy")
        verdict["startup_s"] = round(time.monotonic() - t_start, 2)
        verdict["first_builds"] = first_builds(workdir, [0])
        verdict["forward_ms"] = forward_ms

        # -- phase 1: surge past one replica's capacity -> scale up -----
        surge_stop = {"flag": False}
        outcomes_surge: list = []
        burst_thread = threading.Thread(
            target=run_burst,
            args=(router_url, 10**9, args.surge_workers,
                  args.client_timeout_s, outcomes_surge),
            kwargs={"should_stop": lambda: surge_stop["flag"]},
            daemon=True)
        burst_thread.start()
        tick_until(lambda: ctrl.status()["scale_ups"] >= 1,
                   args.recover_timeout_s,
                   "the controller to scale up under the surge")
        t_scale_up = time.monotonic()
        tick_until(lambda: router.healthy_count() == 2,
                   args.recover_timeout_s,
                   "the elastic replica healthy behind the router")
        # Scale-up decision -> the elastic replica healthy behind the
        # router (spawn, warm start, first clean scrape).
        verdict["scale_up_s"] = round(time.monotonic() - t_scale_up, 2)
        elastic_idx = max(st["replica"] for st in sup.status())
        check(elastic_idx >= 1,
              f"scale-up minted no fresh replica index: {sup.status()}")

        # The warm-elasticity acceptance: the elastic replica found every
        # kernel library built in the shared --compile_cache_dir — ZERO
        # cold builds, by its compile records, never wall clock. This is
        # the property that makes reactive scaling viable at all.
        colds = cold_start_records(
            os.path.join(workdir, f"replica_{elastic_idx}"))
        check(colds, f"elastic replica {elastic_idx} emitted no "
                     f"serve_cold_start record")
        verdict["elastic_compiles_cold"] = colds[-1]["compiles_cold"]
        check(colds[-1]["compiles_cold"] == 0,
              f"elastic replica compiled cold: {colds[-1]}")

        # -- phase 2: SIGKILL mid-surge — same capacity, never growth ---
        seed = sup.status()[0]
        check(seed["pid"], "seed replica has no pid mid-surge")
        os.kill(seed["pid"], signal.SIGKILL)
        # Wait for the RESPAWN (the restart counter moves), not just for
        # a RUNNING state and two healthy targets: right after the kill
        # neither the supervisor's poll nor the router's scrape has seen
        # the death yet, and the stale state would satisfy that test.
        tick_until(
            lambda: sup.status()[0]["restarts"] > seed["restarts"]
            and sup.status()[0]["state"] == supervisor_mod.RUNNING
            and router.healthy_count() == 2,
            args.recover_timeout_s,
            "the SIGKILLed seed replica respawned and healthy")
        check(ctrl.status()["scale_downs"] == 0,
              "the mid-surge SIGKILL triggered a scale-down: "
              f"{ctrl.status()}")

        surge_stop["flag"] = True
        burst_thread.join(timeout=60.0)
        check(not burst_thread.is_alive(), "surge burst never drained")
        phase_surge = classify_outcomes(outcomes_surge)
        verdict["phase_surge"] = phase_surge
        check(phase_surge["failures"] == 0,
              f"surge phase: client-visible failures: {phase_surge}")
        check(phase_surge["sheds"] > 0,
              "the surge never shed — the burst did not ramp past one "
              "replica's capacity (lower --surge_brownout_depth or "
              "raise --surge_workers)")
        check_traced(outcomes_surge, "surge")
        p99_surge = p99_ok_latency(outcomes_surge)

        # -- phase 3: same offered load, doubled capacity ---------------
        outcomes_post: list = []
        post_thread = threading.Thread(
            target=run_burst,
            args=(router_url, args.surge_recovery_requests,
                  args.surge_workers, args.client_timeout_s,
                  outcomes_post),
            daemon=True)
        post_thread.start()
        while post_thread.is_alive():
            ctrl.tick()     # the loop keeps running; no thrash allowed
            time.sleep(0.3)
        post_thread.join()
        phase_post = classify_outcomes(outcomes_post)
        verdict["phase_post"] = phase_post
        check(phase_post["failures"] == 0,
              f"post-scale phase: client-visible failures: {phase_post}")
        check(phase_post["sheds"] == 0,
              f"sheds did not stop after the scale-up: {phase_post}")
        check_traced(outcomes_post, "post-scale")
        p99_post = p99_ok_latency(outcomes_post)
        verdict["p99_surge_s"] = p99_surge
        verdict["p99_post_s"] = p99_post
        check(p99_surge is not None and p99_post is not None,
              "no ok-latency percentile to compare")
        check(p99_post < p99_surge,
              f"p99 did not recover after the scale-up: "
              f"{p99_post:.3f}s >= {p99_surge:.3f}s")

        # -- phase 4: load drops -> graceful scale-down under traffic ---
        trickle_stop = {"flag": False}
        outcomes_trickle: list = []
        trickle_thread = threading.Thread(
            target=run_burst,
            args=(router_url, 10**9, 1, args.client_timeout_s,
                  outcomes_trickle),
            kwargs={"should_stop": lambda: trickle_stop["flag"]},
            daemon=True)
        trickle_thread.start()
        tick_until(lambda: ctrl.status()["scale_downs"] >= 1,
                   args.recover_timeout_s,
                   "green windows + down cooldown to trigger scale-down")
        tick_until(lambda: router.replica_count() == 1,
                   args.recover_timeout_s,
                   "the drain to complete and the router target removed")
        trickle_stop["flag"] = True
        trickle_thread.join(timeout=60.0)
        phase_trickle = classify_outcomes(outcomes_trickle)
        verdict["phase_trickle"] = phase_trickle
        check(phase_trickle["failures"] == 0,
              f"scale-down stranded requests (client-visible failures "
              f"during the drain): {phase_trickle}")
        check_traced(outcomes_trickle, "trickle")

        # The drain contract: the ELASTIC replica (highest index) exits
        # EXIT_PREEMPTED on SIGTERM, is reaped WITHOUT respawn, and its
        # slot stays retired.
        drains = [r for r in sink.records
                  if r.get("event") == "drain_complete"]
        check(drains, "no drain_complete fleet_event recorded")
        check(drains[-1].get("replica") == elastic_idx,
              f"scale-down drained the wrong replica: {drains[-1]} "
              f"(expected the elastic replica {elastic_idx})")
        check(drains[-1].get("rc") == supervisor_mod.EXIT_PREEMPTED,
              f"drained replica did not exit EXIT_PREEMPTED: "
              f"{drains[-1]} (the run_server preemption contract)")
        st = next(s for s in sup.status()
                  if s["replica"] == elastic_idx)
        check(st["state"] == supervisor_mod.STOPPED and st["draining"],
              f"drained replica not reaped as a retired slot: {st}")

        # -- the membership + hysteresis verdicts -----------------------
        ctrl_status = ctrl.status()
        verdict["controller"] = ctrl_status
        check(ctrl_status["thrash"] == 0,
              f"autoscaler thrash recorded: {ctrl_status}")
        check(ctrl_status["scale_ups"] == 1
              and ctrl_status["scale_downs"] == 1,
              f"expected exactly one scale-up and one scale-down: "
              f"{ctrl_status}")
        scale_events = [r for r in sink.records
                        if r.get("kind") == "scale_event"]
        check(scale_events, "the controller emitted no scale_event")
        check(max(int(r["replicas_after"]) for r in scale_events) <= 2,
              "a scale_event reports capacity above the band — the "
              f"SIGKILL respawn was double-counted: {scale_events}")
        check(all(int(r.get("exogenous", 0)) == 0
                  for r in scale_events),
              "unexplained exogenous membership drift — the SIGKILL "
              "respawn was double-counted as capacity change: "
              f"{[r for r in scale_events if r.get('exogenous')]}")

        verdict.update(replica_counters(
            [st["url"] for st in sup.status()
             if st["state"] == supervisor_mod.RUNNING]))
        verdict["wedged_kills"] = sink.count("wedged_kill")
        check(verdict["wedged_kills"] == 0,
              f"the watchdog killed an unwedged replica: "
              f"{verdict['wedged_kills']} wedged_kill events")

        # -- teardown + artifacts ---------------------------------------
        drain = sup.stop()
        router_server.shutdown()
        router.stop()
        check(drain["drain_killed"] == 0,
              f"a replica ignored the drain SIGTERM: {drain}")
        sink.close()
        # validate_file replays the scale_event membership chain — the
        # "reconstructible from the event stream" acceptance rides this
        # lint, not just the in-memory asserts above.
        lint(fleet_jsonl)
        for idx in sorted({s["replica"] for s in sup.status()}):
            lint(os.path.join(workdir, f"replica_{idx}",
                              "serve_telemetry.jsonl"))

        # -- both elasticity report gates, proven live ------------------
        # A copy of the artifact seeded with one impossible record — a
        # direction flip inside its cooldown window that also carries
        # client-visible errors — must make telemetry-report exit 1
        # naming BOTH gates, while the clean artifact self-diffs green.
        breach_path = os.path.join(
            workdir, "fleet_telemetry.breach.jsonl")
        shutil.copyfile(fleet_jsonl, breach_path)
        with open(breach_path, "a", encoding="utf-8") as f:
            f.write(json.dumps({
                "schema": schema.SCHEMA_VERSION,
                "ts": round(time.time(), 3),
                "kind": "scale_event", "tag": "autoscale",
                "decision": "scale_up",
                "reason": "red_windows:sheds=3",
                "replicas_before": 1, "replicas_after": 2,
                "exogenous": 0, "healthy": 1, "reds": 2, "greens": 0,
                "window_requests": 9, "window_errors": 3,
                "window_sheds": 3,
                "cooldown_s": 2.0, "since_last_scale_s": 0.1}) + "\n")
        bad = subprocess.run(
            [sys.executable, report_tool(), breach_path, fleet_jsonl],
            capture_output=True, text=True)
        check(bad.returncode == 1
              and "autoscaler thrash" in bad.stdout
              and "surge client-visible errors" in bad.stdout,
              f"the seeded violation did not trip both elasticity "
              f"gates (rc {bad.returncode}):\n{bad.stdout}")
        clean = subprocess.run(
            [sys.executable, report_tool(), fleet_jsonl, fleet_jsonl],
            capture_output=True, text=True)
        check(clean.returncode == 0,
              f"clean surge artifact failed its own self-diff (rc "
              f"{clean.returncode}):\n{clean.stdout}")
        verdict["report_gate"] = {"breach_rc": bad.returncode,
                                  "clean_rc": clean.returncode}

        verdict.update(ok=True,
                       wall_s=round(time.monotonic() - t_start, 1))
        print(json.dumps(verdict))
        if not args.workdir:
            shutil.rmtree(workdir, ignore_errors=True)
        return 0
    except (ChaosFailure, OSError, ValueError, KeyError,
            RuntimeError) as exc:
        verdict.update(ok=False, error=f"{type(exc).__name__}: {exc}")
        try:
            sup.stop()
            router_server.shutdown()
            router.stop()
        except Exception:
            pass
        print(json.dumps(verdict))
        print(f"chaos_serve --surge: FAILED — artifacts kept in "
              f"{workdir}", file=sys.stderr)
        return 1


# -- the scenario ------------------------------------------------------------

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="replica kill/wedge/drain-kill chaos harness for the "
                    "serving fleet tier")
    parser.add_argument("--smoke", action="store_true",
                        help="the one-command local gate: 2 replicas, "
                             "small bursts, tier-1-budget-sized")
    parser.add_argument("--canary", action="store_true",
                        help="run the deployment-plane E2E (registry "
                             "publish + SLO-gated 1%%->50%%->100%% "
                             "rollout + degraded-version auto-rollback) "
                             "instead of the kill/wedge phases")
    parser.add_argument("--surge", action="store_true",
                        help="run the elasticity-plane E2E (autoscaler "
                             "scale-up under a shedding surge, SIGKILL "
                             "mid-surge, graceful rc-75 scale-down) "
                             "instead of the kill/wedge phases")
    parser.add_argument("--surge_workers", type=int, default=10,
                        help="closed-loop client threads for the surge "
                             "burst (must overwhelm ONE replica's "
                             "brownout ceiling, not two)")
    parser.add_argument("--surge_brownout_depth", type=int, default=9,
                        help="router brownout queue ceiling per replica "
                             "in surge mode — the definition of one "
                             "replica's capacity. One below "
                             "--surge_workers: the overloaded replica "
                             "admits 9 requests (5 batches of 2) where "
                             "each of two admits 5 (3 batches) after the "
                             "scale-up; at 6 it admitted 6, and p99 "
                             "recovered by half a batch only, inside a "
                             "loaded box's noise. A shed needs every "
                             "worker on one replica at once, which a "
                             "surge of a few seconds meets tens of "
                             "times; with 12 workers the harness's own "
                             "shed-and-retry load hid the recovery")
    parser.add_argument("--surge_recovery_requests", type=int, default=60,
                        help="burst size for the post-scale-up recovery "
                             "phase (same worker count as the surge)")
    parser.add_argument("--surge_down_cooldown_s", type=float, default=6.0,
                        help="the controller's scale-down cooldown in "
                             "surge mode (the slow, cautious direction)")
    parser.add_argument("--replicas", type=int, default=2)
    parser.add_argument("--burst_workers", type=int, default=4)
    parser.add_argument("--phase_a_requests", type=int, default=None,
                        help="burst size for the SIGKILL phase "
                             "(default 60; 50 under --smoke)")
    parser.add_argument("--phase_c_requests", type=int, default=30)
    parser.add_argument("--phase_d_requests", type=int, default=24,
                        help="burst size for the SIGKILL-mid-swap phase")
    parser.add_argument("--wedge_at", type=int, default=100,
                        help="requests the wedge replica serves before "
                             "its dispatch thread hangs (BERT_FAULTS "
                             "wedge@N; must exceed its phase-A share)")
    parser.add_argument("--wedge_cap_requests", type=int, default=600,
                        help="phase-B safety cap: the wedge MUST fire "
                             "before this many burst requests")
    parser.add_argument("--router_deadline_s", type=float, default=8.0)
    parser.add_argument("--failover_tolerance_ms", type=float, default=8000.0,
                        help="failover-latency p95 budget — the same "
                             "tolerance telemetry-report's 'router "
                             "failover' gate regresses on")
    parser.add_argument("--warmup_timeout_s", type=float, default=240.0)
    parser.add_argument("--recover_timeout_s", type=float, default=120.0,
                        help="budget for a killed replica to be respawned "
                             "AND healthy again (backoff + warm start)")
    parser.add_argument("--client_timeout_s", type=float, default=15.0)
    parser.add_argument("--workdir", type=str, default="",
                        help="keep artifacts here (default: a fresh temp "
                             "dir, removed on success)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the replicas' torch device: cuda (default; "
                             "a replica raises without a card) or cpu")
    parser.add_argument("--model_config_file", type=str, default="",
                        help="the replicas' model config (default: the "
                             "tiny float32 recipe)")
    parser.add_argument("--dtype", type=str, default="float32",
                        help="the replicas' --dtype")
    parser.add_argument("--attention_backend", type=str, default="",
                        help="the replicas' --attention_backend (default: "
                             "run_server's)")
    parser.add_argument("--buckets", type=str, default="16",
                        help="the replicas' --buckets")
    parser.add_argument("--max_batch_size", type=int, default=None,
                        help="the replicas' --max_batch_size (default 4; "
                             "2 under --surge)")
    parser.add_argument("--profile_s", type=float, default=0.0,
                        help="--smoke: seconds of one POST /profilez "
                             "capture on replica 0 under a steady burst "
                             "at the end (0: none)")
    args = parser.parse_args(argv)
    args.phase_a_requests = args.phase_a_requests or (
        50 if args.smoke else 60)
    if args.canary:
        return run_canary(args)
    if args.surge:
        return run_surge(args)

    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_serve_")
    os.makedirs(workdir, exist_ok=True)

    # One ReplicaSpec per replica: shared model/cache flags, its own
    # port + output dir (telemetry JSONL and the heartbeat file the
    # supervisor watches live under it). The LAST replica is armed with
    # the wedge fault — it hangs only after serving --wedge_at requests,
    # so phases A (SIGKILL) and B (wedge) stay sequenced. Replica 0 is
    # armed with admit_hold@2x6: on its SECOND formed batch the
    # assembler emits the injection record and holds the admission
    # window open for 6s — the cue (and the window) for phase A's
    # SIGKILL-with-requests-in-the-forming-batch.
    shared_args = replica_args(args, workdir, max_batch_size=4)
    template = supervisor_mod.ReplicaTemplate(shared_args, workdir)
    specs = []
    for i in range(args.replicas):
        env = {}
        extra_args = []
        if i == args.replicas - 1:
            env[faults.FAULTS_ENV] = f"wedge@{args.wedge_at}"
        elif i == 0:
            env[faults.FAULTS_ENV] = "admit_hold@2x6"
        if i == 0:
            # Replica 0 writes its freshly-initialized params as a real
            # msgpack checkpoint before serving — the blob phase D
            # publishes into the registry and swaps the fleet to (the
            # torch-free parent can't produce one itself).
            extra_args = ["--save_init_checkpoint",
                          os.path.join(workdir, "init_ckpt")]
        specs.append(template.make_spec(i, extra_args=extra_args, env=env))

    sink = Sink(os.path.join(workdir, "fleet_telemetry.jsonl"))
    sup = supervisor_mod.Supervisor(
        specs, emit=sink.write, spawn=make_spawn(workdir),
        policy=supervisor_mod.RetryPolicy(
            attempts=5, base_delay_s=0.4, max_delay_s=3.0,
            full_jitter=True),
        heartbeat_timeout_s=5.0,
        startup_grace_s=args.warmup_timeout_s,
        stable_reset_s=15.0, poll_interval_s=0.25, drain_grace_s=15.0)
    router = router_mod.Router(
        [s.url for s in specs], emit=sink.write, window=32,
        scrape_interval_s=0.25,
        deadline_s=args.router_deadline_s,
        retry_policy=router_mod.RetryPolicy(
            attempts=3, base_delay_s=0.05, max_delay_s=0.5,
            full_jitter=True),
        hedge_pctl=0.95, hedge_min_ms=30.0, hedge_min_samples=24,
        brownout_queue_depth=64, shed_retry_after_s=0.5,
        # Sample EVERYTHING at the router while the replicas keep their
        # local head rate at 0 (shared_args): every serve_trace that
        # shows up proves the router's sampling decision won fleet-wide,
        # and every client request gets a stitchable trace tree.
        trace_sample_rate=1.0)
    router_server = router_mod.make_router_server(router, port=0)
    router_url = "http://%s:%d" % router_server.server_address[:2]

    t_start = time.monotonic()
    verdict = {"metric": "chaos_serve_fleet_failover", "workdir": workdir,
               "replicas": args.replicas, "router_url": router_url}
    wedge_idx = args.replicas - 1

    def state_of(idx):
        return sup.status()[idx]

    def healthy(idx):
        st = state_of(idx)
        return (st["state"] == supervisor_mod.RUNNING
                and router.healthy_count() >= 1
                and any(r["healthy"] and r["url"].endswith(
                    f":{specs[idx].port}")
                        for r in router.snapshot()["replica_states"]))

    try:
        sup.start()
        router.start()
        threading.Thread(target=router_server.serve_forever,
                         daemon=True).start()
        wait_until(lambda: router.healthy_count() == args.replicas,
                   args.warmup_timeout_s,
                   f"all {args.replicas} replicas healthy")
        verdict["startup_s"] = round(time.monotonic() - t_start, 2)
        verdict["first_builds"] = first_builds(workdir,
                                               range(args.replicas))

        # Replica-side echo, decoupled from sampling: probe a replica
        # DIRECTLY with an unsampled trace context. The response must
        # echo the trace id even though sampled=0 means no serve_trace
        # will be exported for it — correlation must never depend on
        # the sampling decision.
        st, hdrs = post(specs[0].url, "classify",
                        {"text": PHRASES[0]}, args.client_timeout_s,
                        extra_headers={
                            "X-Bert-Trace": "chaos-probe-1;attempt=1;"
                                            "sampled=0"})
        check(st == 200, f"direct replica probe failed: {st}")
        check(header(hdrs, "X-Bert-Trace-Id") == "chaos-probe-1",
              "replica did not echo X-Bert-Trace-Id for an UNSAMPLED "
              f"context (got {header(hdrs, 'X-Bert-Trace-Id')!r}): the "
              "echo must not depend on the sampling decision")
        verdict["router_overhead"] = probe_overhead(
            router_url, specs[0].url, OVERHEAD_PROBES,
            args.client_timeout_s)

        # -- phase A: SIGKILL inside the admission window ----------------
        # Replica 0's armed admit_hold@2x6 emits its injection record
        # and then HOLDS the forming batch open; the kill callback waits
        # for the record and kills during the hold, so the process dies
        # with requests captive in the admission window — the stranded
        # shape that only exists under pipelined (continuous-batching)
        # dispatch. Those requests' clients must still see answers
        # (failover), like every other phase.
        outcomes_a: list = []
        kill_at = {"t": None, "admit_hold_observed": False}
        replica0_jsonl = os.path.join(
            workdir, "replica_0", "serve_telemetry.jsonl")

        def admit_hold_recorded() -> bool:
            try:
                with open(replica0_jsonl) as f:
                    return any('"injected_admit_hold"' in line for line in f)
            except OSError:
                return False

        def kill_replica_0() -> None:
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                if admit_hold_recorded():
                    kill_at["admit_hold_observed"] = True
                    break
                time.sleep(0.2)
            pid = state_of(0)["pid"]
            kill_at["t"] = time.monotonic()
            if pid:
                os.kill(pid, signal.SIGKILL)
            # The respawned replica must not re-arm the hold: spec.env
            # re-arms deliberately (the wedge depends on it), but a
            # second 6s hold would just add tail latency to phases B/C.
            specs[0].env.pop(faults.FAULTS_ENV, None)
            # The first incarnation wrote the init checkpoint phase D
            # publishes: respawns need not rewrite it (seconds of every
            # restart at BERT-large width).
            drop_flag(specs[0].cmd, "--save_init_checkpoint")

        run_burst(router_url, args.phase_a_requests, args.burst_workers,
                  args.client_timeout_s, outcomes_a,
                  mid=(2, kill_replica_0))
        t_kill = kill_at["t"]
        check(t_kill is not None, "phase-A kill never fired")
        phase_a = classify_outcomes(outcomes_a)
        phase_a["admit_hold_observed"] = kill_at["admit_hold_observed"]
        verdict["phase_a"] = phase_a
        check(phase_a["admit_hold_observed"],
              "phase A: the admit_hold injection record never appeared — "
              "the SIGKILL cannot be placed inside the admission window "
              "(is replica 0 running --dispatch_mode pipelined?)")
        check(phase_a["failures"] == 0,
              f"phase A (SIGKILL): client-visible failures: {phase_a}")
        check_traced(outcomes_a, "phase A")
        wait_until(lambda: healthy(0), args.recover_timeout_s,
                   "killed replica respawned and healthy")
        verdict["phase_a"]["recovery_s"] = round(
            time.monotonic() - t_kill, 2)
        check(sink.count("spawn") >= args.replicas + 1,
              "no respawn fleet_event after the SIGKILL")
        crash_restarts = [
            r for r in sink.records
            if r.get("event") == "restart_scheduled" and r.get("crash")]
        check(crash_restarts, "SIGKILL was not classified as a crash")
        check(crash_restarts[0]["backoff_s"] <= sup.policy.max_delay_s,
              f"restart backoff {crash_restarts[0]['backoff_s']} exceeds "
              "the policy ceiling")

        # The warm-restart acceptance: the respawned replica found every
        # kernel library built in the shared --compile_cache_dir — zero
        # cold builds, by its compile records (the authority).
        colds = cold_start_records(os.path.join(workdir, "replica_0"))
        check(len(colds) >= 2,
              f"expected >=2 serve_cold_start records (initial + "
              f"restart), found {len(colds)}")
        verdict["restart_compiles_cold"] = colds[-1]["compiles_cold"]
        check(colds[-1]["compiles_cold"] == 0,
              f"restarted replica recompiled: {colds[-1]}")

        # -- phase B: wedged dispatch, caught only by the watchdog ------
        outcomes_b: list = []
        run_burst(router_url, args.wedge_cap_requests, args.burst_workers,
                  args.client_timeout_s, outcomes_b,
                  should_stop=lambda: sink.count("wedged_kill") > 0)
        # The burst's only job is to push the wedge replica past
        # --wedge_at served requests; the watchdog then needs its OWN
        # detection window — heartbeat_timeout_s of staleness plus a
        # poll tick — measured from the instant the dispatch thread
        # hung. A fast burst drains its remaining requests through the
        # surviving replica in less than that, so the kill is awaited
        # here rather than required to land mid-burst.
        wait_until(lambda: sink.count("wedged_kill") > 0,
                   args.recover_timeout_s,
                   "watchdog kill of the wedged replica (if the wedge "
                   f"never armed, raise --wedge_cap_requests "
                   f"[{args.wedge_cap_requests}] or lower --wedge_at "
                   f"[{args.wedge_at}])")
        phase_b = classify_outcomes(outcomes_b)
        verdict["phase_b"] = phase_b
        check(phase_b["failures"] == 0,
              f"phase B (wedge): client-visible failures: {phase_b}")
        check_traced(outcomes_b, "phase B")
        wait_until(lambda: healthy(wedge_idx), args.recover_timeout_s,
                   "wedged replica respawned and healthy")

        # -- phase C: SIGKILL mid-drain ---------------------------------
        outcomes_c: list = []

        def kill_during_drain() -> None:
            # The replica this kill ends is the wedge's respawn, re-armed
            # by spec.env; the respawn after it comes back unarmed, so
            # the later bursts (the capture's above all) never wedge it.
            specs[wedge_idx].env.pop(faults.FAULTS_ENV, None)
            pid = state_of(wedge_idx)["pid"]
            if not pid:
                verdict["phase_c_kill"] = "no_pid"
                return
            os.kill(pid, signal.SIGTERM)   # graceful drain begins
            time.sleep(0.3)
            try:
                os.kill(pid, signal.SIGKILL)   # ... and is cut short
                verdict["phase_c_kill"] = "mid_drain"
            except ProcessLookupError:
                verdict["phase_c_kill"] = "drained_first"

        run_burst(router_url, args.phase_c_requests, args.burst_workers,
                  args.client_timeout_s, outcomes_c,
                  mid=(args.phase_c_requests // 4, kill_during_drain))
        check(verdict.get("phase_c_kill") in ("mid_drain",
                                              "drained_first"),
              f"phase-C kill did not fire: {verdict.get('phase_c_kill')}")
        phase_c = classify_outcomes(outcomes_c)
        verdict["phase_c"] = phase_c
        check(phase_c["failures"] == 0,
              f"phase C (kill-during-drain): client-visible failures: "
              f"{phase_c}")
        check_traced(outcomes_c, "phase C")
        wait_until(
            lambda: any(r.get("event") == "exit"
                        and r.get("replica") == wedge_idx
                        for r in sink.records[-20:]),
            30.0, "supervisor to reap the drain-killed replica")
        wait_until(lambda: healthy(wedge_idx), args.recover_timeout_s,
                   "drain-killed replica respawned and healthy")

        # -- phase D: SIGKILL mid-swap ----------------------------------
        # The deployment-plane chaos proof (docs/serving.md "Model
        # registry & canary rollouts"): publish the fleet's own init
        # checkpoint as a new version, hold a hot-swap open on replica
        # 0 (swap_hold@1 — new params loaded, flip not yet taken),
        # SIGKILL inside the held window under load, then converge the
        # whole fleet with zero cold compiles and zero torn serves.
        reg = registry_mod.ModelRegistry(
            os.path.join(workdir, "registry"), emit=sink.write)
        ckpt_src = os.path.join(workdir, "init_ckpt", "ckpt_0.msgpack")
        check(os.path.isfile(ckpt_src),
              "replica 0 wrote no init checkpoint "
              "(--save_init_checkpoint)")
        # Published bytes must be immutable: every replica-0 respawn
        # rewrites the init checkpoint, so the registry binds a private
        # copy.
        ckpt_pub = os.path.join(workdir, "published_v2.msgpack")
        shutil.copyfile(ckpt_src, ckpt_pub)
        reg.publish("v2-swap", task="classify", checkpoint=ckpt_pub,
                    geometry=registry_mod.geometry_from_config(
                        model_config(args)))
        reg_ok, reg_detail = reg.verify("v2-swap")
        check(reg_ok, f"published version failed verify: {reg_detail}")

        # Faults arm at spawn: restart replica 0 with swap_hold armed.
        specs[0].env[faults.FAULTS_ENV] = "swap_hold@1x6"
        spawns_before = sink.count("spawn")
        pid = state_of(0)["pid"]
        check(pid, "replica 0 has no pid before the swap phase")
        os.kill(pid, signal.SIGKILL)
        wait_until(lambda: sink.count("spawn") > spawns_before
                   and healthy(0),
                   args.recover_timeout_s,
                   "replica 0 respawned with swap_hold armed")

        swap_attempt = {"resp": None, "exc": None}

        def call_swapz() -> None:
            try:
                swap_attempt["resp"] = sup.swap_replica(
                    0, "classify", ckpt_pub, "v2-swap", timeout_s=60.0)
            except (RuntimeError, OSError) as exc:
                swap_attempt["exc"] = f"{type(exc).__name__}: {exc}"

        def swap_hold_recorded() -> bool:
            try:
                with open(replica0_jsonl) as f:
                    return any('"injected_swap_hold"' in line
                               for line in f)
            except OSError:
                return False

        kill_d = {"hold_observed": False}
        spawns_before_kill = sink.count("spawn")

        def kill_mid_swap() -> None:
            # Start the /swapz call (it loads the new params, then the
            # armed fault emits its record and holds the window open),
            # wait for the cue, and kill with BOTH param trees in
            # memory and the flip not yet taken.
            threading.Thread(target=call_swapz, daemon=True).start()
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                if swap_hold_recorded():
                    kill_d["hold_observed"] = True
                    break
                time.sleep(0.2)
            pid = state_of(0)["pid"]
            if pid:
                os.kill(pid, signal.SIGKILL)
            # The respawn must come back unarmed: a second held swap
            # would only slow the convergence assertions below.
            specs[0].env.pop(faults.FAULTS_ENV, None)

        outcomes_d: list = []
        run_burst(router_url, args.phase_d_requests, args.burst_workers,
                  args.client_timeout_s, outcomes_d,
                  mid=(2, kill_mid_swap))
        phase_d = classify_outcomes(outcomes_d)
        phase_d["swap_hold_observed"] = kill_d["hold_observed"]
        verdict["phase_d"] = phase_d
        check(kill_d["hold_observed"],
              "phase D: the swap_hold injection record never appeared — "
              "the SIGKILL cannot be placed inside the swap window")
        check(phase_d["failures"] == 0,
              f"phase D (SIGKILL mid-swap): client-visible failures: "
              f"{phase_d}")
        check_traced(outcomes_d, "phase D")
        wait_until(lambda: sink.count("spawn") > spawns_before_kill
                   and healthy(0),
                   args.recover_timeout_s,
                   "mid-swap-killed replica respawned and healthy")
        # The interrupted control call must surface as a failure, never
        # a silent 200 for a swap that did not happen.
        wait_until(lambda: swap_attempt["exc"] is not None
                   or swap_attempt["resp"] is not None,
                   30.0, "the interrupted /swapz call to fail")
        check(swap_attempt["resp"] is None,
              f"/swapz answered ok for a swap the SIGKILL interrupted: "
              f"{swap_attempt}")
        # A half-applied swap is structurally impossible: the respawned
        # replica boots the configured baseline version, and nothing
        # ever served torn params.
        stats0 = get_json(specs[0].url, "/statsz")
        check(stats0.get("version") == "v1",
              f"replica respawned after a mid-swap SIGKILL must serve "
              f"the baseline version v1, got {stats0.get('version')!r}")
        check(int(stats0.get("torn_serves", 0)) == 0,
              f"torn serves recorded on the killed replica: {stats0}")

        # Converge: the supervisor swaps the whole fleet onto the
        # published version — sequentially, zero cold compiles (same
        # geometry hits the already-jitted executables; the cache
        # counter events are the authority, never wall clock).
        t_swap = time.monotonic()
        swap_infos = sup.swap_all("classify", ckpt_pub, "v2-swap",
                                  timeout_s=120.0)
        swap_all_s = time.monotonic() - t_swap
        check(len(swap_infos) == args.replicas,
              f"swap_all answered for {len(swap_infos)} of "
              f"{args.replicas} replicas")
        for info in swap_infos:
            check(info.get("compiles_cold") == 0,
                  f"same-geometry hot-swap recompiled: {info}")
        torn_total = 0
        for i in range(args.replicas):
            st = get_json(specs[i].url, "/statsz")
            check(st.get("version") == "v2-swap",
                  f"replica {i} did not converge onto v2-swap: "
                  f"{st.get('version')!r}")
            torn_total += int(st.get("torn_serves", 0))
        check(torn_total == 0,
              f"torn-model serves after fleet convergence: {torn_total}")
        phase_d["torn_serves"] = torn_total
        phase_d["swap_compiles_cold"] = max(
            i.get("compiles_cold", 0) for i in swap_infos)
        phase_d["swap_load_s"] = max(
            i.get("load_s", 0.0) for i in swap_infos)
        phase_d["swap_all_s"] = round(swap_all_s, 3)
        # And the converged fleet still serves.
        outcomes_d2: list = []
        run_burst(router_url, 12, args.burst_workers,
                  args.client_timeout_s, outcomes_d2)
        post_swap = classify_outcomes(outcomes_d2)
        check(post_swap["failures"] == 0,
              f"post-swap burst saw failures: {post_swap}")
        check_traced(outcomes_d2, "phase D post-swap")
        outcomes_e: list = []
        if args.profile_s > 0:
            verdict["profile"] = profile_under_burst(
                args, router_url, specs[0].url, state_of(0)["pid"],
                outcomes_e)
        verdict.update(replica_counters([s.url for s in specs]))
        # Exactly phase B's planted wedge: a warming, swapping or
        # profiled replica is never taken for a wedged one.
        verdict["wedged_kills"] = sink.count("wedged_kill")
        check(verdict["wedged_kills"] == 1,
              f"{verdict['wedged_kills']} wedged_kill events for the one "
              f"planted wedge")

        # -- teardown + fleet-level assertions --------------------------
        drain = sup.stop()
        router_server.shutdown()
        router.stop()
        snapshot = router.snapshot()
        verdict["drain"] = {"rcs": {str(k): v for k, v
                                    in drain["rcs"].items()},
                            "drain_killed": drain["drain_killed"]}
        check(drain["drain_killed"] == 0,
              "a live replica ignored the drain SIGTERM and needed "
              f"SIGKILL at stop: {drain}")
        check(drain["rcs"][0] == supervisor_mod.EXIT_PREEMPTED,
              f"replica 0 should exit EXIT_PREEMPTED on drain, got "
              f"{drain['rcs'][0]} (the run_server preemption contract)")
        verdict["router"] = {
            k: snapshot.get(k) for k in
            ("requests", "ok", "sheds", "errors", "retries", "hedges",
             "hedge_wins", "failovers", "latency_p95_ms",
             "failover_p95_ms")}
        check(snapshot["errors"] == 0,
              f"router recorded client-visible errors: {snapshot}")
        check(snapshot["failovers"] >= 1,
              "no failover was recorded — the kill phases did not "
              "exercise the retry path")
        failover_p95 = snapshot.get("failover_p95_ms")
        check(failover_p95 is not None,
              "router snapshot carries no failover percentile")
        check(failover_p95 <= args.failover_tolerance_ms,
              f"failover p95 {failover_p95}ms exceeds the "
              f"{args.failover_tolerance_ms:g}ms tolerance — the "
              "telemetry-report 'router failover' gate would trip")

        # -- every artifact schema-clean --------------------------------
        sink.close()
        lint(os.path.join(workdir, "fleet_telemetry.jsonl"))
        for i in range(args.replicas):
            lint(os.path.join(workdir, f"replica_{i}",
                              "serve_telemetry.jsonl"))

        # -- end-to-end trace stitching ---------------------------------
        # Post-hoc FleetCollector pass over the router's sink + every
        # replica's serve telemetry: one ordered timeline with one
        # trace_stitch per sampled client request. Everything is already
        # on disk, so one pass joins both sides and close() force-drains
        # anything one-sided into an orphan record.
        timeline_path = os.path.join(workdir, "fleet_timeline.jsonl")
        timeline: list = []
        tails = [collector_mod.JsonlTailer(
            os.path.join(workdir, "fleet_telemetry.jsonl"), "fleet")]
        for i in range(args.replicas):
            tails.append(collector_mod.JsonlTailer(
                os.path.join(workdir, f"replica_{i}",
                             "serve_telemetry.jsonl"), f"replica-{i}"))
        coll = collector_mod.FleetCollector([], tails=tails,
                                            out_path=timeline_path,
                                            emit=timeline.append)
        coll.collect_once()
        coll.close()
        lint(timeline_path)
        router_traces = {r["trace_id"]: r for r in timeline
                         if r.get("kind") == "router_trace"}
        stitches = [r for r in timeline
                    if r.get("kind") == "trace_stitch"]
        check(router_traces, "router sampled at 1.0 but emitted no "
                             "router_trace records")
        stitch_ids = [s["trace_id"] for s in stitches]
        check(len(stitch_ids) == len(set(stitch_ids)),
              "a trace id stitched more than once: every sampled client "
              "request must resolve to exactly ONE stitched tree")
        check(set(stitch_ids) == set(router_traces),
              f"stitch/trace mismatch: {len(stitches)} stitches for "
              f"{len(router_traces)} router traces")
        orphans = [s for s in stitches if s.get("orphan")]
        check(not orphans,
              f"{len(orphans)} orphan stitches on a fully-sampled run "
              f"(first: {orphans[:2]}): a span went missing between "
              "tiers")
        complete = [s for s in stitches
                    if s.get("router_overhead_ms") is not None]
        check(complete, "no complete stitch decompositions")
        bad_decomp = [s for s in complete if not s.get("consistent")]
        check(not bad_decomp,
              f"inconsistent stitch decomposition (client_total < "
              f"router overhead + replica time): {bad_decomp[:2]}")
        # Every 2xx client outcome's echoed trace id names a stitch.
        ok_ids = {o["trace_id"]
                  for o in (outcomes_a + outcomes_b + outcomes_c
                            + outcomes_d + outcomes_d2 + outcomes_e)
                  if o["status"] is not None and 200 <= o["status"] < 300}
        missing = ok_ids - set(stitch_ids)
        check(not missing,
              f"{len(missing)} answered requests never resolved to a "
              f"stitched tree: {sorted(missing)[:5]}")
        # The phase-A failover tree: attempt 1 on the SIGKILLed replica
        # 0, winning attempt 2+ chaining to a surviving replica's
        # serve_trace.
        failover_stitch = None
        for s in complete:
            if s.get("winning_attempt", 1) < 2:
                continue
            rt = router_traces[s["trace_id"]]
            first = next((sp for sp in rt["spans"]
                          if sp.get("name") == "attempt"
                          and sp.get("attempt") == 1), None)
            if first and first["replica"] == specs[0].url \
                    and first.get("outcome") == "transport_error":
                failover_stitch = s
                break
        check(failover_stitch is not None,
              "no stitched trace shows attempt 1 dying on the killed "
              "replica (transport_error) and failing over to a winning "
              "attempt 2+")
        rt = router_traces[failover_stitch["trace_id"]]
        win_span = next(sp for sp in rt["spans"]
                        if sp.get("name") == "attempt"
                        and sp.get("attempt")
                        == failover_stitch["winning_attempt"])
        check(win_span["replica"] != specs[0].url,
              f"winning attempt stayed on the killed replica: {win_span}")
        check(failover_stitch.get("winning_trace_id"),
              "failover stitch does not chain to a replica serve_trace")
        verdict["trace"] = {
            "router_traces": len(router_traces),
            "stitches": len(stitches),
            "orphans": len(orphans),
            "complete": len(complete),
        }
        verdict["failover_trace"] = {
            "trace_id": failover_stitch["trace_id"],
            "attempts": failover_stitch.get("attempts"),
            "winning_attempt": failover_stitch["winning_attempt"],
            "attempt_1_replica": specs[0].url,
            "winning_replica": win_span["replica"],
            "winning_trace_id": failover_stitch["winning_trace_id"],
            "winning_source": failover_stitch.get("winning_source"),
        }
        # The operator drill-down path: obs_collect --trace prints the
        # stitched tree for the failover request out of the timeline.
        tree_proc = subprocess.run(
            [sys.executable, os.path.join(TOOLS_DIR, "obs_collect.py"),
             "--out", timeline_path,
             "--trace", failover_stitch["trace_id"]],
            capture_output=True, text=True)
        check(tree_proc.returncode == 0,
              f"obs_collect --trace failed: {tree_proc.stdout}"
              f"{tree_proc.stderr}")
        check(specs[0].url in tree_proc.stdout
              and win_span["replica"] in tree_proc.stdout
              and "stitch:" in tree_proc.stdout,
              f"obs_collect --trace tree missing expected spans:\n"
              f"{tree_proc.stdout}")

        # -- report gates, proven live ----------------------------------
        # A copy of the timeline doctored with one router-delay-dominated
        # stitch must make telemetry-report exit 1 naming the gate, while
        # the clean timeline self-diffs green (the observatory E2E
        # discipline: the gate is proven to FIRE, not just to exist).
        doctored_path = timeline_path + ".doctored"
        shutil.copyfile(timeline_path, doctored_path)
        with open(doctored_path, "a", encoding="utf-8") as f:
            f.write(json.dumps({
                "schema": schema.SCHEMA_VERSION,
                "ts": round(time.time(), 3),
                "kind": "trace_stitch", "tag": "obs",
                "trace_id": "rt-injected-router-delay", "orphan": False,
                "router_spans": 2, "replica_spans": 1, "status": 200,
                "task": "classify", "attempts": 1, "hedges": 0,
                "hedge_wasted_ms": 0.0,
                "client_total_ms": 60000.0,
                "router_overhead_ms": 59900.0,
                "network_gap_ms": 50.0, "replica_ms": 50.0,
                "consistent": True, "winning_attempt": 1}) + "\n")
        bad = subprocess.run(
            [sys.executable, report_tool(), doctored_path, timeline_path],
            capture_output=True, text=True)
        check(bad.returncode == 1
              and "router overhead share" in bad.stdout,
              f"injected router delay did not trip the 'router overhead "
              f"share' gate (rc {bad.returncode}):\n{bad.stdout}")
        clean = subprocess.run(
            [sys.executable, report_tool(), timeline_path, timeline_path],
            capture_output=True, text=True)
        check(clean.returncode == 0,
              f"clean timeline failed its own self-diff (rc "
              f"{clean.returncode}):\n{clean.stdout}")
        verdict["report_gate"] = {"doctored_rc": bad.returncode,
                                  "clean_rc": clean.returncode}
        os.remove(doctored_path)

        verdict.update(ok=True, wall_s=round(time.monotonic() - t_start, 1))
        print(json.dumps(verdict))
        if not args.workdir:
            shutil.rmtree(workdir, ignore_errors=True)
        return 0
    except (ChaosFailure, OSError, ValueError, KeyError) as exc:
        verdict.update(ok=False, error=f"{type(exc).__name__}: {exc}")
        try:
            sup.stop()
            router_server.shutdown()
            router.stop()
        except Exception:
            pass
        print(json.dumps(verdict))
        print(f"chaos_serve: FAILED — artifacts kept in {workdir}",
              file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
