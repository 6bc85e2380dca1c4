"""The port's serving fleet held to the JAX package's, on the CPU.

Each pair of modules — retry, supervisor, router, autoscaler, registry,
rollout, collector, report — is driven with the same scripted fakes (fake
processes, transports, clocks and signals) once through the JAX package
and once through the port. The scenario tests run in both (``m`` is the
package under test) and assert the JAX tests' own expectations; the
parity tests run both packages on one script and assert equal decisions
and records, field for field (module paths aside). The by-path tests load
the port's modules as its torch-free fleet parent does, beside the JAX
package's by-path copies, and check that no alias crosses packages.
"""

from __future__ import annotations

import importlib
import importlib.util
import io
import json
import os
import random
import sys
import threading
import types
from contextlib import redirect_stdout
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_DIR = REPO / "bert_pytorch_tpu_torch"
JAX_DIR = REPO / "bert_pytorch_tpu"
PACKAGES = {"jax": "bert_pytorch_tpu", "torch": "bert_pytorch_tpu_torch"}
MODULES = {
    "retry": "utils.retry", "preemption": "utils.preemption",
    "supervisor": "serve.supervisor", "router": "serve.router",
    "autoscaler": "serve.autoscaler", "registry": "serve.registry",
    "rollout": "serve.rollout", "collector": "telemetry.collector",
    "report": "telemetry.report", "ledger": "telemetry.ledger",
    "schema": "telemetry.schema",
}


def _package(name: str) -> types.SimpleNamespace:
    return types.SimpleNamespace(**{
        key: importlib.import_module(f"{PACKAGES[name]}.{mod}")
        for key, mod in MODULES.items()})


@pytest.fixture(params=sorted(PACKAGES))
def m(request):
    """The fleet modules of one package (the JAX package's or the
    port's)."""
    return _package(request.param)


def both(scenario, *args):
    """Run ``scenario(m, *args)`` on the JAX package and on the port."""
    return scenario(_package("jax"), *args), scenario(_package("torch"),
                                                      *args)


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


class FakeProc:
    """A replica process: exits when told, drains on SIGTERM."""

    def __init__(self, pid: int, drain_rc: int):
        self.pid = pid
        self.rc = None
        self.signals = []
        self._drain_rc = drain_rc

    def poll(self):
        return self.rc

    def kill(self):
        self.rc = -9

    def wait(self, timeout=None):
        return self.rc

    def send_signal(self, sig):
        self.signals.append(sig)
        self.rc = self._drain_rc


# -- utils/retry.py ------------------------------------------------------------

def test_retry_default_jitter_formula_and_clock(m):
    seed = 20250803
    p = m.retry.RetryPolicy(attempts=6, base_delay_s=0.8, max_delay_s=7.0,
                            jitter=0.5, rng=random.Random(seed))
    assert p.full_jitter is False and p.max_elapsed_s is None
    rng = random.Random(seed)
    for i in range(5):
        raw = min(7.0, 0.8 * 2 ** i)
        assert p.backoff_s(i) == raw * (1.0 - 0.5 + 0.5 * rng.random())

    def explode() -> float:
        raise AssertionError("clock read on the default path")

    q = m.retry.RetryPolicy(attempts=3, base_delay_s=0.0, jitter=0.0,
                            sleep=lambda s: None, clock=explode)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    assert m.retry.retry_call(flaky, policy=q) == "ok"


def test_retry_full_jitter_and_elapsed_budget(m):
    p = m.retry.RetryPolicy(base_delay_s=10.0, max_delay_s=10.0,
                            full_jitter=True, rng=random.Random(0))
    draws = [p.backoff_s(0) for _ in range(200)]
    assert all(0.0 <= d < 10.0 for d in draws) and min(draws) < 2.0
    clock = FakeClock()
    q = m.retry.RetryPolicy(attempts=10, base_delay_s=1.0, jitter=0.0,
                            max_elapsed_s=2.5, clock=clock,
                            sleep=lambda s: clock.advance(s))
    calls = {"n": 0}

    def down():
        calls["n"] += 1
        raise OSError("replica down")

    with pytest.raises(m.retry.RetryError, match="elapsed budget"):
        m.retry.retry_call(down, policy=q)
    assert calls["n"] == 2


def _retry_schedules(m):
    out = []
    for kwargs in ({"jitter": 0.5}, {"full_jitter": True},
                   {"jitter": 0.0, "max_delay_s": 3.0}):
        p = m.retry.RetryPolicy(attempts=8, base_delay_s=0.3,
                                max_delay_s=kwargs.pop("max_delay_s", 30.0),
                                rng=random.Random(7), **kwargs)
        out.append([p.backoff_s(i) for i in range(8)])
    return out


def test_retry_schedules_equal_the_jax_packages():
    jax_out, port_out = both(_retry_schedules)
    assert jax_out == port_out


# -- serve/supervisor.py -------------------------------------------------------

def _supervisor(m, clock, events, tmp=None, heartbeat=None, attempts=4,
                postmortem=False, **kwargs):
    procs = []
    drain_rc = m.preemption.EXIT_PREEMPTED

    def spawn(spec):
        procs.append(FakeProc(4000 + len(procs), drain_rc))
        return procs[-1]

    spec = m.supervisor.ReplicaSpec(
        0, 9001, ["run_server"],
        heartbeat_file="hb.json" if heartbeat else None,
        postmortem_file=str(tmp / "postmortem.json") if postmortem else None)
    sup = m.supervisor.Supervisor(
        [spec], emit=events.append, spawn=spawn,
        policy=m.retry.RetryPolicy(attempts=attempts, base_delay_s=1.0,
                                   max_delay_s=8.0, jitter=0.0),
        read_heartbeat=heartbeat, clock=clock, sleep=lambda s: None,
        **kwargs)
    return sup, procs


def sup_backoff_give_up(m, tmp):
    clock, events = FakeClock(), []
    sup, procs = _supervisor(m, clock, events)
    sup.start(monitor=False)
    for expected in (1.0, 2.0, 4.0):
        procs[-1].rc = 1
        sup.poll_once()
        assert sup.status()[0]["state"] == m.supervisor.BACKOFF
        clock.advance(expected - 0.01)
        sup.poll_once()
        clock.advance(0.02)
        sup.poll_once()
    procs[-1].rc = 1
    sup.poll_once()
    assert sup.status()[0]["state"] == m.supervisor.FAILED
    clock.advance(60.0)
    sup.poll_once()
    assert len(procs) == 4
    assert [e["backoff_s"] for e in events
            if e["event"] == "restart_scheduled"] == [1.0, 2.0, 4.0]
    return events, sup.status()


def sup_graceful_churn(m, tmp):
    clock, events = FakeClock(), []
    sup, procs = _supervisor(m, clock, events)
    sup.start(monitor=False)
    procs[-1].rc = m.preemption.EXIT_PREEMPTED
    sup.poll_once()
    first = [e for e in events if e["event"] == "restart_scheduled"][-1]
    assert first["crash"] is False and first["backoff_s"] == 0.0
    sup.poll_once()
    assert len(procs) == 2
    procs[-1].rc = m.preemption.EXIT_PREEMPTED
    sup.poll_once()
    churn = [e for e in events if e["event"] == "restart_scheduled"][-1]
    assert churn["crash"] is True and churn["reason"] == "graceful_churn"
    return events, sup.status()


def sup_watchdog(m, tmp):
    clock, events, hb = FakeClock(), [], {"counter": 57}
    sup, procs = _supervisor(m, clock, events,
                             heartbeat=lambda spec: hb["counter"],
                             heartbeat_timeout_s=5.0, startup_grace_s=60.0,
                             stable_reset_s=30.0)
    sup.start(monitor=False)
    clock.advance(20.0)
    sup.poll_once()           # warming on a stale counter: not wedged
    assert sup.status()[0]["state"] == m.supervisor.STARTING
    hb["counter"] += 1
    sup.poll_once()
    assert sup.status()[0]["state"] == m.supervisor.RUNNING
    clock.advance(5.5)        # frozen past the timeout: wedged
    sup.poll_once()
    assert [e["event"] for e in events].count("wedged_kill") == 1
    assert procs[-1].rc == -9
    clock.advance(1.01)
    sup.poll_once()           # respawn after the crash backoff
    hb["counter"] += 1
    sup.poll_once()
    clock.advance(31.0)
    hb["counter"] += 1
    sup.poll_once()           # a stable stretch pays the debt back
    assert sup.status()[0]["consecutive_crashes"] == 0
    return events, sup.status()


def sup_postmortem_harvest(m, tmp):
    clock, events = FakeClock(), []
    sup, procs = _supervisor(m, clock, events, tmp=tmp, postmortem=True,
                             heartbeat_file=str(tmp / "sup_hb.json"))
    sup.start(monitor=False)
    pm = tmp / "postmortem.json"
    pm.write_text(json.dumps({
        "process": "serve", "reason": "periodic", "flushed_at": 123.0,
        "ring_entries": 9, "ring_bytes": 512, "dropped": 0,
        "records": [{"kind": "serve_window", "window_requests": i}
                    for i in range(8)],
        "lines": ["serving on :9001"]}))
    procs[-1].rc = -9
    sup.poll_once()
    clock.advance(1.01)
    sup.poll_once()
    assert not pm.exists()    # the respawn wipes the dead one's file
    procs[-1].rc = 1          # a crash before any flush: found false
    sup.poll_once()
    harvests = [e for e in events if e["event"] == "postmortem"]
    assert [h["found"] for h in harvests] == [True, False]
    assert len(harvests[0]["records"]) == 5
    beat = json.loads((tmp / "sup_hb.json").read_text())
    for event in events:
        event.pop("path", None)   # under each run's own directory
    return events, (beat["step"], beat["counter"])


def sup_elastic_and_stop(m, tmp):
    clock, events = FakeClock(), []
    sup, procs = _supervisor(m, clock, events)
    template = m.supervisor.ReplicaTemplate(["--tasks", "classify"],
                                            str(tmp / "fleet"))
    sup.start(monitor=False)
    spec = sup.add_replica(template, port=9100)
    assert spec.index == 1 and spec.port == 9100
    assert sup.active_count() == 2
    drained = sup.drain_replica(1)
    sup.poll_once()
    status = {s["replica"]: s for s in sup.status()}
    assert status[1]["state"] == m.supervisor.STOPPED and drained
    assert sup.active_count() == 1
    summary = sup.stop()
    assert summary["all_graceful"] and summary["drain_killed"] == 0
    assert procs[0].signals == [15]
    # The spec's argv names each package's own server: the port's is
    # ``-m bert_pytorch_tpu_torch.run_server`` (run_server_command).
    argv = [a for a in spec.cmd[1:] if "run_server" not in a
            and a != "-m"]
    return events, summary, argv[:2], argv[-4:-2]


SUPERVISOR_SCENARIOS = {
    "backoff_give_up": sup_backoff_give_up,
    "graceful_churn": sup_graceful_churn,
    "watchdog": sup_watchdog,
    "postmortem_harvest": sup_postmortem_harvest,
    "elastic_and_stop": sup_elastic_and_stop,
}


@pytest.mark.parametrize("name", sorted(SUPERVISOR_SCENARIOS))
def test_supervisor_scenario(m, name, tmp_path):
    SUPERVISOR_SCENARIOS[name](m, tmp_path)


@pytest.mark.parametrize("name", sorted(SUPERVISOR_SCENARIOS))
def test_supervisor_records_equal_the_jax_packages(name, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    scenario = SUPERVISOR_SCENARIOS[name]
    jax_out = scenario(_package("jax"), tmp_path / "jax")
    port_out = scenario(_package("torch"), tmp_path / "torch")
    assert jax_out == port_out


def test_watchdog_waits_out_a_declared_hold(tmp_path):
    """A replica beat carrying ``hold_s`` (telemetry/sentinels.py: a
    ``/profilez`` trace's collection ahead, which holds the replica's
    interpreter) adds that many seconds to the heartbeat
    timeout; the next beat without one ends it, and a replica frozen
    past the timeout then is killed as wedged as before."""
    from bert_pytorch_tpu_torch.telemetry.sentinels import Heartbeat

    m = _package("torch")
    clock, events, procs = FakeClock(), [], []
    path = str(tmp_path / "hb.json")
    beats = Heartbeat(path, clock=lambda: 0.0)

    def spawn(spec):
        procs.append(FakeProc(4000 + len(procs), 75))
        return procs[-1]

    sup = m.supervisor.Supervisor(
        [m.supervisor.ReplicaSpec(0, 9001, ["run_server"],
                                  heartbeat_file=path)],
        emit=events.append, spawn=spawn, heartbeat_timeout_s=5.0,
        startup_grace_s=60.0, clock=clock, sleep=lambda s: None)
    sup.start(monitor=False)
    beats.beat(1)
    sup.poll_once()
    assert sup.status()[0]["state"] == m.supervisor.RUNNING
    beats.beat(1, hold_s=10.0)
    sup.poll_once()
    clock.advance(14.5)           # past the timeout, inside timeout + hold
    sup.poll_once()
    assert "wedged_kill" not in [e["event"] for e in events]
    beats.beat(2, hold_s=0.0)     # the collection is done
    sup.poll_once()
    clock.advance(5.5)
    sup.poll_once()
    assert [e["event"] for e in events].count("wedged_kill") == 1
    assert procs[0].rc == -9


def test_minted_port_stays_held_while_its_replica_is_down(tmp_path):
    """A port ReplicaTemplate mints stays bound (SO_REUSEADDR, not
    listening) until its replica retires: a plain bind to it fails, so no
    other socket takes it while the replica is down, yet the replica's
    HTTP server binds and listens on it again and again; ``stop()``
    releases it."""
    import socket
    from http.server import HTTPServer

    m = _package("torch")
    template = m.supervisor.ReplicaTemplate([], str(tmp_path))
    spec = template.make_spec(0)
    for _ in range(2):   # a replica's start, and its respawn
        server = HTTPServer(("127.0.0.1", spec.port), None)
        server.server_close()
    other = socket.socket()
    with pytest.raises(OSError):
        other.bind(("127.0.0.1", spec.port))
    other.close()

    def spawn(spec):
        return FakeProc(4000, 75)

    sup = m.supervisor.Supervisor([spec], emit=lambda e: None, spawn=spawn,
                                  clock=FakeClock(), sleep=lambda s: None)
    sup.start(monitor=False)
    sup.stop()
    free = socket.socket()
    free.bind(("127.0.0.1", spec.port))
    free.close()


def test_port_replicas_start_the_ports_server(tmp_path):
    cmd = _package("torch").supervisor.run_server_command(
        9001, str(tmp_path), ["--tasks", "classify"], python="py")
    assert cmd == ["py", "-m", "bert_pytorch_tpu_torch.run_server",
                   "--tasks", "classify", "--port", "9001", "--output_dir",
                   str(tmp_path)]
    assert _package("torch").supervisor.REPO_ROOT == str(REPO)


# -- serve/router.py -----------------------------------------------------------

def _healthy(url):
    return {"dispatch_alive": True, "draining": False, "queue_depth": 0}


def _router(m, transport, clock, scrape=_healthy, events=None,
            urls=("http://a:1", "http://b:2"), **kwargs):
    kwargs.setdefault("retry_policy", m.retry.RetryPolicy(
        attempts=3, base_delay_s=0.0, jitter=0.0))
    kwargs.setdefault("hedge_pctl", 0.0)
    r = m.router.Router(list(urls), emit=events.append
                        if events is not None else None,
                        transport=transport, scrape=scrape, clock=clock,
                        sleep=lambda s: None, **kwargs)
    r._trace_token = "0000beef"     # the per-run token of trace ids
    r.scrape_once()
    return r


def _transport(clock, answers, calls):
    """A replica transport: ``answers[url]`` is a status or an
    exception; each call takes 5 ms of the fake clock."""

    def transport(url, task, payload, timeout_s, headers=None):
        calls.append(url)
        clock.advance(0.005)
        answer = answers.get(url, 200)
        if isinstance(answer, Exception):
            raise answer
        return answer, {"from": url}

    return transport


def router_failover(m):
    clock, calls, events = FakeClock(), [], []
    r = _router(m, _transport(clock, {"http://a:1": ConnectionRefusedError(
        "dead")}, calls), clock, events=events, window=2,
        trace_sample_rate=1.0)
    answers = [r.handle("classify", {"text": "hi"})[0] for _ in range(3)]
    assert answers == [200, 200, 200]
    assert calls[:2] == ["http://a:1", "http://b:2"]
    snap = r.snapshot()
    assert snap["failovers"] == 1 and snap["errors"] == 0
    r.scrape_once()
    assert r.healthy_count() == 2   # the scrape re-heals a
    r.stop()
    return calls, events


def router_statuses(m):
    clock, calls, events = FakeClock(), [], []
    r = _router(m, _transport(clock, {"http://a:1": 500}, calls), clock,
                events=events)
    assert r.handle("classify", {"text": "hi"})[0] == 200
    r4 = _router(m, _transport(clock, {"http://a:1": 400}, calls), clock)
    assert r4.handle("classify", {"text": None})[0] == 400
    assert r4.snapshot()["retries"] == 0 and r4.snapshot()["ok"] == 1
    down = _router(m, _transport(clock, {
        "http://a:1": ConnectionRefusedError("x"),
        "http://b:2": ConnectionRefusedError("y")}, calls), clock)
    assert down.handle("classify", {"text": "hi"})[0] == 503
    r.stop()
    return calls, events, r4.snapshot()["errors"], down.snapshot()["sheds"]


def router_brownout_and_draining(m):
    clock, calls = FakeClock(), []

    def saturated(url):
        return {"dispatch_alive": True, "draining": False,
                "queue_depth": 128}

    r = _router(m, _transport(clock, {}, calls), clock, scrape=saturated,
                brownout_queue_depth=64, shed_retry_after_s=1.5)
    status, body, headers = r.handle("classify", {"text": "hi"})
    assert status == 503 and headers["Retry-After"] == "1.5"
    assert "brownout" in body["error"]

    def draining_a(url):
        return {"dispatch_alive": True, "draining": url == "http://a:1",
                "queue_depth": 0 if url == "http://a:1" else 5}

    r2 = _router(m, _transport(clock, {}, calls), clock, scrape=draining_a)
    assert r2.handle("classify", {"text": "hi"})[0] == 200
    assert calls == ["http://b:2"]
    return body, headers, calls


def router_canary_split(m):
    clock, calls, events = FakeClock(), [], []
    versions = {"http://a:1": "v1", "http://b:2": "v2"}

    def scrape(url):
        return dict(_healthy(url), version=versions[url])

    r = _router(m, _transport(clock, {}, calls), clock, scrape=scrape,
                events=events)
    r.set_split("classify", "v2", 0.5)
    for _ in range(20):
        assert r.handle("classify", {"text": "hi"})[0] == 200
    window = r.split_window()
    r.clear_split()
    snap = r.snapshot()
    return calls, window, snap["version_requests"]


ROUTER_SCENARIOS = {
    "failover": router_failover,
    "statuses": router_statuses,
    "brownout_and_draining": router_brownout_and_draining,
    "canary_split": router_canary_split,
}


@pytest.mark.parametrize("name", sorted(ROUTER_SCENARIOS))
def test_router_scenario(m, name):
    ROUTER_SCENARIOS[name](m)


@pytest.mark.parametrize("name", sorted(ROUTER_SCENARIOS))
def test_router_records_equal_the_jax_packages(name):
    jax_out, port_out = both(ROUTER_SCENARIOS[name])
    assert jax_out == port_out


def test_router_records_are_schema_clean(m):
    _, events = router_failover(m)
    kinds = {e["kind"] for e in events}
    assert {"router_window", "router_summary", "router_trace"} <= kinds
    for rec in events:
        assert m.schema.validate_record(
            dict(rec, schema=m.schema.SCHEMA_VERSION, ts=0.0)) == [], rec
    trace = next(e for e in events if e["kind"] == "router_trace")
    assert [s["outcome"] for s in trace["spans"]
            if s["name"] == "attempt"] == ["transport_error", "final"]


def test_router_hedge_fires_only_past_percentile(m):
    release = threading.Event()

    def transport(url, task, payload, timeout_s):
        if url == "http://a:1":
            release.wait(timeout=10.0)
            return 200, {"from": "a"}
        return 200, {"from": "b"}

    r = m.router.Router(["http://a:1", "http://b:2"], transport=transport,
                        scrape=_healthy, hedge_pctl=0.95, hedge_min_ms=10.0,
                        hedge_min_samples=8, sleep=lambda s: None)
    r.scrape_once()
    assert r._hedge_delay_s() is None
    for _ in range(16):
        r.note_latency(0.005)
    assert r._hedge_delay_s() == pytest.approx(0.010)
    status, body, _ = r.handle("classify", {"text": "hi"})
    release.set()
    assert status == 200 and body == {"from": "b"}
    snap = r.snapshot()
    assert snap["hedges"] == 1 and snap["hedge_wins"] == 1


def test_router_metricsz_renders_the_statsz_snapshot(m):
    clock, calls = FakeClock(), []
    r = _router(m, _transport(clock, {}, calls), clock)
    for _ in range(3):
        r.handle("classify", {"text": "hi"})
    text = r.metrics_text()
    snap = r.snapshot()
    assert f"bert_router_requests_total {snap['requests']}" in text


# -- serve/autoscaler.py -------------------------------------------------------

class ScriptedFleet:
    """The ElasticFleet surface with scriptable status rows."""

    def __init__(self, m, replicas=1):
        self.m = m
        self.rows = [self._row(i) for i in range(replicas)]
        self.split = False
        self.pending_drain = False

    def _row(self, i):
        return {"replica": i, "port": 9000 + i,
                "url": f"http://127.0.0.1:{9000 + i}",
                "state": self.m.supervisor.RUNNING, "draining": False}

    def status(self):
        return [dict(r) for r in self.rows]

    def split_active(self):
        return self.split

    def draining(self):
        return self.pending_drain

    def scale_up(self):
        i = max(r["replica"] for r in self.rows) + 1
        self.rows.append(self._row(i))
        return {"replica": i, "url": self.rows[-1]["url"], "port": 9000 + i}

    def begin_drain(self):
        live = [r for r in self.rows if not r["draining"]]
        victim = max(live, key=lambda r: r["replica"])
        victim["draining"] = True
        victim["state"] = self.m.supervisor.STOPPED
        return {"replica": victim["replica"], "url": victim["url"]}

    def reap_drained(self):
        return []


RED = {"window_requests": 40, "window_errors": 0, "window_sheds": 9}
GREEN = {"window_requests": 2, "window_errors": 0, "window_sheds": 0}
NEUTRAL = {"window_requests": 2, "window_errors": 0, "window_sheds": 0,
           "queue_wait_share": 0.9}
# One scripted signal trace: (seconds advanced before the tick, window,
# fleet change before the tick).
SIGNAL_TRACE = (
    [(1.0, RED, None), (1.0, NEUTRAL, None), (1.0, RED, None),
     (1.0, RED, None), (1.0, RED, None), (1.0, RED, None),
     (6.0, RED, None), (1.0, RED, None), (1.0, RED, None),
     (1.0, GREEN, "split"), (1.0, GREEN, None), (1.0, GREEN, "unsplit"),
     (1.0, GREEN, "backoff"), (1.0, GREEN, None), (1.0, GREEN, "running"),
     (25.0, GREEN, None), (1.0, GREEN, None), (1.0, GREEN, None),
     (1.0, GREEN, "drift"), (21.0, GREEN, None), (1.0, GREEN, None),
     (1.0, {"window_requests": 1, "window_errors": 2, "window_sheds": 3},
      None),
     (1.0, RED, None)])


def autoscaler_trace(m):
    fleet, clock, events = ScriptedFleet(m, replicas=1), FakeClock(), []
    sig = {"value": dict(GREEN)}
    ctrl = m.autoscaler.AutoscalerController(
        fleet, lambda: dict(sig["value"]), min_replicas=1, max_replicas=3,
        red_windows_to_scale_up=2, green_windows_to_scale_down=2,
        up_cooldown_s=5.0, down_cooldown_s=20.0, min_window_requests=8,
        emit=events.append, clock=clock)
    decisions = []
    for dt, window, change in SIGNAL_TRACE:
        clock.advance(dt)
        if change == "split":
            fleet.split = True
        elif change == "unsplit":
            fleet.split = False
        elif change == "backoff":
            fleet.rows[-1]["state"] = m.supervisor.BACKOFF
        elif change == "running":
            fleet.rows[-1]["state"] = m.supervisor.RUNNING
        elif change == "drift":
            fleet.rows.append(fleet._row(9))
        sig["value"] = dict(window)
        rec = ctrl.tick()
        decisions.append((rec["decision"], rec["reason"],
                          rec["replicas_before"], rec["replicas_after"]))
    return decisions, events, ctrl.status()


def test_autoscaler_decision_sequence(m):
    decisions, events, status = autoscaler_trace(m)
    assert decisions[3][0] == m.autoscaler.SCALE_UP
    reasons = [d[1] for d in decisions]
    for hold in ("hold:up_cooldown", "hold:band_max", "hold:canary_split",
                 "hold:restarting", "hold:down_cooldown"):
        assert hold in reasons, (hold, reasons)
    assert status["thrash"] == 0 and status["scale_downs"] >= 1
    for rec in events:
        assert m.schema.validate_record(
            dict(rec, schema=m.schema.SCHEMA_VERSION, ts=0.0)) == [], rec


def test_autoscaler_decisions_equal_the_jax_packages():
    jax_out, port_out = both(autoscaler_trace)
    assert jax_out == port_out


def test_autoscaler_elastic_fleet_over_a_live_supervisor(m, tmp_path):
    clock, events = FakeClock(), []
    sup, procs = _supervisor(m, clock, events)
    clock_r, calls = FakeClock(), []
    router = _router(m, _transport(clock_r, {}, calls), clock_r,
                     urls=("http://127.0.0.1:9001",))
    template = m.supervisor.ReplicaTemplate([], str(tmp_path))
    sup.start(monitor=False)
    fleet = m.autoscaler.ElasticFleet(sup, router, template,
                                      alloc_port=lambda: 9200)
    grown = fleet.scale_up()
    assert grown["replica"] == 1 and router.replica_count() == 2
    victim = fleet.begin_drain()
    assert victim["replica"] == 1
    sup.poll_once()
    assert fleet.reap_drained() and router.replica_count() == 1


# -- serve/registry.py and serve/rollout.py ------------------------------------

def _ckpt(root: Path, name="ckpt_0.msgpack", payload=b"model-bytes" * 64):
    path = root / name
    path.write_bytes(payload)
    return str(path)


def registry_lifecycle(m, root: Path):
    records = []
    reg = m.registry.ModelRegistry(str(root / "reg"), emit=records.append,
                                   clock=FakeClock(1754300000.0))
    ckpt = _ckpt(root)
    geometry = m.registry.geometry_from_config(
        {"hidden_size": 32, "num_hidden_layers": 2,
         "num_attention_heads": 2, "intermediate_size": 64,
         "vocab_size": 40, "max_position_embeddings": 64, "extra": 1})
    manifest = reg.publish("v1", task="classify", checkpoint=ckpt,
                           quantize="int8", geometry=geometry)
    with pytest.raises(m.registry.RegistryError):
        reg.publish("v1", task="classify", checkpoint=ckpt)
    reg.begin_canary("v1")
    reg.promote("v1")
    reg.publish("v2", task="classify", checkpoint=_ckpt(root, "c2"))
    reg.begin_canary("v2")
    reg.rollback("v2", reason="canary p95 breach")
    verified = reg.verify("v1")
    with open(ckpt, "ab") as f:
        f.write(b"tampered")
    tampered = reg.verify("v1")
    drift = reg.verify_geometry("v1", dict(geometry, hidden_size=64))
    assert verified[0] and not tampered[0] and not drift[0]
    assert reg.get("v1")["state"] == "live"
    assert reg.get("v2")["state"] == "staged"
    text = json.dumps([manifest, reg.list_versions(), records, verified,
                       tampered, drift])
    return json.loads(text.replace(str(root), "<root>"))


def test_registry_lifecycle(m, tmp_path):
    registry_lifecycle(m, tmp_path)


def test_registry_manifests_and_records_equal_the_jax_packages(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    jax_out = registry_lifecycle(_package("jax"), tmp_path / "jax")
    port_out = registry_lifecycle(_package("torch"), tmp_path / "torch")
    assert jax_out == port_out


class FakeSplitRouter:
    def __init__(self):
        self.calls = []
        self.window = None

    def set_split(self, task, version, share):
        self.calls.append(("set", task, version, share))

    def clear_split(self):
        self.calls.append(("clear",))

    def split_window(self, reset=True):
        return self.window


def _window(requests, errors=0, p95=None):
    canary = {"requests": requests, "ok": requests - errors,
              "errors": errors, "sheds": 0}
    if p95 is not None:
        canary.update(latency_p50_ms=p95 / 2, latency_p95_ms=p95,
                      latency_p99_ms=p95 * 1.2)
    return {"task": "classify", "version": "v2", "share": 0.01,
            "fallbacks": 0, "canary": canary,
            "control": {"requests": requests * 10, "ok": requests * 10,
                        "errors": 0, "sheds": 0}}


def rollout_promote_then_rollback(m, root: Path):
    records, hooks = [], []
    reg = m.registry.ModelRegistry(str(root / "reg"),
                                   clock=FakeClock(1754300000.0))
    reg.publish("v2", task="classify", checkpoint=_ckpt(root))
    reg.publish("v3", task="classify", checkpoint=_ckpt(root, "c3"))
    router = FakeSplitRouter()
    ctrl = m.rollout.RolloutController(
        router, reg, "classify", "v2", stages=(0.01, 0.5, 1.0),
        min_window_requests=10, green_windows_to_advance=1,
        emit=records.append, on_promote=lambda: hooks.append("promote"),
        clock=FakeClock())
    ctrl.start()
    actions = [ctrl.observe(window=w)["action"]
               for w in (_window(3), _window(12), _window(12),
                         _window(12))]
    assert actions == ["hold", "advance", "advance", "promote"]
    assert reg.get("v2")["state"] == "live"
    bad = m.rollout.RolloutController(
        router, reg, "classify", "v3", min_window_requests=10,
        slo_p95_ms=50.0, emit=records.append,
        on_rollback=lambda reason: hooks.append(reason), clock=FakeClock())
    bad.start()
    rec = bad.observe(window=_window(12, p95=80.0))
    assert rec["action"] == "rollback" and "p95" in rec["reason"]
    assert reg.get("v3")["state"] == "staged"
    assert bad.status()["state"] == "rolled_back"
    return actions, router.calls, records, hooks


def test_rollout_promote_then_rollback(m, tmp_path):
    _, _, records, _ = rollout_promote_then_rollback(m, tmp_path)
    for rec in records:
        assert m.schema.validate_record(
            dict(rec, schema=m.schema.SCHEMA_VERSION, ts=0.0)) == [], rec


def test_rollout_records_equal_the_jax_packages(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    jax_out = rollout_promote_then_rollback(_package("jax"),
                                            tmp_path / "jax")
    port_out = rollout_promote_then_rollback(_package("torch"),
                                             tmp_path / "torch")
    assert jax_out == port_out


# -- telemetry/collector.py ----------------------------------------------------

def _router_trace(tid, status=200, total=18.4, winning=2):
    spans = [
        {"name": "admission", "start_ms": 0.0, "dur_ms": 0.2},
        {"name": "attempt", "start_ms": 0.3, "dur_ms": 2.1, "attempt": 1,
         "replica": "http://a:1", "outcome": "transport_error",
         "hedge": False},
        {"name": "backoff", "start_ms": 2.5, "dur_ms": 1.0},
        {"name": "attempt", "start_ms": 3.6, "dur_ms": 14.6, "attempt": 2,
         "replica": "http://b:2", "outcome": "final", "hedge": False,
         "status": 200}]
    rec = {"schema": 1, "ts": 100.0, "kind": "router_trace",
           "tag": "router", "trace_id": tid, "task": "classify",
           "status": status, "total_ms": total, "sampled": True,
           "attempts": 2, "hedges": 0, "hedge_wasted_ms": 0.0,
           "spans": spans}
    if winning is not None:
        rec["winning_attempt"] = winning
    return rec


def _serve_trace(parent, attempt=2, total=12.8, tid="beefcafe-1",
                 sampled=True):
    return {"schema": 1, "ts": 100.1, "kind": "serve_trace", "tag": "serve",
            "trace_id": tid, "task": "classify", "total_ms": total,
            "queue_wait_ms": 2.0, "sampled": sampled,
            "sample_reason": "head" if sampled else "slow",
            "parent_trace_id": parent, "attempt": attempt,
            "spans": [
                {"name": "queue", "start_ms": 0.0, "dur_ms": 2.0},
                {"name": "assembly", "start_ms": 2.0, "dur_ms": 1.5},
                {"name": "execute", "start_ms": 3.5, "dur_ms": 8.0},
                {"name": "postprocess", "start_ms": 11.5, "dur_ms": 1.3}]}


def _sink_files(root: Path) -> tuple:
    router = [_router_trace("rt-ok-1"), _router_trace("rt-lost-1"),
              _router_trace("rt-shed-1", status=503, winning=None),
              {"schema": 1, "ts": 99.0, "kind": "fleet_event",
               "tag": "fleet", "event": "spawn", "replica": 0, "port": 1}]
    replica = [_serve_trace("rt-ok-1"),
               _serve_trace("rt-gone-1", tid="beefcafe-2"),
               _serve_trace("rt-slow-1", tid="beefcafe-3", sampled=False),
               {"schema": 1, "ts": 98.5, "kind": "fleet_event",
                "tag": "fleet", "event": "exit", "replica": 1, "port": 2}]
    paths = []
    for name, recs in (("router", router), ("replica-1", replica)):
        path = root / f"{name}.jsonl"
        path.write_text("".join(json.dumps(r) + "\n" for r in recs))
        paths.append((str(path), name))
    return paths


def collector_timeline(m, root: Path):
    c = m.collector
    paths = _sink_files(root)
    out = root / "timeline.jsonl"
    targets = [c.Target("r0", "replica", "http://r0",
                        scrape=lambda url: {"healthy": True,
                                            "requests": 10.0,
                                            "latency_p99_ms": 40.0}),
               c.Target("dead", "replica", "http://x",
                        scrape=lambda url: None)]
    coll = c.FleetCollector(targets, tails=[c.JsonlTailer(p, n)
                                            for p, n in paths],
                            out_path=str(out), clock=FakeClock(),
                            wall=lambda: 200.0)
    for _ in range(c.STITCH_GRACE_PASSES + 2):
        coll.collect_once()
    coll.close()
    text = out.read_text().replace(str(root), "<root>")
    return [json.loads(line) for line in text.splitlines()]


def test_collector_stitches_and_orphans(m, tmp_path):
    timeline = collector_timeline(m, tmp_path)
    stitches = {s["trace_id"]: s for s in timeline
                if s["kind"] == "trace_stitch"}
    assert stitches["rt-ok-1"]["orphan"] is False
    assert stitches["rt-ok-1"]["winning_source"] == "replica-1"
    assert stitches["rt-gone-1"]["orphan_side"] == "router"
    assert stitches["rt-lost-1"]["orphan_side"] == "replica"
    assert stitches["rt-shed-1"]["replica_spans"] == 0
    assert "rt-slow-1" not in stitches
    assert m.schema.validate_file(str(tmp_path / "timeline.jsonl")) == []


def test_collector_timeline_equals_the_jax_packages(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    jax_out = collector_timeline(_package("jax"), tmp_path / "jax")
    port_out = collector_timeline(_package("torch"), tmp_path / "torch")
    assert jax_out == port_out


def test_collector_tailer_keeps_partial_lines(m, tmp_path):
    path = tmp_path / "sink.jsonl"
    path.write_text('{"a": 1}\n{"b": 2')
    tail = m.collector.JsonlTailer(str(path), "s")
    assert tail.poll() == [{"a": 1}]
    assert tail.poll() == []
    with open(path, "a") as f:
        f.write("}\n")
    assert tail.poll() == [{"b": 2}]


# -- telemetry/report.py: --format json over the same artifacts ----------------

def _fleet_records(failover_p95_ms=120.0, errors=0, gave_up=0):
    records = [{"kind": "fleet_event", "event": "spawn", "replica": i,
                "port": p} for i, p in ((0, 8001), (1, 8002))]
    records += [{"kind": "fleet_event", "event": "gave_up", "replica": 1,
                 "port": 8002}] * gave_up
    records.append({
        "kind": "router_window", "window_requests": 64, "ok": 62 - errors,
        "sheds": 2, "errors": errors, "retries": 3, "hedges": 2,
        "hedge_wins": 1, "failovers": 3, "healthy_replicas": 2,
        "replicas": 2, "latency_p50_ms": 8.0, "latency_p95_ms": 40.0,
        "latency_p99_ms": 80.0, "failover_p50_ms": 60.0,
        "failover_p95_ms": failover_p95_ms})
    return records


def _rollout_records(breaches=0, torn=0):
    records = [{"kind": "rollout_window", "task": "classify",
                "version": "v2", "stage": 0, "canary_share": 0.01,
                "window_requests": 40, "ok": 40, "errors": 0,
                "slo_ok": True, "action": "advance", "torn_serves": 0}]
    records += [{"kind": "rollout_window", "task": "classify",
                 "version": "v2", "stage": 1, "canary_share": 0.5,
                 "window_requests": 40, "ok": 30, "errors": 10,
                 "slo_ok": False, "action": "rollback",
                 "reason": "error budget", "torn_serves": torn}] * breaches
    return records


def _scale_records(flip=False, window_errors=0):
    records = [
        {"kind": "scale_event", "tag": "autoscale", "decision": "scale_up",
         "reason": "red_windows:sheds=5", "replicas_before": 1,
         "replicas_after": 2, "exogenous": 0, "window_requests": 40,
         "window_errors": window_errors, "window_sheds": 5,
         "cooldown_s": 5.0},
        {"kind": "scale_event", "tag": "autoscale",
         "decision": "scale_down", "reason": "green_windows",
         "replicas_before": 2, "replicas_after": 1, "exogenous": 0,
         "window_requests": 4, "window_errors": 0, "window_sheds": 0,
         "cooldown_s": 20.0, "since_last_scale_s": 25.0}]
    if flip:
        records.append(dict(records[0], since_last_scale_s=0.5,
                            window_errors=0))
    return records


def _stitch_records(overhead=1.0, orphan=False):
    records = []
    for i in range(8):
        rec = {"kind": "trace_stitch", "tag": "obs", "trace_id": f"rt-{i}",
               "orphan": False, "router_spans": 2, "replica_spans": 1,
               "status": 200, "client_total_ms": 20.0 + overhead,
               "router_overhead_ms": overhead, "network_gap_ms": 0.5,
               "replica_ms": 19.5, "consistent": True,
               "winning_attempt": 1, "replica_critical_phase": "execute"}
        if orphan and i == 7:
            rec = {"kind": "trace_stitch", "tag": "obs", "trace_id": "rt-7",
                   "orphan": True, "orphan_side": "replica",
                   "router_spans": 2, "replica_spans": 0, "status": 200,
                   "client_total_ms": 20.0}
        records.append(rec)
    return records


def _obs_records(stale=0.4, p99=45.0):
    return [
        {"kind": "obs_scrape", "target": "r1", "target_kind": "replica",
         "ok": False, "staleness_s": stale},
        {"kind": "obs_fleet_window", "targets_total": 3,
         "targets_healthy": 2, "max_staleness_s": stale,
         "replicas_total": 2, "replicas_healthy": 1,
         "worst_replica_p99_ms": p99, "fleet_rps": 40.0,
         "trainer_steps_per_sec": 3.0, "error_budget_burn": 0.5}]


# Each fleet gate: (clean records, breach records, the gate's label).
GATES = {
    "router_failover": (_fleet_records(), _fleet_records(400.0),
                        "router failover p95"),
    "router_errors": (_fleet_records(), _fleet_records(errors=1),
                      "router client-visible errors"),
    "gave_up": (_fleet_records(), _fleet_records(gave_up=1),
                "fleet replicas given up"),
    "canary_slo": (_rollout_records(), _rollout_records(breaches=1),
                   "rollout canary SLO"),
    "torn_serves": (_rollout_records(), _rollout_records(1, torn=1),
                    "rollout torn-model serves"),
    "thrash": (_scale_records(), _scale_records(flip=True),
               "autoscaler thrash"),
    "surge_errors": (_scale_records(), _scale_records(window_errors=3),
                     "surge client-visible errors"),
    "router_overhead": (_stitch_records(), _stitch_records(overhead=11.0),
                        "router overhead share"),
    "orphans": (_stitch_records(), _stitch_records(orphan=True),
                "orphan span share"),
    "staleness": (_obs_records(), _obs_records(stale=5.0),
                  "fleet scrape staleness"),
    "worst_p99": (_obs_records(), _obs_records(p99=200.0),
                  "fleet worst-replica p99"),
}


def _write(path: Path, records) -> str:
    path.write_text("".join(json.dumps(dict(r, schema=1, ts=1.0)) + "\n"
                            for r in records))
    return str(path)


def report_json(m, run: str, base: str):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = m.report.main([run, base, "--format", "json"])
    return rc, json.loads(buf.getvalue())


@pytest.mark.parametrize("gate", sorted(GATES))
def test_report_gate_fires_on_its_breach(m, gate, tmp_path):
    clean, breach, label = GATES[gate]
    base = _write(tmp_path / "base.jsonl", clean)
    bad = _write(tmp_path / "bad.jsonl", breach)
    rc, out = report_json(m, bad, base)
    assert rc == 1 and out["rc"] == 1
    assert label in [r["label"] for r in out["regressions"]]
    rc, out = report_json(m, base, base)
    assert rc == 0 and out["regressions"] == []


@pytest.mark.parametrize("gate", sorted(GATES))
def test_report_json_equals_the_jax_packages(gate, tmp_path):
    clean, breach, _ = GATES[gate]
    base = _write(tmp_path / "base.jsonl", clean)
    bad = _write(tmp_path / "bad.jsonl", breach)
    assert report_json(_package("jax"), bad, base) == report_json(
        _package("torch"), bad, base)


def ledger_drift(m, root: Path):
    """A ledger the test owns: four entries of one leg, the newest 3x
    slower, gated by ``report.main --ledger`` alone."""
    ledger = str(root / "ledger.jsonl")
    for i, step_ms in enumerate((100.0, 101.0, 99.0, 300.0)):
        m.ledger.append_entry(ledger, "train", {"step_ms_p50": step_ms},
                              config={"hidden_size": 16}, ts=100.0 + i)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = m.report.main(["--ledger", ledger, "--format", "json"])
    out = json.loads(buf.getvalue().replace(str(root), "<root>"))
    return rc, out, m.ledger.read_entries(ledger)


def test_report_ledger_drift_gate_on_a_ledger_of_its_own(m, tmp_path):
    rc, out, entries = ledger_drift(m, tmp_path)
    assert rc == 1 and len(entries) == 4
    assert "perf ledger drift" in [r["label"] for r in out["regressions"]]


def test_report_ledger_equals_the_jax_packages(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    assert ledger_drift(_package("jax"), tmp_path / "jax") == \
        ledger_drift(_package("torch"), tmp_path / "torch")


# -- by-path loading: the torch-free parent's modules --------------------------

def _load_jax_by_path(alias: str, *rel: str):
    spec = importlib.util.spec_from_file_location(alias, JAX_DIR.joinpath(*rel))
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return module


def _port_bootstrap():
    spec = importlib.util.spec_from_file_location(
        "_torchtest_bootstrap", PORT_DIR / "tools" / "_bootstrap.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


BY_PATH = (("supervisor", "serve", "supervisor.py"),
           ("router", "serve", "router.py"),
           ("autoscaler", "serve", "autoscaler.py"),
           ("registry", "serve", "registry.py"),
           ("rollout", "serve", "rollout.py"),
           ("collector", "telemetry", "collector.py"),
           ("report", "telemetry", "report.py"),
           ("schema", "telemetry", "schema.py"))


def test_by_path_modules_never_cross_packages():
    """Load the JAX package's fleet modules by path under its own
    aliases, then the port's through its bootstrap: every module the
    port's loads registered (its own and the siblings they pulled in)
    lives under bert_pytorch_tpu_torch/, every JAX alias under
    bert_pytorch_tpu/, and no alias names both."""
    jax_mods = {name: _load_jax_by_path(f"_fleet_{name}", *rel)
                for name, *rel in BY_PATH}
    jax_mods["report"]._load_ledger()
    boot = _port_bootstrap()
    port_mods = {name: boot.load_by_path(f"_torchfleet_{name}", *rel)
                 for name, *rel in BY_PATH}
    port_mods["report"]._load_ledger()
    port_aliases = [k for k in sys.modules if k.startswith("_torch")]
    jax_aliases = [k for k in sys.modules
                   if k.startswith(("_fleet_", "_router_", "_collector_",
                                    "_report_"))]
    assert set(port_aliases).isdisjoint(jax_aliases)
    assert {"_torchfleet_utils_retry", "_torchfleet_telemetry_sentinels",
            "_torchfleet_utils_integrity", "_torchrouter_retry",
            "_torchcollector_schema", "_torchreport_ledger"} <= set(
                port_aliases)
    for alias in port_aliases:
        path = Path(sys.modules[alias].__file__).resolve()
        if alias != "_torchtest_bootstrap":
            assert PORT_DIR in path.parents, (alias, path)
    for alias in jax_aliases:
        path = Path(sys.modules[alias].__file__).resolve()
        assert JAX_DIR in path.parents, (alias, path)
    for name, module in port_mods.items():
        assert module is not jax_mods[name]
        assert PORT_DIR in Path(module.__file__).resolve().parents


def test_by_path_supervisor_records_equal_the_package_import(tmp_path):
    boot = _port_bootstrap()
    by_path = types.SimpleNamespace(
        supervisor=boot.load_by_path("_torchfleet_supervisor", "serve",
                                     "supervisor.py"),
        retry=boot.load_by_path("_torchfleet_retry", "utils", "retry.py"),
        preemption=boot.load_by_path("_torchfleet_preemption", "utils",
                                     "preemption.py"))
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    assert sup_backoff_give_up(by_path, tmp_path / "a") == \
        sup_backoff_give_up(_package("torch"), tmp_path / "b")
    assert os.path.samefile(
        by_path.supervisor.RetryPolicy.__module__ and
        sys.modules[by_path.supervisor.RetryPolicy.__module__].__file__,
        PORT_DIR / "utils" / "retry.py")
