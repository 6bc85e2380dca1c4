"""Replica supervisor: own N serving subprocesses, keep them alive
— a copy of the JAX package's ``serve/supervisor.py``, kept decision for
decision (``tests/test_torch_fleet.py`` holds the two to the same
records), whose replicas are the port's ``run_server``.

A single serving engine process is a single point of failure — the fleet
tier's first primitive (The Tail at Scale, Dean & Barroso 2013) is
simply N replicas that something RESTARTS. The :class:`Supervisor` owns
one subprocess per :class:`ReplicaSpec` (a ``python -m
bert_pytorch_tpu_torch.run_server`` on its own port, finding its CUDA
kernel libraries already built in the shared ``--compile_cache_dir`` so a
restart costs seconds, not an ``nvcc`` run — the zero-cold-build
property is what makes supervision worth having) and runs one monitor
thread that:

* **reaps exits** — a replica that died is classified by exit code:
  ``EXIT_PREEMPTED`` (75) means a SIGTERM-initiated drain finished
  cleanly (run_server holds the training runners' preemption
  contract); anything else is a crash and schedules a restart;
* **applies restart-storm backoff** — consecutive crash restarts walk a
  full-jitter exponential schedule (``utils/retry.py RetryPolicy``) so a
  crash-looping replica cannot hot-spin the host; a replica that stays
  up ``stable_reset_s`` earns its backoff index back. After
  ``policy.attempts`` consecutive crashes the supervisor GIVES UP on
  that replica (emits the event; the router's health gate has long since
  stopped routing to it);
* **catches wedges the health check cannot** — a dispatch thread stuck
  in a hung device call keeps ``/healthz`` answering 200 (the thread is
  alive, just never finishing a batch). The supervisor instead watches
  the replica's HEARTBEAT FILE (the same resumable liveness file the
  training runners write; the serve dispatch loop beats it once per
  second with its request count): a counter that stops advancing past
  ``heartbeat_timeout_s`` gets the replica SIGKILLed and restarted —
  the watchdog path ``tools/chaos_serve.py`` proves. A beat that
  carries ``hold_s`` (the port's addition: a replica about to collect a
  ``/profilez`` trace, which holds its interpreter for seconds) adds
  that many seconds to the timeout until the next beat;
* **optionally probes /healthz** — ``probe_failures_to_kill``
  consecutive failed probes of a process that still looks alive also
  force a restart (listener wedged while dispatch runs).

Every decision emits a schema-v1 ``fleet_event`` record, so the chaos
harness (and an operator reading the artifact) can reconstruct exactly
what the supervisor saw and did.

This module is **stdlib-only and dual-loadable**: imported normally it
is part of the serve package; loaded by FILE PATH (tools/_bootstrap.py)
it pulls its utility dependencies the same way, so the torch-free
chaos/fleet parents never execute the ``serve`` package ``__init__``
chain (which imports torch): a parent that imported torch could take a
CUDA context and card memory the replicas need, and a hung CUDA call can
hang a REPLICA (which the watchdog kills), never the supervisor itself.
"""

from __future__ import annotations

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.parse
from typing import Callable, List, Optional, Sequence


def _load_pkg_module(subpkg: str, modname: str):
    """Import a stdlib-only package sibling both ways: through the
    package when this module was imported normally, by file path when
    this module was itself loaded by path (the ``serve`` package
    ``__init__`` imports torch — the property tools/chaos_serve.py
    needs). By-path aliases carry the ``_torchfleet_`` prefix, so a
    process that also loads the JAX package's copies by path never gets
    one package's module under the other's name."""
    if __package__:
        import importlib

        return importlib.import_module(
            f"bert_pytorch_tpu_torch.{subpkg}.{modname}")
    import importlib.util

    alias = f"_torchfleet_{subpkg}_{modname}"
    module = sys.modules.get(alias)
    if module is not None:
        return module
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), subpkg, f"{modname}.py")
    spec = importlib.util.spec_from_file_location(alias, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return module


def _load_util(modname: str):
    return _load_pkg_module("utils", modname)


RetryPolicy = _load_util("retry").RetryPolicy
EXIT_PREEMPTED = _load_util("preemption").EXIT_PREEMPTED
# The same resumable liveness file the training runners and run_server
# write — the supervisor is the fleet's last liveness blind spot
# (telemetry/sentinels.py is stdlib-only, like utils/retry.py).
Heartbeat = _load_pkg_module("telemetry", "sentinels").Heartbeat

# How many of a harvested postmortem's newest records/lines ride the
# fleet_event (the full file stays on disk for the operator; the event
# names WHY the replica died without bloating the fleet artifact).
_HARVEST_TAIL = 5

# Replica lifecycle states (status()/fleet_event records).
STARTING = "starting"    # spawned; no heartbeat observed yet
RUNNING = "running"      # heartbeat advancing / probe ok
BACKOFF = "backoff"      # crashed; restart scheduled
FAILED = "failed"        # gave up (restart storm exhausted the policy)
STOPPED = "stopped"      # drained/stopped by the supervisor


class ReplicaSpec:
    """One replica's immutable launch description."""

    def __init__(self, index: int, port: int, cmd: Sequence[str],
                 heartbeat_file: Optional[str] = None,
                 postmortem_file: Optional[str] = None,
                 env: Optional[dict] = None,
                 host: str = "127.0.0.1"):
        self.index = int(index)
        self.port = int(port)
        self.cmd = list(cmd)
        self.heartbeat_file = heartbeat_file
        # The replica's flight-recorder flush target (telemetry/
        # flightrec.py): harvested into a fleet_event when the replica
        # dies, so the failover story names WHY.
        self.postmortem_file = postmortem_file
        self.env = dict(env) if env is not None else None
        self.host = host

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"


# Ports minted by ReplicaTemplate.alloc_port, each held by a bound socket
# (SO_REUSEADDR, never listening) until its replica retires. The kernel
# then hands the port to no outgoing connection and to no other bind to
# 0 while the replica is down, so a respawn finds its port free; the
# replica's HTTP server binds beside the held socket (it sets
# SO_REUSEADDR too).
_HELD_PORTS: dict = {}


def release_port(port: int) -> None:
    """Close the socket holding ``port`` (a no-op for a port this module
    did not mint)."""
    held = _HELD_PORTS.pop(int(port), None)
    if held is not None:
        held.close()


# The repo root: the replicas start as ``python -m
# bert_pytorch_tpu_torch.run_server`` with it as their working directory.
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_server_command(port: int, output_dir: str,
                       extra_args: Sequence[str],
                       python: Optional[str] = None,
                       script: Optional[str] = None) -> List[str]:
    """The port's ``run_server`` argv for one replica: shared
    engine/model flags (``extra_args``) plus the per-replica port and
    output dir (the telemetry JSONL and the heartbeat file the supervisor
    watches both default under it). Without ``script`` the replica is
    ``python -m bert_pytorch_tpu_torch.run_server``, which resolves with
    :data:`REPO_ROOT` as the working directory (the spawn functions set
    it); a ``script`` path is run as a file."""
    head = [script] if script else ["-m", "bert_pytorch_tpu_torch.run_server"]
    return ([python or sys.executable, *head, *extra_args,
             "--port", str(port), "--output_dir", output_dir])


class ReplicaTemplate:
    """Shared launch recipe for elastically spawned replicas
    (docs/serving.md "Elastic fleet").

    The engine/model flags — including the ``--compile_cache_dir`` whose
    built kernel libraries make a new replica warm in seconds — are
    fixed ONCE; each
    :meth:`make_spec` call mints only the per-replica pieces: a fresh
    port (bind-to-zero unless the caller supplies one), an output dir
    named after the replica index, and the heartbeat/postmortem files
    the supervisor watches under it. ``Supervisor.add_replica`` and the
    chaos harness both build argv from this one recipe instead of two
    hand-rolled copies drifting apart.
    """

    def __init__(self, shared_args: Sequence[str], output_root: str,
                 python: Optional[str] = None,
                 script: Optional[str] = None,
                 env: Optional[dict] = None,
                 host: str = "127.0.0.1",
                 dir_name: str = "replica_{index}",
                 heartbeat_name: str = "heartbeat.json",
                 postmortem_name: Optional[str] = None):
        self.shared_args = list(shared_args)
        self.output_root = output_root
        self.python = python
        self.script = script
        self.env = dict(env) if env is not None else {}
        self.host = host
        self.dir_name = dir_name
        self.heartbeat_name = heartbeat_name
        self.postmortem_name = postmortem_name

    @staticmethod
    def alloc_port() -> int:
        """A free local port, kernel-assigned (bind to 0) and held until
        :func:`release_port`."""
        s = socket.socket()
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
        except OSError:
            s.close()
            raise
        port = s.getsockname()[1]
        _HELD_PORTS[port] = s
        return port

    def make_spec(self, index: int, port: Optional[int] = None,
                  extra_args: Sequence[str] = (),
                  env: Optional[dict] = None) -> ReplicaSpec:
        """One replica's spec from the shared recipe: fresh port, its
        own output dir (created), heartbeat file under it."""
        port = int(port) if port is not None else self.alloc_port()
        out_dir = os.path.join(self.output_root,
                               self.dir_name.format(index=int(index)))
        os.makedirs(out_dir, exist_ok=True)
        merged_env = dict(self.env)
        if env:
            merged_env.update(env)
        return ReplicaSpec(
            int(index), port,
            run_server_command(port, out_dir,
                               [*self.shared_args, *extra_args],
                               python=self.python, script=self.script),
            heartbeat_file=os.path.join(out_dir, self.heartbeat_name),
            postmortem_file=(os.path.join(out_dir, self.postmortem_name)
                             if self.postmortem_name else None),
            env=merged_env, host=self.host)


class _Replica:
    """Mutable runtime state for one supervised subprocess (internal;
    every field is read/written under ``Supervisor._lock``)."""

    def __init__(self, spec: ReplicaSpec):
        self.spec = spec
        self.proc = None
        self.state = STOPPED
        self.restarts = 0            # total spawns beyond the first
        self.consecutive = 0         # crash restarts since last stable run
        self.rapid_graceful = 0      # consecutive graceful exits that
                                     # never reached stable_reset_s
        self.started_at = 0.0
        self.restart_at: Optional[float] = None
        self.last_rc: Optional[int] = None
        self.hb_counter: Optional[int] = None
        self.hb_advance_at = 0.0     # clock time the counter last moved
        self.hb_hold_s = 0.0         # the newest beat's declared hold
        self.probe_failures = 0
        # Decommission flag (drain_replica): once set it NEVER clears —
        # the exit is reaped WITHOUT respawn and the slot stays retired
        # (its index is never reused; add_replica mints fresh ones).
        self.draining = False


class Supervisor:
    """Keep ``specs``'s replica subprocesses alive until :meth:`stop`.

    Every collaborator is injectable for deterministic tests: ``spawn``
    (a ``subprocess.Popen``-alike factory), ``probe`` (url -> health
    dict or None), ``read_heartbeat`` (spec -> counter int or None),
    ``clock``/``sleep``. Production uses the defaults.
    """

    def __init__(
        self,
        specs: Sequence[ReplicaSpec],
        emit: Optional[Callable[[dict], None]] = None,
        spawn: Optional[Callable[[ReplicaSpec], object]] = None,
        policy: Optional[RetryPolicy] = None,
        heartbeat_timeout_s: float = 15.0,
        startup_grace_s: float = 120.0,
        stable_reset_s: float = 30.0,
        probe: Optional[Callable[[str], Optional[dict]]] = None,
        probe_failures_to_kill: int = 3,
        poll_interval_s: float = 0.5,
        drain_grace_s: float = 15.0,
        read_heartbeat: Optional[Callable[[ReplicaSpec],
                                          Optional[int]]] = None,
        heartbeat_file: Optional[str] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if not specs:
            raise ValueError("need at least one ReplicaSpec")
        self._emit_fn = emit
        self._spawn = spawn or self._default_spawn
        # Full jitter: when a shared cause (OOM, bad rollout) crashes
        # several replicas at once, their restart storms must not march
        # in lockstep against the same compile cache / port range.
        self.policy = policy or RetryPolicy(
            attempts=6, base_delay_s=0.5, max_delay_s=30.0,
            full_jitter=True)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.startup_grace_s = float(startup_grace_s)
        self.stable_reset_s = float(stable_reset_s)
        self._probe = probe
        self.probe_failures_to_kill = int(probe_failures_to_kill)
        self.poll_interval_s = float(poll_interval_s)
        self.drain_grace_s = float(drain_grace_s)
        self._read_heartbeat = read_heartbeat or self._heartbeat_counter
        self._clock = clock
        self._sleep = sleep
        # Guards _replicas (and every _Replica field): the monitor
        # thread mutates replica state while start()/stop()/status()
        # callers read it.
        self._lock = threading.Lock()
        self._replicas = [_Replica(spec) for spec in specs]
        # Monotone replica-index mint for add_replica: an index is
        # NEVER reused, so every fleet_event/scale_event stream entry
        # stays attributable to exactly one replica incarnation lineage.
        self._next_index = max(spec.index for spec in specs) + 1
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # The supervisor's OWN liveness file (step = supervision ticks):
        # the same resumable heartbeat the runners and run_server write,
        # closing the chaos harness's last liveness blind spot. Beaten
        # only from poll_once (the monitor thread, or the fake-clock
        # test driving passes itself) — Heartbeat relies on that
        # single-caller lifecycle, like the serve dispatch loop's.
        self._heartbeat = Heartbeat(heartbeat_file) if heartbeat_file \
            else None
        self._ticks = 0

    # -- telemetry --------------------------------------------------------

    def _emit(self, event: str, replica: _Replica, **extra) -> None:
        if self._emit_fn is None:
            return
        record = {"kind": "fleet_event", "tag": "fleet", "event": event,
                  "replica": replica.spec.index,
                  "port": replica.spec.port}
        record.update(extra)
        try:
            self._emit_fn(record)
        except Exception:
            pass  # observability must never take the fleet down

    # -- default collaborators -------------------------------------------

    @staticmethod
    def _default_spawn(spec: ReplicaSpec):
        env = dict(os.environ)
        if spec.env:
            env.update(spec.env)
        return subprocess.Popen(spec.cmd, env=env, cwd=REPO_ROOT)

    @staticmethod
    def _heartbeat_counter(spec: ReplicaSpec) -> Optional[int]:
        """The replica's heartbeat counter (telemetry/sentinels.py
        Heartbeat writes it atomically); None = no/torn file, treated
        as "no evidence of liveness"."""
        if not spec.heartbeat_file:
            return None
        try:
            with open(spec.heartbeat_file) as f:
                return int(json.load(f).get("counter", 0))
        except (OSError, ValueError, TypeError):
            return None

    @staticmethod
    def _heartbeat_hold(spec: ReplicaSpec) -> float:
        """Seconds the replica's newest beat asked the watchdog to wait
        beyond its timeout (``hold_s``, telemetry/sentinels.py); 0 when
        the beat declared none or the file is absent or torn."""
        if not spec.heartbeat_file:
            return 0.0
        try:
            with open(spec.heartbeat_file) as f:
                return max(0.0, float(json.load(f).get("hold_s", 0.0)))
        except (OSError, ValueError, TypeError, AttributeError):
            return 0.0

    # -- lifecycle --------------------------------------------------------

    def start(self, monitor: bool = True) -> None:
        """Spawn every replica and the monitor thread. ``monitor=False``
        skips the thread — fake-clock tests drive :meth:`poll_once`
        themselves."""
        now = self._clock()
        with self._lock:
            for rep in self._replicas:
                if rep.proc is None and not rep.draining:
                    self._spawn_locked(rep, now)
        self._stop_event.clear()
        if monitor:
            self._thread = threading.Thread(
                target=self._loop, name="fleet-supervisor", daemon=True)
            self._thread.start()

    def _spawn_locked(self, rep: _Replica, now: float) -> None:
        if rep.spec.postmortem_file:
            # Fresh forensics per incarnation: the dead predecessor's
            # postmortem was harvested at reap time (the fleet_event);
            # leaving the file would let a NEXT crash-before-first-flush
            # harvest the wrong incarnation's last seconds.
            try:
                os.remove(rep.spec.postmortem_file)
            except OSError:
                pass
        rep.proc = self._spawn(rep.spec)
        rep.state = STARTING
        rep.started_at = now
        rep.restart_at = None
        # Baseline the heartbeat BEFORE the new process beats: the file
        # survives restarts (the counter resumes from it), so the dead
        # predecessor's last value must not read as an "advance" — that
        # would flip a still-warming replica to RUNNING and arm the
        # short wedge timeout against its startup time.
        rep.hb_counter = self._read_heartbeat(rep.spec)
        rep.hb_advance_at = now
        rep.hb_hold_s = 0.0
        rep.probe_failures = 0
        self._emit("spawn", rep, restarts=rep.restarts,
                   pid=getattr(rep.proc, "pid", None))

    def _loop(self) -> None:
        while not self._stop_event.is_set():
            self.poll_once()
            self._sleep(self.poll_interval_s)

    # -- the monitoring pass (public for fake-clock tests) ---------------

    def poll_once(self) -> None:
        """One monitoring pass over every replica: reap exits, schedule
        and execute backoff restarts, kill wedged processes. Each pass
        beats the supervisor's own heartbeat (step = tick count), so
        "is the supervisor itself alive" is readable the same way
        replica liveness is."""
        now = self._clock()
        with self._lock:
            for rep in self._replicas:
                self._poll_replica_locked(rep, now)
        self._ticks += 1
        if self._heartbeat is not None:
            self._heartbeat.beat(self._ticks)

    def _poll_replica_locked(self, rep: _Replica, now: float) -> None:
        if rep.state == FAILED or (rep.state == STOPPED
                                   and rep.proc is None):
            return
        if rep.state == BACKOFF:
            if rep.restart_at is not None and now >= rep.restart_at:
                rep.restarts += 1
                self._spawn_locked(rep, now)
            return
        proc = rep.proc
        if proc is None:
            return
        rc = proc.poll()
        if rc is not None:
            self._handle_exit_locked(rep, rc, now)
            return
        # Alive: fold in heartbeat progress, then the wedge/probe checks.
        counter = self._read_heartbeat(rep.spec)
        if counter is not None and counter != rep.hb_counter:
            rep.hb_counter = counter
            rep.hb_advance_at = now
            rep.hb_hold_s = self._heartbeat_hold(rep.spec)
            if rep.state == STARTING:
                rep.state = RUNNING
            # A stable stretch pays the restart-storm debt back (and
            # re-earns the free graceful respawn).
            if ((rep.consecutive or rep.rapid_graceful)
                    and now - rep.started_at >= self.stable_reset_s):
                rep.consecutive = 0
                rep.rapid_graceful = 0
        if rep.spec.heartbeat_file:
            limit = (self.heartbeat_timeout_s + rep.hb_hold_s
                     if rep.state == RUNNING else self.startup_grace_s)
            age = now - max(rep.hb_advance_at, rep.started_at)
            if age > limit:
                self._emit("wedged_kill", rep,
                           heartbeat_age_s=round(age, 3),
                           requests=rep.hb_counter)
                self._kill_locked(rep)
                self._harvest_postmortem_locked(rep, context="wedged")
                if rep.draining:
                    # A drain that wedged instead of exiting: the kill
                    # completes the decommission, never a respawn.
                    rep.state = STOPPED
                    self._emit("drain_complete", rep, rc=rep.last_rc,
                               graceful=False)
                    return
                self._schedule_restart_locked(rep, now, crash=True,
                                              reason="wedged")
                return
        if self._probe is not None and rep.state == RUNNING:
            health = None
            try:
                health = self._probe(rep.spec.url)
            except Exception:
                health = None
            ok = bool(health) and health.get("status") in ("ok", "draining")
            rep.probe_failures = 0 if ok else rep.probe_failures + 1
            if rep.probe_failures >= self.probe_failures_to_kill:
                self._emit("probe_kill", rep,
                           failures=rep.probe_failures)
                self._kill_locked(rep)
                self._harvest_postmortem_locked(rep, context="probe")
                if rep.draining:
                    rep.state = STOPPED
                    self._emit("drain_complete", rep, rc=rep.last_rc,
                               graceful=False)
                    return
                self._schedule_restart_locked(rep, now, crash=True,
                                              reason="probe")

    def _handle_exit_locked(self, rep: _Replica, rc: int,
                            now: float) -> None:
        rep.last_rc = rc
        rep.proc = None
        graceful = rc in (0, EXIT_PREEMPTED)
        self._emit("exit", rep, rc=rc, graceful=graceful,
                   uptime_s=round(now - rep.started_at, 3))
        if not graceful:
            # The failover story should name WHY the replica died, not
            # just that it did: harvest the dead process's flight-
            # recorder flush (its last telemetry records and log lines)
            # into the fleet artifact before the slot is respawned.
            self._harvest_postmortem_locked(rep, context="exit")
        if rep.draining:
            # A scale-down drain (drain_replica): the ONE exit the
            # supervisor's "N alive" contract does not replace. Reap,
            # mark the slot retired, and tell the autoscaler the drain
            # is confirmed — the router target is removed only now, so
            # every in-flight request already got its answer.
            rep.state = STOPPED
            release_port(rep.spec.port)
            self._emit("drain_complete", rep, rc=rc, graceful=graceful)
            return
        if self._stop_event.is_set():
            rep.state = STOPPED
            return
        # A replica that drained on an external SIGTERM still leaves the
        # fleet a replica short — the supervisor's contract is N alive,
        # so graceful exits respawn too, just WITHOUT burning the
        # restart-storm budget (the exit was asked for, not a crash).
        # ONE free graceful respawn per stable stretch, though: a
        # replica that keeps exiting 0/75 within stable_reset_s of each
        # spawn is a crash loop wearing a polite exit code (a config
        # that drains instantly, an external agent SIGTERMing every
        # startup), and a zero-backoff respawn every poll tick is
        # exactly the storm the backoff schedule exists to prevent.
        if graceful:
            rapid = (now - rep.started_at) < self.stable_reset_s
            churn = rapid and rep.rapid_graceful > 0
            rep.rapid_graceful = rep.rapid_graceful + 1 if rapid else 0
            self._schedule_restart_locked(
                rep, now, crash=churn,
                reason="graceful_churn" if churn else "exit")
        else:
            self._schedule_restart_locked(rep, now, crash=True,
                                          reason="exit")

    def _schedule_restart_locked(self, rep: _Replica, now: float,
                                 crash: bool, reason: str) -> None:
        if crash:
            if rep.consecutive + 1 >= self.policy.attempts:
                rep.state = FAILED
                self._emit("gave_up", rep, restarts=rep.restarts,
                           consecutive=rep.consecutive + 1)
                return
            backoff = self.policy.backoff_s(rep.consecutive)
            rep.consecutive += 1
        else:
            backoff = 0.0
        rep.state = BACKOFF
        rep.restart_at = now + backoff
        self._emit("restart_scheduled", rep, backoff_s=round(backoff, 3),
                   restarts=rep.restarts, crash=crash, reason=reason)

    def _harvest_postmortem_locked(self, rep: _Replica,
                                   context: str) -> None:
        """Emit the dead replica's postmortem (telemetry/flightrec.py
        flush) as a ``fleet_event``: the ring's newest records/lines
        (bounded to ``_HARVEST_TAIL`` each — the file keeps the full
        ring for the operator), the flush reason, and whether a
        postmortem existed at all (a crash before the first flush is
        itself diagnostic)."""
        spec = rep.spec
        if not spec.postmortem_file:
            return
        pm = None
        try:
            with open(spec.postmortem_file, "r", encoding="utf-8") as f:
                pm = json.load(f)
        except (OSError, ValueError):
            pm = None
        if not isinstance(pm, dict):
            self._emit("postmortem", rep, context=context, found=False,
                       path=spec.postmortem_file)
            return
        records = pm.get("records") or []
        lines = pm.get("lines") or []
        self._emit(
            "postmortem", rep, context=context, found=True,
            path=spec.postmortem_file,
            reason=pm.get("reason"), process=pm.get("process"),
            flushed_at=pm.get("flushed_at"),
            ring_entries=pm.get("ring_entries"),
            ring_bytes=pm.get("ring_bytes"),
            dropped=pm.get("dropped"),
            records=records[-_HARVEST_TAIL:]
            if isinstance(records, list) else [],
            lines=lines[-_HARVEST_TAIL:]
            if isinstance(lines, list) else [])

    def _kill_locked(self, rep: _Replica) -> None:
        proc = rep.proc
        rep.proc = None
        if proc is None:
            return
        try:
            proc.kill()
            proc.wait(timeout=10.0)
        except Exception:
            pass

    # -- drain / stop -----------------------------------------------------

    def stop(self) -> dict:
        """Drain the fleet: SIGTERM every replica, wait up to
        ``drain_grace_s`` for the preemption-contract exits (rc 75 /
        0), SIGKILL stragglers, join the monitor thread. Returns a
        summary the chaos harness asserts on: per-replica final rc and
        whether every live replica drained gracefully."""
        self._stop_event.set()
        with self._lock:
            live = [rep for rep in self._replicas if rep.proc is not None]
            for rep in live:
                self._emit("drain", rep)
                try:
                    rep.proc.send_signal(signal.SIGTERM)
                except Exception:
                    pass
        deadline = self._clock() + self.drain_grace_s
        while self._clock() < deadline:
            with self._lock:
                waiting = False
                for rep in self._replicas:
                    if rep.proc is None:
                        continue
                    rc = rep.proc.poll()
                    if rc is None:
                        waiting = True
                    else:
                        self._handle_exit_locked(rep, rc, self._clock())
            if not waiting:
                break
            self._sleep(min(0.05, self.poll_interval_s))
        killed = 0
        with self._lock:
            for rep in self._replicas:
                if rep.proc is not None:
                    killed += 1
                    self._emit("drain_kill", rep)
                    self._kill_locked(rep)
                    rep.state = STOPPED
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        with self._lock:
            rcs = {rep.spec.index: rep.last_rc for rep in self._replicas}
            for rep in self._replicas:
                release_port(rep.spec.port)
        graceful = all(rc in (0, EXIT_PREEMPTED)
                       for rc in rcs.values() if rc is not None)
        return {"rcs": rcs, "drain_killed": killed,
                "all_graceful": graceful and killed == 0}

    # -- elastic membership (serve/autoscaler.py, docs/serving.md
    # "Elastic fleet") ----------------------------------------------------

    def add_replica(self, template: ReplicaTemplate,
                    port: Optional[int] = None) -> ReplicaSpec:
        """Grow the fleet by one: mint a spec from ``template`` under a
        NEVER-REUSED replica index (fresh port + output dir + heartbeat
        baseline per incarnation), spawn it, and return the spec. The
        caller registers ``spec.url`` with the router, where the new
        target enters UNHEALTHY until its first clean scrape — a
        still-warming replica never absorbs traffic."""
        now = self._clock()
        with self._lock:
            index = self._next_index
            self._next_index += 1
            spec = template.make_spec(index, port=port)
            rep = _Replica(spec)
            self._replicas.append(rep)
            self._spawn_locked(rep, now)
        return spec

    def drain_replica(self, index: int) -> dict:
        """Shrink the fleet by one: SIGTERM replica ``index`` and reap
        its exit WITHOUT respawn — the one exit the supervisor's "N
        alive" contract does not replace. The replica drains through
        the same preemption contract :meth:`stop` uses (finish in-flight
        work, exit rc 75); the monitor pass marks it STOPPED when the
        exit lands. The caller removes the router target only after
        :meth:`status` confirms the drain, so no request is stranded.
        The slot stays decommissioned forever (``draining`` never
        clears; the index is never reused)."""
        with self._lock:
            matches = [rep for rep in self._replicas
                       if rep.spec.index == int(index)]
            if not matches:
                raise ValueError(f"no replica with index {index}")
            rep = matches[0]
            if rep.draining:
                return {"replica": rep.spec.index, "state": rep.state}
            rep.draining = True
            self._emit("scale_drain", rep, state=rep.state)
            if rep.proc is None:
                # Nothing running (backoff slot / already exited):
                # decommission directly — there is no drain to wait on.
                rep.state = STOPPED
                rep.restart_at = None
                release_port(rep.spec.port)
                self._emit("drain_complete", rep, rc=rep.last_rc,
                           graceful=True)
                return {"replica": rep.spec.index, "state": rep.state}
            try:
                rep.proc.send_signal(signal.SIGTERM)
            except Exception:
                pass
            return {"replica": rep.spec.index, "state": rep.state}

    def active_count(self) -> int:
        """Replicas that count as fleet capacity: not decommissioned
        and not given up on. A slot mid-crash-restart (BACKOFF) still
        counts — its respawn is already owed, and counting the respawn
        as NEW capacity would double-book a SIGKILLed replica (exactly
        the drift the autoscaler's membership chain lint forbids)."""
        with self._lock:
            return sum(1 for rep in self._replicas
                       if not rep.draining
                       and rep.state not in (STOPPED, FAILED))

    # -- hot-swap control (docs/serving.md "Model registry & canary
    # rollouts") ----------------------------------------------------------

    def swap_replica(self, index: int, task: str, checkpoint: str,
                     version: str, timeout_s: float = 120.0) -> dict:
        """Drive one replica's ``POST /swapz`` (serve/http.py): load the
        checkpoint on the replica's control thread, flip its serving
        params atomically. The supervisor resolves the checkpoint path
        from the registry PARENT-SIDE — the replica never needs the
        registry module, only a readable file. Returns the swap info
        dict; raises RuntimeError on a non-200 answer (the caller —
        rollout controller or chaos harness — decides whether that is
        fatal). Every attempt emits fleet_event swap_requested and then
        swap_ok (with the compile split) or swap_failed."""
        with self._lock:
            matches = [rep for rep in self._replicas
                       if rep.spec.index == int(index)]
        if not matches:
            raise ValueError(f"no replica with index {index}")
        rep = matches[0]
        self._emit("swap_requested", rep, task=str(task),
                   version=str(version))
        body = json.dumps({"task": str(task),
                           "checkpoint": str(checkpoint),
                           "version": str(version)}).encode("utf-8")
        parsed = urllib.parse.urlsplit(rep.spec.url)
        conn = http.client.HTTPConnection(
            parsed.hostname, parsed.port, timeout=max(1.0, timeout_s))
        try:
            try:
                conn.request("POST", "/swapz", body=body,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read().decode("utf-8", "replace")
                status = resp.status
            except OSError as exc:
                self._emit("swap_failed", rep, task=str(task),
                           version=str(version),
                           error=f"{type(exc).__name__}: {exc}")
                raise RuntimeError(
                    f"swap transport failure on replica {index}: "
                    f"{exc}") from exc
        finally:
            conn.close()
        try:
            info = json.loads(data) if data else {}
        except ValueError:
            info = {"error": data[:200]}
        if status != 200:
            self._emit("swap_failed", rep, task=str(task),
                       version=str(version), status=int(status),
                       error=str(info.get("error", ""))[:200])
            raise RuntimeError(
                f"swap failed on replica {index} "
                f"(status {status}): {info.get('error')}")
        self._emit("swap_ok", rep, task=str(task), version=str(version),
                   load_s=info.get("load_s"),
                   compiles_cold=info.get("compiles_cold"),
                   compiles_warm=info.get("compiles_warm"))
        return info

    def swap_all(self, task: str, checkpoint: str, version: str,
                 timeout_s: float = 120.0,
                 skip_indices: Sequence[int] = ()) -> List[dict]:
        """Swap every replica SEQUENTIALLY (skipping ``skip_indices`` —
        the canary replicas that already serve the version). Sequential
        on purpose: with N-1 replicas still serving, one replica busy
        loading costs capacity, never availability; swapping the fleet
        at once would stack every load on the same window."""
        skip = {int(i) for i in skip_indices}
        with self._lock:
            indices = [rep.spec.index for rep in self._replicas
                       if rep.spec.index not in skip]
        return [self.swap_replica(i, task, checkpoint, version,
                                  timeout_s=timeout_s)
                for i in indices]

    # -- introspection ----------------------------------------------------

    def status(self) -> List[dict]:
        """Per-replica snapshot (state, restarts, pid, port) under the
        lock — what the chaos harness and tests assert on."""
        with self._lock:
            return [{
                "replica": rep.spec.index,
                "port": rep.spec.port,
                "url": rep.spec.url,
                "state": rep.state,
                "restarts": rep.restarts,
                "consecutive_crashes": rep.consecutive,
                "pid": getattr(rep.proc, "pid", None),
                "last_rc": rep.last_rc,
                "heartbeat_counter": rep.hb_counter,
                "draining": rep.draining,
            } for rep in self._replicas]

    def replica_urls(self) -> List[str]:
        with self._lock:
            return [rep.spec.url for rep in self._replicas]
