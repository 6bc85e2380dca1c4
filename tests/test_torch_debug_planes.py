"""The port's debug planes held against the JAX package's on the CPU.

Each new module of the port meets its JAX counterpart on the same input:
the flight recorders on one record and log-line stream (the same
postmortem payload apart from ``pid`` and the flush stamps, which come
from the same injected clock anyway); the capture controllers on one
``arm``/``status``/``tick`` script under one injected clock (the same
phases, refusals, caps and ``profile_window`` fields, frames and paths
excepted); the introspection hubs on one record stream (equal /statsz
JSON, /metricsz text and /healthz answers, over HTTP too); the kernel
build's ``compile`` records through both schemas. Then the port's
``run_server`` with its planes: the JAX server's ``serve_window`` keys
for the same requests, the heartbeat, ``POST /profilez``, the pending cap,
the serial dispatch mode, and SIGTERM/SIGINT in a subprocess; and the
trainers with ``--debug_port`` and the flight recorder. Tolerances: exact
everywhere (the same stdlib arithmetic on the same inputs).
"""

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import run_server as jax_run_server
from bert_pytorch_tpu.serve import make_server as jax_make_server
from bert_pytorch_tpu.telemetry import flightrec as jax_flightrec
from bert_pytorch_tpu.telemetry import introspect as jax_introspect
from bert_pytorch_tpu.telemetry import sampler as jax_sampler
from bert_pytorch_tpu.telemetry import schema as jax_schema
from bert_pytorch_tpu_torch import run_glue, run_pretraining, run_server
from bert_pytorch_tpu_torch.ops.kernels import build as kernel_build
from bert_pytorch_tpu_torch.serve import make_server
from bert_pytorch_tpu_torch.telemetry import (cli, compile_events, flightrec,
                                              introspect, profiler, sampler,
                                              schema)
from bert_pytorch_tpu_torch.telemetry.runner import TrainTelemetry
from bert_pytorch_tpu_torch.telemetry.sentinels import Heartbeat
from bert_pytorch_tpu_torch.tools import make_synthetic_data as synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeClock:
    """Manually advanced clock (the JAX telemetry tests' FakeClock)."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _get(port: int, path: str):
    """(status, body text) of a GET."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def _post(port: int, path: str, body: dict):
    """(status, parsed JSON body) of a POST."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _records(path: str) -> dict:
    kinds: dict = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            rec = json.loads(line)
            kinds.setdefault(rec.get("kind", rec.get("tag")), []).append(rec)
    return kinds


# -- (a) the flight recorder ---------------------------------------------------

def _stream(n: int = 60):
    """A seeded stream of records and log lines (one oversized)."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        if i % 5 == 4:
            out.append(("line", f"[ts] step {i} " + "x" * int(rng.integers(
                0, 600))))
        else:
            out.append(("record", {"kind": "step_window", "step": i,
                                   "loss": float(rng.normal()),
                                   "pad": "y" * int(rng.integers(0, 200))}))
    out.append(("record", {"tag": "train", "step": n, "loss": float("nan")}))
    out.append(("record", {"kind": "memory", "blob": "z" * 9000}))
    return out


def _recorders(tmp_path, **kwargs):
    clock = FakeClock()
    recs = (jax_flightrec.FlightRecorder(str(tmp_path / "jax.json"),
                                         clock=clock, **kwargs),
            flightrec.FlightRecorder(str(tmp_path / "port.json"),
                                     clock=clock, **kwargs))
    return clock, recs


def _feed(recs, clock, stream):
    for typ, item in stream:
        clock.advance(0.25)
        for rec in recs:
            if typ == "line":
                rec.log_handler().write_message(item)
            else:
                rec.note_record(item)


def _payload(path):
    pm = jax_flightrec.read_postmortem(path)
    assert pm is not None
    pm.pop("pid")
    return pm


@pytest.mark.parametrize("scenario", ["incident", "clean_close",
                                      "excepthook"])
def test_flight_recorder_payload_equals_jax(tmp_path, scenario):
    clock, recs = _recorders(tmp_path, max_bytes=4096, flush_interval_s=2.0)
    _feed(recs, clock, _stream())
    if scenario == "incident":
        for rec in recs:
            rec.note_record({"kind": "fault", "fault": "preemption",
                             "injected": False})
        jax_pm, port_pm = (_payload(r.path) for r in recs)
        assert port_pm == jax_pm
        assert port_pm["reason"] == "fault:preemption"
        assert port_pm["records"][-1]["kind"] == "fault"
        assert port_pm["dropped"] > 0 and port_pm["ring_bytes"] <= 4096
        assert port_pm["lines"] and all(len(x) <= 400
                                        for x in port_pm["lines"])
        for rec in recs:
            rec.close(clean=True)
            assert os.path.exists(rec.path)  # incident forensics stay
    elif scenario == "clean_close":
        # Periodic flushes wrote the files; the clean close removes them.
        jax_pm, port_pm = (_payload(r.path) for r in recs)
        assert port_pm == jax_pm and port_pm["reason"] == "periodic"
        jax_pm, port_pm = (_payload(r.flush("clean")) for r in recs)
        assert port_pm == jax_pm
        stub = port_pm["records"][-1]
        assert (stub["truncated"], stub["kind"]) == (True, "memory")
        assert stub["bytes"] > 4096
        for rec in recs:
            rec.close(clean=True)
            assert not os.path.exists(rec.path)
    else:
        saved = sys.excepthook
        try:
            for rec in recs:
                rec.install_exit_hooks()
                rec._prev_excepthook = lambda *exc_info: None
            try:
                raise RuntimeError("injected crash")
            except RuntimeError as exc:
                for rec in recs:
                    rec._excepthook(type(exc), exc, exc.__traceback__)
            jax_pm, port_pm = (_payload(r.path) for r in recs)
            assert port_pm == jax_pm and port_pm["reason"] == "crash"
            assert "RuntimeError: injected crash" in port_pm["exception"]
            for rec in recs:
                rec.close(clean=True)
        finally:
            sys.excepthook = saved


def test_recorder_log_handler_is_a_port_handler(tmp_path):
    from bert_pytorch_tpu_torch.utils.logging import Handler, Logger

    rec = flightrec.FlightRecorder(str(tmp_path / "pm.json"),
                                   flush_interval_s=1e9)
    logger = Logger()
    logger.init([rec.log_handler()])
    assert isinstance(logger.handlers[0], Handler)
    logger.info("warming 1 task heads")
    logger.log(tag="train", step=3, loss=float("nan"))
    pm = flightrec.read_postmortem(rec.flush("unit"))
    assert pm["lines"][0].endswith("warming 1 task heads")
    assert pm["records"][-1]["loss"] is None
    rec.close(clean=True)


# -- (b) the capture controller ------------------------------------------------

class _Window:
    """A stand-in trace window: begin/end recorded, begin's answer set."""

    def __init__(self, accept=True):
        self.accept = accept
        self.calls = []

    def begin(self, trace_dir=None):
        self.calls.append(("begin", os.path.basename(trace_dir)))
        return self.accept

    def end(self, sync_target=None):
        self.calls.append(("end", sync_target))
        return True


def _strip(rec):
    """A profile_window record without its frames and paths."""
    return {k: v for k, v in rec.items()
            if k not in ("top_frames", "threads", "samples", "trace_path",
                         "trace_bytes")}


def _script(ctrl, clock, emitted):
    """The arm/status/tick script; returns what each call answered."""
    out = []
    out.append(ctrl.arm(duration_s=-4))
    out.append(ctrl.arm(duration_s="abc"))
    out.append(ctrl.status())
    out.append(ctrl.arm(duration_s=600, sample_interval_s=0.0,
                        max_samples=10 ** 9, top_k=0, trigger="bogus"))
    out.append(ctrl.arm())
    out.append(ctrl.status())
    out.append(ctrl.tick(5, sync_target="t5"))
    clock.advance(1.5)
    out.append(ctrl.status())
    out.append(ctrl.tick(9))
    out.append(ctrl.arm(duration_s=1))
    clock.advance(59.0)
    rec = ctrl.tick(12, sync_target="t12")
    out.append(_strip(rec))
    status = ctrl.status()
    status["last"] = {k: v for k, v in status["last"].items()
                      if k not in ("top_frame", "samples", "trace_path",
                                   "trace_bytes")}
    out.append(status)
    out.append(ctrl.arm(duration_s=0.5, trigger="fleet"))
    out.append(ctrl.tick(13))
    clock.advance(0.5)
    out.append(_strip(ctrl.tick(20) or {}))
    out.append([_strip(r) for r in emitted])
    return out


@pytest.mark.parametrize("accept", [True, False, None],
                         ids=["trace", "trace_refused", "sampler_only"])
def test_capture_controller_answers_as_jax(tmp_path, accept):
    answers = []
    windows = []
    for mod in (jax_sampler, sampler):
        clock = FakeClock()
        emitted = []
        window = None if accept is None else _Window(accept)
        windows.append(window)
        ctrl = mod.CaptureController(
            source="replica", covered_unit="requests", window=window,
            trace_dir=str(tmp_path / mod.__name__), emit=emitted.append,
            clock=clock)
        answers.append(_script(ctrl, clock, emitted))
    assert answers[1] == answers[0]
    refused_400, refused_bad, idle, capped, busy = answers[1][:5]
    assert not refused_400[0] and "phase" not in refused_400[1]
    assert not refused_bad[0] and "bad capture parameter" in refused_bad[1][
        "error"]
    assert idle == {"phase": "idle", "captures": 0}
    assert capped[0] and capped[1]["duration_s"] == sampler.MAX_DURATION_S
    assert busy == (False, {"error": "capture already in progress",
                            "phase": "armed"})
    record = answers[1][10]
    assert record["covered"] == 7 and record["duration_s"] == 60.5
    assert record["trigger"] == "ondemand"
    assert answers[1][11]["captures"] == 1
    assert answers[1][14]["trigger"] == "fleet"
    if accept is not None:
        assert windows[1].calls == windows[0].calls
        begins = [c for c in windows[1].calls if c[0] == "begin"]
        assert begins == [("begin", "ondemand_1"), ("begin", "ondemand_2")]
        ends = [c for c in windows[1].calls if c[0] == "end"]
        assert ends == ([("end", "t12"), ("end", None)] if accept else [])
    emitted = answers[1][-1]
    assert len(emitted) == 2
    for rec in emitted:
        assert schema.validate_record(dict(
            rec, schema=1, ts=0.0, samples=0, threads=[], top_frames=[],
            trace_path="", trace_bytes=0)) == []


@pytest.mark.parametrize("accept", [True, False, None],
                         ids=["trace", "trace_refused", "sampler_only"])
def test_capture_holds_around_the_collection(tmp_path, accept):
    """``hold`` is called with a bound just before a trace is collected
    (which holds the interpreter: on the card a replica's heartbeat tells
    the fleet watchdog to wait) and with 0 just after; a capture without
    a trace holds nothing."""
    clock = FakeClock()
    window = None if accept is None else _Window(accept)
    calls = window.calls if window is not None else []
    ctrl = sampler.CaptureController(
        "replica", covered_unit="requests", window=window,
        trace_dir=str(tmp_path), hold=lambda s: calls.append(("hold", s)),
        clock=clock)
    ctrl.arm(duration_s=2.0)
    ctrl.tick(0)
    clock.advance(2.5)
    assert ctrl.tick(5)["covered"] == 5
    collect = sampler.HOLD_COLLECT_S + sampler.HOLD_COLLECT_S_PER_S * 2.5
    expected = {
        True: [("begin", "ondemand_1"), ("hold", collect), ("end", None),
               ("hold", 0.0)],
        False: [("begin", "ondemand_1")],
        None: [],
    }[accept]
    assert calls == expected


def test_capture_force_collects_an_active_capture(tmp_path):
    clock = FakeClock()
    emitted = []
    ctrl = sampler.CaptureController("trainer", window=None,
                                     emit=emitted.append, clock=clock)
    assert ctrl.tick(1, force=True) is None  # idle: nothing to collect
    ctrl.arm(duration_s=30)
    assert ctrl.tick(1, force=True) is None  # armed: not started by force
    assert ctrl.tick(2) is None  # starts
    rec = ctrl.tick(4, force=True)
    assert rec["covered"] == 2 and ctrl.status()["phase"] == "idle"
    assert schema.validate_record(dict(rec, schema=1, ts=0.0)) == []
    assert jax_schema.validate_record(dict(rec, schema=1, ts=0.0)) == []


def test_sampler_tells_same_named_threads_apart():
    """Two threads of one name (two services' stages in one process) are
    two rows, neither counting more samples than the sampler took: the
    record stays schema-valid."""
    stop = threading.Event()
    threads = [threading.Thread(target=stop.wait, name="serve-executor",
                                daemon=True) for _ in range(2)]
    for thread in threads:
        thread.start()
    smp = sampler.ThreadSampler(interval_s=0.001, max_samples=30,
                                include=("serve-",))
    smp.start()
    time.sleep(0.2)
    smp.stop()
    stop.set()
    folded = smp.result()
    rows = [r for r in folded["top_frames"] if r["thread"] == "serve-executor"]
    assert len(rows) == 2 and folded["threads"] == ["serve-executor"]
    assert all(r["samples"] <= folded["samples"] for r in rows)
    rec = {"schema": 1, "ts": 0.0, "kind": "profile_window",
           "source": "replica", "trigger": "ondemand", "covered": 0,
           "covered_unit": "requests", "duration_s": 0.2,
           "sample_interval_s": 0.001, "trace_path": "", "trace_bytes": 0,
           **folded}
    assert schema.validate_record(rec) == []
    assert jax_schema.validate_record(rec) == []


def test_profiler_window_begin_end_and_the_latch(tmp_path):
    startup = profiler.ProfilerWindow("2:3", str(tmp_path / "startup"))
    ondemand = profiler.ProfilerWindow(None, str(tmp_path / "od"))
    assert startup.maybe_start(2)
    # Another window refuses while the startup one traces.
    assert not ondemand.begin(str(tmp_path / "od" / "ondemand_1"))
    assert not startup.begin()
    with startup.annotation(2):
        torch.ones(4).sum()
    assert startup.maybe_stop(2) and startup.done
    assert ondemand.begin(str(tmp_path / "od" / "ondemand_1"))
    # stop() ends the startup window only.
    assert not ondemand.stop() and ondemand.active
    with ondemand.annotation(7):
        torch.ones(4).sum()
    assert ondemand.end(sync_target=None) and not ondemand.active
    assert not ondemand.end()
    path = ondemand.last_trace
    assert path == str(tmp_path / "od" / "ondemand_1" /
                       f"trace_{os.getpid()}.json")
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "train/7" in names
    assert not profiler.trace_active()


# -- (c) the introspection hub -------------------------------------------------

def _hub_records():
    rng = np.random.default_rng(5)
    window = {"kind": "step_window", "tag": "telemetry", "step": 10,
              "window_steps": 10, "synced_steps": 10,
              "steps_per_sec": float(rng.random()), "mfu": 0.0,
              "step_p50_s": float(rng.random()),
              "loader": {"wait_s_total": 0.25, "queue_depth": 3}}
    return [
        {"kind": "compile", "fn": "flash_attention_infer",
         "shapes_digest": "ab12", "compile_s": 27.5, "cache": "miss"},
        {"kind": "compile", "fn": "flash_attention_fwd",
         "shapes_digest": "cd34", "compile_s": 0.0, "cache": "hit"},
        window,
        {"kind": "grad_health", "step": 10, "grad_norm": 1.5,
         "param_norm": 30.0, "update_ratio": 1e-3},
        {"kind": "memory", "step": 10, "memory_supported": False},
        {"kind": "sentinel", "step": 11, "finite": 0.0},
        {"kind": "divergence", "step": 12},
        {"kind": "fault", "fault": "hung_step", "injected": False},
        {"tag": "train", "step": 12, "loss": 3.0},
    ]


def _hubs(clock, capture: bool, tmp_path):
    hubs = []
    for mod, smod in ((jax_introspect, jax_sampler),
                      (introspect, sampler)):
        hub = mod.IntrospectionHub(process="pretrain", stale_after_s=5.0,
                                   clock=clock)
        if capture:
            hub.capture = smod.CaptureController(
                "trainer", window=None, trace_dir=str(tmp_path),
                clock=clock)
        hubs.append(hub)
    return hubs


@pytest.mark.parametrize("capture", [False, True])
def test_introspection_hub_answers_as_jax(tmp_path, capture):
    clock = FakeClock()
    hubs = _hubs(clock, capture, tmp_path)
    answers = [[] for _ in hubs]
    for i, hub in enumerate(hubs):
        answers[i].append(hub.healthz())  # warming
    clock.advance(2.0)
    for rec in _hub_records():
        for hub in hubs:
            hub.observe_record(dict(rec))
    for step, loss in ((1, 9.5), (2, None), (3, float("nan"))):
        clock.advance(1.0)
        for hub in hubs:
            hub.note_step(step, loss=loss)
    for i, hub in enumerate(hubs):
        answers[i] += [hub.healthz(), hub.statsz(), hub.metrics_text()]
    clock.advance(6.0)
    for i, hub in enumerate(hubs):
        answers[i].append(hub.healthz())  # stale
    jax_answers, port_answers = answers
    assert json.dumps(port_answers, default=str) == json.dumps(
        jax_answers, default=str)
    assert [a[1]["status"] for a in (port_answers[0], port_answers[1],
                                     port_answers[4])] == [
        "warming", "ok", "stale"]
    assert port_answers[4][0] == 503
    stats = port_answers[2]
    assert stats["compile_cache"] == {"miss": 1, "hit": 1}
    assert (stats["nonfinite_steps"], stats["divergence_warnings"],
            stats["faults"]) == (1, 1, 1)
    assert ("profile" in stats) == capture
    text = port_answers[3]
    assert 'bert_train_compiles_total{process="pretrain",cache="miss"} 1' \
        in text
    assert "bert_train_loader_wait_s_total" in text


def test_debug_server_routes_answer_as_jax(tmp_path):
    clock = FakeClock()
    hubs = _hubs(clock, False, tmp_path)
    for rec in _hub_records():
        for hub in hubs:
            hub.observe_record(dict(rec))
    servers = [jax_introspect.start_debug_server(hubs[0]),
               introspect.start_debug_server(hubs[1])]
    try:
        ports = [s.server_address[1] for s in servers]
        for path in ("/healthz", "/statsz", "/metricsz", "/nope"):
            assert _get(ports[1], path) == _get(ports[0], path)
        # No capture attached: 404 from both.
        assert _post(ports[1], "/profilez", {})[0] == 404
        assert _post(ports[0], "/profilez", {})[0] == 404
        for hub, smod in zip(hubs, (jax_sampler, sampler)):
            hub.capture = smod.CaptureController("trainer", window=None,
                                                 clock=clock)
        for body, code in (({"duration_s": 2}, 200), ({}, 409),
                           ({"duration_s": -1}, 400)):
            answers = [_post(p, "/profilez", body) for p in ports]
            assert answers[1] == answers[0] and answers[1][0] == code
        assert _get(ports[1], "/statsz") == _get(ports[0], "/statsz")
    finally:
        for server in servers:
            server.shutdown()
            server.server_close()


# -- (d) the compile records ---------------------------------------------------

@pytest.fixture()
def stub_nvcc(tmp_path, monkeypatch):
    """A stand-in compiler that writes its ``-o`` target, and an empty
    build directory and library cache."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then echo lib > \"$2\"; fi\n"
                    "  shift\ndone\necho 'ptxas info: 0 registers'\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernel_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernel_build, "_libraries", {})
    # Loading a built library: the stand-in file is not a real one.
    monkeypatch.setattr(kernel_build.ctypes, "CDLL", lambda path: path)
    return nvcc


def test_build_reports_miss_then_hit(stub_nvcc):
    events = []
    monitor = compile_events.CompileMonitor(emit=events.append)
    names = ("flash_attention_infer", "layer_norm_fwd")
    kernel_build.build(names)  # not installed: nothing reported
    assert events == []
    for path in kernel_build.BUILD_DIR.glob("*.so"):
        path.unlink()
    with monitor.installed():
        cold = kernel_build.build(names)
        warm = kernel_build.build(names)
        kernel_build.ensure(names[:1])  # loaded now by ensure's load
        kernel_build.ensure(names[:1])  # loaded before: a hit
    kernel_build.build(names)  # uninstalled again
    assert [(e["fn"], e["cache"]) for e in events] == [
        ("flash_attention_infer", "miss"), ("layer_norm_fwd", "miss"),
        ("flash_attention_infer", "hit"), ("layer_norm_fwd", "hit"),
        ("flash_attention_infer", "hit"), ("flash_attention_infer", "hit")]
    assert all(cold[n] > 0 for n in names) and warm == dict.fromkeys(names,
                                                                      0.0)
    for event in events:
        assert event["shapes_digest"] == kernel_build.library_digest(
            event["fn"])
        assert event["compile_s"] == event["backend_compile_s"]
        rec = dict(event, schema=1, ts=0.0)
        assert schema.validate_record(rec) == []
        assert jax_schema.validate_record(rec) == []
    assert monitor.events == events


def test_failed_build_raises_and_reports_nothing(stub_nvcc):
    stub_nvcc.write_text("#!/bin/sh\necho 'error: bad kernel'\nexit 2\n")
    events = []
    with compile_events.CompileMonitor(emit=events.append).installed():
        with pytest.raises(RuntimeError, match="bad kernel"):
            kernel_build.build(["layer_norm_fwd"])
    assert events == []
    assert not kernel_build.library_path("layer_norm_fwd").exists()


def test_monitor_install_nests():
    monitor = compile_events.CompileMonitor()
    with monitor.installed():
        with monitor.installed():
            pass
        compile_events.report_build("x", "d", 1.0, True)
    compile_events.report_build("y", "d", 0.0, False)
    assert [e["fn"] for e in monitor.events] == ["x"]


# -- (e) the serving replica ---------------------------------------------------

SERVE_CONFIG = dict(vocab_size=40, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=64,
                    max_position_embeddings=64, type_vocab_size=2,
                    next_sentence=True, hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0)
REQUESTS = [("fill_mask", {"text": "the capital of [MASK] is paris"}),
            ("classify", {"text": "paris is big"}),
            ("fill_mask", {"text": "who wrote [MASK]", "top_k": 3}),
            ("classify", {"text": "the river runs",
                          "text_pair": "through london"})]


@pytest.fixture(scope="module")
def serve_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("replica")
    vocab = synth.write_trace_vocab(str(root / "vocab.txt"))
    config = root / "config.json"
    config.write_text(json.dumps(SERVE_CONFIG))
    return {"vocab": vocab, "config": str(config), "root": root}


def _serve_argv(files, out, *extra):
    return ["--model_config_file", files["config"], "--vocab_file",
            files["vocab"], "--dtype", "float32", "--tasks",
            "fill_mask,classify", "--buckets", "16,32", "--max_batch_size",
            "2", "--port", "0", "--telemetry_window", "4",
            "--trace_sample_rate", "0", *(["--output_dir", str(out)]
                                          if out else []), *extra]


class _Replica:
    """A port replica from ``build_service``, served over HTTP."""

    def __init__(self, args):
        self.service = run_server.build_service(args)
        self.service.engine.warmup()
        self.service.start()
        self.server = make_server(self.service, port=0)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.service.stop()
        self.thread.join(timeout=30)
        run_server.close_planes(self.service)


def _send(port, requests):
    return [_post(port, f"/v1/{task}", payload) for task, payload in requests]


@pytest.fixture(scope="module")
def jax_windows(serve_files):
    """The JAX server's serve_window records for REQUESTS."""
    out = serve_files["root"] / "jax_out"
    args = jax_run_server.parse_arguments(_serve_argv(serve_files, out))
    service, sink = jax_run_server.build_service(args)
    service.engine.warmup()
    service.start()
    server = jax_make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        answers = _send(server.server_address[1], REQUESTS)
    finally:
        server.shutdown()
        server.server_close()
        service.stop()
        thread.join(timeout=30)
        sink.close()
        service.flight_recorder.close(clean=True)
    assert [a[0] for a in answers] == [200] * len(REQUESTS)
    return _records(str(out / "serve_telemetry.jsonl"))


def test_run_server_takes_the_jax_flags_and_defaults(serve_files):
    """Every JAX run_server flag, with its default (--autotune and
    --autotune_cache included); the attention backends keep the port's
    names."""
    argv = ["--model_config_file", serve_files["config"], "--vocab_file",
            serve_files["vocab"]]
    jax_args = vars(jax_run_server.parse_arguments(argv))
    port_args = vars(run_server.parse_arguments(argv))
    queued = set()
    assert set(jax_args) - queued <= set(port_args)
    assert set(port_args) - set(jax_args) == {"device"}
    differ = {k for k in set(jax_args) - queued
              if jax_args[k] != port_args[k]}
    assert differ == {"attention_backend"}
    assert (jax_args["attention_backend"],
            port_args["attention_backend"]) == ("xla", "flash_infer")


def test_replica_planes_match_the_jax_server(serve_files, jax_windows,
                                             tmp_path):
    out = tmp_path / "out"
    args = run_server.parse_arguments(
        _serve_argv(serve_files, out, "--device", "cpu"))
    assert (args.max_pending, args.dispatch_mode, args.seed,
            args.telemetry_window) == (1024, "pipelined", 0, 4)
    replica = _Replica(args)
    try:
        beat0 = Heartbeat.read(str(out / "heartbeat.json"))
        answers = _send(replica.port, REQUESTS)
        assert [a[0] for a in answers] == [200] * len(REQUESTS)
        time.sleep(1.2)  # past the heartbeat's 1 s cadence
        beat1 = Heartbeat.read(str(out / "heartbeat.json"))
        assert beat1["counter"] > beat0["counter"]
        assert beat1["step"] == len(REQUESTS)
        # POST /profilez: a capture over the next requests, with a trace.
        status, armed = _post(replica.port, "/profilez", {"duration_s": 0.2})
        assert status == 200 and armed["armed"]
        assert _post(replica.port, "/profilez", {})[0] == 409
        assert _post(replica.port, "/profilez", {"duration_s": -1})[0] == 400
        deadline = time.time() + 30
        profile = {}
        while time.time() < deadline:
            _send(replica.port, REQUESTS[:2])
            profile = json.loads(_get(replica.port, "/statsz")[1])["profile"]
            if profile["captures"]:
                break
        assert profile["captures"] == 1 and profile["phase"] == "idle"
    finally:
        replica.close()
    jsonl = str(out / "serve_telemetry.jsonl")
    assert schema.validate_file(jsonl) == []
    assert jax_schema.validate_file(jsonl) == []
    kinds = _records(jsonl)
    windows = kinds["serve_window"]
    assert sorted(windows[0]) == sorted(jax_windows["serve_window"][0])
    assert windows[0]["window_requests"] == jax_windows["serve_window"][0][
        "window_requests"]
    cold = kinds["serve_cold_start"][0]
    assert (cold["compiles"], cold["compiles_cold"],
            cold["compiles_warm"]) == (0, 0, 0)  # no kernels on the CPU
    (window,) = kinds["profile_window"]
    assert window["source"] == "replica"
    assert window["covered_unit"] == "requests" and window["covered"] >= 1
    assert window["trace_path"] == str(out / "profile" / "ondemand_1")
    assert window["trace_bytes"] > 0 and window["samples"] > 0
    trace = os.path.join(window["trace_path"], f"trace_{os.getpid()}.json")
    assert json.load(open(trace))["traceEvents"]
    assert "serve_summary" in kinds
    # A clean close removed the postmortem.
    assert not os.path.exists(out / "postmortem.json")


def test_replica_sheds_past_max_pending(serve_files, tmp_path):
    args = run_server.parse_arguments(_serve_argv(
        serve_files, None, "--device", "cpu", "--max_pending", "1",
        "--max_wait_ms", "300", "--max_batch_size", "8",
        "--dispatch_mode", "serial"))
    replica = _Replica(args)
    try:
        burst = REQUESTS * 3
        with ThreadPoolExecutor(max_workers=len(burst)) as pool:
            codes = [a[0] for a in pool.map(
                lambda tp: _post(replica.port, f"/v1/{tp[0]}", tp[1]),
                burst)]
    finally:
        replica.close()
    assert 503 in codes and 200 in codes
    assert set(codes) <= {200, 503}


def test_serial_dispatch_answers_as_pipelined(serve_files):
    answers = {}
    for mode in ("pipelined", "serial"):
        args = run_server.parse_arguments(_serve_argv(
            serve_files, None, "--device", "cpu", "--dispatch_mode", mode))
        replica = _Replica(args)
        try:
            assert replica.service.dispatch_mode == mode
            answers[mode] = _send(replica.port, REQUESTS)
        finally:
            replica.close()
    assert [a[0] for a in answers["serial"]] == [200] * len(REQUESTS)
    for ours, ref in zip(answers["serial"], answers["pipelined"]):
        body, want = ours[1], ref[1]
        if "masks" in want:
            assert [[s["token"] for s in m] for m in body["masks"]] == [
                [s["token"] for s in m] for m in want["masks"]]
            np.testing.assert_allclose(
                [s["score"] for m in body["masks"] for s in m],
                [s["score"] for m in want["masks"] for s in m], atol=1e-6)
        else:
            assert body["label"] == want["label"]
            np.testing.assert_allclose(list(body["scores"].values()),
                                       list(want["scores"].values()),
                                       atol=1e-6)


@pytest.mark.parametrize("signum,rc,kept", [
    (signal.SIGTERM, 75, True), (signal.SIGINT, 0, False)],
    ids=["sigterm", "sigint"])
def test_replica_subprocess_signal_contract(serve_files, tmp_path, signum,
                                            rc, kept):
    out = tmp_path / "out"
    port = _free_port()
    argv = _serve_argv(serve_files, out, "--device", "cpu", "--tasks",
                       "classify", "--buckets", "16")
    argv[argv.index("--port") + 1] = str(port)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "bert_pytorch_tpu_torch.run_server", *argv],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                if _get(port, "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            assert proc.poll() is None, proc.stdout.read()
            time.sleep(0.2)
        answers = _send(port, [r for r in REQUESTS if r[0] == "classify"])
        assert [a[0] for a in answers] == [200, 200]
        proc.send_signal(signum)
        log, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == rc, log
    assert "cold kernel builds" in log
    kinds = _records(str(out / "serve_telemetry.jsonl"))
    assert schema.validate_file(str(out / "serve_telemetry.jsonl")) == []
    faults = kinds.get("fault", [])
    pm = flightrec.read_postmortem(str(out / "postmortem.json"))
    if kept:
        assert [(f["fault"], f["signal"], f["step"]) for f in faults] == [
            ("preemption", "SIGTERM", 2)]
        assert pm["reason"] == "fault:preemption"
        assert pm["records"][-1]["kind"] == "fault"
        assert any("serving" in line for line in pm["lines"])
    else:
        assert faults == [] and pm is None


# -- (f) the trainers ----------------------------------------------------------

TRAIN_CONFIG = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=64,
                    max_position_embeddings=32, type_vocab_size=2,
                    next_sentence=True, hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0)


def _scripted_step_done(monkeypatch, port, seen, crash_at=None):
    """Wrap TrainTelemetry.step_done: at step 2 scrape the debug plane and
    arm a capture, at step 3 wait past its deadline; ``crash_at`` raises
    after that step's close-out."""
    original = TrainTelemetry.step_done

    def step_done(self, step, *args, **kwargs):
        out = original(self, step, *args, **kwargs)
        if port and step == 2:
            seen["healthz"] = _get(port, "/healthz")
            seen["statsz"] = _get(port, "/statsz")
            seen["metricsz"] = _get(port, "/metricsz")
            seen["arm"] = _post(port, "/profilez", {"duration_s": 0.05})
            seen["again"] = _post(port, "/profilez", {})
        if port and step == 3:
            time.sleep(0.1)
        if step == crash_at:
            raise RuntimeError("injected crash")
        return out

    monkeypatch.setattr(TrainTelemetry, "step_done", step_done)


def _pretrain_args(tmp_path, *extra):
    config = tmp_path / "tiny.json"
    config.write_text(json.dumps(TRAIN_CONFIG))
    return run_pretraining.parse_arguments([
        "--model_config_file", str(config), "--output_dir",
        str(tmp_path / "out"), "--global_batch_size", "4",
        "--local_batch_size", "4", "--max_steps", "6", "--steps", "6",
        "--device", "cpu", "--dtype", "float32",
        "--max_predictions_per_seq", "5", "--telemetry_window", "2",
        "--telemetry_sync_every", "1", "--skip_final_checkpoint", *extra])


def _check_debug_plane(seen, process):
    code, body = seen["healthz"]
    health = json.loads(body)
    assert code == 200 and health["status"] == "ok"
    assert (health["process"], health["step"]) == (process, 2)
    stats = json.loads(seen["statsz"][1])
    assert stats["last_window"]["step"] == 2
    assert stats["profile"]["phase"] == "idle"
    assert f'bert_train_step{{process="{process}"}} 2' in seen["metricsz"][1]
    assert seen["arm"][0] == 200 and seen["again"][0] == 409


def _check_capture(jsonl):
    assert schema.validate_file(jsonl) == []
    assert jax_schema.validate_file(jsonl) == []
    (window,) = _records(jsonl)["profile_window"]
    assert (window["source"], window["covered_unit"]) == ("trainer", "steps")
    assert window["covered"] == 1 and window["samples"] > 0
    trace = os.path.join(window["trace_path"], f"trace_{os.getpid()}.json")
    assert os.path.basename(window["trace_path"]) == "ondemand_1"
    assert json.load(open(trace))["traceEvents"]


def test_pretraining_debug_port_and_capture(tmp_path, monkeypatch):
    port = _free_port()
    seen = {}
    _scripted_step_done(monkeypatch, port, seen)
    args = _pretrain_args(tmp_path, "--debug_port", str(port))
    summary = run_pretraining.main(
        args, synth.SyntheticPretrainingDataset(0, 4 * 6, 32, 64, 5))
    assert summary["global_step"] == 6
    _check_debug_plane(seen, "pretrain")
    out = tmp_path / "out"
    _check_capture(str(out / "pretraining_telemetry.jsonl"))
    with pytest.raises(OSError):  # the server is gone with the run
        _get(port, "/healthz")
    assert not os.path.exists(out / "postmortem.json")  # clean run


def test_pretraining_postmortem_on_crash(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    _scripted_step_done(monkeypatch, 0, {}, crash_at=3)
    pm_path = str(tmp_path / "forensics" / "pm.json")
    args = _pretrain_args(tmp_path, "--postmortem_file", pm_path)
    with pytest.raises(RuntimeError, match="injected crash"):
        run_pretraining.main(
            args, synth.SyntheticPretrainingDataset(0, 4 * 6, 32, 64, 5))
    pm = flightrec.read_postmortem(pm_path)
    assert pm["process"] == "pretrain" and pm["reason"] == "crash"
    assert "RuntimeError: injected crash" in pm["exception"]
    assert [r["step"] for r in pm["records"] if r.get("tag") == "train"] == [
        1, 2]
    assert any("event start" in line for line in pm["lines"])


def test_glue_debug_port_and_capture(tmp_path, monkeypatch):
    vocab = synth.write_trace_vocab(str(tmp_path / "vocab.txt"))
    config = tmp_path / "model.json"
    config.write_text(json.dumps(dict(SERVE_CONFIG, vocab_file=vocab,
                                      tokenizer="wordpiece")))
    mrpc = synth.write_mrpc_tsvs(str(tmp_path / "MRPC"), 0, 32, 8)
    port = _free_port()
    seen = {}
    _scripted_step_done(monkeypatch, port, seen)
    out = tmp_path / "out"
    args = run_glue.parse_arguments([
        "--task", "mrpc", "--data_dir", mrpc, "--batch_size", "4",
        "--model_config_file", str(config), "--output_dir", str(out),
        "--device", "cpu", "--dtype", "float32", "--max_seq_len", "32",
        "--epochs", "1", "--telemetry_window", "2", "--debug_port",
        str(port), "--skip_eval"])
    results, _, _ = run_glue.run(args)
    assert results["global_step"] == 8
    _check_debug_plane(seen, "glue")
    _check_capture(str(out / "glue_telemetry.jsonl"))
    assert not os.path.exists(out / "postmortem.json")


def test_from_args_survives_a_held_debug_port(tmp_path):
    holder = socket.socket()
    holder.bind(("127.0.0.1", 0))
    holder.listen(1)
    try:
        parser = argparse.ArgumentParser()
        cli.add_cli_args(parser)
        tele = cli.from_args(parser.parse_args(
            ["--debug_port", str(holder.getsockname()[1])]))
        assert tele.debug_server is None and tele.introspect is not None
        assert tele.flight_recorder is None  # no output dir, no flag
        assert tele.introspect.capture is tele.capture
        tele.close()
    finally:
        holder.close()
