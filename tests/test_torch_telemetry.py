"""The port's runner telemetry (``bert_pytorch_tpu_torch/telemetry``,
``utils/logging.py``, ``utils/flops.py``) held against the JAX package's
on the CPU.

Each piece meets its JAX counterpart on the same input: the schema copy
gives the same verdicts on a corpus of good and bad records (the JAX
telemetry tests' records plus every kind the port writes); the JSONL
handler writes the same bytes; ``StepTimer`` gives identical window
records under one scripted fake-clock protocol (and, with a fake device
clock, device samples that follow the event spans); the profile spec,
the sentinel, the heartbeat, the watchdog and the divergence monitor
answer the same observations alike; the FLOP counts are equal on the
tiny, base and large configs; grad health groups and reduces alike; the
memory sampler aggregates the same readings alike; the loader's gauges
carry the JAX keys. Then the port's ``run_pretraining`` writes, on the
CPU, a JSONL that both packages' ``validate_file`` accept. Tolerances:
exact everywhere except grad health (fp32 sums in another order, 1e-6
relative).
"""

import json
import math
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert_pytorch_tpu.config import BertConfig as JaxConfig
from bert_pytorch_tpu.data.loader import DataLoader as JaxLoader
from bert_pytorch_tpu.telemetry import memory as jax_memory
from bert_pytorch_tpu.telemetry import model_stats as jax_stats
from bert_pytorch_tpu.telemetry import profiler as jax_profiler
from bert_pytorch_tpu.telemetry import schema as jax_schema
from bert_pytorch_tpu.telemetry import sentinels as jax_sentinels
from bert_pytorch_tpu.telemetry.step_timer import StepTimer as JaxStepTimer
from bert_pytorch_tpu.utils import flops as jax_flops
from bert_pytorch_tpu.utils import logging as jax_logging
from bert_pytorch_tpu_torch import run_pretraining, telemetry
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.data.loader import DataLoader
from bert_pytorch_tpu_torch.data.sampler import DistributedSampler
from bert_pytorch_tpu_torch.telemetry import memory, model_stats, profiler
from bert_pytorch_tpu_torch.telemetry import schema, sentinels
from bert_pytorch_tpu_torch.telemetry.step_timer import StepTimer
from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
    SyntheticPretrainingDataset)
from bert_pytorch_tpu_torch.utils import flops
from bert_pytorch_tpu_torch.utils import logging as logging_util

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEALTH_RTOL = 1e-6


class FakeClock:
    """Manually advanced clock (the JAX telemetry tests' FakeClock)."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


class FakeDeviceClock:
    """A device clock whose marks are scripted times."""

    def __init__(self):
        self.t = 0.0

    def mark(self):
        return self.t

    @staticmethod
    def wait(mark):
        pass

    @staticmethod
    def elapsed_s(start, end):
        return end - start


# -- the schema copy ----------------------------------------------------------

def _window(**extra):
    rec = {"schema": 1, "ts": 0, "kind": "step_window", "step": 1,
           "window_steps": 1, "synced_steps": 1, "steps_per_sec": 1.0,
           "mfu": 0.0}
    rec.update({f"{p}_{s}_s": 0.0 for p in
                ("data_wait", "host", "device", "step")
                for s in ("p50", "p95", "max")})
    rec.update(extra)
    return rec


def _tel(kind, **fields):
    return {"schema": 1, "ts": 1.5, "kind": kind, "tag": "telemetry",
            **fields}


SKIPPED = [{"step": 6, "path": "/x/ckpt_6.msgpack", "reason": "integrity"}]
CORPUS = [
    # the JAX telemetry tests' records
    {"schema": 999, "ts": 0},
    {"schema": 1, "ts": 0, "kind": "mystery"},
    {"schema": 1, "ts": 0, "kind": "sentinel"},
    _window(loader={"batches": 1}),
    {"schema": 1, "ts": 0, "tag": "train", "step": 4, "loss": 1.25},
    {"schema": 1, "ts": 0, "tag": "train", "step": 1, "loss": None},
    _tel("run_summary", step=3, steps=3, note="hi"),
    # every kind the port writes, good and broken
    _window(),
    _window(loader={"batches": 2, "wait_s_total": 0.1, "wait_s_max": 0.1,
                    "stalls": 0, "depth_mean": 1.5, "depth_max": 2}),
    _window(mfu_basis="device", device_sum_s=0.5, seq_per_sec=16.0,
            padding_efficiency=0.8, tokens_per_s=100.0,
            tokens_per_s_basis="real", mfu_real_tokens=0.01,
            ckpt_steps=1, ckpt_step_p50_s=1.0, ckpt_step_p95_s=1.0,
            ckpt_step_max_s=1.0),
    _window(tokens_per_s=100.0, tokens_per_s_basis="bogus"),
    _window(padding_efficiency=1.5, tokens_per_s=1.0,
            tokens_per_s_basis="real"),
    _window(mfu=float("nan")),
    {k: v for k, v in _window().items() if k != "device_p50_s"},
    _tel("grad_health", step=2, grad_norm=1.0, param_norm=2.0,
         update_ratio=0.01, groups={"bert/encoder": {
             "grad_norm": 1.0, "param_norm": 2.0, "update_ratio": 0.01}},
         per_layer_grad_norm=[0.5, 0.5]),
    _tel("grad_health", step=2, grad_norm=1.0, param_norm=2.0,
         groups={}),
    _tel("memory", step=1, memory_supported=False),
    _tel("memory", step=2, memory_supported=True, samples=2, n_devices=1,
         bytes_in_use=10, bytes_in_use_max=12, peak_bytes_in_use=20,
         bytes_limit=100),
    _tel("memory", step=2),
    _tel("sentinel", step=3, finite=0, loss=None, consecutive_nonfinite=1,
         policy="abort"),
    _tel("divergence", step=4, reason="grad_norm_spike", value=9.0,
         threshold=5.0, consecutive=1, policy="continue"),
    _tel("divergence", step=4, reason="grad_norm_spike"),
    _tel("fault", fault="preemption", step=7, signal="SIGTERM",
         injected=False),
    _tel("fault", fault="hung_step", injected=False, step=3, age_s=9.0,
         max_age_s=5.0),
    _tel("fault", fault="resume_walk_back_exhausted", injected=False,
         step=0, skipped=SKIPPED),
    _tel("fault", step=1),
    _tel("resume", step=4, skipped=SKIPPED),
    _tel("resume", step=4, skipped=[]),
    _tel("resume", step=4, skipped=[{"step": 6}]),
    _tel("resume", step=4, skipped="ckpt_6"),
    _tel("run_summary", step=22, steps=22, training_seq_per_sec=10.0,
         training_mfu=0.0, terminated_by_signal=False),
    _tel("run_summary", step=22),
]
LINES = ['{"loss": NaN}', "not json at all", "[1, 2]", '{"x": Infinity}',
         json.dumps(_window())]


@pytest.mark.parametrize("index", range(len(CORPUS)))
def test_schema_copy_gives_the_jax_verdicts(index):
    rec = CORPUS[index]
    assert schema.validate_record(rec) == jax_schema.validate_record(rec)
    line = json.dumps(rec)
    assert schema.validate_line(line) == jax_schema.validate_line(line)


def test_schema_copy_lines_and_files(tmp_path):
    assert schema.SCHEMA_VERSION == jax_schema.SCHEMA_VERSION == 1
    assert schema.KIND_REQUIRED_KEYS == jax_schema.KIND_REQUIRED_KEYS
    assert schema.LOADER_REQUIRED_KEYS == jax_schema.LOADER_REQUIRED_KEYS
    for line in LINES:
        assert schema.validate_line(line) == jax_schema.validate_line(line)
    path = tmp_path / "mixed.jsonl"
    path.write_text("\n".join([json.dumps(r) for r in CORPUS] + LINES)
                    + "\n")
    errors = schema.validate_file(str(path))
    assert errors and errors == jax_schema.validate_file(str(path))


# -- the JSONL handler --------------------------------------------------------

def test_jsonl_handler_writes_the_jax_line(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1792233901.4876)
    record = {"kind": "grad_health", "tag": "telemetry", "step": 3,
              "grad_norm": float("inf"), "param_norm": 2.5,
              "update_ratio": float("nan"),
              "groups": {"bert/encoder": {"grad_norm": float("-inf"),
                                          "param_norm": 1.0}},
              "per_layer_grad_norm": [1.0, float("nan")], "note": "hi"}
    lines = []
    for module, name in ((logging_util, "port"), (jax_logging, "jax")):
        path = str(tmp_path / f"{name}.jsonl")
        sink = module.JSONLHandler(path)
        sink.write_record(record)
        sink.write_record({"tag": "train", "step": 4, "loss": 1.25})
        sink.close()
        sink.write_record({"tag": "train", "step": 5})  # closed: dropped
        lines.append(open(path).read())
    assert lines[0] == lines[1]
    assert "NaN" not in lines[0] and "Infinity" not in lines[0]
    first = json.loads(lines[0].splitlines()[0])
    assert first["grad_norm"] is None and first["update_ratio"] is None
    assert first["per_layer_grad_norm"] == [1.0, None]
    assert first["ts"] == 1792233901.488 and first["schema"] == 1
    assert schema.validate_file(str(tmp_path / "port.jsonl")) == []


def test_logger_and_file_handlers_write_what_jax_writes(tmp_path):
    """The text and CSV sinks (a widening CSV included) give the JAX
    files' bytes; a non-primary handler writes nothing."""
    outs = []
    for module, name in ((logging_util, "port"), (jax_logging, "jax")):
        csv_path = str(tmp_path / f"{name}.csv")
        logger = module.Logger()
        logger.init([module.FileHandler(str(tmp_path / f"{name}.txt")),
                     module.CSVHandler(csv_path),
                     module.CSVHandler(str(tmp_path / f"{name}_np.csv"),
                                       is_primary=False)])
        logger.log(tag="train", step=1, loss=2.0)
        logger.log(tag="train", step=2, loss=1.5, grad_norm=0.25)
        logger.close()
        text = [line.split("] ", 1)[-1] for line in
                open(tmp_path / f"{name}.txt").read().splitlines()]
        outs.append((text, open(csv_path).read(),
                     os.path.exists(tmp_path / f"{name}_np.csv")))
    assert outs[0] == outs[1]
    assert outs[0][1].splitlines()[0] == "tag,step,loss,grad_norm"


# -- the step timer -----------------------------------------------------------

# (data wait s, host s, device tail s or None for an unsynced step, real
# tokens, checkpoint stall s or None) per step.
PROTOCOL = [
    (0.10, 0.02, 0.30, 60, None),
    (0.01, 0.03, None, 50, None),
    (0.00, 0.02, 0.25, 64, 1.5),
    (0.20, 0.05, None, 40, None),
    (0.05, 0.01, 0.40, 64, None),
    (0.00, 0.02, None, 30, None),
    (0.03, 0.04, 0.10, 62, None),
]


@pytest.mark.parametrize("sync_every,window", [(1, 3), (2, 3), (2, 4),
                                               (0, 2)])
def test_step_timer_windows_equal_jax(sync_every, window):
    """One fake clock drives both timers through the same marks: every
    window record (and the end-of-run flush) is identical."""
    clock = FakeClock()
    kw = dict(window=window, sync_every=sync_every, clock=clock,
              seq_per_step=8, flops_per_seq=1e12, device_kind="cpu",
              tokens_per_step=64)
    ours, theirs = StepTimer(**kw), JaxStepTimer(**kw)
    got, want = [], []
    for step, (wait, host, tail, real, stall) in enumerate(PROTOCOL, 1):
        for t in (ours, theirs):
            t.data_start()
        clock.advance(wait)
        for t in (ours, theirs):
            t.data_end()
        clock.advance(host)
        for t in (ours, theirs):
            t.dispatch_end()
        assert ours.should_sync() == theirs.should_sync()
        if ours.should_sync() and tail is not None:
            clock.advance(tail)
            ours.device_sync()
            theirs._t_device1 = clock()  # what the JAX device_sync records
            ours.note_tokens(real)
            theirs.note_tokens(real)
        got.append(ours.step_done(step))
        want.append(theirs.step_done(step))
        if stall is not None:
            ours.note_ckpt_stall(stall)
            theirs.note_ckpt_stall(stall)
    got.append(ours.flush(len(PROTOCOL)))
    want.append(theirs.flush(len(PROTOCOL)))
    assert got == want
    assert any(r is not None for r in got)
    assert ours.run_padding_efficiency() == theirs.run_padding_efficiency()


def test_step_timer_device_time_follows_the_event_spans():
    """With a device clock, a synced step's device sample is the span
    between its data_end and dispatch_end marks, not the host residual;
    device-basis MFU divides by their sum on the card's peak."""
    clock, dev = FakeClock(), FakeDeviceClock()
    timer = StepTimer(window=3, sync_every=1, clock=clock, seq_per_step=16,
                      flops_per_seq=1e12,
                      device_kind="NVIDIA H100 80GB HBM3", device_clock=dev)
    spans = [0.5, 0.25, 0.75]
    for step, span in enumerate(spans, 1):
        timer.data_start()
        clock.advance(0.01)
        dev.t = 10.0 * step
        timer.data_end()
        clock.advance(0.9)  # the host issues the step
        dev.t += span
        timer.dispatch_end()
        clock.advance(0.001)  # the sync's tail on the host clock
        timer.device_sync()
        record = timer.step_done(step)
    assert record["synced_steps"] == 3 and record["mfu_basis"] == "device"
    assert (record["device_p50_s"], record["device_max_s"]) == (0.5, 0.75)
    assert record["device_sum_s"] == 1.5
    assert record["host_p50_s"] == pytest.approx(0.9)
    assert record["mfu"] == round(16 * 3 * 1e12 / 1.5 / 989e12, 4)
    assert record["device_p50_s"] <= record["step_p50_s"]
    assert schema.validate_record({"schema": 1, "ts": 0, **record}) == []


def test_step_timer_sampled_cadence_reads_wall_basis():
    clock, dev = FakeClock(), FakeDeviceClock()
    timer = StepTimer(window=4, sync_every=2, clock=clock, seq_per_step=8,
                      flops_per_seq=1e12,
                      device_kind="NVIDIA H100 80GB HBM3", device_clock=dev)
    for step in range(1, 5):
        timer.data_start()
        dev.t = float(step)
        timer.data_end()
        clock.advance(1.0)
        dev.t += 0.125
        timer.dispatch_end()
        if timer.should_sync():
            timer.device_sync()
        record = timer.step_done(step)
    assert record["synced_steps"] == 2 and record["mfu_basis"] == "wall"
    assert record["device_sum_s"] == 0.25  # the unsynced spans are not read
    assert record["mfu"] == round(8e12 / 989e12, 4)  # 8 seq/s on the wall


# -- flops ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny", "bert_base_config",
                                  "bert_large_uncased_config"])
def test_flops_equal_jax(name):
    if name == "tiny":
        fields = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=64)
        ours, theirs = BertConfig(**fields), JaxConfig(**fields)
    else:
        path = os.path.join(REPO, "configs", f"{name}.json")
        ours, theirs = (BertConfig.from_json_file(path),
                        JaxConfig.from_json_file(path))
    for seq in (128, 384, 512):
        assert (flops.bert_encoder_flops_per_seq(ours, seq)
                == jax_flops.bert_encoder_flops_per_seq(theirs, seq))
        for nsp in (True, False):
            assert (flops.bert_train_flops_per_seq(ours, seq, 80, nsp)
                    == jax_flops.bert_train_flops_per_seq(theirs, seq, 80,
                                                          nsp))
        for kw in ({}, {"head_outputs": 10}, {"head_outputs": 3,
                                              "per_token_head": False,
                                              "pooled": True}):
            assert (flops.bert_finetune_flops_per_seq(ours, seq, **kw)
                    == jax_flops.bert_finetune_flops_per_seq(theirs, seq,
                                                             **kw))
    assert flops.mfu(10.0, 1e12, "cpu") == jax_flops.mfu(10.0, 1e12,
                                                        "cpu") == 0.0


def test_peak_tflops_names_nvidia_cards_only():
    assert flops.peak_tflops("NVIDIA H100 80GB HBM3") == 989
    assert flops.peak_tflops("NVIDIA H100 PCIe") == 756
    for kind in ("cpu", "TPU v4", "TPU v5 lite", "NVIDIA A100-SXM4-80GB"):
        assert flops.peak_tflops(kind) == 0.0
    assert flops.mfu(989.0, 1e12, "NVIDIA H100 80GB HBM3") == 1.0


# -- the profiler spec and window ------------------------------------------

SPECS = [None, "", "0", 0, "5", 5, "3:10", "1:2", " 4 ", "0:5", "7:3",
         "4:4", "x", "2:y"]


@pytest.mark.parametrize("spec", SPECS, ids=[repr(s) for s in SPECS])
def test_parse_profile_spec_equals_jax(spec):
    try:
        want = jax_profiler.parse_profile_spec(spec)
    except ValueError:
        with pytest.raises(ValueError):
            profiler.parse_profile_spec(spec)
    else:
        assert profiler.parse_profile_spec(spec) == want


def test_profiler_window_writes_one_bounded_trace(tmp_path):
    window = profiler.ProfilerWindow("2:3", str(tmp_path))
    assert not window.maybe_start(1)
    assert window.maybe_start(2) and window.active and profiler.trace_active()
    # The latch: no second trace while one is active.
    assert not profiler.ProfilerWindow("1:9", str(tmp_path)).maybe_start(2)
    with window.annotation(2):
        torch.ones(8).add_(1.0)
    assert not window.maybe_stop(1)
    assert window.maybe_stop(2) and window.done and not window.active
    assert not profiler.trace_active() and not window.maybe_start(2)
    trace = json.load(open(window.last_trace))
    assert any(e.get("name") == "train/2" for e in trace["traceEvents"])
    assert os.path.dirname(window.last_trace) == str(tmp_path)
    assert profiler.ProfilerWindow("0", None).range is None


def test_trace_reading_counts_every_kernel_once(tmp_path):
    """The repo's one device reading: every kernel event of a Chrome
    trace, a demangled lambda kernel (``#`` in its name) included; the
    profiler's ranges mirrored onto the device and the host operators are
    not kernels. A range's device time is its kernels' overlap with it."""
    from bert_pytorch_tpu_torch.tools import profile_train

    lam = "void at::native::elementwise_kernel<128, 2, {lambda(float)#1}>"
    events = [
        {"cat": "kernel", "name": "gemm", "ts": 0, "dur": 1000},
        {"cat": "kernel", "name": lam, "ts": 1000, "dur": 500},
        {"cat": "kernel", "name": lam, "ts": 2000, "dur": 500},
        {"cat": "gpu_user_annotation", "name": "kfac.ema", "ts": 900,
         "dur": 1300},
        {"cat": "gpu_user_annotation", "name": "Optimizer.step#Lamb.step",
         "ts": 0, "dur": 2500},
        {"cat": "cpu_op", "name": "aten::mul", "ts": 0, "dur": 4000},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    rows = profile_train.kernel_rows(profile_train.load_trace(str(path)))
    assert rows == [("gemm", 1.0, 1), (lam, 1.0, 2)]
    assert profile_train.range_device_ms(events, "kfac.ema") == (
        pytest.approx(0.8))
    assert profile_train.range_device_ms(events, "kfac.inverses") == 0.0


# -- sentinels, heartbeat, watchdog, divergence ----------------------------

OBSERVATIONS = [(1, 1.0, 2.0), (2, 0.0, float("nan")), (3, 1.0, 1.5),
                (4, 0.0, None), (5, 0.0, 9.0), (6, 0.0, 9.0), (7, 1.0, 1.0)]


@pytest.mark.parametrize("policy,patience", [("abort", 3), ("abort", 1),
                                             ("continue", 1)])
def test_sentinel_answers_as_jax(policy, patience):
    runs = []
    for module in (sentinels, jax_sentinels):
        emitted, answers = [], []
        s = module.FailureSentinel(policy=policy, patience=patience,
                                   emit=emitted.append)
        for step, finite, loss in OBSERVATIONS:
            try:
                answers.append(s.observe(step, finite, loss))
            except module.NonFiniteError as e:
                answers.append(("raised", str(e)))
                break
        runs.append((emitted, answers, s.total_nonfinite))
    assert json.dumps(runs[0]) == json.dumps(runs[1])
    with pytest.raises(ValueError):
        sentinels.FailureSentinel(policy="explode")


def test_heartbeat_hold_counts_down_and_ends(tmp_path):
    """``beat(..., hold_s=S)`` declares that the process may not beat for
    S seconds: beats inside the hold carry the seconds left (a regular
    beat from another thread does not end it), ``hold_s=0`` ends it, and
    a beat outside a hold writes the JAX package's four keys alone."""
    clock = FakeClock()
    path = str(tmp_path / "hb.json")
    hb = sentinels.Heartbeat(path, clock=clock)
    hb.beat(1, hold_s=12.0)
    assert sentinels.Heartbeat.read(path)["hold_s"] == 12.0
    clock.advance(4.0)
    hb.beat(2)
    assert sentinels.Heartbeat.read(path)["hold_s"] == 8.0
    hb.beat(3, hold_s=0.0)
    assert set(sentinels.Heartbeat.read(path)) == {
        "step", "wallclock", "last_loss", "counter"}
    hb.beat(4, hold_s=1.0)
    clock.advance(1.5)
    hb.beat(5)
    assert "hold_s" not in sentinels.Heartbeat.read(path)
    assert sentinels.Heartbeat.read(path)["counter"] == 5


def test_heartbeat_and_watchdog_answer_as_jax(tmp_path):
    beats = []
    for module, name in ((sentinels, "port"), (jax_sentinels, "jax")):
        path = str(tmp_path / f"{name}.json")
        hb = module.Heartbeat(path, clock=lambda: 1000.1234)
        hb.beat(1, last_loss=2.5)
        hb.beat(2)
        module.Heartbeat(path, clock=lambda: 1001.0).beat(3)  # resumed
        beats.append(module.Heartbeat.read(path))
        assert module.Heartbeat(None).path is None
        assert module.Heartbeat(path, is_primary=False).path is None
    # A resumed heartbeat keeps the counter, not the last loss.
    assert beats[0] == beats[1] == {"step": 3, "wallclock": 1001.0,
                                    "last_loss": None, "counter": 3}
    records = []
    for module in (sentinels, jax_sentinels):
        clock = FakeClock()
        dog = module.HeartbeatWatchdog(5.0, clock=clock)
        seen = [dog.check()]
        dog.note(3)
        clock.advance(4.0)
        seen.append(dog.check())
        clock.advance(2.0)
        seen += [dog.check(), dog.check()]  # one flag per stall
        dog.note(4)
        clock.advance(6.0)
        seen.append(dog.check())
        records.append((seen, dog.stalls_flagged))
    assert records[0] == records[1]
    assert records[0][1] == 2


DIVERGENCE = [(0, 100.0, 0.001), (1, 1.0, 0.001), (2, 1.0, 0.001),
              (3, 1.1, 0.001), (4, 50.0, 0.001), (5, 50.0, 2.0),
              (6, 1.0, 0.001), (7, float("nan"), 0.5), (8, 60.0, None)]


@pytest.mark.parametrize("policy", ["continue", "abort"])
def test_divergence_monitor_answers_as_jax(policy):
    runs = []
    for module in (model_stats, jax_stats):
        emitted, answers = [], []
        mon = module.DivergenceMonitor(emit=emitted.append, policy=policy,
                                       patience=2, spike_factor=5.0,
                                       ratio_max=1.0, warmup=3)
        for step, norm, ratio in DIVERGENCE:
            try:
                answers.append(mon.observe(step, norm, ratio))
            except module.DivergenceError as e:
                answers.append(("raised", str(e)))
                break
        runs.append((emitted, answers, mon.ema, mon.total_warnings))
    assert runs[0] == runs[1]


# -- grad health ------------------------------------------------------------

def test_grad_health_groups_and_reduces_as_jax():
    """The JAX test tree (embeddings, a 3-layer stacked encoder, a QA
    head) against the same tensors under the port's names."""
    def tree(scale):
        return {"bert": {
            "embeddings": {"word_embeddings": jnp.full((4, 2), scale)},
            "encoder": {"layers": {"kernel": jnp.full((3, 2, 2), scale),
                                   "bias": jnp.full((3, 2), scale)}}},
            "qa_outputs": {"kernel": jnp.arange(4.0).reshape(2, 2) * scale}}

    want = jax_stats.health_record(
        1, jax_stats.grad_health(tree(2.0), tree(1.0), tree(0.5)))

    def tensors(scale):
        out = {"bert.embeddings.word_embeddings.weight":
               torch.full((4, 2), scale)}
        for i in range(3):
            out[f"bert.encoder.layers.{i}.kernel"] = torch.full((2, 2),
                                                                scale)
            out[f"bert.encoder.layers.{i}.bias"] = torch.full((2,), scale)
        out["qa_outputs.weight"] = torch.arange(4.0).reshape(2, 2) * scale
        return out

    names = list(tensors(1.0))
    norms = {s: model_stats.tensor_norms(list(tensors(s).values()))
             for s in (2.0, 1.0, 0.5)}
    got = model_stats.health_record(1, model_stats.grad_health(
        names, norms[2.0], norms[1.0], norms[0.5]))
    assert set(got["groups"]) == set(want["groups"]) == {
        "bert/embeddings", "bert/encoder", "qa_outputs"}
    np.testing.assert_allclose(got["per_layer_grad_norm"],
                               want["per_layer_grad_norm"], rtol=HEALTH_RTOL)
    for key in ("grad_norm", "param_norm", "update_ratio"):
        np.testing.assert_allclose(got[key], want[key], rtol=HEALTH_RTOL)
        for group in want["groups"]:
            np.testing.assert_allclose(got["groups"][group][key],
                                       want["groups"][group][key],
                                       rtol=HEALTH_RTOL)
    assert schema.validate_record({"schema": 1, "ts": 0, **got}) == []
    assert model_stats.group_key("cls.predictions.bias") == "cls"
    assert [model_stats.is_due(c, 4, 2) for c in range(2, 8)] == [
        True, False, False, False, True, False]
    assert not model_stats.is_due(0, 0) and not model_stats.is_due(0, -1)


def test_step_health_reads_the_optimizers_updates():
    """The block after a real AdamW step: the updates are the deltas the
    optimizer applied (its ``step(updates=)`` dict)."""
    from bert_pytorch_tpu_torch.optim.transforms import AdamW

    w = torch.nn.Parameter(torch.ones(3))
    before = w.detach().clone()
    w.grad = torch.tensor([1.0, -2.0, 0.5])
    opt = AdamW([{"params": [w]}], 0.1, weight_decay=0.0)
    named = [("qa_outputs.weight", w)]
    stats = model_stats.step_with_health(opt, named, 1)
    applied = float((w.detach() - before).norm())
    assert stats["due"] == 1.0
    assert float(stats["update_ratio"]) * 3 ** 0.5 == pytest.approx(applied)
    assert float(stats["grad_norm"]) == pytest.approx(
        float(torch.tensor([1.0, -2.0, 0.5]).norm()))
    # Off the cadence: a plain step and no block.
    before = w.detach().clone()
    assert model_stats.step_with_health(opt, named, 2) is None
    assert opt.param_groups[0]["count"] == 2
    assert not torch.equal(w.detach(), before)


# -- the memory sampler -----------------------------------------------------

READINGS = [(100, 150, 1000), (300, 400, 1000), (200, 400, 1000)]


def test_memory_sampler_aggregates_as_jax(monkeypatch):
    """The same allocator readings (the CUDA allocator's keys for the
    port, ``memory_stats()`` for JAX) give the same window record."""
    import jax

    class FakeDevice:
        def __init__(self, reading):
            self.reading = reading

        def memory_stats(self):
            live, peak, limit = self.reading
            return {"bytes_in_use": live, "peak_bytes_in_use": peak,
                    "bytes_limit": limit}

    class Props:
        total_memory = 1000

    jax_iter, port_iter = iter(READINGS), iter(READINGS)
    monkeypatch.setattr(jax, "local_devices",
                        lambda: [FakeDevice(next(jax_iter))])

    def stats(device):
        live, peak, _ = next(port_iter)
        return {"allocated_bytes.all.current": live,
                "allocated_bytes.all.peak": peak}

    monkeypatch.setattr(torch.cuda, "memory_stats", stats)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props())
    records = []
    for sampler in (memory.MemorySampler(records.append, device="cuda"),
                    jax_memory.MemorySampler(records.append)):
        for step in (1, 2, 3):
            sampler.sample(step)
        sampler.flush(3)
        assert sampler.flush(4) is None
    assert records[0] == records[1]
    assert (records[0]["peak_bytes_in_use"], records[0]["bytes_in_use"],
            records[0]["bytes_in_use_max"]) == (400, 200, 300)

    def broken(device):
        raise RuntimeError("no card")

    monkeypatch.setattr(torch.cuda, "memory_stats", broken)
    with pytest.raises(RuntimeError, match="no card"):
        memory.MemorySampler(records.append, device="cuda").sample(1)


def test_memory_sampler_cpu_writes_one_note():
    emitted = []
    sampler = memory.MemorySampler(emitted.append, device="cpu")
    for step in range(5):
        sampler.sample(step)
    assert sampler.flush(5) is None
    assert emitted == [{"kind": "memory", "tag": "telemetry", "step": 0,
                        "memory_supported": False}]


# -- the loader's gauges ----------------------------------------------------

def test_loader_snapshot_carries_the_jax_gauges():
    dataset = SyntheticPretrainingDataset(0, 24, 16, 64, 3)
    snaps = []
    for cls in (DataLoader, JaxLoader):
        loader = cls(dataset, DistributedSampler(dataset), batch_size=4)
        assert loader.snapshot() is None
        for _ in zip(range(5), loader):
            pass
        snaps.append(loader.snapshot())
        assert loader.snapshot() is None  # reset per snapshot
    ours, theirs = snaps
    assert set(ours) == set(theirs) >= set(schema.LOADER_REQUIRED_KEYS)
    assert ours["batches"] == theirs["batches"] == 5
    assert 0 <= ours["depth_mean"] <= ours["depth_max"] <= 2
    assert ours["wait_s_max"] <= ours["wait_s_total"]


# -- the facade and the runner ------------------------------------------------

def test_train_telemetry_loop_protocol(tmp_path):
    """The JAX facade test's protocol on the port's facade: windows, the
    host-side fallback sentinel on a NaN loss, the summary, the heartbeat
    (3 steps + finish)."""
    path = str(tmp_path / "tele.jsonl")
    clock = FakeClock()
    tele = telemetry.TrainTelemetry(
        jsonl_path=path, window=2, clock=clock,
        heartbeat_path=str(tmp_path / "hb.json"), sentinel_policy="continue")
    step = 0
    for _ in tele.timed(iter([torch.ones(2)] * 3)):
        step += 1
        clock.advance(0.01)
        tele.dispatch_done()
        loss = torch.tensor(1.0 if step < 3 else float("nan"))
        tele.step_done(step, {"loss": loss, "real_tokens": torch.tensor(5.0)})
    with tele.checkpoint_stall():
        clock.advance(0.5)
    tele.finish(step, summary={"note": "done"})
    tele.close()
    kinds = {}
    for line in open(path):
        rec = json.loads(line)
        kinds.setdefault(rec["kind"], []).append(rec)
    assert [w["window_steps"] for w in kinds["step_window"]] == [2, 1]
    assert kinds["step_window"][1]["ckpt_steps"] == 1
    assert kinds["sentinel"][0]["step"] == 3
    assert kinds["run_summary"][0]["note"] == "done"
    assert kinds["memory"] == [dict(kinds["memory"][0],
                                    memory_supported=False)]
    hb = telemetry.Heartbeat.read(str(tmp_path / "hb.json"))
    assert hb["step"] == 3 and hb["counter"] == 4
    assert schema.validate_file(path) == []
    assert jax_schema.validate_file(path) == []


def test_sentinel_abort_stops_the_facade():
    """Under ``abort`` the in-step ``finite`` flag of ``patience``
    consecutive synced steps raises out of ``step_done``; a healthy step
    in between resets the streak."""
    tele = telemetry.TrainTelemetry(window=5, sentinel_policy="abort",
                                    sentinel_patience=2)
    for step, finite in enumerate((0.0, 1.0, 0.0, 0.0), 1):
        tele.timer.data_start()
        tele.timer.data_end()
        tele.dispatch_done()
        metrics = {"loss": torch.tensor(2.0), "finite": torch.tensor(finite)}
        if step < 4:
            tele.step_done(step, metrics)
        else:
            with pytest.raises(telemetry.NonFiniteError, match="step 4"):
                tele.step_done(step, metrics)
    assert tele.sentinel.total_nonfinite == 3


# The JAX runner smoke test's record kinds (tests/test_telemetry.py,
# test_pretraining_smoke_emits_telemetry) that the port does not write:
# XLA compile events and their cost analysis.
JAX_ONLY_KINDS = {"compile", "compile_cost"}
JAX_SMOKE_KINDS = {"step_window", "compile", "compile_cost", "grad_health",
                   "memory", "run_summary", "metric"}


@pytest.fixture(scope="module")
def pretraining_run(tmp_path_factory):
    """The port's run_pretraining on the CPU: 2 layers at hidden 32, 22
    steps, window 10, sync every 1, a profiler window over step 2."""
    root = tmp_path_factory.mktemp("tele_run")
    config = root / "tiny.json"
    config.write_text(json.dumps(dict(
        vocab_size=64, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=32, type_vocab_size=2, next_sentence=True,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)))
    out = root / "out"
    args = run_pretraining.parse_arguments([
        "--model_config_file", str(config), "--output_dir", str(out),
        "--global_batch_size", "8", "--local_batch_size", "4",
        "--max_steps", "22", "--steps", "22", "--device", "cpu",
        "--dtype", "float32", "--max_predictions_per_seq", "5",
        "--telemetry_window", "10", "--telemetry_sync_every", "1",
        "--profile_steps", "2:3", "--skip_final_checkpoint"])
    summary = run_pretraining.main(
        args, SyntheticPretrainingDataset(0, 8 * 22, 32, 64, 5))
    return summary, out


def test_runner_jsonl_passes_both_schemas(pretraining_run):
    summary, out = pretraining_run
    assert summary["global_step"] == 22 and summary["training_mfu"] == 0.0
    path = str(out / "pretraining_telemetry.jsonl")
    assert schema.validate_file(path) == []
    assert jax_schema.validate_file(path) == []
    kinds = {}
    for line in open(path):
        rec = json.loads(line)
        kinds.setdefault(rec.get("kind", "metric"), []).append(rec)
    assert set(kinds) == JAX_SMOKE_KINDS - JAX_ONLY_KINDS
    windows = kinds["step_window"]
    assert len(windows) >= 2
    for w in windows:
        assert w["synced_steps"] == w["window_steps"]
        assert w["mfu"] == 0.0 and w["mfu_basis"] == "device"
        assert "device_sum_s" not in w  # no device clock on the CPU
    assert all(set(schema.LOADER_REQUIRED_KEYS) <= set(w["loader"])
               for w in windows[:2])
    health = kinds["grad_health"]
    assert [r["step"] for r in health] == list(range(1, 23))
    for rec in health:
        assert {"bert/encoder", "bert/embeddings"} <= set(rec["groups"])
        assert len(rec["per_layer_grad_norm"]) == 2
        assert rec["grad_norm"] > 0 and 0 <= rec["update_ratio"] < 1
    # The schedule's lr reaches 0 at the last step, and so do the updates.
    assert all(r["update_ratio"] > 0 for r in health[:-1])
    assert health[-1]["update_ratio"] == 0.0
    train = {r["step"]: r for r in kinds["metric"] if r["tag"] == "train"}
    assert sorted(train) == list(range(1, 23))
    # The block's global norm is the step's own grad_norm metric.
    assert health[5]["grad_norm"] == pytest.approx(train[6]["grad_norm"],
                                                   rel=1e-5)
    assert kinds["memory"] == [dict(kinds["memory"][0],
                                    memory_supported=False)]
    assert len(kinds["run_summary"]) == 1
    assert kinds["run_summary"][0]["steps"] == 22
    hb = telemetry.Heartbeat.read(str(out / "heartbeat.json"))
    assert hb["step"] == 22 and math.isfinite(hb["last_loss"])


def test_runner_writes_the_jax_file_sinks_and_one_trace(pretraining_run):
    _, out = pretraining_run
    csv_lines = open(out / "pretraining_metrics.csv").read().splitlines()
    assert csv_lines[0].startswith("tag,epoch,step,loss")
    assert len(csv_lines) == 23
    text = open(out / "pretraining.txt").read()
    assert "event start" in text and "training_seq_per_sec" in text
    traces = os.listdir(out / "profile")
    assert len(traces) == 1
    events = json.load(open(out / "profile" / traces[0]))["traceEvents"]
    names = {e.get("name") for e in events}
    assert "train/2" in names and "train/3" not in names
    assert not os.path.exists(out / "tensorboard")


def test_runner_refuses_the_planes_it_does_not_port(tmp_path):
    base = ["--model_config_file", "x.json", "--output_dir", str(tmp_path),
            "--global_batch_size", "8", "--local_batch_size", "8",
            "--max_steps", "1"]
    with pytest.raises(SystemExit):
        run_pretraining.parse_arguments(
            base + ["--telemetry_cost_analysis", "off"])
    args = run_pretraining.parse_arguments(base + ["--disable_tensorboard"])
    assert (args.debug_port, args.debug_stale_after_s,
            args.postmortem_file) == (0, 0.0, "")
    assert (args.telemetry_window, args.telemetry_sync_every,
            args.grad_stats_every, args.log_prefix) == (20, 4, -1,
                                                        "pretraining")
    assert telemetry.stats_every(args) == 4
    with pytest.raises(ValueError, match="profile_steps"):
        run_pretraining.setup_training(run_pretraining.parse_arguments(
            base + ["--device", "cpu", "--profile_steps", "5:2",
                    "--model_config_file", "configs/bert_base_config.json"]))
