"""TrainTelemetry — the facade every runner of the port threads its
training loop through (run_pretraining, run_squad, run_glue, run_ner,
run_swag): the port of the JAX package's ``telemetry/runner.py``.

One object owns the telemetry pieces and their lifecycle:

* a JSONL sink (``utils/logging.py JSONLHandler``) — shared with the
  runner's logger so ordinary train records land there too, while
  telemetry records go ONLY there;
* a :class:`~bert_pytorch_tpu_torch.telemetry.step_timer.StepTimer` for
  the data-wait / host-dispatch / device decomposition + MFU windows (on
  ``cuda`` the device time is a CUDA-event span, step_timer.py);
* a :class:`~bert_pytorch_tpu_torch.telemetry.profiler.ProfilerWindow` for
  bounded ``torch.profiler`` traces with per-step annotations;
* a :class:`~bert_pytorch_tpu_torch.telemetry.sampler.CaptureController` —
  the on-demand profiling plane: ``POST /profilez`` on the introspection
  hub arms it from an HTTP thread; :meth:`TrainTelemetry.step_done` ticks
  it at each step boundary, starting/collecting the bounded host-sampler
  + trace capture and emitting the ``profile_window`` record;
* the optional live
  :class:`~bert_pytorch_tpu_torch.telemetry.introspect.IntrospectionHub`
  (``--debug_port``: /healthz, /statsz, /metricsz, /profilez) and crash
  :class:`~bert_pytorch_tpu_torch.telemetry.flightrec.FlightRecorder`
  (``postmortem.json``), both fed by :meth:`TrainTelemetry.emit`;
* a :class:`~bert_pytorch_tpu_torch.telemetry.sentinels.FailureSentinel`
  and a :class:`~bert_pytorch_tpu_torch.telemetry.sentinels.Heartbeat`,
  and the optional hung-step watchdog;
* a :class:`~bert_pytorch_tpu_torch.telemetry.memory.MemorySampler`
  reading the CUDA allocator's watermarks on the sync cadence (one record
  per window; a single ``memory_supported: false`` note on the CPU);
* a :class:`~bert_pytorch_tpu_torch.telemetry.model_stats.DivergenceMonitor`
  consuming the grad-health block the train steps put into
  ``metrics["grad_health"]`` on due steps (popped here, emitted as
  ``grad_health`` records, checked for grad-norm spikes / update-ratio
  drift).

Not ported yet: the JAX facade's ``instrument`` and its
``CompileMonitor`` come with the bench legs (ROADMAP item "Bench legs and
an entry point"; the port's compile records are the kernel builds,
``telemetry/compile_events.py``, which the serving engine counts).
:meth:`TrainTelemetry.attach_prefetcher` takes the device prefetcher
(data/device_prefetch.py): each step's staging share of its data wait
becomes the ``h2d_wait`` sub-phase, and its gauges a window's
``prefetch`` sub-object.

One difference from the JAX facade: an on-demand capture still active
when the run ends is collected by :meth:`TrainTelemetry.finish` (its
``profile_window`` covers the steps up to the last), and :meth:`close`
after an exception flushes the flight recorder with the traceback instead
of closing it clean (the port's runners close their telemetry in a
``finally``).

Minimal loop integration::

    tele = TrainTelemetry(jsonl_path=..., heartbeat_path=..., ...)
    for batch in tele.timed(iter(loader)):        # measures data_wait
        tele.profiler.maybe_start(step)
        with tele.profiler.annotation(step):
            metrics = train_step(batch)
        tele.dispatch_done()                      # measures host dispatch
        tele.step_done(step, metrics)             # sync + window + sentinel
                                                  # + heartbeat + auto-stop
    tele.finish(step)                             # flush partial window
"""

from __future__ import annotations

import contextlib
import math
import sys
import time
from typing import Callable, Iterator, Optional

import torch

from bert_pytorch_tpu_torch.telemetry.memory import MemorySampler
from bert_pytorch_tpu_torch.telemetry.model_stats import (DivergenceMonitor,
                                                          health_record)
from bert_pytorch_tpu_torch.telemetry.profiler import ProfilerWindow
from bert_pytorch_tpu_torch.telemetry.sampler import CaptureController
from bert_pytorch_tpu_torch.telemetry.sentinels import (FailureSentinel,
                                                        Heartbeat,
                                                        HeartbeatWatchdog)
from bert_pytorch_tpu_torch.telemetry.step_timer import (CudaEventClock,
                                                         StepTimer)
from bert_pytorch_tpu_torch.utils import logging as logging_util


class TrainTelemetry:
    def __init__(
        self,
        jsonl_path: Optional[str] = None,
        sink=None,
        window: int = 20,
        sync_every: int = 1,
        seq_per_step: Optional[int] = None,
        flops_per_seq: Optional[float] = None,
        tokens_per_step: Optional[int] = None,
        device_kind: str = "",
        profile_steps=None,
        profile_dir: Optional[str] = None,
        sentinel_policy: str = "continue",
        sentinel_patience: int = 3,
        heartbeat_path: Optional[str] = None,
        watchdog_timeout_s: float = 0.0,
        grad_spike_factor: float = 10.0,
        update_ratio_max: float = 1.0,
        device="cpu",
        introspect=None,
        flight_recorder=None,
        clock: Callable[[], float] = time.perf_counter,
        device_clock=None,
    ):
        """``device`` is the training device: on ``cuda`` the timer's
        device clock is a :class:`CudaEventClock` on it (unless
        ``device_clock`` is given), the memory sampler reads its
        allocator and the profiler traces its kernels. The process is the
        run's one process on one card: it writes every artifact, and the
        heartbeat beats on every synced step (the JAX facade's
        ``is_primary``, ``n_devices`` and ``heartbeat_every`` come with
        the ROADMAP item "Multi-GPU layouts"). ``introspect`` (an
        :class:`IntrospectionHub`) and ``flight_recorder`` (a
        :class:`FlightRecorder`) are fed every emitted record; the hub
        also gets the step liveness and the capture controller."""
        self._clock = clock
        device = torch.device(device)
        if device_clock is None and device.type == "cuda":
            device_clock = CudaEventClock(device)
        # An already-open handler can be shared in via ``sink``.
        if sink is not None:
            self.sink = sink
        else:
            self.sink = logging_util.JSONLHandler(
                jsonl_path) if jsonl_path else None
        self.timer = StepTimer(
            window=window, sync_every=sync_every, clock=clock,
            seq_per_step=seq_per_step, flops_per_seq=flops_per_seq,
            device_kind=device_kind, tokens_per_step=tokens_per_step,
            device_clock=device_clock)
        self.profiler = ProfilerWindow(profile_steps, profile_dir,
                                       device=device)
        self.sentinel = FailureSentinel(
            policy=sentinel_policy, patience=sentinel_patience,
            emit=self.emit)
        # Grad-health early-warning shares the sentinel's policy/patience:
        # a sustained divergence warning is the same class of failure as a
        # sustained NaN, just caught earlier (model_stats.py).
        self.divergence = DivergenceMonitor(
            emit=self.emit, policy=sentinel_policy,
            patience=sentinel_patience, spike_factor=grad_spike_factor,
            ratio_max=update_ratio_max)
        # Device-memory watermarks, sampled where the host already waits
        # (the sync cadence) and emitted one record per window.
        self.memory = MemorySampler(emit=self.emit, device=device)
        self.heartbeat = Heartbeat(heartbeat_path)
        # Hung-step watchdog: fed a liveness note per completed step;
        # flags (fault record + warning, never a kill) when none lands
        # within the timeout. Started lazily at the first step so runner
        # setup doesn't count.
        self.watchdog = (HeartbeatWatchdog(watchdog_timeout_s, emit=self.emit)
                         if watchdog_timeout_s else None)
        # Live introspection hub and crash flight recorder: both fed from
        # emit() — which background threads (watchdog) also call — so the
        # bindings are frozen after __init__; each object does its own
        # locking.
        self.introspect = introspect
        self.flight_recorder = flight_recorder
        # On-demand capture plane: armed over HTTP (POST /profilez on the
        # hub), started/collected at the step boundary in step_done. It
        # shares the startup window's ProfilerWindow — the process-wide
        # trace latch (profiler.py) keeps the two from stacking traces.
        self.capture = CaptureController(
            source="trainer", covered_unit="steps", window=self.profiler,
            trace_dir=self.profiler.trace_dir, emit=self.emit)
        if self.introspect is not None:
            self.introspect.capture = self.capture
        # The debug HTTP server serving the hub, attached by
        # telemetry/cli.from_args (or tests); close() shuts it down so a
        # runner that opened --debug_port never leaks the port.
        self.debug_server = None
        self._loader_stats: Optional[Callable[[], Optional[dict]]] = None
        self._prefetcher = None
        self.last_step_synced = False

    # -- wiring ---------------------------------------------------------

    def emit(self, record=None, **kwargs) -> None:
        """Write one telemetry record to the JSONL sink — teeing it into
        the live introspection hub and the flight-recorder ring first
        (both no-ops when not attached; an incident record — fault /
        divergence / sentinel — makes the recorder flush its
        postmortem)."""
        rec = dict(record or {})
        rec.update(kwargs)
        if self.introspect is not None:
            self.introspect.observe_record(rec)
        if self.flight_recorder is not None:
            self.flight_recorder.note_record(rec)
        if self.sink is not None:
            self.sink.write_record(rec)

    def attach_loader(self, loader) -> None:
        """Use ``loader.snapshot()`` gauges in each window record."""
        snapshot = getattr(loader, "snapshot", None)
        if callable(snapshot):
            self._loader_stats = snapshot

    def attach_prefetcher(self, prefetcher) -> None:
        """Attribute the staging share of each step's data wait to the
        ``h2d_wait`` sub-phase (``DevicePrefetcher.pop_h2d_wait_s``), and
        fold the prefetcher's gauges into window records."""
        self._prefetcher = prefetcher

    @contextlib.contextmanager
    def checkpoint_stall(self):
        """Context manager timing a checkpoint save's host stall; the
        measured block lands on the step it rode on as a ``ckpt_step``
        sample (step_timer.py note_ckpt_stall). Wrap every IN-LOOP save
        with it, and the final save before :meth:`finish`."""
        t0 = self._clock()
        try:
            yield
        finally:
            self.timer.note_ckpt_stall(self._clock() - t0)

    # -- per-step protocol ----------------------------------------------

    def timed(self, iterator: Iterator) -> Iterator:
        """Wrap the batch iterator so host time blocked on the input
        pipeline is measured as data_wait."""
        while True:
            self.timer.data_start()
            try:
                item = next(iterator)
            except StopIteration:
                return
            self.timer.data_end()
            if self._prefetcher is not None:
                # The item came through the device prefetcher: how much
                # of the wait was staging (0.0 when it was ready).
                self.timer.note_h2d(self._prefetcher.pop_h2d_wait_s())
            yield item

    def dispatch_done(self) -> None:
        self.timer.dispatch_end()

    def step_done(self, step: int, metrics: Optional[dict] = None,
                  profile_step: Optional[int] = None) -> Optional[dict]:
        """Close out one step: device sync (per the cadence), sentinel
        check, heartbeat, profiler auto-stop, window emission.

        ``metrics`` is the step's metrics dict (device tensors: the source
        of the ``finite``/``loss`` scalars; a step without one is not
        synced). ``profile_step`` is the step number in the SAME base the
        runner feeds ``profiler.maybe_start`` — pass it when that base
        differs from ``step`` (run_pretraining profiles in step-in-run
        terms while ``step`` is the checkpoint-resumed global step).
        Returns the window record when one was emitted.
        """
        # The grad-health block rides in metrics but is telemetry's, not
        # the runner's: pop it unconditionally so runner-side
        # float(metrics[...]) loops never trip over the nested dict, and
        # read it only on synced steps (reading it otherwise would BE a
        # sync and defeat the cadence). The real-token count follows the
        # same contract: popped always, read only when this step syncs.
        health = metrics.pop("grad_health", None) \
            if isinstance(metrics, dict) else None
        real_tokens = metrics.pop("real_tokens", None) \
            if isinstance(metrics, dict) else None
        synced = False
        if metrics is not None and self.timer.should_sync():
            self.timer.device_sync()
            synced = True
        self.last_step_synced = synced
        if synced:
            if real_tokens is not None:
                self.timer.note_tokens(float(real_tokens))
            self.memory.sample(step)
            if health is not None and float(health.get("due", 0.0)):
                record = health_record(step, health)
                self.emit(record)
                # DivergenceError propagates under policy="abort", same
                # surface as the sentinel's NonFiniteError.
                self.divergence.observe(
                    step, record["grad_norm"], record["update_ratio"])
        if metrics is not None and synced:
            loss = metrics.get("loss")
            loss = None if loss is None else float(loss)
            finite = metrics.get("finite")
            if finite is not None:
                finite = float(finite)
            else:
                # No in-step sentinel (the finetune runners): fall back to
                # a host-side isfinite on the read loss.
                finite = 1.0 if (loss is None or math.isfinite(loss)) else 0.0
            self.sentinel.observe(step, finite, loss)
            self.heartbeat.beat(step, last_loss=loss)
        if self.introspect is not None:
            # Every step, synced or not: /healthz liveness must not
            # depend on the sync cadence (the loss rides only when this
            # step read it — reading it off-cadence would BE a sync).
            hub_loss = None
            if metrics is not None and synced and \
                    metrics.get("loss") is not None:
                hub_loss = float(metrics["loss"])
            self.introspect.note_step(step, loss=hub_loss)
        if self.watchdog is not None:
            self.watchdog.start().note(step)
        self.profiler.maybe_stop(
            step if profile_step is None else profile_step)
        # On-demand capture boundary: starts an armed capture, collects
        # an expired one (the finished profile_window record rides the
        # normal emit tee into hub/recorder/sink).
        self.capture.tick(step, sync_target=metrics)
        window = self.timer.step_done(step)
        if window is not None:
            if self._loader_stats is not None:
                gauges = self._loader_stats()
                if gauges:
                    window["loader"] = gauges
            if self._prefetcher is not None:
                gauges = self._prefetcher.snapshot()
                if gauges:
                    window["prefetch"] = gauges
            self.emit(window)
            self.memory.flush(step)  # one memory record per window
        return window

    # -- teardown -------------------------------------------------------

    def finish(self, step: int, summary: Optional[dict] = None) -> None:
        """End of run: stop a still-open trace, flush the partial window,
        final heartbeat, optional run summary record."""
        if self.watchdog is not None:
            self.watchdog.stop()
        # A capture still running collects over the steps it saw.
        self.capture.tick(step, force=True)
        self.profiler.stop()
        window = self.timer.flush(step)
        if window is not None:
            self.emit(window)
        self.memory.flush(step)  # partial-window memory samples
        if summary is not None:
            rec = {"kind": "run_summary", "tag": "telemetry", "step": step,
                   "steps": step}
            rec.update(summary)
            self.emit(rec)
        self.heartbeat.beat(step)

    def close(self) -> None:
        """Stop the watchdog and the debug server, close the sink, and
        end the flight recorder: clean (removing the postmortem unless an
        incident was flushed during the run), or — when called while an
        exception is propagating (a runner's ``finally``) — flushed with
        the traceback and left armed for the exit hooks."""
        if self.watchdog is not None:
            self.watchdog.stop()
        server, self.debug_server = self.debug_server, None
        if server is not None:
            try:
                server.shutdown()
                server.server_close()
            except Exception:
                pass
        if self.sink is not None:
            self.sink.close()
        if self.flight_recorder is not None:
            exc = sys.exc_info()[1]
            if exc is not None and not isinstance(exc, KeyboardInterrupt):
                self.flight_recorder.flush("crash", exc=exc)
            else:
                self.flight_recorder.close(clean=True)
