"""Step-time decomposition with device-sync discipline: the port of the JAX
package's ``telemetry/step_timer.py``, with the device time taken from
CUDA events.

PyTorch's CUDA calls return before the card has run them, so the wall
time of ``train_step(...)`` is mostly the HOST cost of issuing its
kernels; the card runs behind, and the next blocking operation (a
``float()`` of a metric, a synchronize) absorbs what is left. The
:class:`StepTimer` splits each step:

* ``data_wait`` — host blocked on the input pipeline;
* ``host`` — dispatch: from the batch's arrival until the step function
  returns (the host issuing the step's work);
* ``device`` — on ``cuda``, the span of the current stream over the
  step's work: a timing ``torch.cuda.Event`` is recorded on the stream at
  ``data_end`` (when dispatch begins) and another at ``dispatch_end``; a
  synced step waits on the second (:meth:`device_sync`) and its sample
  is ``start.elapsed_time(end) / 1e3``. The span includes the stream's
  waits on the host, so it bounds the card's busy time from above and
  never reads near zero on a host-bound step; it cannot exceed the
  step's wall time less its data wait by more than the events' clock
  resolution. On ``cpu`` there are no events: :meth:`device_sync`
  returns at once and the sample is the clock residual from dispatch
  return to the sync, exactly what the JAX timer reads on the CPU.

Why the span and not the JAX residual: the JAX timer takes device time as
dispatch-return → ``block_until_ready``, which is right under XLA, where
one dispatch enqueues one program and returns at once. An eager PyTorch
step is issued op by op, so on a host-bound step (the port's phase-2 step
is 12–31% busy with ~22.7k launches) the host enqueues almost the whole
step before dispatch returns, and any host sync inside the step leaves no
tail at all: the residual would read near zero and device-basis MFU
would exceed 1. The span is the card-side interval the step's work
occupied.

Per-step syncing costs a round trip, so the sync cadence is a knob:
``sync_every=1`` gives the full decomposition, ``sync_every=N`` samples
every Nth step and the unsynced steps contribute data/host times only
(``synced_steps`` in the record says how many device samples a window
holds).

Every ``window`` steps :meth:`step_done` returns one ``kind="step_window"``
record (schema.py) with p50/p95/max per component and MFU. ``mfu_basis``
says how MFU was computed: ``"device"`` (window FLOPs over the peak FLOPs
the card could have delivered in the summed device samples) when every
step in the window was synced, ``"wall"`` (window FLOPs over window wall
time) otherwise. With a device clock the record also carries
``device_sum_s``, the sum that device-basis MFU divides by, so a reader
can recompute it.

Padding-aware accounting: given ``tokens_per_step`` (the step's token
budget, pad included) and per-step real-token counts (``note_tokens``,
fed from the train step's ``real_tokens`` metric on the sync cadence),
windows additionally report ``padding_efficiency``, ``tokens_per_s`` with
an explicit ``tokens_per_s_basis`` and ``mfu_real_tokens``.
With a device prefetcher attached, :meth:`note_h2d` records the staging
share of each step's data wait and windows carry ``h2d_wait_*``
percentiles, clamped so that ``h2d_wait <= data_wait`` (a sub-phase).
:meth:`note_ckpt_stall` folds a checkpoint save's host stall into the
step it rode on, and windows with such steps carry ``ckpt_steps`` +
``ckpt_step_*`` percentiles.

The host clock is injectable (``clock=``), and so is the device clock
(``device_clock=``: ``mark()`` returns a mark on the device's timeline,
``wait(mark)`` blocks until it is reached, ``elapsed_s(a, b)`` is the
seconds between two reached marks; :class:`CudaEventClock` on ``cuda``),
so fake-clock tests drive both paths.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from bert_pytorch_tpu_torch.utils import flops as flops_util


class CudaEventClock:
    """The device clock of ``device``'s current CUDA stream: each mark is
    a timing event recorded on it."""

    def __init__(self, device):
        import torch

        self._torch = torch
        self.device = torch.device(device)

    def mark(self):
        event = self._torch.cuda.Event(enable_timing=True)
        event.record(self._torch.cuda.current_stream(self.device))
        return event

    @staticmethod
    def wait(mark) -> None:
        mark.synchronize()

    @staticmethod
    def elapsed_s(start, end) -> float:
        return start.elapsed_time(end) / 1e3


def _percentile(sorted_vals: list, frac: float) -> float:
    """Nearest-rank percentile of an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(frac * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


def _stats(vals: list, prefix: str) -> dict:
    s = sorted(vals)
    return {
        f"{prefix}_p50_s": round(_percentile(s, 0.50), 6),
        f"{prefix}_p95_s": round(_percentile(s, 0.95), 6),
        f"{prefix}_max_s": round(s[-1] if s else 0.0, 6),
    }


class StepTimer:
    def __init__(
        self,
        window: int = 20,
        sync_every: int = 1,
        clock: Callable[[], float] = time.perf_counter,
        seq_per_step: Optional[int] = None,
        flops_per_seq: Optional[float] = None,
        device_kind: str = "",
        tokens_per_step: Optional[int] = None,
        device_clock=None,
    ):
        self.window = max(1, int(window))
        self.sync_every = max(0, int(sync_every))  # 0 = never sync
        self._clock = clock
        self._device_clock = device_clock
        self.seq_per_step = seq_per_step
        self.flops_per_seq = flops_per_seq
        self.device_kind = device_kind
        # tokens_per_step is the step's token BUDGET (rows x seq_len, pad
        # included); the train step reports the real (non-pad) count via
        # note_tokens on the sync cadence.
        self.tokens_per_step = tokens_per_step
        self.run_real_tokens = 0.0
        self.run_token_steps = 0
        self._step_index = 0
        self._reset_window()
        self._t_data0 = self._t_data1 = self._t_dispatch1 = None
        self._t_device1 = None
        self._mark0 = self._mark1 = None
        self._device_s = None
        self._pending_h2d = None
        self._h2d_attached = False
        self._last_step_s = 0.0

    def _reset_window(self):
        self._data_waits: list = []
        self._hosts: list = []
        self._devices: list = []
        self._steps: list = []
        self._real_tokens: list = []
        self._h2ds: list = []
        self._ckpt_steps_s: list = []
        self._window_t0 = None

    # -- per-step marks, in order --------------------------------------

    def data_start(self) -> None:
        self._t_data0 = self._clock()
        if self._window_t0 is None:
            self._window_t0 = self._t_data0

    def data_end(self) -> None:
        self._t_data1 = self._clock()
        if self._device_clock is not None:
            self._mark0 = self._device_clock.mark()

    def dispatch_end(self) -> None:
        if self._device_clock is not None:
            self._mark1 = self._device_clock.mark()
        self._t_dispatch1 = self._clock()

    def should_sync(self) -> bool:
        if self.sync_every == 0:
            return False
        return self._step_index % self.sync_every == 0

    def note_h2d(self, h2d_wait_s: float) -> None:
        """Record the staging share of THIS step's data wait (the device
        prefetcher's attribution, data/device_prefetch.py). Called right
        after ``data_end``; clamped to the step's data_wait at
        :meth:`step_done`."""
        self._pending_h2d = max(0.0, float(h2d_wait_s))
        self._h2d_attached = True

    def note_ckpt_stall(self, stall_s: float) -> None:
        """Record a checkpoint save's host stall, attributed to the step
        it rode on (the one that just finished). Window records then carry
        ``ckpt_steps`` and ``ckpt_step_*`` percentiles over step+stall
        durations."""
        base = self._steps[-1] if self._steps else self._last_step_s
        self._ckpt_steps_s.append(base + max(0.0, float(stall_s)))

    def note_tokens(self, real_tokens: float) -> None:
        """Record one step's REAL (non-pad) token count. Called by the
        telemetry facade on synced steps only — the count rides in the
        step metrics, so reading it off-cadence would itself be a sync."""
        self._real_tokens.append(float(real_tokens))
        self.run_real_tokens += float(real_tokens)
        self.run_token_steps += 1

    def run_padding_efficiency(self) -> Optional[float]:
        """Run-level real/budget token ratio over the sampled steps (None
        when no counts were observed or the budget is unknown)."""
        if not self.run_token_steps or not self.tokens_per_step:
            return None
        return self.run_real_tokens / (
            self.run_token_steps * self.tokens_per_step)

    def device_sync(self) -> bool:
        """Wait for the step's work and record its device sample. Call
        after :meth:`dispatch_end`, only when :meth:`should_sync` (the
        caller may also force a sync, e.g. on log steps). With a device
        clock it waits on the ``dispatch_end`` mark and the sample is the
        span from the ``data_end`` mark; without one (the CPU, where an op
        has run when it returns) it returns at once and the sample is the
        clock residual."""
        if self._device_clock is not None and self._mark1 is not None:
            self._device_clock.wait(self._mark1)
            self._device_s = self._device_clock.elapsed_s(self._mark0,
                                                          self._mark1)
        self._t_device1 = self._clock()
        return True

    def step_done(self, step: int) -> Optional[dict]:
        """Finish the step; every ``window`` steps return the window record.

        The host components are differences of successive clock reads, so
        they are non-negative and their sum never exceeds the step's total
        wall time.
        """
        if self._t_data0 is None or self._t_data1 is None:
            return None  # marks were skipped (e.g. epoch boundary)
        self._data_waits.append(max(0.0, self._t_data1 - self._t_data0))
        if self._h2d_attached:
            # A sub-phase of this step's data_wait (a step with no note
            # contributes 0).
            self._h2ds.append(min(self._pending_h2d or 0.0,
                                  self._data_waits[-1]))
            self._pending_h2d = None
        if self._t_dispatch1 is not None:
            self._hosts.append(max(0.0, self._t_dispatch1 - self._t_data1))
            if self._device_s is not None:
                self._devices.append(max(0.0, self._device_s))
            elif (self._device_clock is None and self._t_device1 is not None
                  and self._t_device1 >= self._t_dispatch1):
                self._devices.append(self._t_device1 - self._t_dispatch1)
        end = self._t_device1 if self._t_device1 is not None \
            else (self._t_dispatch1 if self._t_dispatch1 is not None
                  else self._t_data1)
        self._steps.append(max(0.0, end - self._t_data0))
        self._last_step_s = self._steps[-1]
        self._t_data0 = self._t_data1 = self._t_dispatch1 = None
        self._t_device1 = None
        self._mark0 = self._mark1 = None
        self._device_s = None
        self._step_index += 1

        if len(self._steps) < self.window:
            return None
        record = self._window_record(step, end)
        self._reset_window()
        return record

    def flush(self, step: int) -> Optional[dict]:
        """Emit a final partial-window record (end of run)."""
        if not self._steps and not self._ckpt_steps_s:
            # A checkpoint stall noted after the last full window rolled
            # (the end-of-run save) must still land in a record.
            return None
        record = self._window_record(step, None)
        self._reset_window()
        return record

    # -- window rollup --------------------------------------------------

    def _window_record(self, step: int, window_end) -> dict:
        n = len(self._steps)
        wall = ((window_end - self._window_t0)
                if (window_end is not None and self._window_t0 is not None)
                else sum(self._steps)) or 1e-9
        record = {
            "kind": "step_window",
            "tag": "telemetry",
            "step": step,
            "window_steps": n,
            "synced_steps": len(self._devices),
            "steps_per_sec": round(n / wall, 4),
        }
        record.update(_stats(self._data_waits, "data_wait"))
        if self._h2d_attached:
            # Clamped pairwise again, so the h2d_wait <= data_wait rule
            # (schema.py) survives rounding and percentile picks.
            h2d = _stats(self._h2ds, "h2d_wait")
            for suffix in ("p50_s", "p95_s", "max_s"):
                h2d[f"h2d_wait_{suffix}"] = min(
                    h2d[f"h2d_wait_{suffix}"], record[f"data_wait_{suffix}"])
            record.update(h2d)
        record.update(_stats(self._hosts, "host"))
        record.update(_stats(self._devices, "device"))
        if self._device_clock is not None:
            record["device_sum_s"] = round(sum(self._devices), 6)
        record.update(_stats(self._steps, "step"))
        if self._ckpt_steps_s:
            record["ckpt_steps"] = len(self._ckpt_steps_s)
            record.update(_stats(self._ckpt_steps_s, "ckpt_step"))
        record["mfu"], record["mfu_basis"] = self._window_mfu(wall, n)
        if self.seq_per_step:
            record["seq_per_sec"] = round(self.seq_per_step * n / wall, 2)
        if self.tokens_per_step:
            # "real" divides out the pad tokens (sampled from the steps
            # the sync cadence observed); "all" is the raw token budget
            # rate (the only number when no step in the window was
            # sampled).
            if self._real_tokens:
                eff = (sum(self._real_tokens)
                       / (len(self._real_tokens) * self.tokens_per_step))
                eff = min(1.0, eff)
                record["padding_efficiency"] = round(eff, 4)
                record["tokens_per_s"] = round(
                    self.tokens_per_step * n / wall * eff, 2)
                record["tokens_per_s_basis"] = "real"
                if record["mfu"]:
                    # Counts only real-token FLOPs as useful work ("mfu"
                    # keeps reporting hardware occupancy).
                    record["mfu_real_tokens"] = round(
                        record["mfu"] * eff, 4)
            else:
                record["tokens_per_s"] = round(
                    self.tokens_per_step * n / wall, 2)
                record["tokens_per_s_basis"] = "all"
        return record

    def _window_mfu(self, wall: float, n_steps: int):
        """(mfu, basis). Device basis — window FLOPs over the peak FLOPs
        the card could have delivered in the measured DEVICE seconds —
        only when EVERY step was synced; otherwise wall basis (FLOPs over
        window wall time). 0.0 when the device kind has no known peak
        (the CPU)."""
        if not self.seq_per_step or not self.flops_per_seq:
            return 0.0, "none"
        if self._devices and len(self._devices) == n_steps:
            device_s = sum(self._devices)
            if device_s <= 0:
                return 0.0, "device"
            seq_per_s = self.seq_per_step * n_steps / device_s
            basis = "device"
        else:
            if wall <= 0:
                return 0.0, "wall"
            seq_per_s = self.seq_per_step * n_steps / wall
            basis = "wall"
        return round(flops_util.mfu(
            seq_per_s, self.flops_per_seq, self.device_kind), 4), basis
