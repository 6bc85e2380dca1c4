"""Device prefetch: the stage between the host loader and the training
loop, the port of the JAX package's ``data/device_prefetch.py``.

``data/loader.py`` keeps host batches ahead of the loop; this module keeps
them ahead ON THE CARD. :class:`DevicePrefetcher` (the JAX class, rule for
rule) runs a background thread that pulls host items, calls the caller's
``stage`` on each and keeps up to ``depth`` staged items in a queue; the
loop's ``data_wait`` then measures only true producer stalls, and
:meth:`DevicePrefetcher.pop_h2d_wait_s` attributes ``min(consumer wait,
stage time)`` of each wait to the ``h2d_wait`` sub-phase (telemetry's
windows clamp it under ``data_wait``). ``depth <= 0`` stages inline on the
consumer's thread: the same iterator, gauges and staging.

:class:`HostToDevice` is the stage in PyTorch's idiom, where the JAX
package calls ``device_put``. On ``cuda`` each numpy array is copied into
pinned host memory and sent with a ``non_blocking`` copy on a dedicated
``torch.cuda.Stream``, cast there to the model's dtype (integers travel
as int32 and become int64 on the card, floats fp32), and an event is
recorded after the item's last copy. The consumer (``deliver``) makes its
current stream wait on that event and calls ``record_stream`` on every
tensor, so the caching allocator keeps their memory until the step that
reads them has run. The producer thread sets the current device itself
(it is per thread). There is no fallback: on a CUDA device a stage
without its side stream or pinned memory raises, never stages on the
compute stream. On the CPU the arrays become tensors in place.

Importing this module imports no torch (``data/`` stays torch-free for
the loader's spawned workers); :class:`HostToDevice` imports it.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional

from bert_pytorch_tpu_torch.data.loader import _bounded_put


def add_cli_args(parser, default: int = 2) -> None:
    """The one device-prefetch flag every runner shares (the JAX
    package's name, default and meaning)."""
    parser.add_argument(
        "--device_prefetch", type=int, default=default,
        help="batches staged ahead ON THE CARD (pinned host memory, "
             "copies on a side CUDA stream; data/device_prefetch.py): the "
             "host-to-device copy overlaps the previous step and "
             "telemetry's data_wait measures only producer stalls (an "
             "h2d_wait sub-phase reports the staging share). 0 stages "
             "inline on the loop's thread")


class HostToDevice:
    """``stage(item) -> staged`` on the producer thread and
    ``deliver(staged) -> value`` on the consumer's, for ``device``.

    ``prepare(item, put)`` builds the value from a host item, calling
    ``put(array)`` for each numpy array that goes to the card; ``put``
    returns the device tensor (int64 for integer arrays, fp32 for float
    ones, bool for bool ones)."""

    def __init__(self, device, prepare: Callable):
        import torch

        self._torch = torch
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # The constructing thread's card, named: the producer thread
            # sets it as its own current device.
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.prepare = prepare
        # Raises where there is no card: no silent staging on the CPU or
        # on the compute stream.
        self.stream = (torch.cuda.Stream(device=self.device)
                       if self.device.type == "cuda" else None)

    def _dtype(self, array):
        torch = self._torch
        if array.dtype.kind == "f":
            return torch.float32
        if array.dtype.kind == "b":
            return torch.bool
        return torch.int64

    def __call__(self, item):
        import numpy as np

        torch = self._torch
        tensors = []
        if self.stream is None:
            def put(array):
                array = np.ascontiguousarray(array)
                return torch.from_numpy(array).to(self._dtype(array))

            return self.prepare(item, put), None, tensors

        torch.cuda.set_device(self.device)

        def put(array):
            array = np.ascontiguousarray(array)
            pinned = torch.from_numpy(array).pin_memory()
            t = pinned.to(self.device, non_blocking=True).to(
                self._dtype(array))
            tensors.append(t)
            return t

        with torch.cuda.stream(self.stream):
            value = self.prepare(item, put)
            event = torch.cuda.Event()
            event.record(self.stream)
        return value, event, tensors

    def deliver(self, staged):
        value, event, tensors = staged
        if event is not None:
            stream = self._torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in tensors:
                t.record_stream(stream)
        return value


def prefetch(source: Iterable, device, depth: int, prepare: Callable):
    """A :class:`DevicePrefetcher` over ``source``'s host items, ``depth``
    ahead on ``device``: ``prepare(item, put)`` builds each staged item
    (:class:`HostToDevice`). Every runner stages its training batches
    through it; close it when the epoch is left."""
    return DevicePrefetcher(source, HostToDevice(device, prepare), depth)


class DevicePrefetcher:
    """One-shot iterator of staged items, ``depth`` ahead.

    ``source`` yields host items; ``stage(item)`` (a :class:`HostToDevice`)
    moves one to the device on the producer thread, and
    ``stage.deliver(staged)`` runs on the consumer's thread before the
    item is returned. Errors of either surface at the consumer's
    ``next()``. Call :meth:`close` when abandoning the iterator mid-epoch
    (the runners do, in their ``finally``)."""

    def __init__(self, source: Iterable, stage: HostToDevice, depth: int = 2,
                 clock: Callable[[], float] = time.perf_counter):
        self._source = iter(source)
        self._stage = stage
        self.depth = int(depth)
        self._clock = clock
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, self.depth))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._done = False
        self._last_h2d_wait_s = 0.0
        self._reset_stats()

    # -- gauges (a window's "prefetch" sub-object, telemetry/runner.py) --

    def _reset_stats(self) -> None:
        self._stats = {"batches": 0, "wait_s_total": 0.0,
                       "h2d_wait_s_total": 0.0, "h2d_s_total": 0.0,
                       "producer_wait_s_total": 0.0, "depth_max": 0}

    def snapshot(self):
        """Gauges accumulated since the previous snapshot (None when no
        batches were delivered in the interval)."""
        s = self._stats
        if s["batches"] == 0:
            return None
        out = {"batches": s["batches"],
               "wait_s_total": round(s["wait_s_total"], 6),
               "h2d_wait_s_total": round(s["h2d_wait_s_total"], 6),
               "h2d_s_total": round(s["h2d_s_total"], 6),
               "producer_wait_s_total": round(s["producer_wait_s_total"], 6),
               "depth_max": s["depth_max"]}
        self._reset_stats()
        return out

    def pop_h2d_wait_s(self) -> float:
        """The staging share of the wait for the item just delivered
        (read by ``TrainTelemetry.timed`` into ``note_h2d``)."""
        value, self._last_h2d_wait_s = self._last_h2d_wait_s, 0.0
        return value

    # -- producer thread ------------------------------------------------

    def _produce(self) -> None:
        while not self._stop.is_set():
            t0 = self._clock()
            try:
                item = next(self._source)
            except StopIteration:
                break
            except BaseException as e:  # surfaced at the consumer's next()
                _bounded_put(self._queue, (e, 0.0, 0.0), self._stop)
                return
            if self._stop.is_set():
                # close() raced the pull: never stage for an abandoned
                # prefetcher.
                return
            t1 = self._clock()
            try:
                staged = self._stage(item)
            except BaseException as e:
                _bounded_put(self._queue, (e, 0.0, 0.0), self._stop)
                return
            t2 = self._clock()
            if not _bounded_put(self._queue, (staged, t1 - t0, t2 - t1),
                                self._stop):
                return
        _bounded_put(self._queue, (None, 0.0, 0.0), self._stop)

    # -- consumer protocol ----------------------------------------------

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        if self.depth <= 0:
            return self._next_inline()
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._produce, name="device-prefetch", daemon=True)
            self._thread.start()
        t0 = self._clock()
        depth = self._queue.qsize()
        item, producer_wait_s, h2d_s = self._queue.get()
        wait_s = self._clock() - t0
        if item is None:
            self.close()
            raise StopIteration
        if isinstance(item, BaseException):
            self.close()
            raise item
        self._observe(wait_s, min(wait_s, h2d_s), h2d_s,
                      producer_wait_s, depth)
        return self._stage.deliver(item)

    def _next_inline(self):
        """depth <= 0: pull and stage on the consumer's thread; the whole
        staging call is consumer wait. An error ends the iterator."""
        t0 = self._clock()
        try:
            item = next(self._source)
            t1 = self._clock()
            staged = self._stage(item)
        except BaseException:
            self._done = True
            raise
        t2 = self._clock()
        self._observe(t2 - t0, t2 - t1, t2 - t1, t1 - t0, 0)
        return self._stage.deliver(staged)

    def _observe(self, wait_s, h2d_wait_s, h2d_s, producer_wait_s,
                 depth) -> None:
        self._last_h2d_wait_s = h2d_wait_s
        s = self._stats
        s["batches"] += 1
        s["wait_s_total"] += wait_s
        s["h2d_wait_s_total"] += h2d_wait_s
        s["h2d_s_total"] += h2d_s
        s["producer_wait_s_total"] += producer_wait_s
        s["depth_max"] = max(s["depth_max"], depth)

    def close(self) -> None:
        """Stop the producer: set the stop event (a put parked on a full
        queue gives up), join it briefly, and then close the source
        (ending a loader's own thread or workers) unless the producer is
        still inside a pull from it, which it leaves to daemon teardown
        (it exits at the stop check without staging again)."""
        self._done = True
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=1.0)
            if thread.is_alive():
                return
        close = getattr(self._source, "close", None)
        if callable(close):
            close()
