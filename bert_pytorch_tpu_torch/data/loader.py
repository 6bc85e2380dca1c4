"""Batching loader with background prefetch: a copy of the thread mode
(``num_workers=0``) of the JAX package's ``data/loader.py``. One producer
thread walks the sampler, pulls samples from the dataset (whose own thread
streams shard files), collates numpy batches and keeps a small queue ahead
of the training loop, so host-side masking overlaps device work.
``drop_last`` defaults to True: every step sees the same batch shape. The
consumer-side gauges (:meth:`DataLoader.snapshot`) are the JAX loader's,
read into each telemetry window."""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np

BATCH_KEYS = ("input_ids", "segment_ids", "input_mask", "masked_lm_labels",
              "next_sentence_labels")
# Packed samples append the per-token sequence ids and per-pack [CLS]
# offsets; next_sentence_labels is then [K] per row.
PACKED_EXTRA_KEYS = ("sequence_ids", "cls_positions")


def _bounded_put(q, item, stop_event) -> bool:
    """A put that gives up once the consumer is gone."""
    while True:
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            if stop_event.is_set():
                return False


class DataLoader:
    def __init__(self, dataset, sampler, batch_size: int,
                 drop_last: bool = True, prefetch_batches: int = 2):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        self.prefetch_batches = prefetch_batches
        self._reset_stats()

    # -- telemetry gauges -----------------------------------------------
    #
    # Consumer-side instrumentation of the prefetch queue: how long the
    # training loop blocked waiting for a batch (wait), how often it found
    # the queue EMPTY (a stall — the producer is the bottleneck), and the
    # queue depth observed at each get (depth ~= prefetch_batches means the
    # producer keeps up; ~0 means it doesn't). snapshot() returns the deltas
    # since the last snapshot, so the runner can fold them into each
    # telemetry step-window record.

    def _reset_stats(self) -> None:
        self._stats = {"batches": 0, "wait_s_total": 0.0, "wait_s_max": 0.0,
                       "stalls": 0, "depth_sum": 0, "depth_max": 0}

    def _observe_get(self, wait_s: float, depth: int) -> None:
        s = self._stats
        s["batches"] += 1
        s["wait_s_total"] += wait_s
        s["wait_s_max"] = max(s["wait_s_max"], wait_s)
        if depth == 0:
            s["stalls"] += 1
        s["depth_sum"] += depth
        s["depth_max"] = max(s["depth_max"], depth)

    def snapshot(self) -> Optional[dict]:
        """Gauges accumulated since the previous snapshot (None if no
        batches were delivered in the interval)."""
        s = self._stats
        if s["batches"] == 0:
            return None
        out = {
            "batches": s["batches"],
            "wait_s_total": round(s["wait_s_total"], 6),
            "wait_s_max": round(s["wait_s_max"], 6),
            "stalls": s["stalls"],
            "depth_mean": round(s["depth_sum"] / s["batches"], 2),
            "depth_max": s["depth_max"],
        }
        self._reset_stats()
        return out

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def produce():
            samples = []
            try:
                for idx in self.sampler:
                    if stop.is_set():
                        return
                    samples.append(self.dataset[idx])
                    if len(samples) == self.batch_size:
                        if not _bounded_put(q, self._collate(samples), stop):
                            return
                        samples = []
                if samples and not self.drop_last:
                    if not _bounded_put(q, self._collate(samples), stop):
                        return
            except BaseException as e:  # surface producer errors
                _bounded_put(q, e, stop)
                return
            _bounded_put(q, None, stop)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        try:
            while True:
                depth = q.qsize()
                t_wait0 = time.perf_counter()
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                self._observe_get(time.perf_counter() - t_wait0, depth)
                yield item
        finally:
            stop.set()

    @staticmethod
    def _collate(samples) -> dict:
        keys = BATCH_KEYS + PACKED_EXTRA_KEYS[:len(samples[0]) - len(BATCH_KEYS)]
        arrays = [np.stack([s[i] for s in samples]) for i in range(len(keys))]
        return dict(zip(keys, arrays))
