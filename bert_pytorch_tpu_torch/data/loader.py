"""Batching loader with background prefetch: a copy of the JAX package's
``data/loader.py``.

``num_workers=0`` (default): one producer thread walks the sampler, pulls
samples from the dataset (whose own thread streams shard files), collates
numpy batches and keeps a small queue ahead of the training loop, so
host-side masking overlaps device work.

``num_workers=N``: N spawned worker PROCESSES each featurize every Nth
batch (round robin), and the parent delivers them in sampler order, so
the batches are the thread path's byte for byte (the masking draws derive
from (seed, epoch, index) inside the dataset). The sampler is drained up
front and its live ``index`` is set per DELIVERED batch, exact (the
thread path's runs ahead by its queue). A worker that dies raises
``RuntimeError`` naming it. Spawn, never fork: the parent holds a CUDA
context and threads, and a forked child that touched either could
deadlock. A spawned child re-imports the parent's ``__main__`` (for
``python -m bert_pytorch_tpu_torch.run_pretraining``, ``import torch``);
this module and the datasets it unpickles import no torch themselves.

``drop_last`` defaults to True: every step sees the same batch shape. The
consumer-side gauges (:meth:`DataLoader.snapshot`) are the JAX loader's,
read into each telemetry window."""

from __future__ import annotations

import multiprocessing as mp
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


def _worker_main(dataset, index_batches, out_queue, stop_event, worker_id):
    """A worker process: featurize and collate its (batch number, [dataset
    indices]) in order; results go out as (batch number, batch), an error
    as (batch number, RuntimeError) for the parent to raise at that
    batch."""
    for bno, idxs in index_batches:
        if stop_event.is_set():
            return
        try:
            batch = DataLoader._collate([dataset[i] for i in idxs])
        except BaseException as e:
            _bounded_put(out_queue, (bno, RuntimeError(
                f"DataLoader worker {worker_id} failed on batch {bno}: "
                f"{type(e).__name__}: {e}")), stop_event)
            return
        if not _bounded_put(out_queue, (bno, batch), stop_event):
            return
    _bounded_put(out_queue, (None, None), stop_event)


class DataLoader:
    def __init__(self, dataset, sampler, batch_size: int,
                 drop_last: bool = True, prefetch_batches: int = 2,
                 num_workers: int = 0):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        self.prefetch_batches = prefetch_batches
        self.num_workers = int(num_workers)
        # Per worker of the newest multi-process epoch: seconds from the
        # call that starts it to its first delivered batch. A spawned
        # start returns once the child has read its arguments, after it
        # re-imported the parent's __main__, so workers start in turn.
        self.worker_first_batch_s: list = []
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
        if self.num_workers > 0:
            return self._iter_multiprocess()
        return self._iter_thread()

    def _iter_multiprocess(self) -> Iterator[dict]:
        """Spawned workers, round robin over batches, in-order delivery;
        the sampler's ``index`` follows the delivered batches."""
        start = self.sampler.index  # nonzero on a mid-epoch resume
        positions = list(self.sampler)  # drains; resets sampler.index to 0
        n_batches = len(positions) // self.batch_size
        tail = positions[n_batches * self.batch_size:]
        batches = [(b, positions[b * self.batch_size:(b + 1)
                                 * self.batch_size])
                   for b in range(n_batches)]
        if tail and not self.drop_last:
            batches.append((n_batches, tail))
        ctx = mp.get_context("spawn")
        stop = ctx.Event()
        n_workers = max(1, min(self.num_workers, len(batches)))
        out_queues = [ctx.Queue(maxsize=max(2, self.prefetch_batches))
                      for _ in range(n_workers)]
        procs = [ctx.Process(target=_worker_main,
                             args=(self.dataset, batches[w::n_workers],
                                   out_queues[w], stop, w), daemon=True)
                 for w in range(n_workers)]
        started = []
        for p in procs:
            started.append(time.perf_counter())
            p.start()
        self.worker_first_batch_s = [None] * n_workers
        try:
            for b in range(len(batches)):
                w = b % n_workers
                q = out_queues[w]
                depth = q.qsize()
                t_wait0 = time.perf_counter()
                while True:
                    try:
                        bno, item = q.get(timeout=5.0)
                        break
                    except queue.Empty:
                        if not procs[w].is_alive():
                            raise RuntimeError(
                                f"DataLoader worker {w} died (exit code "
                                f"{procs[w].exitcode}) before producing "
                                f"batch {b}")
                if isinstance(item, BaseException):
                    raise item
                if bno != b:
                    raise RuntimeError(f"DataLoader worker {w} delivered "
                                       f"batch {bno} in place of {b}")
                now = time.perf_counter()
                if self.worker_first_batch_s[w] is None:
                    self.worker_first_batch_s[w] = now - started[w]
                self._observe_get(now - t_wait0, depth)
                self.sampler.index = min(len(self.sampler),
                                         start + (b + 1) * self.batch_size)
                yield item
            self.sampler.index = 0  # the epoch is complete, as __next__'s
        finally:
            stop.set()
            # Drain before joining: a worker exits only once its queue's
            # feeder thread has flushed what it put into the pipe.
            deadline = time.perf_counter() + 5.0
            for p, q in zip(procs, out_queues):
                while p.is_alive() and time.perf_counter() < deadline:
                    try:
                        q.get(timeout=0.05)
                    except queue.Empty:
                        pass
                if p.is_alive():
                    p.terminate()
                p.join(timeout=5.0)
            for q in out_queues:
                q.close()
                q.cancel_join_thread()

    def _iter_thread(self) -> Iterator[dict]:
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
