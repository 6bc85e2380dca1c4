"""LK503 negative: the producer communicates only through the Queue
(internally synchronized); the confined gauges stay consumer-side."""
import queue
import threading


class Prefetcher:
    def __init__(self):
        self._queue = queue.Queue(2)
        self._stats = {"batches": 0}
        self._thread = threading.Thread(target=self._worker, daemon=True)

    def _worker(self):
        while True:
            self._queue.put(object())

    def __next__(self):
        item = self._queue.get()
        self._stats["batches"] += 1
        return item

    def snapshot(self):
        return dict(self._stats)
