"""LK503 positive (with the test registry): `_stats` is confined to the
consumer thread, but the producer thread target `_worker` mutates it."""
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
            self._stats["batches"] += 1

    def snapshot(self):
        return dict(self._stats)
