"""LK501 negative: every access outside __init__ holds the declared
lock (and __init__ itself is implicitly allowed — no second thread can
hold a reference yet)."""
import threading


class Gauges:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0

    def bump(self):
        with self._lock:
            self.count += 1

    def read(self):
        with self._lock:
            return self.count
