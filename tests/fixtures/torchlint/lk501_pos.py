"""LK501 positive (with the test registry): `count` is declared guarded
by `_lock`, but read() touches it bare — exactly the lock-free gauge
read the serve stack shipped twice."""
import threading


class Gauges:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0

    def bump(self):
        with self._lock:
            self.count += 1

    def read(self):
        return self.count
