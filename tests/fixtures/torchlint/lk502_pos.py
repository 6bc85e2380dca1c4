"""LK502 positive (with the test registry): `sink` is declared frozen —
shared across threads through a stable binding — but reset() rebinds
it, racing every reader."""


class Emitter:
    def __init__(self, sink):
        self.sink = sink

    def reset(self, sink):
        self.sink = sink

    def emit(self, record):
        self.sink.write(record)
