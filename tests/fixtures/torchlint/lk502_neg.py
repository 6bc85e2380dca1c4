"""LK502 negative: the frozen binding is assigned once in __init__;
reads from any thread are fine."""


class Emitter:
    def __init__(self, sink):
        self.sink = sink

    def emit(self, record):
        self.sink.write(record)
