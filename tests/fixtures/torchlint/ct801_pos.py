"""CT801 positive: record kinds emitted off the schema registry (the
fixture registry lives in tests/fixtures/torchlint/telemetry/schema.py,
passed as program context by the tests)."""


def emit_window(sink, step):
    sink.write({"kind": "train_windw", "step": step, "loss": 0.0})


def emit_fault(record):
    record["kind"] = "falt"
    return record
