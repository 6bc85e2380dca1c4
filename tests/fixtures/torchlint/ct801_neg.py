"""CT801 negative: registered kinds pass; a dynamic kind is out of this
tier's reach (the runtime schema lint still judges the artifact)."""


def emit_window(sink, step):
    sink.write({"kind": "train_window", "step": step, "loss": 0.0})


def emit_dynamic(record, kind):
    record["kind"] = kind
    return record
