"""Mini telemetry schema for the CT801 fixtures. This is a CONTEXT
module (tests pass it through ``run_files(context_paths=...)``): CT801
reads ``KIND_REQUIRED_KEYS`` by parsing whatever ``telemetry/schema.py``
the program holds — never by importing it — so the fixtures bring their
own registry instead of coupling to the real one."""

KIND_REQUIRED_KEYS = {
    "train_window": ("step", "loss"),
    "fault": ("kind",),
}
