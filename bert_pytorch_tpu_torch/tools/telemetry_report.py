#!/usr/bin/env python
"""Offline telemetry summary + baseline-diff regression verdict: the
port's counterpart of the repo-root ``tools/telemetry_report.py``.

Thin CLI shim over :mod:`bert_pytorch_tpu_torch.telemetry.report`, which
it loads by file path with its schema and ledger siblings — stdlib only,
no torch — so it runs anywhere, the fleet's torch-free parent included.

Usage::

    python bert_pytorch_tpu_torch/tools/telemetry_report.py RUN.jsonl
    python bert_pytorch_tpu_torch/tools/telemetry_report.py RUN.jsonl BASE.jsonl
    python bert_pytorch_tpu_torch/tools/telemetry_report.py RUN.jsonl --ledger L.jsonl
    python bert_pytorch_tpu_torch/tools/telemetry_report.py --ledger L.jsonl

Exit 0 = no regression, 1 = regression (named in the output),
2 = missing file. ``--format json`` prints one stable versioned object
(``{"version": 1, ..., "rc": N}``); ``--json`` is the legacy machine
shape. ``--ledger`` appends the run to a perf ledger the caller owns and
gates its rolling median — "perf ledger drift" by name
(telemetry/ledger.py). Tolerance knobs: ``--step-tol --p95-tol --mfu-tol
--mem-tol --grad-tol --ledger-tol``.
"""

from __future__ import annotations

import sys

if __package__:
    from bert_pytorch_tpu_torch.tools._bootstrap import load_by_path
else:
    from _bootstrap import load_by_path

_report = load_by_path(
    "_torchtelemetry_report_engine", "telemetry", "report.py")

if __name__ == "__main__":
    sys.exit(_report.main())
