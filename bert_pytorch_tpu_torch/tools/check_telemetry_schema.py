#!/usr/bin/env python
"""Lint telemetry JSONL artifacts against the port's record schema
(telemetry/schema.py, the JAX package's rules kept rule for rule): the
counterpart of the repo-root ``tools/check_telemetry_schema.py``.

Every line must be valid JSON without NaN/Infinity spellings, and every
record that claims a schema version must carry its kind's required keys
and hold that kind's consistency rules (the serve, fleet, tracing,
profiling, ledger, deployment and compile families alike).

Usage::

    python bert_pytorch_tpu_torch/tools/check_telemetry_schema.py out/pretraining_telemetry.jsonl [more.jsonl ...]

Exit 0 = all valid, 1 = violations (one ``path:line: error`` each),
2 = no path named or a named path is missing. Stdlib only: the schema
module loads by file path (tools/_bootstrap.py), no torch.
"""

from __future__ import annotations

import os
import sys

if __package__:
    from bert_pytorch_tpu_torch.tools._bootstrap import REPO_ROOT, \
        load_by_path
else:
    from _bootstrap import REPO_ROOT, load_by_path

validate_file = load_by_path(
    "_torch_telemetry_schema", "telemetry", "schema.py").validate_file


def main(argv=None) -> int:
    paths = list(argv if argv is not None else sys.argv[1:])
    if not paths:
        print("check_telemetry_schema: name the JSONL artifacts to lint")
        return 2
    failed = False
    for path in paths:
        if not os.path.exists(path):
            print(f"check_telemetry_schema: {path}: no such file")
            return 2
        errors = validate_file(path)
        rel = os.path.relpath(path, REPO_ROOT)
        if errors:
            failed = True
            for lineno, err in errors:
                print(f"{rel}:{lineno}: {err}")
        else:
            print(f"{rel}: ok")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
