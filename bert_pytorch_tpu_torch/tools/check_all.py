#!/usr/bin/env python
"""The port's lint gate (bert_pytorch_tpu_torch/analysis/check_all.py):
torchlint over the port's package and chip_smoke.py, then the telemetry
record schema over the named JSONL artifacts and the autotune winners
format over the named JSON files::

    python bert_pytorch_tpu_torch/tools/check_all.py                # code
    python -m bert_pytorch_tpu_torch.tools.check_all run.jsonl w.json
    python bert_pytorch_tpu_torch/tools/check_all.py --skip-torchlint x.jsonl

Exit 0 = clean, 1 = findings or a failing/missing artifact, 2 = usage
error. Stdlib only: no torch, no JAX.
"""

from __future__ import annotations

import sys

if __package__:
    from bert_pytorch_tpu_torch.tools._bootstrap import REPO_ROOT
else:
    from _bootstrap import REPO_ROOT

if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from bert_pytorch_tpu_torch.analysis.check_all import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
