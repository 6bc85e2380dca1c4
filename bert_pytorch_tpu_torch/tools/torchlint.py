#!/usr/bin/env python
"""torchlint, the port's static analyzer (bert_pytorch_tpu_torch/analysis/):
host-sync, recompile, dropout-seed, autograd-leak and lock-discipline
checks per file, and the whole-program tier (process-group axes, buffers
read while the card owns them, telemetry kinds and CLI flags), with the
JAX package's check IDs::

    python bert_pytorch_tpu_torch/tools/torchlint.py            # the port
    python -m bert_pytorch_tpu_torch.tools.torchlint serve      # a subset
    python bert_pytorch_tpu_torch/tools/torchlint.py --list-checks

Exit 0 = clean against the committed baseline, 1 = findings, 2 = usage
error. Stdlib only: no torch, no JAX (files are parsed, never imported).
"""

from __future__ import annotations

import sys

if __package__:
    from bert_pytorch_tpu_torch.tools._bootstrap import REPO_ROOT
else:
    from _bootstrap import REPO_ROOT

if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from bert_pytorch_tpu_torch.analysis.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
