"""torchlint — a pure-AST, torch-free static analyzer for the port's
hazard patterns: the counterpart of the JAX package's ``analysis/``
(jaxlint), with every check restated for PyTorch on a CUDA card.

The port's step loops dispatch work to the card and let telemetry own
the device sync at a declared cadence; its background threads (async
checkpoint writer, data loader and HDF5 reader, device prefetcher,
watchdog, JSONL sink, the serving stages and the fleet's control loops,
autograd's backward thread) share state under a declared lock
discipline. This package makes those invariants machine-checked, before
the code runs.

Design constraints (the JAX package's, kept):

* **Pure AST** — files are parsed, never imported. Scanning a module that
  imports torch costs milliseconds and needs no torch.
* **torch-free** — importing ``bert_pytorch_tpu_torch.analysis`` pulls
  only the standard library (the port's package ``__init__`` imports
  nothing, and this one only its own stdlib modules),
  so the linter runs on commit hooks and CI boxes without the CUDA
  stack. It imports nothing of the JAX package either.
* **Stable check IDs** — the JAX package's IDs, so ``HS101`` names the
  same hazard in both packages. Every finding is suppressible inline with
  ``# torchlint: disable=ID`` and grandfatherable in the committed
  baseline file (``bert_pytorch_tpu_torch/torchlint_baseline.json``).

Per-file checks (one module each):

* ``host_sync``       HS101 — blocking device->host syncs (``.item()``,
  ``.cpu()``, ``float(tensor)``, ``torch.cuda.synchronize()``...) in
  step-loop hot paths, across modules through the program graph
* ``recompile``       RC201/RC202/RC203 — ``torch.compile``/``torch.jit``
  boundaries and cache-keyed builders (``lru_cache``, the kernel library
  cache, the autotune geometry): unhashable or per-value keys, compiled
  closures over module-level mutable state
* ``rng``             RN301/RN302 — a dropout seed consumed twice (the
  same Philox mask twice), and seeds from a wall clock or a pid
* ``tracer_leak``     TL401 — a tensor still attached to autograd stored
  on ``self``/a global in a forward or step function
* ``lock_discipline`` LK501/LK502/LK503 — accesses of registered shared
  state outside its declared guard (``analysis/concurrency.py``)

Whole-program checks (``graph.Program`` over every target):

* ``sharding``  SD601/SD602/SD603 — process-group axis names against the
  axes registry (``analysis/axes.py``, the torch-free mirror of
  ``parallel/mesh.py``), the Megatron split table's logical names
  against the rule table, and raw mesh-axis literals outside
  ``parallel/``
* ``donation``  DN701 — a buffer read while the card still owns it (an
  ``async_op=True`` collective's tensor before ``work.wait()``, a
  non-blocking device->host copy's destination before a sync)
* ``contracts`` CT801/CT802 — telemetry kinds emitted off the
  ``telemetry/schema.py`` registry; argparse flags declared-but-never-
  read / read-but-never-declared
"""

from bert_pytorch_tpu_torch.analysis.core import (  # noqa: F401
    ALL_CHECK_IDS,
    Finding,
    run_files,
    run_paths,
)
from bert_pytorch_tpu_torch.analysis.baseline import (  # noqa: F401
    apply_baseline,
    load_baseline,
    write_baseline,
)
