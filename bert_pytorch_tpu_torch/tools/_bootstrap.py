"""Shared bootstrap for the port's fleet tools: load a stdlib-only module
of ``bert_pytorch_tpu_torch`` by FILE PATH, without executing a package
``__init__`` chain that imports torch (``serve/__init__``,
``telemetry/__init__``) — the property that keeps the fleet's parent
process (``chaos_serve.py``, ``obs_collect.py``, ``model_registry.py``,
``telemetry_report.py``) free of torch, so it never takes a CUDA context
or card memory that its replicas need.

Paths resolve under the port's own package directory only. A tool run as
a script imports this module by name (Python puts the script's own
directory on ``sys.path``); imported as a module of the package, it
imports ``bert_pytorch_tpu_torch.tools._bootstrap`` (the package's and
``tools``' ``__init__`` import nothing).
"""

from __future__ import annotations

import importlib.util
import os
import sys

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE_ROOT)


def load_by_path(name: str, *relpath: str):
    """Load ``<PACKAGE_ROOT>/<relpath...>`` as module ``name`` (no package
    __init__ execution; the module must be stdlib-only). Give ``name`` a
    prefix of the port's own (``_torch...``): a process that also loads
    the JAX package's copies by path must never get one package's module
    under the other's name."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(PACKAGE_ROOT, *relpath))
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module
