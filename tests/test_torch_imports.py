"""The PyTorch port stands alone: no file of ``bert_pytorch_tpu_torch``,
nor ``chip_smoke.py``, imports JAX, flax or anything of the JAX package
``bert_pytorch_tpu`` (it keeps its own copies of what it needs)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "bert_pytorch_tpu"}
PORT_FILES = sorted(
    str(p.relative_to(REPO))
    for p in (REPO / "bert_pytorch_tpu_torch").rglob("*.py")) + [
        "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_nothing_of_jax(rel):
    bad = [(line, root) for line, root in _imported_roots(REPO / rel)
           if root in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


def test_port_runs_with_jax_unimportable():
    """Import every module of the port in a fresh interpreter where JAX,
    flax and the JAX package cannot be imported at all."""
    modules = sorted(
        rel[:-3].replace(os.sep, ".").removesuffix(".__init__")
        for rel in PORT_FILES if rel.startswith("bert_pytorch_tpu_torch"))
    code = (
        "import sys\n"
        f"for name in {sorted(FORBIDDEN)!r}: sys.modules[name] = None\n"
        "import importlib\n"
        f"for name in {modules!r}: importlib.import_module(name)\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
