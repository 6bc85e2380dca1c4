"""The PyTorch port stands alone: no file of ``bert_pytorch_tpu_torch``,
nor ``chip_smoke.py``, imports JAX, flax or anything of the JAX package
``bert_pytorch_tpu`` (it keeps its own copies of what it needs), nor
``msgpack`` or ``ml_dtypes``, which a CUDA serving host need not have: its
checkpoint code reads and writes flax msgpack with its own codec. Nor does
any of them load a file of the JAX package by path (``load_by_path``,
``spec_from_file_location`` and their kin), which an import check alone
would not see."""

import ast
import collections
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "bert_pytorch_tpu",
             "msgpack", "ml_dtypes"}
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


# Calls that load a module or run a file by its path.
PATH_LOADERS = {"load_by_path", "spec_from_file_location",
                "SourceFileLoader", "run_path", "load_source"}
# A path (or path part) naming the JAX package's directory.
JAX_PACKAGE_PATH = re.compile(r"(?:^|[/\\])bert_pytorch_tpu(?:$|[/\\])")


def _call_name(func) -> str:
    return getattr(func, "attr", getattr(func, "id", ""))


def _by_path_loads(source: str):
    """(line, text) of every path-loading call whose arguments name the
    JAX package's directory: in a string of the call itself, or in a
    name the call passes that the file assigns from such a string."""
    tree = ast.parse(source)
    assigned = collections.defaultdict(list)
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    assigned[target.id].append(node.value)

    def names_jax(expr, depth=0):
        for sub in ast.walk(expr):
            if (isinstance(sub, ast.Constant) and isinstance(sub.value, str)
                    and JAX_PACKAGE_PATH.search(sub.value)):
                return sub.value
            if isinstance(sub, ast.Name) and depth < 4:
                for value in assigned.get(sub.id, ()):
                    found = names_jax(value, depth + 1)
                    if found:
                        return found
        return None

    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _call_name(node.func) in \
                PATH_LOADERS:
            for arg in [*node.args, *(k.value for k in node.keywords)]:
                found = names_jax(arg)
                if found:
                    yield node.lineno, found


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_loads_nothing_of_jax_by_path(rel):
    loads = list(_by_path_loads((REPO / rel).read_text(encoding="utf-8")))
    assert not loads, f"{rel} loads the JAX package by path: {loads}"


@pytest.mark.parametrize("source, caught", [
    ('load_by_path("_x", "bert_pytorch_tpu", "serve", "router.py")', True),
    ('import importlib.util, os\n'
     'importlib.util.spec_from_file_location("x", os.path.join(\n'
     '    ROOT, "bert_pytorch_tpu", "serve", "router.py"))', True),
    ('p = ROOT / "bert_pytorch_tpu/serve/router.py"\n'
     'q = p\n'
     'spec = importlib.util.spec_from_file_location("x", q)', True),
    ('runpy.run_path("tools/../bert_pytorch_tpu/tools/x.py")', True),
    ('load_by_path("_x", "telemetry", "schema.py")', False),
    ('load_by_path("_x", "bert_pytorch_tpu_torch", "serve", "r.py")',
     False),
    ('REPLACES = "bert_pytorch_tpu/ops/pallas/attention.py:512"', False),
])
def test_by_path_rule_catches_jax_loads(source, caught):
    assert bool(list(_by_path_loads(source))) is caught


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


def test_checkpoints_round_trip_without_msgpack_or_ml_dtypes(tmp_path):
    """In a fresh interpreter where msgpack, ml_dtypes and JAX cannot be
    imported: import the port's checkpoint modules and serving engine,
    write a small checkpoint of a BERT head (fp32 and bf16 leaves) with
    the port, and read it back params-only, equal."""
    code = (
        "import sys\n"
        f"for name in {sorted(FORBIDDEN)!r}: sys.modules[name] = None\n"
        "import torch\n"
        "import bert_pytorch_tpu_torch.serve.engine\n"
        "from bert_pytorch_tpu_torch.config import BertConfig\n"
        "from bert_pytorch_tpu_torch.models import bert\n"
        "from bert_pytorch_tpu_torch.models.convert import to_jax_params\n"
        "from bert_pytorch_tpu_torch.utils import (checkpoint, "
        "flax_msgpack, integrity)\n"
        "cfg = BertConfig(vocab_size=32, hidden_size=16, "
        "num_hidden_layers=2, num_attention_heads=2, intermediate_size=32,"
        " max_position_embeddings=16, next_sentence=True)\n"
        "model = bert.init_weights(bert.BertForTokenClassification(cfg, 3),"
        " 0.02, torch.Generator().manual_seed(0))\n"
        "state = model.state_dict()\n"
        "params = to_jax_params(state, cfg, 'ner')\n"
        "params['bert']['pooler']['dense_act']['dense']['kernel'] = "
        "params['bert']['pooler']['dense_act']['dense']['kernel'].to("
        "torch.bfloat16)\n"
        f"path = checkpoint.save_checkpoint({str(tmp_path)!r}, 7, "
        "{'model': params, 'epoch': 7})\n"
        "assert integrity.verify_checkpoint(path)[0] == 'verified'\n"
        "target = bert.BertForTokenClassification(cfg, 3, device='meta')"
        ".state_dict()\n"
        "back = checkpoint.load_params_only(path, target)\n"
        "key = 'bert.pooler.dense_act.dense.weight'\n"
        "for k, v in state.items():\n"
        "    want = v.to(torch.bfloat16).float() if k == key else v\n"
        "    assert torch.equal(back[k], want), k\n"
        "print('ok', len(back))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_text_path_runs_without_h5py_tensorflow_or_hf_tokenizers(tmp_path):
    """The text path needs none of h5py, tensorflow or HF ``tokenizers``
    (the H100 machine has none of them): in a fresh interpreter where they
    cannot be imported, the tokenizer core trains and encodes, the text
    tools and the TF reader import, and ``encode_data`` fails only when it
    writes HDF5."""
    code = (
        "import sys\n"
        "for name in ('h5py', 'tensorflow', 'tokenizers', 'jax'):\n"
        "    sys.modules[name] = None\n"
        "from bert_pytorch_tpu_torch.data.tokenization import get_tokenizer\n"
        "from bert_pytorch_tpu_torch.models import convert, tf_bundle\n"
        "from bert_pytorch_tpu_torch.tools import (batch_infer, "
        "build_vocab, encode_data, make_synthetic_text, shard)\n"
        f"root = {str(tmp_path)!r}\n"
        "files = make_synthetic_text.write_corpus(root + '/text', 1, 20, 0)\n"
        "vocab = build_vocab.main(['--input_glob', root + '/text/*.txt', "
        "'--tokenizer', 'bpe', '--output', root + '/bpe', '--vocab_size', "
        "'300'])\n"
        "tok = get_tokenizer('bpe', vocab)\n"
        "assert tok.encode('the old roads').ids\n"
        "try:\n"
        "    encode_data.main(['--input_dir', root + '/text', '--output_dir',"
        " root + '/h5', '--vocab_file', vocab, '--tokenizer', 'bpe', "
        "'--processes', '1'])\n"
        "except ImportError as exc:\n"
        "    print('ok', exc)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].startswith("ok")
