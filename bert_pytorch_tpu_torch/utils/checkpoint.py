"""Checkpoints of the JAX package, read (and written) by the port: the read
side of the JAX package's ``utils/checkpoint.py`` plus the one write the
server needs.

A JAX checkpoint is one flax msgpack file, ``ckpt_{step}.msgpack``,
holding ``{model, optimizer, sampler, epoch[, preconditioner]}``, beside
its integrity manifest (:mod:`.integrity`). A server needs only ``model``:
:func:`load_params_only` walks the top-level map with the port's own codec
(:mod:`.flax_msgpack`; no ``msgpack``, ``flax`` or ``ml_dtypes``), skips
every other subtree by byte offset without decoding it, and decodes
``model`` one leaf at a time. Each flax module converts to the port's
state-dict entries (``models/convert.py`` ``module_state``: stacked
encoder leaves split per layer) as soon as its leaves decode, is checked
against the target's shapes, and is cast or quantized then, so the host
never holds a second full fp32 tree. A sharded-layout index
(``ckpt_{step}.shard{p}of{n}.msgpack`` beside it) reads only the slices
of ``model`` from its shard files.

:func:`save_checkpoint` is synchronous and writes one file, tmp + rename,
then its manifest: what ``run_server --save_init_checkpoint`` needs.
Retention, async writes and resume belong to the pretraining runner.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Callable, Dict, Optional

import torch

from bert_pytorch_tpu_torch.models import convert as convert_lib
from bert_pytorch_tpu_torch.ops import quant as quant_ops
from bert_pytorch_tpu_torch.utils import flax_msgpack, integrity

CKPT_RE = re.compile(r"ckpt_(\d+)\.msgpack$")
# The sharded layout's index carries this top-level key ({version,
# n_shards, shard_files, mesh_spec}); its array leaves are stubs
# {_LEAF_KEY: 1, shape, dtype} whose bytes live in the shard files as
# slice records {start, limit, data} under "leaves/<flat path>".
SHARDED_KEY = "__sharded__"
_LEAF_KEY = "__elastic_leaf__"


class CheckpointCorruptError(RuntimeError):
    """The checkpoint's integrity manifest exists and the bytes fail it
    (size or sha256), or a sharded leaf misses slices."""


class CheckpointShapeError(ValueError):
    """A checkpoint leaf's shape does not match the target's, or the
    checkpoint lacks modules the target has."""


def checkpoint_path(output_dir: str, step: int) -> str:
    return os.path.join(output_dir, f"ckpt_{step}.msgpack")


def _ckpt_steps(output_dir: str) -> list:
    """Ascending steps of the ckpt_*.msgpack files in ``output_dir``."""
    if not os.path.isdir(output_dir):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(output_dir)
                  if (m := CKPT_RE.search(name)))


def find_resume_step(output_dir: str) -> Optional[int]:
    """Max step among ckpt_*.msgpack files (None for none)."""
    steps = _ckpt_steps(output_dir)
    return steps[-1] if steps else None


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """Path of the newest ``ckpt_*.msgpack`` in ``output_dir``, or None
    (also for a directory that does not exist yet)."""
    step = find_resume_step(output_dir)
    return None if step is None else checkpoint_path(output_dir, step)


def _read(path: str) -> bytearray:
    """The file's bytes in a writable buffer (tensors decode straight from
    it, ``torch.frombuffer``)."""
    with open(path, "rb") as f:
        blob = bytearray(os.fstat(f.fileno()).st_size)
        f.readinto(blob)
    return blob


def load_params_only(path: str, target: Dict[str, torch.Tensor],
                     key: str = "model", quantize: Optional[str] = None,
                     device=None) -> Dict[str, torch.Tensor]:
    """The ``key`` subtree of a JAX checkpoint as the port's state dict,
    decoding no other subtree.

    ``target`` is the fp32 state dict of the model to load (its tensors
    only give shapes and dtypes; a model built on the ``meta`` device
    does). Every module converts as its leaves decode: shapes are checked
    (:class:`CheckpointShapeError`); with ``quantize=None`` each leaf casts
    to the target's dtype, with ``"bf16"``/``"int8"`` each module takes
    ``models/convert.py`` ``quantize_module``'s rule, giving the state
    dict of the model built with ``quant=quantize``. Modules the target
    lacks are dropped, as flax's restore ignores them; a target module the
    checkpoint lacks raises :class:`CheckpointShapeError`. ``device`` moves
    each converted tensor there at once.

    The integrity manifest, when present, is checked on the bytes just
    read (:class:`CheckpointCorruptError`); a file without the subtree
    raises ``KeyError``."""
    if quantize is not None:
        quant_ops.check_mode(quantize)
    blob = _read(path)
    status, detail = integrity.verify_blob(path, blob)
    if status == integrity.CORRUPT:
        raise CheckpointCorruptError(f"{path}: {detail}")
    convert = _make_module_converter(target, quantize, device)
    offsets = _toplevel_offsets(path, blob)
    if key not in offsets:
        raise KeyError(f"checkpoint {path} has no top-level {key!r} subtree "
                       f"(keys: {sorted(k for k in offsets if k != SHARDED_KEY)})")
    if SHARDED_KEY in offsets:
        meta, _ = flax_msgpack.decode(blob, offsets[SHARDED_KEY])
        stubs, _ = flax_msgpack.decode(blob, offsets[key])
        tree = _assemble_sharded(path, {key: stubs}, meta, only_prefix=key)
        state: Dict[str, torch.Tensor] = {}
        for module_path, leaves in convert_lib.modules_of(tree[key]):
            state.update(convert(module_path, leaves))
    else:
        if not flax_msgpack.is_map(blob, offsets[key]):
            raise KeyError(f"checkpoint {path}: the {key!r} subtree is not "
                           "a map of modules")
        state = {}
        _walk(blob, offsets[key], (), lambda p, leaves: state.update(
            convert(p, leaves)))
    missing = ({k.rpartition(".")[0] for k in target}
               - {k.rpartition(".")[0] for k in state})
    if missing:
        raise CheckpointShapeError(
            f"checkpoint {path} lacks {len(missing)} modules of the target "
            f"under {key!r}, e.g. {sorted(missing)[:4]}")
    return state


def _toplevel_offsets(path: str, blob) -> Dict[str, int]:
    """Offset of each value of the checkpoint's top-level map, found by
    skipping (nothing decodes but the keys)."""
    if not flax_msgpack.is_map(blob, 0):
        raise KeyError(f"checkpoint {path} is not a map of subtrees")
    n, pos = flax_msgpack.map_header(blob, 0)
    offsets = {}
    for _ in range(n):
        name, pos = flax_msgpack.decode(blob, pos)
        offsets[name] = pos
        pos = flax_msgpack.skip(blob, pos)
    return offsets


def _walk(blob, pos: int, path: tuple,
          on_module: Callable[[tuple, dict], None]) -> int:
    """Decode the map at ``pos`` leaf by leaf, handing each module's
    leaves (a map's non-map values; a chunked leaf counts as one) to
    ``on_module`` as soon as the map ends; returns the end offset."""
    n, pos = flax_msgpack.map_header(blob, pos)
    leaves = {}
    for _ in range(n):
        name, pos = flax_msgpack.decode(blob, pos)
        if (flax_msgpack.is_map(blob, pos)
                and not flax_msgpack.is_chunked_leaf(blob, pos)):
            pos = _walk(blob, pos, path + (str(name),), on_module)
        else:
            leaves[name], pos = flax_msgpack.decode(blob, pos)
    if leaves:
        on_module(path, leaves)
    return pos


def _make_module_converter(target: Dict[str, torch.Tensor],
                           quantize: Optional[str], device):
    """The per-module hook of the streaming decode: one flax module (path,
    leaves) in, the port's converted state-dict entries out."""
    layers = {key.split(".")[3] for key in target
              if key.startswith("bert.encoder.layers.")}
    modules = {key.rpartition(".")[0] for key in target}

    def convert(path: tuple, leaves: dict) -> Dict[str, torch.Tensor]:
        where = "/".join(path)
        for name, leaf in leaves.items():
            if not isinstance(leaf, torch.Tensor):
                raise CheckpointShapeError(
                    f"checkpoint leaf {where}/{name} is a "
                    f"{type(leaf).__name__}, not an array")
            if tuple(path[:3]) == convert_lib.STACKED_PATH and (
                    leaf.dim() == 0 or leaf.shape[0] != len(layers)):
                raise CheckpointShapeError(
                    f"checkpoint leaf {where}/{name} has shape "
                    f"{tuple(leaf.shape)}: {len(layers)} stacked layers "
                    "expected")
        by_module: Dict[str, Dict[str, torch.Tensor]] = {}
        for key, value in convert_lib.module_state(path, leaves).items():
            module, _, name = key.rpartition(".")
            if module not in modules:
                continue
            want = target.get(key)
            if want is not None:
                if tuple(want.shape) != tuple(value.shape):
                    raise CheckpointShapeError(
                        f"checkpoint leaf {where}/{name} gives {key} the "
                        f"shape {tuple(value.shape)}, target expects "
                        f"{tuple(want.shape)}")
                if quantize is None and value.dtype != want.dtype:
                    value = value.to(want.dtype)
            by_module.setdefault(module, {})[name] = value
        out: Dict[str, torch.Tensor] = {}
        for module, entries in by_module.items():
            if quantize is not None:
                entries = convert_lib.quantize_module(module, entries,
                                                      quantize)
            for name, value in entries.items():
                out[f"{module}.{name}"] = (value if device is None
                                           else value.to(device))
        return out

    return convert


def _assemble_sharded(path: str, index: dict, meta: dict,
                      only_prefix: str) -> dict:
    """Full tensors of the stubs in ``index`` from the slice records of
    every shard file named in ``meta`` (each verified against its own
    manifest). Only records under ``only_prefix`` decode; the rest of each
    shard is skipped by offset. A stub whose elements are not all covered
    raises :class:`CheckpointCorruptError`."""
    directory = os.path.dirname(os.path.abspath(path))
    records: Dict[str, list] = {}
    for name in meta.get("shard_files", ()):
        shard_path = os.path.join(directory, os.path.basename(str(name)))
        blob = _read(shard_path)
        status, detail = integrity.verify_blob(shard_path, blob)
        if status == integrity.CORRUPT:
            raise CheckpointCorruptError(f"{shard_path}: {detail}")
        offsets = _toplevel_offsets(shard_path, blob)
        if "leaves" not in offsets:
            continue
        n, pos = flax_msgpack.map_header(blob, offsets["leaves"])
        for _ in range(n):
            flat, pos = flax_msgpack.decode(blob, pos)
            if flat == only_prefix or flat.startswith(only_prefix + "/"):
                recs, pos = flax_msgpack.decode(blob, pos)
                records.setdefault(flat, []).extend(recs)
            else:
                pos = flax_msgpack.skip(blob, pos)

    def fill(node, parts):
        if not isinstance(node, dict):
            return node
        if not node.get(_LEAF_KEY):
            return {k: fill(v, parts + (str(k),)) for k, v in node.items()}
        flat = "/".join(parts)
        dtype = flax_msgpack.TORCH_DTYPES[node["dtype"]]
        shape = [int(d) for d in node["shape"]]
        full = torch.zeros(shape, dtype=dtype)
        covered = torch.zeros(shape, dtype=torch.bool)
        for rec in records.get(flat, ()):
            window = tuple(slice(int(s), int(e))
                           for s, e in zip(rec["start"], rec["limit"]))
            full[window] = rec["data"]
            covered[window] = True
        if not bool(covered.all()):
            raise CheckpointCorruptError(
                f"{path}: sharded leaf {flat} has uncovered elements "
                "(missing shard slices)")
        return full

    return fill(index, ())


def _atomic_write(path: str, blob: bytes) -> None:
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(output_dir: str, step: int, contents: dict) -> str:
    """Write ``contents`` (a dict of subtrees: nested dicts of tensors,
    numpy values and plain values, e.g. ``{"model": to_jax_params(...),
    "epoch": 0}``) as ``ckpt_{step}.msgpack`` in flax's bytes, tmp +
    rename, then its integrity manifest (the gathered layout). Returns the
    path. The JAX package's ``load_params_only`` and
    ``integrity.verify_checkpoint`` read it."""
    os.makedirs(output_dir, exist_ok=True)
    blob = flax_msgpack.encode(contents)
    path = checkpoint_path(output_dir, step)
    _atomic_write(path, blob)
    integrity.write_manifest(path, integrity.build_manifest(
        step, blob, keys=contents.keys(), layout="gathered"))
    return path
