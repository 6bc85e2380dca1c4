"""Checkpoints in the JAX package's format, read and written by the port:
the counterpart of the JAX package's ``utils/checkpoint.py``.

A checkpoint is one flax msgpack file, ``ckpt_{step}.msgpack``, holding
``{model, optimizer, sampler, epoch[, preconditioner]}`` (a finetuning
runner's holds ``{model[, config]}``), beside its integrity manifest
(:mod:`.integrity`). Either package resumes from the other's file.

Reading. :func:`load_params_only` walks the top-level map with the port's
own codec (:mod:`.flax_msgpack`; no ``msgpack``, ``flax`` or
``ml_dtypes``), skips every other subtree by byte offset without decoding
it, and decodes ``model`` one leaf at a time. Each flax module converts to
the port's state-dict entries (``models/convert.py`` ``module_state``:
stacked encoder leaves split per layer) as soon as its leaves decode, is
checked against the target's shapes, and is cast or quantized (or moved
to the target's device) then, so the host never holds a second full fp32
tree. :func:`restore_training_state` does the same for ``model`` and the
optimizer's ``mu`` and ``nu`` of a training checkpoint, staging every
tensor on the target's device and committing only once the whole state
decoded and matched, so a failed restore leaves the model and optimizer
as they were; a K-FAC ``preconditioner`` restores into the caller's
``optim.kfac.KFACState`` (checked key by key against it), or is
byte-skipped when the caller has none; an fp16 ``LossScaleState``
restores into a ``DynamicLossScale`` (its scale and growth count, and the
wrapped state as any other). :func:`load_latest_checkpoint` walks
the retained checkpoints newest first, skipping (with a record naming
step, path and reason) every file whose manifest or msgpack structure
fails, and restores the first that passes; across ranks, ``agree``
(``utils/dist.py`` ``agree_on_resume_step``) picks the step every rank
can load. A sharded-layout index (``ckpt_{step}.shard{p}of{n}.msgpack``
beside it) reads its slices from the shard files. A model under FSDP
(parallel/sharding.py) takes its shard's rows of each decoded tensor; a
model split over ``pipe`` or ``model`` (parallel/mesh.py ``place_model``)
decodes the whole tensors and takes its stage's layers and its model
part of each, so a checkpoint of any layout resumes in any other.

Writing. :func:`save_checkpoint` streams the tree's bytes to a temporary
file while hashing them, renames it into place, writes the manifest, then
prunes all but the newest ``keep`` checkpoints. ``layout="sharded"`` (the
JAX ``_write_sharded``): every rank writes ``ckpt_{step}.shard{r}of{n}.
msgpack``, the slice records ``{start, limit, data}`` of the leaves it
holds, in the coordinates of the whole JAX leaf, with its own manifest;
then rank 0 waits until every shard's manifest carries this save's token
(``utils/dist.py`` ``shared_token``, so a shard that an earlier, torn
save of the step left behind is never taken for this one's) and writes
the index (the tree with a stub ``{__elastic_leaf__, shape, dtype}`` per
array and ``__sharded__`` naming the shard files and mesh spec) and its
manifest (``layout="sharded"``, the same token: a restore refuses an
index whose shards carry another). A leaf a rank holds a part of is a
:class:`ShardedLeaf`; a whole tensor is written by rank 0 alone.
:func:`sharded_training_state` builds the model and optimizer subtrees
from FSDP shards. With ``async_write=True`` it
snapshots the tensors on their device (one clone each, on the current
stream) and returns; a background thread copies the snapshot to the host
on a side stream, encodes and writes it. One write per directory is in
flight: the next save to it, and :func:`wait_for_pending_save`, join it
first, and raise if it failed.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import os
import re
import tempfile
import threading
import time
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from bert_pytorch_tpu_torch.models import convert as convert_lib
from bert_pytorch_tpu_torch.ops import quant as quant_ops
from bert_pytorch_tpu_torch.optim import transforms
from bert_pytorch_tpu_torch.parallel import sharding
from bert_pytorch_tpu_torch.parallel.mesh import AXIS_MODEL, AXIS_PIPE
from bert_pytorch_tpu_torch.parallel import state as state_lib
from bert_pytorch_tpu_torch.parallel import tensor_parallel as tp_lib
from bert_pytorch_tpu_torch.utils import dist as dist_utils
from bert_pytorch_tpu_torch.utils import flax_msgpack, integrity

CKPT_RE = re.compile(r"ckpt_(\d+)\.msgpack$")
# Sharded-layout shard files; they do not match CKPT_RE, so discovery,
# retention and the walk-back see only the index file.
SHARD_RE = re.compile(r"ckpt_(\d+)\.shard(\d+)of(\d+)\.msgpack$")
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


def find_resume_step(output_dir: str, verify: bool = False
                     ) -> Optional[int]:
    """Max step among ckpt_*.msgpack files (None for none). ``verify``
    walks newest first past files whose manifest fails: the newest step a
    resume could load (a file without a manifest passes, unverifiable is
    not corrupt)."""
    steps = _ckpt_steps(output_dir)
    if not verify:
        return steps[-1] if steps else None
    for step in reversed(steps):
        status, _ = integrity.verify_checkpoint(
            checkpoint_path(output_dir, step))
        if status != integrity.CORRUPT:
            return step
    return None


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
    offsets = _toplevel_offsets(path, blob)
    if key not in offsets:
        raise KeyError(f"checkpoint {path} has no top-level {key!r} subtree "
                       f"(keys: {sorted(k for k in offsets if k != SHARDED_KEY)})")
    return _decode_state(path, blob, offsets, (key,), target, quantize,
                         device, partial=True)


def _decode_state(path: str, blob, offsets: Dict[str, int], keys: tuple,
                  target: Dict[str, torch.Tensor], quantize: Optional[str],
                  device, partial: bool,
                  shards: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The subtree at ``keys`` (a top-level key, then map keys below it)
    as the port's state dict for ``target``, converted module by module
    as it decodes. ``partial`` (the params-only rule): every module of the
    target must arrive; otherwise every tensor of the target must."""
    where = "/".join(keys)
    convert = _make_module_converter(target, quantize, device)
    state: Dict[str, torch.Tensor] = {}
    if SHARDED_KEY in offsets:
        tree = _sharded_value(path, blob, offsets, keys, shards)
        for module_path, leaves in convert_lib.modules_of(tree):
            state.update(convert(module_path, leaves))
    else:
        pos = _subtree_offset(path, blob, offsets, keys)
        if not flax_msgpack.is_map(blob, pos):
            raise KeyError(f"checkpoint {path}: the {where!r} subtree is not "
                           "a map of modules")
        _walk(blob, pos, (), lambda p, leaves: state.update(
            convert(p, leaves)))
    if partial:
        missing = ({k.rpartition(".")[0] for k in target}
                   - {k.rpartition(".")[0] for k in state})
    else:
        missing = set(target) - set(state)
    if missing:
        raise CheckpointShapeError(
            f"checkpoint {path} lacks {len(missing)} "
            f"{'modules' if partial else 'tensors'} of the target under "
            f"{where!r}, e.g. {sorted(missing)[:4]}")
    return state


def _subtree_offset(path: str, blob, offsets: Dict[str, int],
                    keys: tuple) -> int:
    """Offset of the value at ``keys`` below the top-level map, found by
    skipping."""
    pos = offsets[keys[0]]
    for part in keys[1:]:
        items = _map_offsets(blob, pos)
        if part not in items:
            raise KeyError(f"checkpoint {path}: {'/'.join(keys)} not found "
                           f"(have {sorted(items)})")
        pos = items[part]
    return pos


def _map_offsets(blob, pos: int) -> Dict[str, int]:
    """Offset of each value of the map at ``pos``, by key (nothing decodes
    but the keys)."""
    n, pos = flax_msgpack.map_header(blob, pos)
    offsets = {}
    for _ in range(n):
        name, pos = flax_msgpack.decode(blob, pos)
        offsets[name] = pos
        pos = flax_msgpack.skip(blob, pos)
    return offsets


def _toplevel_offsets(path: str, blob) -> Dict[str, int]:
    """Offset of each value of the checkpoint's top-level map, found by
    skipping (nothing decodes but the keys)."""
    if not flax_msgpack.is_map(blob, 0):
        raise KeyError(f"checkpoint {path} is not a map of subtrees")
    return _map_offsets(blob, 0)


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
        if device is not None and quantize is None:
            # Transposes and layer splits then run on the device.
            leaves = {name: leaf.to(device) for name, leaf in leaves.items()}
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


def _read_shard(shard_path: str, shards: Optional[dict]) -> bytearray:
    """A shard file's bytes, verified against its own manifest; kept in
    ``shards`` (by path) when a caller passes one, so that one restore
    reads and hashes each file once for all of its subtrees."""
    if shards is not None and shard_path in shards:
        return shards[shard_path]
    blob = _read(shard_path)
    status, detail = integrity.verify_blob(shard_path, blob)
    if status == integrity.CORRUPT:
        raise CheckpointCorruptError(f"{shard_path}: {detail}")
    if shards is not None:
        shards[shard_path] = blob
    return blob


def _assemble_sharded(path: str, index: dict, meta: dict,
                      only_prefix: Optional[str],
                      shards: Optional[dict] = None) -> dict:
    """Full tensors of the stubs in ``index`` from the slice records of
    every shard file named in ``meta`` (each verified against its own
    manifest; see :func:`_read_shard` for ``shards``). Only records under
    ``only_prefix`` decode; the rest of each shard is skipped by offset. A
    stub whose elements are not all covered, or a shard whose manifest
    names another save than the index's, raises
    :class:`CheckpointCorruptError`."""
    directory = os.path.dirname(os.path.abspath(path))
    save_id = (integrity.read_manifest(path) or {}).get("save_id")
    records: Dict[str, list] = {}
    for name in meta.get("shard_files", ()):
        shard_path = os.path.join(directory, os.path.basename(str(name)))
        if save_id is not None and (integrity.read_manifest(shard_path)
                                    or {}).get("save_id") != save_id:
            raise CheckpointCorruptError(
                f"{shard_path}: written by another save than {path}")
        blob = _read_shard(shard_path, shards)
        offsets = _toplevel_offsets(shard_path, blob)
        if "leaves" not in offsets:
            continue
        n, pos = flax_msgpack.map_header(blob, offsets["leaves"])
        for _ in range(n):
            flat, pos = flax_msgpack.decode(blob, pos)
            if (only_prefix is None or flat == only_prefix
                    or flat.startswith(only_prefix + "/")):
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



# -- full reads and resume -------------------------------------------------

def _read_checked(path: str) -> bytearray:
    """The file's bytes once its manifest (and a sharded index's shard
    files) verify and the bytes hold exactly one msgpack value; else
    :class:`CheckpointCorruptError` (or ``MsgpackError`` for a file that
    has no manifest and is truncated)."""
    blob = _read(path)
    status, detail = integrity.verify_blob(path, blob)
    if status == integrity.CORRUPT:
        raise CheckpointCorruptError(f"{path}: {detail}")
    end = flax_msgpack.skip(blob, 0)
    if end != len(blob):
        raise CheckpointCorruptError(
            f"{path}: {len(blob) - end} bytes after the msgpack value")
    if SHARDED_KEY in _toplevel_offsets(path, blob):
        status, detail = integrity.verify_checkpoint(path)
        if status == integrity.CORRUPT:
            raise CheckpointCorruptError(f"{path}: {detail}")
    return blob


def _sharded_value(path: str, blob, offsets: Dict[str, int], keys: tuple,
                   shards: Optional[dict] = None):
    """The value at ``keys`` of a sharded index, its array stubs filled
    from the shard files (only their records under ``keys`` decode)."""
    meta, _ = flax_msgpack.decode(blob, offsets[SHARDED_KEY])
    value, _ = flax_msgpack.decode(
        blob, _subtree_offset(path, blob, offsets, keys))
    if not isinstance(value, dict):
        return value
    for part in reversed(keys):
        value = {part: value}
    value = _assemble_sharded(path, value, meta, "/".join(keys), shards)
    for part in keys:
        value = value[part]
    return value


def _decode_value(path: str, blob, offsets: Dict[str, int], keys: tuple,
                  shards: Optional[dict] = None):
    """The whole value at ``keys``, decoded."""
    if SHARDED_KEY in offsets:
        return _sharded_value(path, blob, offsets, keys, shards)
    return flax_msgpack.decode(
        blob, _subtree_offset(path, blob, offsets, keys))[0]


def load_checkpoint(path: str, verify: bool = True) -> dict:
    """The whole checkpoint decoded: nested dicts of CPU tensors and plain
    values (a sharded index assembled from its shard files). ``verify``
    checks the manifest first (:class:`CheckpointCorruptError`)."""
    blob = _read_checked(path) if verify else _read(path)
    offsets = _toplevel_offsets(path, blob)
    return {key: _decode_value(path, blob, offsets, (key,))
            for key in offsets if key != SHARDED_KEY}


def _decode_preconditioner(path: str, blob, offsets: Dict[str, int],
                           state) -> list:
    """The ``preconditioner`` subtree as (target tensor, decoded CPU
    tensor) pairs for every leaf of ``state`` (a ``KFACState``), each
    checked against its target's key and shape
    (:class:`CheckpointShapeError`) and cast to its dtype."""
    tree = _decode_value(path, blob, offsets, ("preconditioner",))
    where = f"checkpoint {path}: preconditioner"
    leaves = [("count", state.count, tree.get("count")
               if isinstance(tree, dict) else None)]
    for field, targets in state.state_dict().items():
        if field == "count":
            continue
        got = tree.get(field) if isinstance(tree, dict) else None
        if not isinstance(got, dict) or set(got) != set(targets):
            raise CheckpointShapeError(
                f"{where}/{field} does not hold the K-FAC state's keys "
                f"{sorted(targets)} (another model or --kfac_skip_layers?)")
        leaves += [(f"{field}/{key}", target, got[key])
                   for key, target in targets.items()]
    pairs = []
    for name, target, value in leaves:
        if isinstance(value, np.generic):
            value = torch.as_tensor(np.asarray(value))
        if (not isinstance(value, torch.Tensor)
                or tuple(value.shape) != tuple(target.shape)):
            raise CheckpointShapeError(
                f"{where}/{name}: {getattr(value, 'shape', value)!r} for "
                f"the K-FAC state's shape {tuple(target.shape)}")
        pairs.append((target, value.to(target.dtype)))
    return pairs


def restore_training_state(path: str, model: torch.nn.Module,
                           optimizer: Optional[torch.optim.Optimizer] = None,
                           blob=None, preconditioner=None) -> dict:
    """Load a training checkpoint (either package's) into ``model`` and,
    when given, the Adam-family ``optimizer`` and the K-FAC
    ``preconditioner`` (an ``optim.kfac.KFACState``), in place; returns
    ``{"sampler": dict or None, "epoch": int or None, "count": int or
    None}`` and, when ``preconditioner`` is given, ``"preconditioner"``:
    whether the checkpoint held one.

    ``model`` and ``mu``/``nu`` decode module by module onto the model's
    device (every tensor of the model's state dict, and of each parameter's
    moments, must arrive with its shape: :class:`CheckpointShapeError`),
    the preconditioner to the host, and all are committed only then, so a
    failed restore leaves ``model``, ``optimizer`` and ``preconditioner``
    untouched. A loss-scaled (fp16) optimizer state ``{scale,
    growth_count, inner}`` restores into a ``DynamicLossScale`` (the
    scale and growth count too; ``extras["loss_scale"]`` is the scale),
    and a tree of the other kind than the optimizer raises ``ValueError``
    (``models/convert.py`` ``check_optimizer_tree``). A
    ``preconditioner`` subtree is skipped undecoded, with a warning, when
    the caller passes no state (a run without ``--kfac``, as the JAX
    runner skips it); a checkpoint without one leaves the given state as
    it is. ``blob`` is the file's
    bytes when the caller has read and checked them
    (:func:`load_latest_checkpoint`)."""
    if blob is None:
        blob = _read_checked(path)
    offsets = _toplevel_offsets(path, blob)
    needed = ("model",) + (("optimizer",) if optimizer is not None else ())
    absent = [key for key in needed if key not in offsets]
    if absent:
        raise KeyError(f"checkpoint {path} has no {absent} subtree (keys: "
                       f"{sorted(k for k in offsets if k != SHARDED_KEY)})")
    kfac_pairs = None
    if "preconditioner" in offsets and preconditioner is None:
        warnings.warn(f"{path}: its K-FAC preconditioner state is skipped: "
                      "the run has no --kfac")
    elif "preconditioner" in offsets:
        kfac_pairs = _decode_preconditioner(path, blob, offsets,
                                            preconditioner)
    device = next(model.parameters()).device
    target = model.state_dict()
    # A model split over pipe/model decodes whole tensors, then keeps its
    # parts.
    layout = _split_layout(model)
    whole = target
    if layout is not None:
        whole = {k: torch.empty(shape, device="meta") for k, shape in
                 _whole_shapes(model, layout).items()}
    loss_scaled = isinstance(optimizer, transforms.DynamicLossScale)
    if optimizer is not None:
        if SHARDED_KEY in offsets:
            opt_index = flax_msgpack.decode(blob, offsets["optimizer"])[0]
            inner = opt_index.get("inner") if isinstance(
                opt_index, dict) else None
        else:
            opt_index = _map_offsets(blob, offsets["optimizer"])
            inner = (_map_offsets(blob, opt_index["inner"])
                     if "inner" in opt_index
                     and flax_msgpack.is_map(blob, opt_index["inner"])
                     else None)
        convert_lib.check_optimizer_tree(
            opt_index, f"checkpoint {path}", loss_scaled,
            inner if isinstance(inner, dict) else ())
    # The OptState's path: under "inner" of an fp16 LossScaleState.
    opt_keys = ("optimizer", "inner") if loss_scaled else ("optimizer",)
    # A sharded checkpoint's shard files, read and hashed once for every
    # subtree below.
    shards: dict = {}
    state = _decode_state(path, blob, offsets, ("model",), whole, None,
                          device, partial=False, shards=shards)
    if layout is not None:
        state = _local_parts(state, target, layout)
    extras = {"count": None}
    if preconditioner is not None:
        extras["preconditioner"] = kfac_pairs is not None
    if optimizer is not None:
        params = dict(model.named_parameters())
        # Whole moments of every parameter (of every stage) under a split.
        shapes = ({n: whole[n].shape for n in whole} if layout is not None
                  else {n: p.shape for n, p in params.items()})
        moment_target = {n: torch.empty(shape, dtype=torch.float32,
                                        device="meta")
                         for n, shape in shapes.items()}
        mu, nu = (_decode_state(path, blob, offsets, opt_keys + (part,),
                                moment_target, None, device, partial=False,
                                shards=shards)
                  for part in ("mu", "nu"))
        if layout is not None:
            mu, nu = (_local_parts(m, params, layout) for m in (mu, nu))
        count = _decode_value(path, blob, offsets, opt_keys + ("count",),
                              shards)
        extras["count"] = int(np.asarray(count))
        if loss_scaled:
            scale_state = [_decode_value(path, blob, offsets,
                                         ("optimizer", key), shards)
                           for key in ("scale", "growth_count")]
            extras["loss_scale"] = float(np.asarray(scale_state[0]))
    model.load_state_dict({k: sharding.as_like(v, target[k])
                           for k, v in state.items()})
    del state
    if optimizer is not None:
        transforms.load_moments(optimizer, params, extras["count"], mu, nu)
        if loss_scaled:
            optimizer.load_scale_state(extras["loss_scale"],
                                       int(np.asarray(scale_state[1])))
    for target, value in kfac_pairs or ():
        target.copy_(value)
    for key in ("sampler", "epoch"):
        extras[key] = (_decode_value(path, blob, offsets, (key,), shards)
                       if key in offsets else None)
    return extras


def _split_layout(model: torch.nn.Module):
    """The model's ``parallel.mesh.Layout`` when it splits parameters over
    ``pipe`` or ``model``, else None."""
    layout = getattr(model, "layout", None)
    return layout if layout is not None and layout.model_parallel else None


def _whole_shapes(model: torch.nn.Module, layout) -> Dict[str, tuple]:
    return state_lib.full_shapes(model, layout.axis(AXIS_MODEL),
                                 layout.axis(AXIS_PIPE),
                                 model.config.num_hidden_layers)


def _local_parts(whole: Dict[str, torch.Tensor], names, layout
                 ) -> Dict[str, torch.Tensor]:
    """This rank's parts (its layers, its model part) of whole tensors."""
    model_axis = layout.axis(AXIS_MODEL)
    return {name: tp_lib.local_part(name, whole[name], model_axis)
            .contiguous() for name in names}


def _newest_loadable(output_dir: str, on_skip, below: Optional[int] = None):
    """(step, bytes) of the newest checkpoint (at or below ``below``) that
    reads back whole, or (None, None); each skipped file warns and goes
    to ``on_skip``."""
    for step in reversed(_ckpt_steps(output_dir)):
        if below is not None and step > below:
            continue
        path = checkpoint_path(output_dir, step)
        try:
            return step, _read_checked(path)
        except CheckpointCorruptError as e:
            reason = f"integrity: {e}"
        except (flax_msgpack.MsgpackError, KeyError, OSError) as e:
            reason = f"{type(e).__name__}: {e}"
        warnings.warn(f"Skipping unreadable checkpoint {path} ({reason}); "
                      "falling back to the previous retained one")
        if on_skip is not None:
            on_skip({"step": step, "path": path, "reason": reason})
    return None, None


def load_latest_checkpoint(output_dir: str, model: torch.nn.Module,
                           optimizer: Optional[torch.optim.Optimizer] = None,
                           on_skip: Optional[Callable[[dict], None]] = None,
                           preconditioner=None,
                           agree: Optional[Callable] = None):
    """(step, :func:`restore_training_state`'s extras) of the newest
    checkpoint in ``output_dir`` that reads back whole, or None.

    Newest first across every retained checkpoint: a file whose manifest
    fails, or whose bytes are not one msgpack value (a truncated file
    without a manifest), is skipped with a warning and
    ``on_skip({"step", "path", "reason"})``, before anything of it is
    restored; the first that passes is restored, and an error there (a
    shape that does not fit the model) raises. ``agree`` (the ranks'
    ``agree_on_resume_step``) turns this rank's newest loadable step into
    the run's: the oldest of the ranks' proposals, restored on every rank
    (an agreed step this rank cannot load raises)."""
    step, blob = _newest_loadable(output_dir, on_skip)
    if agree is not None:
        agreed = agree(step)
        if agreed != step:
            step, blob = _newest_loadable(output_dir, on_skip, below=agreed)
            if step != agreed:
                raise CheckpointCorruptError(
                    f"{output_dir}: the ranks agreed on step {agreed}, which "
                    f"this rank cannot load (its newest below is {step})")
    if step is None:
        return None
    return step, restore_training_state(checkpoint_path(output_dir, step),
                                        model, optimizer, blob,
                                        preconditioner)


# -- writing ---------------------------------------------------------------

# One pending async write per output directory (its absolute path): a
# second save there joins the first, so its checkpoints land in order and
# at most one extra copy of its state is held.
_pending_saves: Dict[str, threading.Thread] = {}
_pending_errors: Dict[str, list] = {}
_pending_lock = threading.Lock()
# The newest writes, one record each: {"path", "step", "bytes", "start",
# "end" (perf_counter), "seconds", "async"}; a caller timing its saves
# reads them here.
write_records: collections.deque = collections.deque(maxlen=64)


def _pending_key(output_dir: str) -> str:
    return os.path.abspath(output_dir)


def _join_pending_save(key: Optional[str] = None
                       ) -> Optional[BaseException]:
    """Join the pending writes (all, or one directory's) and return the
    first recorded error instead of raising it."""
    with _pending_lock:
        if key is None:
            threads = list(_pending_saves.values())
            _pending_saves.clear()
        else:
            thread = _pending_saves.pop(key, None)
            threads = [thread] if thread is not None else []
    for thread in threads:
        thread.join()
    with _pending_lock:
        if key is None:
            errors = [(k, e) for k in list(_pending_errors)
                      for e in _pending_errors.pop(k)]
        else:
            errors = [(key, e) for e in _pending_errors.pop(key, [])]
    for where, extra in errors[1:]:
        warnings.warn(f"additional async checkpoint write failure for "
                      f"{where}: {type(extra).__name__}: {extra}")
    return errors[0][1] if errors else None


def _start_pending_save(key: str, step: int, work: Callable[[], None]
                        ) -> None:
    def run():
        try:
            work()
        except BaseException as e:  # raised by the next join
            with _pending_lock:
                _pending_errors.setdefault(key, []).append(e)

    thread = threading.Thread(target=run, name=f"ckpt-write-{step}",
                              daemon=False)
    with _pending_lock:
        _pending_saves[key] = thread
    thread.start()


def wait_for_pending_save(output_dir: Optional[str] = None) -> None:
    """Block until the pending async writes (all, or ``output_dir``'s)
    have finished; raise if one failed. Call before reading checkpoints
    back and before the process exits."""
    key = None if output_dir is None else _pending_key(output_dir)
    error = _join_pending_save(key)
    if error is not None:
        raise RuntimeError("async checkpoint write failed") from error


def _prune_old(output_dir: str, keep: int) -> None:
    """Delete all but the newest ``keep`` checkpoints (with their
    manifests and any shard files)."""
    steps = _ckpt_steps(output_dir)
    for old in steps[:-keep] if keep > 0 else []:
        old_path = checkpoint_path(output_dir, old)
        stale = [old_path, integrity.manifest_path(old_path)]
        for name in os.listdir(output_dir):
            m = SHARD_RE.search(name)
            if m and int(m.group(1)) == old:
                shard = os.path.join(output_dir, name)
                stale += [shard, integrity.manifest_path(shard)]
        for name in stale:
            try:
                os.unlink(name)
            except OSError:
                pass


def _write_and_prune(contents: dict, output_dir: str, step: int, keep: int,
                     is_async: bool, mesh_spec: Optional[dict] = None
                     ) -> None:
    """Stream ``contents``' bytes to a temporary file, hashing them on the
    way, rename it into place, write the manifest (blob first, manifest
    second: a crash between leaves a file without a manifest, which reads
    as unverifiable, never as corrupt), then prune."""
    start = time.perf_counter()
    path = checkpoint_path(output_dir, step)
    digest, size = _stream_write(path, contents)
    integrity.write_manifest(path, integrity.build_manifest(
        step, None, keys=contents.keys(), layout="gathered",
        mesh_spec=mesh_spec, sha256=digest, size_bytes=size))
    _prune_old(output_dir, keep)
    end = time.perf_counter()
    write_records.append({"path": path, "step": int(step), "bytes": size,
                          "start": start, "end": end,
                          "seconds": end - start, "async": is_async})


def _snapshot(tree):
    """A copy the caller's later updates cannot reach: tensors cloned on
    their own devices (enqueued on the current stream), numpy arrays
    copied, dicts and lists rebuilt, other values kept."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_snapshot(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


def _cuda_device(tree) -> Optional[torch.device]:
    """The CUDA device of the first CUDA tensor leaf, or None."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for value in tree:
            found = _cuda_device(value)
            if found is not None:
                return found
        return None
    if isinstance(tree, torch.Tensor) and tree.is_cuda:
        return tree.device
    return None


@dataclasses.dataclass
class ShardedLeaf:
    """An array leaf of which this rank holds some windows: the whole
    leaf's ``shape`` and ``dtype`` (a numpy name) and this rank's
    ``records``, ``(start, limit, data)`` windows of it."""

    shape: tuple
    dtype: str
    records: list


def shard_name(step: int, proc: int, n_procs: int) -> str:
    return f"ckpt_{step}.shard{proc}of{n_procs}.msgpack"


def _build_sharded(tree, records: dict, rank: int, path=()):
    """The index of ``tree`` (array leaves replaced by stubs) and, in
    ``records`` (flat-path keyed), the slice records this rank writes: a
    :class:`ShardedLeaf`'s own, and a whole tensor's from rank 0 only.
    Other values (sampler state, epoch, counts) stay inline."""
    if isinstance(tree, dict):
        return {k: _build_sharded(v, records, rank, path + (str(k),))
                for k, v in tree.items()}
    key = "/".join(path)
    if isinstance(tree, ShardedLeaf):
        records[key] = [{"start": [int(x) for x in start],
                         "limit": [int(x) for x in limit], "data": data}
                        for start, limit, data in tree.records]
        return {_LEAF_KEY: 1, "shape": [int(d) for d in tree.shape],
                "dtype": tree.dtype}
    if isinstance(tree, torch.Tensor) or (isinstance(tree, np.ndarray)
                                          and tree.ndim > 0):
        array = tree if isinstance(tree, np.ndarray) else tree.detach()
        if rank == 0:
            records[key] = [{"start": [0] * array.ndim,
                             "limit": [int(d) for d in array.shape],
                             "data": array}]
        dtype = (str(array.dtype) if isinstance(array, np.ndarray)
                 else flax_msgpack.DTYPE_NAMES[array.dtype])
        return {_LEAF_KEY: 1, "shape": [int(d) for d in array.shape],
                "dtype": dtype}
    return tree


def _stream_write(path: str, tree) -> tuple:
    """Encode ``tree`` into a temporary file beside ``path``, hashing on
    the way, and rename it into place: (sha256, size)."""
    digest, size = hashlib.sha256(), 0
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            def write(data) -> None:
                nonlocal size
                f.write(data)
                digest.update(data)
                size += len(data)

            flax_msgpack.encode_to(tree, write)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return digest.hexdigest(), size


# How long rank 0 waits for the other ranks' shard files before the index.
SHARD_WAIT_S = 600.0


def _write_sharded(index: dict, records: dict, output_dir: str, step: int,
                   keep: int, mesh_spec: Optional[dict], rank: int,
                   world: int, is_async: bool, save_id: str) -> None:
    """This rank's shard file and manifest; on rank 0, once every shard's
    manifest carries ``save_id``, the index and its manifest, then the
    pruning. Shards first, index last: a torn write leaves orphan shard
    files but no visible step. No collective, so an async write may run
    it."""
    start = time.perf_counter()
    shard_files = [shard_name(step, r, world) for r in range(world)]
    shard_path = os.path.join(output_dir, shard_files[rank])
    digest, size = _stream_write(shard_path, {"leaves": records})
    integrity.write_manifest(shard_path, integrity.build_manifest(
        step, None, mesh_spec=mesh_spec, sha256=digest, size_bytes=size,
        save_id=save_id))
    if rank == 0:
        deadline = time.monotonic() + SHARD_WAIT_S
        for name in shard_files:
            shard = os.path.join(output_dir, name)
            while (integrity.read_manifest(shard) or {}).get(
                    "save_id") != save_id:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{shard}: this save's shard did not land within "
                        f"{SHARD_WAIT_S:.0f} s; the index of step {step} is "
                        "not written")
                time.sleep(0.05)
        index = dict(index)
        index[SHARDED_KEY] = {"version": 1, "n_shards": world,
                              "shard_files": shard_files,
                              "mesh_spec": dict(mesh_spec or {})}
        path = checkpoint_path(output_dir, step)
        digest, size = _stream_write(path, index)
        integrity.write_manifest(path, integrity.build_manifest(
            step, None, keys=[k for k in index if k != SHARDED_KEY],
            mesh_spec=mesh_spec, layout="sharded", shard_files=shard_files,
            sha256=digest, size_bytes=size, save_id=save_id))
        _prune_old(output_dir, keep)
    end = time.perf_counter()
    write_records.append({"path": shard_path, "step": int(step),
                          "bytes": size, "start": start, "end": end,
                          "seconds": end - start, "async": is_async})


def sharded_training_state(model: torch.nn.Module,
                           optimizer: Optional[torch.optim.Optimizer],
                           config) -> dict:
    """``{"model"[, "optimizer"]}`` in the JAX layout with a
    :class:`ShardedLeaf` per array: this rank's FSDP shard of every
    parameter (and of its moments) as windows of the JAX leaves
    (``models/convert.py`` ``jax_slices``). A replicated copy is written
    by one rank only: under HSDP the ranks of ``data`` coordinate 0, for
    an unsharded tensor rank 0."""
    state = model.state_dict()
    layout = _split_layout(model)
    shapes_by_name = (_whole_shapes(model, layout) if layout is not None
                      else {k: tuple(v.shape) for k, v in state.items()})
    meta = {k: torch.empty(shape, device="meta")
            for k, shape in shapes_by_name.items()}
    shapes = convert_lib.to_jax_params(meta, config, "pretraining",
                                       keep_device=True)
    rank = dist_utils.get_rank()
    model_axis = layout.axis(AXIS_MODEL) if layout is not None else None

    def writes(name, like) -> bool:
        if layout is not None:
            c = layout.coords
            if c["data"] or c["seq"] or (c["fsdp"]
                                         and not sharding.is_sharded(like)):
                return False
            if c["model"] and tp_lib.split_of(name) is None:
                return False
            if c["pipe"] and ".encoder.layers." not in name:
                return False
            return True
        if not sharding.is_sharded(like):
            return rank == 0
        mesh = like.device_mesh
        return all(mesh.get_local_rank(d) == 0
                   for d, p in enumerate(like.placements)
                   if not p.is_shard())

    def windows_of(name, part, like):
        row0 = sharding.row_range(like)[0]
        window = (tp_lib.shard_window(name, shapes_by_name[name],
                                      model_axis)
                  if model_axis is not None else None)
        if window is None:
            return convert_lib.jax_slices(name, part, row0, config)
        dim, lo, _ = window
        if dim == 0:
            return convert_lib.jax_slices(name, part, lo + row0, config)
        return convert_lib.jax_column_slices(name, part, row0, lo, config)

    def tree_of(tensors: Dict[str, torch.Tensor]) -> dict:
        records: Dict[tuple, list] = {}
        for name, t in tensors.items():
            like = state[name]
            if not writes(name, like):
                continue
            path, windows = windows_of(name, sharding.local(t).detach(),
                                       like)
            records.setdefault(path, []).extend(windows)

        def leaf(node, path):
            if isinstance(node, dict):
                return {k: leaf(v, path + (k,)) for k, v in node.items()}
            return ShardedLeaf(tuple(node.shape), "float32",
                               records.get(path, []))

        return leaf(shapes, ())

    out = {"model": tree_of(state)}
    if optimizer is not None:
        mu, nu = transforms.moments(optimizer, dict(model.named_parameters()))
        tree = {"count": np.asarray(transforms.opt_step_count(optimizer),
                                    np.int32),
                "mu": tree_of(mu), "nu": tree_of(nu)}
        if isinstance(optimizer, transforms.DynamicLossScale):
            tree = {"scale": np.asarray(optimizer.scale, np.float32),
                    "growth_count": np.asarray(optimizer.growth_count,
                                               np.int32),
                    "inner": tree}
        out["optimizer"] = tree
    return out


def save_checkpoint(output_dir: str, step: int, contents: dict,
                    keep: int = 3, async_write: bool = False,
                    layout: str = "gathered",
                    mesh_spec: Optional[dict] = None) -> Optional[str]:
    """Write ``contents`` (a dict of subtrees: nested dicts of tensors on
    any device, numpy values and plain values, e.g. ``{"model":
    to_jax_params(...), "epoch": 0}``) as ``ckpt_{step}.msgpack`` in
    flax's bytes, then its manifest, and keep the newest ``keep``
    checkpoints of ``output_dir``. Returns the path. The JAX package's
    ``load_checkpoint`` and ``integrity.verify_checkpoint`` read it.

    A pending async write to ``output_dir`` is joined first (and its
    error raised once this save's own work is done). ``async_write``:
    every tensor is cloned on its device now, and a background thread
    copies the clones to the host on a side stream (after an event that
    follows the clones), encodes and writes them; the caller may update
    its tensors at once.

    ``layout="sharded"`` writes this rank's shard and, on rank 0, the
    index (see the module docstring; every rank calls it, and the async
    write covers it too); ``mesh_spec`` (``MeshSpec.as_dict()``) is
    recorded in the manifests. The gathered layout is rank 0's alone
    (other ranks return None). Returns the index's path."""
    if layout not in ("gathered", "sharded"):
        raise ValueError(f"unknown checkpoint layout {layout!r}; options: "
                         "gathered, sharded")
    rank, world = dist_utils.get_rank(), dist_utils.get_world_size()
    if layout == "gathered" and rank != 0:
        return None
    key = _pending_key(output_dir)
    pending_error = _join_pending_save(key)
    os.makedirs(output_dir, exist_ok=True)
    path = checkpoint_path(output_dir, step)
    if layout == "sharded":
        records: dict = {}
        index = _build_sharded(contents, records, rank)
        save_id = dist_utils.shared_token()

        def write(recs, is_async):
            _write_sharded(index, recs, output_dir, step, keep, mesh_spec,
                           rank, world, is_async, save_id)

        contents = records
    else:
        def write(tree, is_async):
            _write_and_prune(tree, output_dir, step, keep, is_async,
                             mesh_spec)
    if async_write:
        box = [_snapshot(contents)]
        device = _cuda_device(box[0])
        ready = None
        if device is not None:
            ready = torch.cuda.Event()
            ready.record()

        def write_snapshot():
            snapshot = box.pop()
            if ready is None:
                write(snapshot, True)
                return
            with torch.cuda.device(device):
                side = torch.cuda.Stream()
                with torch.cuda.stream(side):
                    side.wait_event(ready)
                    write(snapshot, True)

        _start_pending_save(key, step, write_snapshot)
    else:
        write(contents, False)
    if pending_error is not None:
        raise RuntimeError("async checkpoint write failed") from pending_error
    return path
