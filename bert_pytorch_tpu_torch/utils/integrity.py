"""Checkpoint integrity manifests: the port's copy of the JAX package's
``utils/integrity.py`` (stdlib only; the same manifest schema, so a
checkpoint either package writes verifies in the other).

A checkpoint write is atomic (tmp + rename, ``utils/checkpoint.py``), but
atomicity only protects against the writing process dying, not against a
torn filesystem, a partial copy from another machine, or bit rot between
runs. Every checkpoint therefore gets a sidecar manifest:

    ckpt_200.msgpack            # the flax msgpack state
    ckpt_200.msgpack.manifest.json
        {"schema": "ckpt-manifest-v1", "step": 200,
         "sha256": "...", "size_bytes": N, "keys": ["epoch", "model", ...]}

written tmp+rename immediately after the blob's own rename (a crash in
the gap leaves a blob with no manifest, reported as ``no_manifest``, the
same status pre-manifest checkpoints get, never as corruption).

Verification statuses (:func:`verify_checkpoint`):

* ``verified``    — manifest present, size and sha256 match;
* ``no_manifest`` — blob present, no sidecar (legacy checkpoint or a
  crash between the two renames). Loadable, but unverifiable;
* ``corrupt``     — size/sha mismatch, unreadable manifest, or missing
  blob. Never loaded.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Optional, Tuple

MANIFEST_SCHEMA = "ckpt-manifest-v1"
MANIFEST_SUFFIX = ".manifest.json"

# verify_checkpoint statuses, strongest first.
VERIFIED = "verified"
NO_MANIFEST = "no_manifest"
CORRUPT = "corrupt"


def manifest_path(ckpt_path: str) -> str:
    return ckpt_path + MANIFEST_SUFFIX


def sha256_file(path: str, chunk_bytes: int = 1 << 20) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            digest.update(chunk)
    return digest.hexdigest()


def build_manifest(step: int, blob: Optional[bytes], keys=(),
                   mesh_spec=None, layout=None, shard_files=None,
                   sha256: Optional[str] = None,
                   size_bytes: Optional[int] = None,
                   save_id: Optional[str] = None) -> dict:
    """Manifest dict for an in-memory serialized checkpoint (the save path
    has the bytes in hand — hashing them costs no extra IO). A streamed
    write passes ``blob=None`` with the ``sha256`` and ``size_bytes`` it
    computed on the way out.

    ``mesh_spec`` (a plain dict of axis sizes, ``MeshSpec.as_dict()``)
    labels the topology the checkpoint was saved under — what elastic
    resume and ``tools/verify_checkpoint.py --strict`` read. Sharded-save
    layouts pass ``layout='sharded'`` plus the shard file NAMES; each
    shard carries its own sidecar manifest (multi-host saves cannot hash
    another process's shard), and :func:`verify_checkpoint` chases them.
    ``save_id`` (the ranks' shared token of one sharded save) is recorded
    in the index's and every shard's manifest, so a shard left by another
    save of the same step is told apart from this save's.
    """
    manifest = {
        "schema": MANIFEST_SCHEMA,
        "step": int(step),
        "sha256": (hashlib.sha256(blob).hexdigest() if blob is not None
                   else sha256),
        "size_bytes": len(blob) if blob is not None else int(size_bytes),
        "keys": sorted(keys),
    }
    if mesh_spec is not None:
        manifest["mesh_spec"] = {str(k): int(v)
                                 for k, v in dict(mesh_spec).items()}
    if layout is not None:
        manifest["layout"] = str(layout)
    if shard_files is not None:
        manifest["shard_files"] = sorted(str(n) for n in shard_files)
    if save_id is not None:
        manifest["save_id"] = str(save_id)
    return manifest


def write_manifest(ckpt_path: str, manifest: dict) -> str:
    """Atomically (tmp + rename) write the sidecar next to ``ckpt_path``."""
    path = manifest_path(ckpt_path)
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(manifest, f, sort_keys=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def read_manifest(ckpt_path: str) -> Optional[dict]:
    """The sidecar manifest dict, or None when absent/unreadable."""
    try:
        with open(manifest_path(ckpt_path)) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    return manifest if isinstance(manifest, dict) else None


def _verify_against_manifest(ckpt_path: str, actual_size: int,
                             sha_fn) -> Tuple[str, str]:
    """Shared core of the file-path and in-memory verifiers: manifest
    presence/schema, cheap size check first (truncation — the common
    torn-copy shape — is caught without hashing a multi-GB state), then
    ``sha_fn()`` only when the size matches."""
    if not os.path.exists(manifest_path(ckpt_path)):
        return NO_MANIFEST, "no manifest sidecar (legacy or torn write)"
    manifest = read_manifest(ckpt_path)
    if manifest is None:
        return CORRUPT, "manifest unreadable (not a JSON object)"
    if manifest.get("schema") != MANIFEST_SCHEMA:
        return CORRUPT, (f"unknown manifest schema "
                         f"{manifest.get('schema')!r}")
    expected_size = manifest.get("size_bytes")
    if expected_size != actual_size:
        return CORRUPT, (f"size mismatch: manifest says {expected_size} "
                         f"bytes, file is {actual_size}")
    actual_sha = sha_fn()
    if manifest.get("sha256") != actual_sha:
        return CORRUPT, (f"sha256 mismatch: manifest "
                         f"{str(manifest.get('sha256'))[:12]}..., file "
                         f"{actual_sha[:12]}...")
    return VERIFIED, "sha256 verified"


def verify_checkpoint(ckpt_path: str) -> Tuple[str, str]:
    """(status, detail) for one checkpoint file — see the module docstring
    for the status vocabulary. Detail is a human-readable reason string.

    A sharded-layout INDEX whose manifest lists ``shard_files`` chases
    every shard: a missing or corrupt shard corrupts the whole
    checkpoint (the resume walk-back must not half-load it), and an
    unverifiable shard caps the status at ``no_manifest``.
    """
    if not os.path.isfile(ckpt_path):
        return CORRUPT, "checkpoint file missing"
    status, detail = _verify_against_manifest(
        ckpt_path, os.path.getsize(ckpt_path),
        lambda: sha256_file(ckpt_path))
    if status != VERIFIED:
        return status, detail
    manifest = read_manifest(ckpt_path)
    directory = os.path.dirname(os.path.abspath(ckpt_path))
    for name in (manifest or {}).get("shard_files", ()):
        shard = os.path.join(directory, os.path.basename(str(name)))
        if not os.path.isfile(shard):
            return CORRUPT, f"shard file missing: {name}"
        shard_status, shard_detail = _verify_against_manifest(
            shard, os.path.getsize(shard), lambda s=shard: sha256_file(s))
        if shard_status == CORRUPT:
            return CORRUPT, f"shard {name}: {shard_detail}"
        if shard_status == NO_MANIFEST:
            status, detail = NO_MANIFEST, f"shard {name}: {shard_detail}"
        elif manifest.get("save_id") is not None and (
                read_manifest(shard) or {}).get("save_id") != \
                manifest["save_id"]:
            return CORRUPT, f"shard {name}: written by another save"
    return status, detail


def validate_mesh_spec(manifest: dict) -> Tuple[bool, str]:
    """Consistency of a manifest's mesh spec with its shard layout
    (``tools/verify_checkpoint.py --strict``): axis sizes are concrete
    positives, and a sharded layout's device product is divisible by its
    shard count (each rank wrote one shard). Returns (ok, reason)."""
    spec = manifest.get("mesh_spec")
    if spec is None:
        return True, "no mesh_spec recorded"
    if not isinstance(spec, dict) or not spec:
        return False, "mesh_spec is not a non-empty object"
    product = 1
    for key, size in spec.items():
        if not isinstance(size, int) or size < 1:
            return False, (f"mesh_spec axis '{key}' must be a concrete "
                           f"positive size, got {size!r}")
        product *= size
    shards = manifest.get("shard_files")
    if manifest.get("layout") == "sharded":
        if not shards:
            return False, "layout=sharded but no shard_files listed"
        if product % len(shards) != 0:
            return False, (f"device product {product} not divisible by "
                           f"{len(shards)} process shards")
    return True, f"mesh_spec consistent ({product} devices)"


def verify_blob(ckpt_path: str, blob: bytes) -> Tuple[str, str]:
    """(status, detail) for checkpoint bytes already in memory — the load
    paths read the file ONCE and verify that buffer instead of paying a
    second multi-GB read just to hash (utils/checkpoint.py)."""
    return _verify_against_manifest(
        ckpt_path, len(blob),
        lambda: hashlib.sha256(blob).hexdigest())
