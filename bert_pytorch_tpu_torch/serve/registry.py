"""Versioned on-disk model registry (docs/serving.md "Model registry &
canary rollouts") — a copy of the JAX package's ``serve/registry.py``,
on the port's ``utils/integrity.py`` and ``telemetry/schema.py``
(``tests/test_torch_fleet.py`` holds the two to the same manifests and
``registry_event`` records).

The deployment plane's source of truth: every model version the fleet
can serve is one directory under the registry root holding a single
manifest written tmp+rename — the same torn-write discipline as
checkpoints (utils/checkpoint.py), so a publisher SIGKILLed mid-write
leaves either the previous manifest or none, never half of one::

    <root>/<version>/manifest.json
        {"schema": "model-registry-v1", "version": "vB",
         "task": "classify", "checkpoint": "/abs/ckpt.msgpack",
         "sha256": "...", "size_bytes": N, "quantize": "none",
         "geometry": {"hidden_size": 128, ...},
         "state": "staged", "history": [...]}

The manifest binds a version name to the EXACT checkpoint bytes it was
published from (``sha256`` over the blob, ``utils/integrity.py``) and
the geometry it was built for — :meth:`ModelRegistry.verify` re-checks
both offline, and the rollout controller refuses to swap a version
whose digest no longer matches.

**State machine.** A version is published ``staged`` and moves only
along the edges ``telemetry/schema.py REGISTRY_TRANSITIONS`` defines
(the registry imports the same tuples the schema lint checks, so the
two cannot drift)::

    staged ──► canary ──► live ──► retired
      │           │
      ▼           ▼ (rollback: reason required)
    retired     staged

Every publish and transition emits one schema-v1 ``registry_event``
record, so an artifact stream replays the full deployment history.

Stdlib-only and **dual-loadable** like the supervisor/router: imported
normally it is part of the serve package; loaded by file path
(tools/_bootstrap.py) it pulls ``utils/integrity.py`` and
``telemetry/schema.py`` the same way — the torch-free registry CLI and
chaos/fleet parents never execute a package ``__init__`` chain that
imports torch.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional


def _load_pkg_module(subpkg: str, modname: str):
    """See serve/supervisor.py — package import normally, file-path
    import when this module itself was loaded by path (torch-free)."""
    if __package__:
        import importlib

        return importlib.import_module(
            f"bert_pytorch_tpu_torch.{subpkg}.{modname}")
    import importlib.util

    alias = f"_torchfleet_{subpkg}_{modname}"
    module = sys.modules.get(alias)
    if module is not None:
        return module
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), subpkg, f"{modname}.py")
    spec = importlib.util.spec_from_file_location(alias, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return module


integrity = _load_pkg_module("utils", "integrity")
_schema = _load_pkg_module("telemetry", "schema")

REGISTRY_SCHEMA = "model-registry-v1"
MANIFEST_NAME = "manifest.json"

# The lifecycle vocabulary is the SCHEMA's: the registry enforces
# exactly the edges the offline lint accepts.
STATES = _schema.REGISTRY_STATES
TRANSITIONS = _schema.REGISTRY_TRANSITIONS
STAGED, CANARY, LIVE, RETIRED = STATES

# Geometry keys a publish records (the ones that determine every param
# shape — a checkpoint with different values cannot load into the
# serving model, and a SAME-geometry swap builds no kernel library:
# the engine's forwards and their built libraries serve the new params).
GEOMETRY_KEYS = ("hidden_size", "num_hidden_layers",
                 "num_attention_heads", "intermediate_size",
                 "vocab_size", "max_position_embeddings")


class RegistryError(RuntimeError):
    """A registry operation refused: unknown version, illegal state
    transition, duplicate publish, or a corrupt/missing checkpoint."""


class ModelRegistry:
    def __init__(self, root: str,
                 emit: Optional[Callable[[dict], None]] = None,
                 clock: Callable[[], float] = time.time):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._emit_fn = emit
        self._clock = clock
        # One lock guards the manifest cache AND serializes writers:
        # the rollout controller's promote/rollback races /swapz-driving
        # control threads and the CLI's reads.
        self._lock = threading.Lock()
        self._cache: Dict[str, dict] = {}

    # -- paths ------------------------------------------------------------

    def _dir(self, version: str) -> str:
        safe = str(version)
        if not safe or os.sep in safe or safe in (".", ".."):
            raise RegistryError(f"bad version name {version!r}")
        return os.path.join(self.root, safe)

    def manifest_path(self, version: str) -> str:
        return os.path.join(self._dir(version), MANIFEST_NAME)

    # -- telemetry --------------------------------------------------------

    def _emit(self, event: str, manifest: dict,
              from_state: Optional[str] = None,
              reason: Optional[str] = None) -> None:
        record = {
            "kind": "registry_event", "tag": "registry",
            "version": manifest["version"], "event": event,
            "state": manifest["state"], "task": manifest.get("task"),
            "digest": manifest.get("sha256"),
        }
        if from_state is not None:
            record["from_state"] = from_state
            record["to_state"] = manifest["state"]
        if reason is not None:
            record["reason"] = reason
        if self._emit_fn is not None:
            try:
                self._emit_fn(record)
            except Exception:
                pass

    # -- reads ------------------------------------------------------------

    def _read_locked(self, version: str) -> dict:
        cached = self._cache.get(version)
        if cached is not None:
            return cached
        try:
            with open(self.manifest_path(version)) as f:
                manifest = json.load(f)
        except OSError:
            raise RegistryError(f"unknown version {version!r} "
                                f"(no manifest under {self.root})")
        except ValueError as exc:
            raise RegistryError(
                f"version {version!r} manifest unreadable: {exc}")
        if not isinstance(manifest, dict) or \
                manifest.get("schema") != REGISTRY_SCHEMA:
            raise RegistryError(
                f"version {version!r} manifest has unknown schema "
                f"{manifest.get('schema') if isinstance(manifest, dict) else manifest!r}")
        self._cache[version] = manifest
        return manifest

    def get(self, version: str) -> dict:
        """The version's manifest (a copy — mutate via set_state)."""
        with self._lock:
            return dict(self._read_locked(version))

    def list_versions(self) -> List[dict]:
        """Every version's manifest, oldest publish first."""
        with self._lock:
            manifests = []
            for name in sorted(os.listdir(self.root)):
                if not os.path.isfile(
                        os.path.join(self.root, name, MANIFEST_NAME)):
                    continue
                try:
                    manifests.append(dict(self._read_locked(name)))
                except RegistryError:
                    continue
            manifests.sort(key=lambda m: m.get("published_ts", 0.0))
            return manifests

    def live_version(self, task: str) -> Optional[dict]:
        """The manifest currently ``live`` for ``task`` (None if no
        version has been promoted yet)."""
        for manifest in self.list_versions():
            if manifest.get("task") == task and \
                    manifest.get("state") == LIVE:
                return manifest
        return None

    # -- writes -----------------------------------------------------------

    def _write_locked(self, manifest: dict) -> None:
        """tmp + rename into the version directory — the checkpoint
        torn-write discipline (utils/integrity.py write_manifest)."""
        directory = self._dir(manifest["version"])
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(manifest, f, sort_keys=True, indent=1)
            os.replace(tmp, os.path.join(directory, MANIFEST_NAME))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self._cache[manifest["version"]] = manifest

    def publish(self, version: str, task: str, checkpoint: str,
                quantize: Optional[str] = None,
                geometry: Optional[dict] = None) -> dict:
        """Register ``checkpoint`` as ``version`` in state ``staged``.

        The blob is digested NOW (sha256 over the bytes on disk) and,
        when it carries an integrity sidecar, verified first — the
        registry must never bind a version name to bytes that are
        already torn."""
        checkpoint = os.path.abspath(checkpoint)
        if not os.path.isfile(checkpoint):
            raise RegistryError(f"checkpoint missing: {checkpoint}")
        status, detail = integrity.verify_checkpoint(checkpoint)
        if status == integrity.CORRUPT:
            raise RegistryError(
                f"refusing to publish corrupt checkpoint "
                f"{checkpoint}: {detail}")
        manifest = {
            "schema": REGISTRY_SCHEMA,
            "version": str(version),
            "task": str(task),
            "checkpoint": checkpoint,
            "sha256": integrity.sha256_file(checkpoint),
            "size_bytes": os.path.getsize(checkpoint),
            "quantize": str(quantize) if quantize else "none",
            "geometry": dict(geometry or {}),
            "state": STAGED,
            "published_ts": round(float(self._clock()), 3),
            "history": [],
        }
        with self._lock:
            if version in self._cache or \
                    os.path.exists(self.manifest_path(version)):
                raise RegistryError(
                    f"version {version!r} already published "
                    f"(versions are immutable; pick a new name)")
            self._write_locked(manifest)
        self._emit("published", manifest)
        return dict(manifest)

    def set_state(self, version: str, state: str,
                  reason: Optional[str] = None) -> dict:
        """One state-machine transition; raises on an illegal edge.
        A rollback (canary -> staged) must carry ``reason``."""
        with self._lock:
            manifest = dict(self._read_locked(version))
            from_state = manifest.get("state")
            if (from_state, state) not in TRANSITIONS:
                raise RegistryError(
                    f"illegal transition {from_state!r} -> {state!r} "
                    f"for version {version!r} (legal edges: "
                    f"{TRANSITIONS})")
            if (from_state, state) == (CANARY, STAGED) and not reason:
                raise RegistryError(
                    "a rollback (canary -> staged) requires a reason")
            manifest["state"] = state
            manifest["history"] = list(manifest.get("history", ())) + [{
                "from": from_state, "to": state,
                "reason": reason,
                "ts": round(float(self._clock()), 3),
            }]
            self._write_locked(manifest)
        self._emit("state_change", manifest, from_state=from_state,
                   reason=reason)
        return dict(manifest)

    def begin_canary(self, version: str) -> dict:
        return self.set_state(version, CANARY)

    def promote(self, version: str) -> dict:
        """canary -> live; any other version of the same task that was
        live retires (exactly one live version per task)."""
        promoted = self.set_state(version, LIVE)
        for other in self.list_versions():
            if other["version"] != promoted["version"] and \
                    other.get("task") == promoted.get("task") and \
                    other.get("state") == LIVE:
                self.set_state(other["version"], RETIRED)
        return promoted

    def rollback(self, version: str, reason: str) -> dict:
        return self.set_state(version, STAGED, reason=reason)

    # -- verification -----------------------------------------------------

    def verify(self, version: str) -> (bool, str):
        """Does the version's checkpoint still match its manifest?
        (ok, detail) — missing bytes, a size change, or a digest
        mismatch all fail; the rollout controller refuses to swap a
        version that does not verify."""
        manifest = self.get(version)
        checkpoint = manifest.get("checkpoint", "")
        if not os.path.isfile(checkpoint):
            return False, f"checkpoint missing: {checkpoint}"
        size = os.path.getsize(checkpoint)
        if size != manifest.get("size_bytes"):
            return False, (f"size mismatch: manifest says "
                           f"{manifest.get('size_bytes')} bytes, "
                           f"file is {size}")
        digest = integrity.sha256_file(checkpoint)
        if digest != manifest.get("sha256"):
            return False, (f"sha256 mismatch: manifest "
                           f"{str(manifest.get('sha256'))[:12]}..., "
                           f"file {digest[:12]}...")
        return True, "sha256 verified"

    def verify_geometry(self, version: str, config: dict) -> (bool, str):
        """Does the version's recorded geometry still match ``config``
        (a model-config dict)? Only keys the manifest recorded are
        compared — a version published without geometry passes with a
        note (nothing to check against)."""
        manifest = self.get(version)
        geometry = manifest.get("geometry") or {}
        if not geometry:
            return True, "no geometry recorded"
        drifted = {k: (v, config.get(k)) for k, v in geometry.items()
                   if k in config and config[k] != v}
        if drifted:
            detail = ", ".join(
                f"{k}: manifest {v[0]!r} != config {v[1]!r}"
                for k, v in sorted(drifted.items()))
        return (not drifted,
                detail if drifted else "geometry matches config")


def geometry_from_config(config: dict) -> dict:
    """The shape-determining subset of a model config — what publish
    records and ``verify_checkpoint --registry`` compares."""
    return {k: config[k] for k in GEOMETRY_KEYS if k in config}
