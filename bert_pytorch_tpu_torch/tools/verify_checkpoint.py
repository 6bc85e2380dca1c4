#!/usr/bin/env python
"""Verify the port's checkpoint integrity manifests offline: the
counterpart of the repo-root ``tools/verify_checkpoint.py``, on the
port's ``utils/integrity.py``.

For every ``ckpt_*.msgpack`` named (or found under a named directory) it
checks the sidecar manifest (size, then sha256) and prints one ``path:
status (detail)`` line. Statuses:

* ``verified``    — manifest present, bytes match;
* ``no_manifest`` — loadable but unverifiable (a write torn between the
  blob and sidecar renames, or a file written without one);
* ``corrupt``     — size/sha mismatch or an unreadable manifest; the
  resume walk-back (utils/checkpoint.py) skips these.

Every layout the port writes is covered: the gathered ``ckpt_{step}``
file of the trainers, the finetune runners' model-only files, and the
sharded layout (``--checkpoint_layout sharded``): its index
``ckpt_{step}.msgpack`` verifies against its own manifest and then
chases each ``ckpt_{step}.shard{r}of{n}.msgpack`` its manifest lists
(a missing or mismatched shard makes the index ``corrupt``); each shard
file also verifies against its own sidecar. A manifest's ``mesh_spec``
and layout are printed, and under ``--strict`` the spec is validated
against the shard layout (``integrity.validate_mesh_spec``).

Usage::

    python bert_pytorch_tpu_torch/tools/verify_checkpoint.py out/pretrain_ckpts [more paths...]
    python bert_pytorch_tpu_torch/tools/verify_checkpoint.py --strict out/   # no_manifest fails too
    python bert_pytorch_tpu_torch/tools/verify_checkpoint.py --registry reg/ [--config model.json]

With ``--registry`` the paths are model-registry roots
(serve/registry.py): every version's checkpoint is re-hashed against its
registry manifest digest, and with ``--config`` each version's recorded
geometry is diffed against the config (``no_geometry`` fails under
``--strict`` only).

Exit 0 = nothing corrupt (``--strict``: everything verified), 1 =
corruption found (or unverified under ``--strict``), 2 = a named path is
missing. Stdlib only: the integrity module loads by file path
(tools/_bootstrap.py), no torch.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

if __package__:
    from bert_pytorch_tpu_torch.tools._bootstrap import load_by_path
else:
    from _bootstrap import load_by_path

integrity = load_by_path(
    "_torch_ckpt_integrity", "utils", "integrity.py")


def expand(paths):
    """Named files, plus every ckpt_*.msgpack under named directories
    (index and shard files alike)."""
    out = []
    for path in paths:
        if os.path.isdir(path):
            out.extend(sorted(
                glob.glob(os.path.join(path, "**", "ckpt_*.msgpack"),
                          recursive=True)))
        else:
            out.append(path)
    return out


def verify_registry(root: str, config, strict: bool) -> int:
    """Registry mode: re-hash every version under a serve/registry.py root
    against its manifest digest, plus geometry drift against ``config``."""
    registry_mod = load_by_path(
        "_torch_ckpt_registry", "serve", "registry.py")
    reg = registry_mod.ModelRegistry(root)
    versions = reg.list_versions()
    if not versions:
        print(f"verify_checkpoint: no registry versions under {root}")
        return 2
    failed = False
    for manifest in versions:
        version = manifest["version"]
        ok, detail = reg.verify(version)
        status = "verified" if ok else "corrupt"
        print(f"{root}:{version}: {status} ({detail}) "
              f"[state={manifest.get('state')} task={manifest.get('task')}]")
        failed |= not ok
        if config is None:
            continue
        if not manifest.get("geometry"):
            print(f"{root}:{version}: no_geometry "
                  "(published without --config; nothing to diff)")
            failed |= strict
            continue
        gok, gdetail = reg.verify_geometry(version, config)
        print(f"{root}:{version}: geometry "
              f"{'ok' if gok else 'DRIFT'} ({gdetail})")
        failed |= not gok
    return 1 if failed else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="verify the port's checkpoint integrity manifests")
    parser.add_argument("paths", nargs="+",
                        help="checkpoint files or directories to scan "
                             "(--registry: registry roots)")
    parser.add_argument("--strict", action="store_true",
                        help="treat no_manifest (unverifiable) as failure")
    parser.add_argument("--registry", action="store_true",
                        help="paths are model-registry roots "
                             "(serve/registry.py)")
    parser.add_argument("--config", default="",
                        help="model config JSON to diff each registry "
                             "version's recorded geometry against "
                             "(--registry only)")
    args = parser.parse_args(argv)

    if args.registry:
        config = None
        if args.config:
            with open(args.config, "r", encoding="utf-8") as f:
                config = json.load(f)
        for root in args.paths:
            if not os.path.isdir(root):
                print(f"verify_checkpoint: {root}: no such registry root")
                return 2
        return max(verify_registry(root, config, args.strict)
                   for root in args.paths)

    for path in args.paths:
        if not os.path.exists(path):
            print(f"verify_checkpoint: {path}: no such file or directory")
            return 2
    ckpts = expand(args.paths)
    if not ckpts:
        print("verify_checkpoint: no ckpt_*.msgpack files found")
        return 2
    failed = False
    for path in ckpts:
        status, detail = integrity.verify_checkpoint(path)
        print(f"{path}: {status} ({detail})")
        if status == integrity.CORRUPT or (
                args.strict and status != integrity.VERIFIED):
            failed = True
        manifest = integrity.read_manifest(path)
        if manifest and "mesh_spec" in manifest:
            spec = ",".join(f"{k}={v}"
                            for k, v in sorted(manifest["mesh_spec"].items()))
            layout = manifest.get("layout")
            suffix = f" (layout={layout})" if layout else ""
            print(f"{path}: mesh_spec {spec}{suffix}")
            ok, reason = integrity.validate_mesh_spec(manifest)
            if not ok:
                print(f"{path}: mesh_spec INVALID ({reason})")
                failed |= args.strict
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
