#!/usr/bin/env python
"""Model-registry CLI: publish, inspect, verify, and promote model
versions without torch (docs/serving.md "Model registry & canary
rollouts") — the port's counterpart of the repo-root
``tools/model_registry.py``, over the port's ``serve/registry.py``.

The registry itself is serve/registry.py — one directory per version,
one ``manifest.json`` each (checkpoint path + sha256 + quant level +
geometry + lifecycle state), written tmp+rename so a SIGKILL mid-write
never leaves a half-manifest. This tool is the operator's (and CI's)
surface over it::

    python bert_pytorch_tpu_torch/tools/model_registry.py --root runs/registry \
        publish v2 --task classify --checkpoint out/ckpt_9000.msgpack \
        --quantize int8 --config configs/bert_base_config.json
    python bert_pytorch_tpu_torch/tools/model_registry.py --root runs/registry list
    python bert_pytorch_tpu_torch/tools/model_registry.py --root runs/registry verify v2
    python bert_pytorch_tpu_torch/tools/model_registry.py --root runs/registry canary v2
    python bert_pytorch_tpu_torch/tools/model_registry.py --root runs/registry promote v2
    python bert_pytorch_tpu_torch/tools/model_registry.py --root runs/registry \
        rollback v2 --reason "canary p95 breach"

``publish --config`` records the model geometry from the config JSON so
``verify`` can flag a
version whose checkpoint was trained at a different shape than the
fleet serves — the drift that otherwise surfaces as a shape error at
swap time on a live replica.

With ``--telemetry_jsonl`` every state change appends a schema-v1
``registry_event`` record (the audit trail telemetry-report
summarizes). Exit codes: 0 ok, 1 verification/state failure, 2 usage.

torch-free by construction: serve/registry.py and its integrity/schema
dependencies are stdlib-only and loaded by file path (tools/
_bootstrap.py), so this runs on any checkout.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

if __package__:
    from bert_pytorch_tpu_torch.tools._bootstrap import load_by_path
else:
    from _bootstrap import load_by_path

registry_mod = load_by_path("_torchregistry_cli", "serve", "registry.py")
schema = load_by_path("_torchregistry_schema", "telemetry", "schema.py")


def make_emit(path):
    """Append-mode schema-v1 JSONL emitter (the registry emits bare
    records; the envelope — schema tag + timestamp — is stamped here,
    the same shape every sink in the repo writes)."""
    if not path:
        return None

    def emit(record: dict) -> None:
        rec = {"schema": schema.SCHEMA_VERSION, "ts": round(time.time(), 3)}
        rec.update(record)
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec) + "\n")

    return emit


def cmd_publish(reg, args) -> int:
    geometry = None
    if args.config:
        with open(args.config, "r", encoding="utf-8") as f:
            geometry = registry_mod.geometry_from_config(json.load(f))
    manifest = reg.publish(args.version, task=args.task,
                           checkpoint=args.checkpoint,
                           quantize=args.quantize, geometry=geometry)
    print(f"published {manifest['version']} (task {manifest['task']}, "
          f"sha256 {manifest['sha256'][:12]}..., "
          f"{manifest['size_bytes']} bytes, "
          f"quantize {manifest['quantize']}, state {manifest['state']})")
    return 0


def cmd_list(reg, args) -> int:
    versions = reg.list_versions()
    if args.task:
        versions = [m for m in versions if m.get("task") == args.task]
    if not versions:
        print("(empty registry)")
        return 0
    for m in versions:
        geo = m.get("geometry") or {}
        shape = (f"L{geo['num_hidden_layers']}/H{geo['hidden_size']}"
                 if geo else "-")
        print(f"{m['version']:>12}  {m['state']:>7}  task={m['task']}  "
              f"quant={m['quantize']}  geometry={shape}  "
              f"sha256={m['sha256'][:12]}...")
    return 0


def cmd_verify(reg, args) -> int:
    rc = 0
    versions = ([args.version] if args.version
                else [m["version"] for m in reg.list_versions()])
    if not versions:
        print("(empty registry)")
        return 0
    for version in versions:
        ok, detail = reg.verify(version)
        print(f"{version}: {'OK' if ok else 'FAIL'} ({detail})")
        if not ok:
            rc = 1
    return rc


def cmd_canary(reg, args) -> int:
    manifest = reg.begin_canary(args.version)
    print(f"{manifest['version']}: staged -> canary")
    return 0


def cmd_promote(reg, args) -> int:
    manifest = reg.promote(args.version)
    print(f"{manifest['version']}: canary -> live "
          f"(task {manifest['task']})")
    return 0


def cmd_rollback(reg, args) -> int:
    manifest = reg.rollback(args.version, args.reason)
    print(f"{manifest['version']}: canary -> staged "
          f"(reason: {args.reason})")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="model-registry",
        description="versioned model registry over serve/registry.py "
                    "(docs/serving.md)")
    parser.add_argument("--root", required=True,
                        help="registry root directory (one subdir per "
                             "version)")
    parser.add_argument("--telemetry_jsonl", default="",
                        help="append registry_event records here "
                             "(schema v1 audit trail)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("publish", help="register a checkpoint as a new "
                                       "staged version")
    p.add_argument("version")
    p.add_argument("--task", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="ckpt_*.msgpack file the serving hosts can read")
    p.add_argument("--quantize", default=None,
                   help="quant level the version serves at (e.g. int8)")
    p.add_argument("--config", default="",
                   help="model config JSON; records the geometry so "
                        "verify can flag shape drift vs the fleet")

    p = sub.add_parser("list", help="list versions, newest last")
    p.add_argument("--task", default="")

    p = sub.add_parser("verify", help="re-hash checkpoints against the "
                                      "manifests (exit 1 on mismatch)")
    p.add_argument("version", nargs="?", default=None,
                   help="one version (default: every version)")

    p = sub.add_parser("canary", help="staged -> canary")
    p.add_argument("version")

    p = sub.add_parser("promote", help="canary -> live (retires the "
                                       "task's previous live version)")
    p.add_argument("version")

    p = sub.add_parser("rollback", help="canary -> staged, with a "
                                        "recorded reason")
    p.add_argument("version")
    p.add_argument("--reason", required=True,
                   help="why (lands on the registry_event and the "
                        "manifest history)")

    args = parser.parse_args(argv)
    reg = registry_mod.ModelRegistry(
        args.root, emit=make_emit(args.telemetry_jsonl))
    commands = {"publish": cmd_publish, "list": cmd_list,
                "verify": cmd_verify, "canary": cmd_canary,
                "promote": cmd_promote, "rollback": cmd_rollback}
    try:
        return commands[args.command](reg, args)
    except (registry_mod.RegistryError, FileNotFoundError) as exc:
        print(f"model-registry: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
