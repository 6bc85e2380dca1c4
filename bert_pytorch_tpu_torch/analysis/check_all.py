"""The port's one standalone lint gate: torchlint + the telemetry schema
lint + the autotune winners-file lint — the JAX package's ``bert-lint``
(``analysis/check_all.py``) over the port.

Three legs, exit 0 only when all pass:

1. **torchlint** over the canonical targets (the port's package and
   ``chip_smoke.py``), honoring the committed baseline
   (``bert_pytorch_tpu_torch/torchlint_baseline.json``);
2. the **telemetry schema lint** (the port's ``telemetry/schema.py``
   ``validate_file``) over the ``*.jsonl`` artifacts the caller names.
   The default set is empty: a run lints what it wrote, never whatever
   JSONL happens to lie around the checkout;
3. the **winners-file lint** (``ops/kernels/autotune.py``
   ``validate_winners_file``) over the ``*.json`` autotune winners files
   the caller names.

``bert_pytorch_tpu_torch/tools/check_all.py`` is the wrapper (a script,
or ``python -m bert_pytorch_tpu_torch.tools.check_all``). Exit codes:
0 = clean, 1 = findings or a failing/missing artifact, 2 = usage error
(a malformed baseline).

torch-free like everything in this package: the schema and autotune
modules are loaded by FILE PATH (the ``tools/_bootstrap.py`` technique)
— their module-level imports are the standard library's — never through
the ``telemetry``/``ops`` package ``__init__`` chains, which import torch.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from typing import List, Optional

from bert_pytorch_tpu_torch.analysis import cli as torchlint_cli


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _repo_root() -> str:
    return os.path.dirname(_package_root())


def _load_by_path(name: str, *parts: str):
    path = os.path.join(_package_root(), *parts)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _load_schema_module():
    return _load_by_path("_torch_lint_schema", "telemetry", "schema.py")


def _load_autotune_module():
    # ops/kernels/autotune.py keeps its module-level imports stdlib-only
    # for exactly this loader: the winners-file FORMAT rules live once,
    # next to the code that writes the files.
    return _load_by_path("_torch_lint_autotune", "ops", "kernels",
                         "autotune.py")


def _rel(path: str) -> str:
    return os.path.relpath(path, _repo_root()) if os.path.exists(path) \
        else path


def _results(paths: List[str], validate) -> List[dict]:
    """[{path, ok, errors: [{line, error}]}] per artifact, one shape for
    both legs so both render through one presenter; ``validate(path)``
    returns (line, error) pairs, line 0 for a whole-file error."""
    results = []
    for path in paths:
        if not os.path.exists(path):
            results.append({"path": _rel(path), "ok": False,
                            "errors": [{"line": 0, "error": "no such file"}]})
            continue
        errors = validate(path)
        results.append({
            "path": _rel(path), "ok": not errors,
            "errors": [{"line": lineno, "error": err}
                       for lineno, err in errors]})
    return results


def _schema_results(paths: List[str]) -> List[dict]:
    """One result per JSONL artifact (telemetry/schema.py)."""
    return _results(paths, _load_schema_module().validate_file)


def _winners_results(paths: List[str]) -> List[dict]:
    """One result per autotune winners JSON (ops/kernels/autotune.py)."""
    autotune = _load_autotune_module()
    return _results(paths, lambda path: [
        (0, err) for err in autotune.validate_winners_file(path)])


def _print_results(results: List[dict]) -> int:
    """Text presentation of one leg; returns the failing artifact count."""
    failed = 0
    for result in results:
        if result["ok"]:
            print(f"{result['path']}: ok")
            continue
        failed += 1
        for err in result["errors"]:
            if err["line"] == 0 and err["error"] == "no such file":
                print(f"check_all: {result['path']}: no such file",
                      file=sys.stderr)
            elif err["line"]:
                print(f"{result['path']}:{err['line']}: {err['error']}")
            else:
                print(f"{result['path']}: {err['error']}")
    return failed


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="check_all",
        description="The port's lint gate: torchlint over the port's "
                    "package and chip_smoke.py, then the telemetry record "
                    "schema over the named JSONL artifacts and the "
                    "autotune winners format over the named JSON files.")
    parser.add_argument(
        "artifacts", nargs="*",
        help="artifacts to lint: *.jsonl files go through the telemetry "
             "record schema (telemetry/schema.py), *.json files through "
             "the autotune winners format (ops/kernels/autotune.py). "
             "Default: none")
    parser.add_argument("--skip-torchlint", action="store_true",
                        help="only lint the named artifacts")
    parser.add_argument("--skip-schema", action="store_true",
                        help="only run torchlint over the code targets")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text",
                        help="json emits one machine-readable object "
                             "(torchlint findings incl. suppression state "
                             "+ per-artifact results) so CI can diff "
                             "findings across commits")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    targets = torchlint_cli.canonical_targets()
    jsonls = [p for p in args.artifacts if not p.endswith(".json")]
    winners = [p for p in args.artifacts if p.endswith(".json")]

    if args.format == "json":
        rc = 0
        combined: dict = {"version": 1}
        if not args.skip_torchlint:
            try:
                payload, lint_rc = torchlint_cli.gather(targets)
            except (ValueError, FileNotFoundError) as e:
                # The text mode's rc-2 usage-error contract: a corrupt
                # baseline yields an error line, not a traceback.
                print(f"check_all: {e}", file=sys.stderr)
                return 2
            combined["torchlint"] = payload
            rc = rc or lint_rc
        if not args.skip_schema:
            results = _schema_results(jsonls)
            wresults = _winners_results(winners)
            combined["schema"] = results
            combined["autotune_winners"] = wresults
            if any(not r["ok"] for r in results + wresults):
                rc = 1
        combined["rc"] = rc
        print(json.dumps(combined, indent=2, sort_keys=False))
        return rc

    rc = 0
    if not args.skip_torchlint:
        print("== torchlint ==")
        lint_rc = torchlint_cli.main(targets)
        if lint_rc == 2:
            return 2
        if lint_rc != 0:
            rc = 1
    if not args.skip_schema:
        print("== telemetry schema ==")
        if not jsonls:
            print("check_all: no *.jsonl artifacts named")
        elif _print_results(_schema_results(jsonls)):
            rc = 1
        if winners:
            print("== autotune winners ==")
            if _print_results(_winners_results(winners)):
                rc = 1
    print("check_all: " + ("OK" if rc == 0 else "FAILED"))
    return rc


if __name__ == "__main__":
    sys.exit(main())
