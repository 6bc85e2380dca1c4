"""torchlint command line (``bert_pytorch_tpu_torch/tools/torchlint.py``
is the wrapper; the JAX package's jaxlint CLI, kept flag for flag).

Exit codes: 0 = clean (baseline-covered findings allowed), 1 = findings,
2 = usage / missing path / malformed baseline. With no path it lints
the canonical target set (``core.TORCHLINT_TARGETS``: the port's package
and ``chip_smoke.py``).

The whole-program tier (SD6xx/DN701/CT8xx) needs the whole program, so
a subset run (``torchlint serve``) still parses the canonical target set
as graph context — otherwise a flag declared in ``serve/cli.py`` and
read in ``run_server.py`` would be falsely flagged as dead. Findings are
only ever REPORTED for the requested paths; ``--no-context`` restricts
the graph to them too (fixture tests and out-of-repo runs).

``--format json`` emits one machine-readable object (stable check id,
path, line, source text, suppression state for every finding incl.
baselined ones) so CI can diff findings across commits; ``tools/
check_all.py --format json`` threads it through the unified gate.

This module — like the whole analysis package — never imports torch,
nor JAX: the tier-1 gate runs it with both poisoned.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Tuple

from bert_pytorch_tpu_torch.analysis import baseline as baseline_mod
from bert_pytorch_tpu_torch.analysis import core


def _repo_root() -> str:
    # analysis/cli.py -> analysis -> bert_pytorch_tpu_torch -> repo root
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def default_baseline() -> str:
    """The committed baseline: ``<package>/torchlint_baseline.json``."""
    return os.path.join(_repo_root(), core.PACKAGE,
                        baseline_mod.DEFAULT_BASENAME)


def canonical_targets() -> List[str]:
    """The canonical target set, as paths under the repo root (those
    that exist: a partial checkout lints what it has)."""
    root = _repo_root()
    return [os.path.join(root, t) for t in core.TORCHLINT_TARGETS
            if os.path.exists(os.path.join(root, t))]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="torchlint",
        description="Pure-AST hazard linter of the PyTorch port: "
                    "host-sync, recompile, RNG, autograd-leak, and "
                    "lock-discipline checks per file, plus the "
                    "whole-program tier (process-group axis discipline, "
                    "buffers read while the card owns them, contract "
                    "drift), all with the JAX package's stable IDs.")
    parser.add_argument(
        "paths", nargs="*",
        help="files or directories; a bare name that does not exist is "
             "retried under bert_pytorch_tpu_torch/ (so 'serve' works)")
    parser.add_argument(
        "--baseline", default=None,
        help="baseline file (default: bert_pytorch_tpu_torch/"
             "torchlint_baseline.json when present); entries suppress "
             "matching findings")
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="ignore any baseline file: report every finding")
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="write the current UNSUPPRESSED findings to the baseline "
             "file and exit 0 (stale entries are pruned)")
    parser.add_argument(
        "--list-checks", action="store_true",
        help="print every check ID with its description and exit")
    parser.add_argument(
        "--no-context", action="store_true",
        help="do not parse the canonical target set as whole-program "
             "context for subset runs (the program checks then see only "
             "the given paths)")
    parser.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="output format; json emits one object with every finding "
             "(incl. baselined, with suppression state) for CI diffing")
    parser.add_argument(
        "-q", "--quiet", action="store_true",
        help="suppress the summary line (findings still print)")
    return parser


def gather(paths: List[str], *, baseline: Optional[str] = None,
           no_baseline: bool = False, no_context: bool = False
           ) -> Tuple[dict, int]:
    """Run the lint and return (payload, rc) without printing — the
    shared engine behind ``main`` and ``check_all --format json``.
    Payload: {files, findings: [{check, path, line, col, message,
    source, status}], stale_baseline: [...]}; rc as the CLI exit code.
    Raises FileNotFoundError / ValueError for usage errors (rc 2 paths)
    so callers can present them."""
    repo_root = _repo_root()
    files = core.expand_paths(paths, repo_root=repo_root)
    context = None
    if not no_context:
        context = canonical_targets()
        context = core.expand_paths(context, repo_root=repo_root) \
            if context else None
    findings = core.run_files(files, repo_root=repo_root,
                              context_paths=context)

    baseline_path = baseline or default_baseline()
    entries: List[dict] = []
    if not no_baseline:
        entries = baseline_mod.load_baseline(baseline_path)
    new, matched, stale = baseline_mod.apply_baseline(findings, entries)
    linted = {os.path.relpath(p, repo_root).replace(os.sep, "/")
              for p in files}
    # Only entries for files this run actually linted can be judged
    # stale — a subset run must not advertise other files' entries as
    # prunable.
    stale = [e for e in stale if e["path"] in linted]

    def record(f, status):
        return {"check": f.check, "path": f.path, "line": f.line,
                "col": f.col, "message": f.message, "source": f.source,
                "status": status}

    payload = {
        "version": 1,
        "files": len(files),
        "findings": ([record(f, "new") for f in new]
                     + [record(f, "baselined") for f in matched]),
        "stale_baseline": stale,
    }
    return payload, (1 if new else 0)


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.list_checks:
        for check_id in sorted(core.ALL_CHECK_IDS):
            print(f"{check_id}  {core.ALL_CHECK_IDS[check_id]}")
        return 0
    if not args.paths:
        args.paths = canonical_targets()

    repo_root = _repo_root()
    if args.write_baseline:
        payload, _ = _gather_or_usage_error(args, allow_corrupt=True)
        if payload is None:
            return 2
        findings = _findings_from(payload)
        # Safe now: gather() already expanded these same paths, so a
        # missing one was reported as the usage error above.
        files = core.expand_paths(args.paths, repo_root=repo_root)
        baseline_path = args.baseline or default_baseline()
        try:
            entries = baseline_mod.load_baseline(baseline_path)
        except ValueError:
            entries = []  # rewriting is the recovery path
        # MERGE, not overwrite: a subset run (torchlint run_glue.py
        # --write-baseline) must keep other files' entries and every
        # still-matching entry's hand-written justification; only
        # stale entries for the files actually linted are pruned.
        linted = {os.path.relpath(p, repo_root).replace(os.sep, "/")
                  for p in files}
        merged = baseline_mod.merge_entries(entries, findings, linted)
        n = baseline_mod.write_entries(baseline_path, merged)
        print(f"torchlint: wrote {n} baseline entr"
              f"{'y' if n == 1 else 'ies'} to {baseline_path}")
        return 0

    payload, rc = _gather_or_usage_error(args)
    if payload is None:
        return 2

    if args.format == "json":
        print(json.dumps(payload, indent=2, sort_keys=False))
        return rc

    new = [f for f in payload["findings"] if f["status"] == "new"]
    matched = [f for f in payload["findings"] if f["status"] == "baselined"]
    stale = payload["stale_baseline"]
    for f in new:
        print(f"{f['path']}:{f['line']}:{f['col']}: "
              f"{f['check']} {f['message']}")
    if not args.quiet:
        parts = [f"torchlint: {len(new)} finding"
                 f"{'' if len(new) == 1 else 's'} in "
                 f"{payload['files']} files"]
        if matched:
            parts.append(f"{len(matched)} baselined")
        if stale:
            parts.append(f"{len(stale)} stale baseline entr"
                         f"{'y' if len(stale) == 1 else 'ies'} "
                         "(run --write-baseline to prune)")
        print("; ".join(parts))
    return rc


def _gather_or_usage_error(args, allow_corrupt: bool = False):
    try:
        return gather(list(args.paths), baseline=args.baseline,
                      no_baseline=args.no_baseline or allow_corrupt,
                      no_context=args.no_context)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return None, 2
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return None, 2


def _findings_from(payload: dict) -> List[core.Finding]:
    return [core.Finding(check=f["check"], path=f["path"], line=f["line"],
                         col=f["col"], message=f["message"],
                         source=f["source"])
            for f in payload["findings"]]


if __name__ == "__main__":
    sys.exit(main())
