"""Shared analyzer machinery: parsed-module model, suppression comments,
check registry, and the file-walking entry points — the counterpart of
the JAX package's ``analysis/core.py``, rule for rule, with the port's
comment markers (``# torchlint: disable=ID``, ``# torchlint: hot``) and
target set.

Everything here is stdlib-only (ast/re/os/tokenize) — see the package
docstring for why that is a hard constraint.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass
from typing import Iterable, List, Optional

# Inline suppression: a trailing comment on the flagged line (or a comment
# on its own line DIRECTLY above, for statements too long to annotate
# inline). Multiple IDs comma-separate. An unknown ID is itself an error
# (JL000) — a typo'd suppression must not silently stop suppressing.
DISABLE_RE = re.compile(r"#\s*torchlint:\s*disable=([A-Za-z0-9_,\s]+)")
# Hot-path marker: a comment on (or directly above) a ``def`` line opts
# that function into the host-sync scan even when it is not reachable
# from a ``tele.timed`` loop in the same module (host_sync.py).
HOT_RE = re.compile(r"#\s*torchlint:\s*hot\b")

JL_BAD_ID = "JL000"
JL_PARSE = "JL001"


@dataclass(frozen=True)
class Finding:
    check: str
    path: str          # path as reported (relative when possible)
    line: int
    col: int
    message: str
    source: str        # stripped source of the flagged line (baseline key)

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.check} {self.message}"


class Module:
    """One parsed source file plus the derived maps every check shares:
    parent links, import-alias resolution, suppression/hot comment lines."""

    def __init__(self, path: str, text: str, rel: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        # One BFS walk, shared by every check: ~25 separate ast.walk
        # passes per module dominated the gate's runtime otherwise.
        self.nodes = list(ast.walk(self.tree))
        self.parents: dict = {}
        for parent in self.nodes:
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.aliases = self._import_aliases()
        self.suppressions, self.bad_ids, self.hot_lines = \
            self._scan_comments()

    # -- comments --------------------------------------------------------

    def _comment_tokens(self):
        """(line, text) of every actual COMMENT token — a ``# torchlint:``
        marker quoted inside a docstring must not count."""
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(self.text).readline):
                if tok.type == tokenize.COMMENT:
                    yield tok.start[0], tok.string
        except tokenize.TokenError:
            return  # ast.parse already succeeded; be permissive here

    def _scan_comments(self):
        suppressions: dict = {}   # line -> set of IDs
        bad: list = []            # (line, bad_id)
        hot_lines: set = set()
        for lineno, comment in self._comment_tokens():
            if HOT_RE.search(comment):
                hot_lines.add(lineno)
            m = DISABLE_RE.search(comment)
            if not m:
                continue
            ids = {tok.strip() for tok in m.group(1).split(",") if tok.strip()}
            for check_id in ids:
                # ALL_CHECK_IDS is a module global populated at import
                # time; Modules are only built at analysis time, after.
                if check_id not in ALL_CHECK_IDS:
                    bad.append((lineno, check_id))
            suppressions[lineno] = ids
        return suppressions, bad, hot_lines

    def suppressed(self, line: int, check_id: str) -> bool:
        for at in (line, line - 1):
            ids = self.suppressions.get(at)
            if ids and check_id in ids:
                return True
        return False

    def source_line(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def finding(self, check: str, node: ast.AST, message: str) -> Finding:
        return Finding(check=check, path=self.rel, line=node.lineno,
                       col=node.col_offset, message=message,
                       source=self.source_line(node.lineno))

    # -- name resolution -------------------------------------------------

    def _import_aliases(self) -> dict:
        """Map local names to canonical dotted roots: ``import numpy as
        np`` -> {"np": "numpy"}; ``from torch.nn import functional as F`` ->
        {"F": "torch.nn.functional"}."""
        aliases: dict = {}
        for node in self.nodes:
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    if a.name == "*":
                        continue
                    aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        return aliases

    def dotted(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted name of an attribute chain / name, resolved
        through the module's import aliases; None for anything else."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.aliases.get(node.id, node.id)
        parts.append(root)
        return ".".join(reversed(parts))


# -- check registry ------------------------------------------------------

# The canonical lint target set — what the tier-1 gate, the card's smoke
# and commit hooks all mean by "lint the port": the port's package (its
# runners and tools included) and the smoke that drives it on the card.
# Also the context the CLI parses for the whole-program tier on subset
# runs. The JAX package is never a target.
PACKAGE = "bert_pytorch_tpu_torch"
TORCHLINT_TARGETS = (PACKAGE, "chip_smoke.py")


def _checks():
    # Local imports keep core importable before the check modules exist
    # in partial environments, and break the package import cycle.
    from bert_pytorch_tpu_torch.analysis import (host_sync, lock_discipline,
                                           recompile, rng, tracer_leak)
    return (host_sync, recompile, rng, tracer_leak, lock_discipline)


def _program_checks():
    """The whole-program tier: checks over the cross-module
    symbol/call graph (graph.Program) instead of one file at a time."""
    from bert_pytorch_tpu_torch.analysis import contracts, donation, sharding
    return (sharding, donation, contracts)


def all_check_ids() -> dict:
    """{check_id: one-line description} over every registered check,
    plus the analyzer's own JL error codes."""
    ids = {
        JL_BAD_ID: "unknown check ID in a torchlint disable comment",
        JL_PARSE: "file failed to parse",
    }
    for mod in _checks() + _program_checks():
        ids.update(mod.CHECKS)
    return ids


# Computed once at import; the package __init__ re-exports it and the
# suppression parser checks typo'd IDs against it.
ALL_CHECK_IDS = all_check_ids()


def run_module(module: Module, registry=None, program=None) -> List[Finding]:
    """The per-file check tier. With ``program``, checks that can use
    the cross-module graph (HS101's hot-region propagation) may emit
    findings in OTHER modules; suppression is then looked up in the
    module that owns the flagged line, not the one being scanned."""
    findings: List[Finding] = []
    for line, bad_id in module.bad_ids:
        findings.append(Finding(
            check=JL_BAD_ID, path=module.rel, line=line, col=0,
            message=f"unknown check ID {bad_id!r} in disable comment "
                    f"(known: {', '.join(sorted(ALL_CHECK_IDS))})",
            source=module.source_line(line)))
    for mod in _checks():
        for f in mod.check(module, registry=registry, program=program):
            # JL000 is deliberately unsuppressable; everything else
            # honors the inline disable comment in its OWN module.
            owner = module
            if program is not None and f.path != module.rel:
                owner = program.by_rel.get(f.path, module)
            if f.check == JL_BAD_ID or not owner.suppressed(f.line, f.check):
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.check))
    return findings


def _parse_module(path: str, repo_root: Optional[str]):
    """(Module, None) or (None, JL001 Finding)."""
    rel = os.path.relpath(path, repo_root) if repo_root else path
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        return Module(path, text, rel), None
    except (SyntaxError, ValueError) as e:
        return None, Finding(
            check=JL_PARSE, path=rel.replace(os.sep, "/"),
            line=getattr(e, "lineno", 0) or 0, col=0,
            message=f"parse error: {e}", source="")


def run_files(paths: Iterable[str], repo_root: Optional[str] = None,
              registry=None,
              context_paths: Optional[Iterable[str]] = None
              ) -> List[Finding]:
    """Analyze the given FILES (no directory expansion — see run_paths).
    Unparseable files produce a JL001 finding instead of crashing the
    run: a syntax error in lint-scope code must fail the gate loudly.

    ``context_paths`` (the CLI passes the canonical target set) are
    parsed INTO the whole-program graph but produce no findings of
    their own — the whole-program tier (SD6xx/DN701/CT8xx) and HS101's
    cross-module propagation need the full program to judge a subset
    run correctly; a context file that fails to parse is silently
    skipped (it fails loudly when it is itself a target)."""
    findings: List[Finding] = []
    modules = []
    target_rels = set()
    seen = set()
    for path in paths:
        seen.add(os.path.abspath(path))
        module, err = _parse_module(path, repo_root)
        if err is not None:
            findings.append(err)
            continue
        modules.append(module)
        target_rels.add(module.rel)
    for path in context_paths or ():
        if os.path.abspath(path) in seen:
            continue
        seen.add(os.path.abspath(path))
        module, err = _parse_module(path, repo_root)
        if module is not None:
            modules.append(module)

    from bert_pytorch_tpu_torch.analysis.graph import Program
    program = Program(modules, target_rels=target_rels)

    for module in modules:
        if module.rel not in target_rels:
            continue
        for f in run_module(module, registry=registry, program=program):
            # Cross-module propagation (HS101) can land a finding in a
            # context-only file; like the program tier below, subset runs
            # report only requested paths (the canonical gate targets
            # every file, so nothing is lost there).
            if f.path in target_rels:
                findings.append(f)
    for mod in _program_checks():
        for f in mod.check_program(program, registry=registry):
            if f.path not in target_rels:
                continue
            owner = program.by_rel.get(f.path)
            if owner is None or not owner.suppressed(f.line, f.check):
                findings.append(f)

    # Cross-module propagation can surface the same finding from two
    # scanning modules: dedupe, then order.
    unique, emitted = [], set()
    for f in findings:
        if f not in emitted:
            emitted.add(f)
            unique.append(f)
    unique.sort(key=lambda f: (f.path, f.line, f.col, f.check))
    return unique


def expand_paths(args: Iterable[str], repo_root: Optional[str] = None
                 ) -> List[str]:
    """Resolve CLI path arguments to a sorted .py file list. Directories
    recurse (skipping __pycache__, build and hidden dirs); a bare name
    that does not exist is retried under ``<repo_root>/bert_pytorch_tpu_
    torch/`` so ``torchlint serve`` means the port's serving subsystem
    from anywhere."""
    files: List[str] = []
    for arg in args:
        path = arg
        if not os.path.exists(path) and repo_root:
            for base in (repo_root, os.path.join(repo_root, PACKAGE)):
                candidate = os.path.join(base, arg)
                if os.path.exists(candidate):
                    path = candidate
                    break
        if os.path.isdir(path):
            for dirpath, dirnames, filenames in os.walk(path):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", "build")
                               and not d.startswith(".")]
                files.extend(os.path.join(dirpath, n)
                             for n in sorted(filenames) if n.endswith(".py"))
        elif os.path.isfile(path):
            files.append(path)
        else:
            raise FileNotFoundError(f"torchlint: no such path: {arg}")
    # De-duplicate while preserving order (the package + serve both
    # naming serve/ files must not double-report).
    seen = set()
    unique = []
    for f in files:
        key = os.path.abspath(f)
        if key not in seen:
            seen.add(key)
            unique.append(f)
    return unique


def run_paths(args: Iterable[str], repo_root: Optional[str] = None,
              registry=None,
              context: Optional[Iterable[str]] = None) -> List[Finding]:
    context_files = None
    if context:
        try:
            context_files = expand_paths(context, repo_root)
        except FileNotFoundError:
            context_files = None  # partial checkouts: lint what exists
    return run_files(expand_paths(args, repo_root), repo_root=repo_root,
                     registry=registry, context_paths=context_files)
