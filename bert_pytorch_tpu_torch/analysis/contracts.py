"""CT801/CT802 — cross-module contract drift.

Two contracts in this codebase span modules and were previously held by
review memory only:

* **CT801** telemetry kinds: every record the sinks write carries a
  ``kind`` that selects its required-key set in
  ``telemetry/schema.py KIND_REQUIRED_KEYS``. The schema lint catches
  an off-registry kind only AFTER a run produced the artifact; this
  check catches it at the emit site. Statically extracted emit sites:
  dict literals with a ``"kind"`` key and ``record["kind"] = "..."``
  assignments, anywhere in the program; the registry is read by PARSING
  the program's ``telemetry/schema.py`` (never importing it), so the
  check follows whatever the schema module actually declares. Skipped
  entirely when no schema module is in the program (single-file fixture
  runs).

* **CT802** argparse flags: a flag declared but never read is dead
  weight that misleads operators ("I set it and nothing changed"); a
  namespace attribute read but never declared is an AttributeError
  waiting for the first caller that exercises the path. Declarations =
  every ``add_argument``/``add_subparsers`` dest in the program (first
  long option, argparse's dash-to-underscore mapping, explicit
  ``dest=``); reads = ``args.<dest>`` loads, ``getattr(args, "<dest>"
  [, default])``, f-string getattrs matched as patterns
  (``getattr(args, f"{task}_checkpoint")`` reads every
  ``*_checkpoint`` dest), plus — deliberately lenient — any bare string
  literal equal to the dest elsewhere in the program (config-file key
  lists, ``require_args([...])``). ``args.<x> = ...`` stores count as
  programmatic declarations. A fully dynamic ``getattr(args, var)`` or
  ``vars(args)`` anywhere disables only the declared-but-never-read
  direction (it could read anything); read-but-never-declared keeps
  working.

Both checks are only meaningful whole-program; the CLI therefore parses
the canonical target set as context even for subset runs (findings are
still reported only for the requested files).
"""

from __future__ import annotations

import ast
import fnmatch
from typing import Dict, List, Optional, Set, Tuple

from bert_pytorch_tpu_torch.analysis.core import Finding, Module
from bert_pytorch_tpu_torch.analysis.graph import Program

CHECKS = {
    "CT801": "telemetry record kind not registered in telemetry/schema.py "
             "KIND_REQUIRED_KEYS",
    "CT802": "argparse flag declared but never read, or namespace "
             "attribute read but never declared",
}

_SCHEMA_SUFFIX = "telemetry/schema.py"
_NAMESPACE_NAMES = ("args",)
# Namespace attributes that are argparse/stdlib machinery, not flags.
_NAMESPACE_INTERNAL = {"__dict__", "__class__"}


# -- CT801 ----------------------------------------------------------------

def _registered_kinds(program: Program) -> Optional[Set[str]]:
    """Keys of KIND_REQUIRED_KEYS across every schema module in the
    program (fixtures bring their own mini schema next to the real one);
    None when the program holds no schema module at all."""
    kinds: Optional[Set[str]] = None
    for module in program.modules:
        if not module.rel.endswith(_SCHEMA_SUFFIX):
            continue
        for stmt in module.tree.body:
            if isinstance(stmt, ast.Assign) \
                    and any(isinstance(t, ast.Name)
                            and t.id == "KIND_REQUIRED_KEYS"
                            for t in stmt.targets) \
                    and isinstance(stmt.value, ast.Dict):
                kinds = set() if kinds is None else kinds
                kinds |= {k.value for k in stmt.value.keys
                          if isinstance(k, ast.Constant)
                          and isinstance(k.value, str)}
    return kinds


def _emit_sites(module: Module) -> List[Tuple[ast.AST, str]]:
    sites: List[Tuple[ast.AST, str]] = []
    for node in module.nodes:
        if isinstance(node, ast.Dict):
            for key, value in zip(node.keys, node.values):
                if isinstance(key, ast.Constant) and key.value == "kind" \
                        and isinstance(value, ast.Constant) \
                        and isinstance(value.value, str):
                    sites.append((value, value.value))
        elif isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            for t in node.targets:
                if isinstance(t, ast.Subscript) \
                        and isinstance(t.slice, ast.Constant) \
                        and t.slice.value == "kind":
                    sites.append((node.value, node.value.value))
    return sites


def _check_kinds(program: Program) -> List[Finding]:
    kinds = _registered_kinds(program)
    if kinds is None:
        return []
    findings: List[Finding] = []
    for module in program.modules:
        if module.rel not in program.target_rels \
                or module.rel.endswith(_SCHEMA_SUFFIX):
            continue
        for node, kind in _emit_sites(module):
            if kind not in kinds:
                findings.append(module.finding(
                    "CT801", node,
                    f"record kind '{kind}' is not registered in "
                    "telemetry/schema.py KIND_REQUIRED_KEYS — the "
                    "schema lint will reject the artifact this emits; "
                    "register the kind (with its required keys) first"))
    return findings


# -- CT802 ----------------------------------------------------------------

def _dest_of_add_argument(call: ast.Call) -> Optional[Tuple[str, bool]]:
    """(dest, is_flag) for an add_argument call with literal options;
    None when the options are dynamic. argparse semantics: explicit
    dest= wins, else the first long option, else the first option."""
    for kw in call.keywords:
        if kw.arg == "dest":
            if isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                return kw.value.value, True
            return None
    options = [a.value for a in call.args
               if isinstance(a, ast.Constant) and isinstance(a.value, str)]
    if not options:
        return None
    flags = [o for o in options if o.startswith("-")]
    if not flags:
        return options[0], False  # positional: dest is the name itself
    long_flags = [o for o in flags if o.startswith("--")]
    chosen = (long_flags or flags)[0].lstrip("-")
    return chosen.replace("-", "_"), True


class _FlagScan:
    def __init__(self) -> None:
        self.declared: Dict[str, Tuple[Module, ast.AST, bool]] = {}
        self.read: Set[str] = set()
        self.read_sites: List[Tuple[Module, ast.AST, str]] = []
        self.stored: Set[str] = set()
        self.literals: Set[str] = set()
        self.patterns: Set[str] = set()
        self.wildcard_read = False


def _scan_module(module: Module, scan: _FlagScan) -> None:
    # A declaration's own strings (options, help text) are not read
    # evidence for itself; ast.walk visits parents first, so the skip
    # set is filled before its constants are reached.
    skip_literals: Set[int] = set()
    for node in module.nodes:
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) \
                    and func.attr in ("add_argument", "add_subparsers"):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Constant):
                        skip_literals.add(id(sub))
                hit = _dest_of_add_argument(node) \
                    if func.attr == "add_argument" else None
                if func.attr == "add_subparsers":
                    for kw in node.keywords:
                        if kw.arg == "dest" \
                                and isinstance(kw.value, ast.Constant):
                            hit = (kw.value.value, True)
                if hit is not None:
                    dest, is_flag = hit
                    scan.declared.setdefault(dest, (module, node, is_flag))
            elif isinstance(func, ast.Name) and func.id == "getattr" \
                    and node.args and isinstance(node.args[0], ast.Name) \
                    and node.args[0].id in _NAMESPACE_NAMES \
                    and len(node.args) >= 2:
                key = node.args[1]
                if isinstance(key, ast.Constant) \
                        and isinstance(key.value, str):
                    scan.read.add(key.value)
                elif isinstance(key, ast.JoinedStr):
                    pattern = "".join(
                        v.value if isinstance(v, ast.Constant) else "*"
                        for v in key.values)
                    scan.patterns.add(pattern)
                elif len(node.args) == 2:
                    # A dynamic 2-arg getattr could be the sole reader
                    # of anything: soundness requires the wildcard. The
                    # 3-arg form tolerates absence and its name always
                    # originates from a literal somewhere (require_args
                    # lists, config-file key tables) that the literal
                    # evidence below already credits.
                    scan.wildcard_read = True
            elif isinstance(func, ast.Name) and func.id == "vars" \
                    and node.args and isinstance(node.args[0], ast.Name) \
                    and node.args[0].id in _NAMESPACE_NAMES:
                scan.wildcard_read = True
        elif isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id in _NAMESPACE_NAMES \
                and node.attr not in _NAMESPACE_INTERNAL:
            if isinstance(node.ctx, ast.Load):
                scan.read.add(node.attr)
                scan.read_sites.append((module, node, node.attr))
            else:
                scan.stored.add(node.attr)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in skip_literals:
            scan.literals.add(node.value)


def _check_flags(program: Program) -> List[Finding]:
    scan = _FlagScan()
    for module in program.modules:
        _scan_module(module, scan)

    findings: List[Finding] = []
    if not scan.wildcard_read:
        for dest, (module, node, is_flag) in sorted(scan.declared.items()):
            if module.rel not in program.target_rels:
                continue
            if dest in scan.read or dest in scan.stored:
                continue
            # Lenient literal evidence: the dest named anywhere else
            # (require_args lists, config-file key tables, subprocess
            # command lines passing the flag spelling) counts.
            if dest in scan.literals or f"--{dest}" in scan.literals:
                continue
            if any(fnmatch.fnmatchcase(dest, p) for p in scan.patterns):
                continue
            spelled = f"--{dest}" if is_flag else dest
            findings.append(module.finding(
                "CT802", node,
                f"flag '{spelled}' is declared but its value is never "
                "read anywhere in the program — wire it up or delete "
                "it (a knob that does nothing misleads operators)"))
    if not scan.declared:
        # No argparse anywhere in the program: 'args' is then just a
        # conventional parameter name of unknown type (fixtures,
        # out-of-repo runs) and the read direction has no registry to
        # judge against.
        return findings
    declared_or_stored = set(scan.declared) | scan.stored
    for module, node, attr in scan.read_sites:
        if module.rel not in program.target_rels:
            continue
        if attr in declared_or_stored:
            continue
        findings.append(module.finding(
            "CT802", node,
            f"'args.{attr}' is read but no parser in the program "
            "declares it (and nothing assigns it) — an AttributeError "
            "waiting for the first caller on this path"))
    return findings


def check_program(program: Program, registry=None) -> List[Finding]:
    return _check_kinds(program) + _check_flags(program)
