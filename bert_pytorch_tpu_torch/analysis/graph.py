"""Whole-program model: the cross-module symbol/call graph behind the
whole-program tier (SD6xx/DN701/CT8xx) and HS101's cross-module
hot-region propagation — the JAX package's ``analysis/graph.py`` over the
port's dotted module names (``bert_pytorch_tpu_torch.parallel.mesh``).

The per-file tier judges one file at a time; that is the right altitude
for lexical hazards (a ``.item()`` in a loop body) but blind to the
contracts that span modules: an axis constant imported from
``parallel/mesh.py``, a telemetry ``kind`` emitted three packages away
from the schema that registers it, a CLI flag declared in
``telemetry/cli.py`` and read in a runner. :class:`Program` is the
second tier's shared substrate — every target (and context) file parsed
ONCE, keyed by both repo-relative path and dotted module name, with
conservative resolution helpers:

* :meth:`Program.resolve_function` — a called name to the
  ``(Module, FunctionDef)`` that defines it, through ``from X import f``
  aliases and ``pkg.mod.f`` attribute chains;
* :meth:`Program.resolve_constant` — a name to the module-level
  assignment that binds it, ditto;
* :func:`resolve_strings` — an expression to the set of string literals
  it statically denotes (literal, tuple/list/set/frozenset of literals,
  a local or module-level constant, or an imported constant), or None
  when the value is dynamic. Checks SKIP dynamic values: this tier
  proves what is statically knowable and stays silent about the rest.

Everything stdlib-only, like the whole analysis package: the graph is
built from ASTs, never from imports.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from bert_pytorch_tpu_torch.analysis.core import Module


def module_name(rel: str) -> Optional[str]:
    """Dotted module name of a repo-relative path: parallel/mesh.py under
    bert_pytorch_tpu_torch -> 'bert_pytorch_tpu_torch.parallel.mesh';
    chip_smoke.py -> 'chip_smoke'; a package __init__.py names the
    package itself."""
    if not rel.endswith(".py"):
        return None
    parts = rel[:-3].replace("\\", "/").split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    if not parts or not all(p.isidentifier() for p in parts):
        return None
    return ".".join(parts)


class Program:
    """All parsed modules of one analysis run (targets + context)."""

    def __init__(self, modules: List[Module],
                 target_rels: Optional[Set[str]] = None):
        self.modules = list(modules)
        self.by_rel: Dict[str, Module] = {m.rel: m for m in self.modules}
        self.target_rels: Set[str] = (
            set(target_rels) if target_rels is not None
            else set(self.by_rel))
        self.by_name: Dict[str, Module] = {}
        for m in self.modules:
            name = module_name(m.rel)
            if name and name not in self.by_name:  # first wins on collisions
                self.by_name[name] = m
        # Per-module def/constant tables, built lazily.
        self._defs: Dict[str, Dict[str, ast.AST]] = {}
        self._consts: Dict[str, Dict[str, ast.AST]] = {}

    # -- per-module symbol tables ---------------------------------------

    def defs_of(self, module: Module) -> Dict[str, ast.AST]:
        """Function defs anywhere in the module, by name (last wins —
        matches runtime rebinding closely enough for a lint)."""
        table = self._defs.get(module.rel)
        if table is None:
            table = {}
            for node in module.nodes:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    table[node.name] = node
            self._defs[module.rel] = table
        return table

    def consts_of(self, module: Module) -> Dict[str, ast.AST]:
        """Module-level ``NAME = <value>`` bindings, by name."""
        table = self._consts.get(module.rel)
        if table is None:
            table = {}
            for stmt in module.tree.body:
                if isinstance(stmt, ast.Assign):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            table[t.id] = stmt.value
                elif isinstance(stmt, ast.AnnAssign) \
                        and isinstance(stmt.target, ast.Name) \
                        and stmt.value is not None:
                    table[stmt.target.id] = stmt.value
            self._consts[module.rel] = table
        return table

    # -- cross-module resolution ----------------------------------------

    def _split_dotted(self, dotted: str
                      ) -> Optional[Tuple[Module, str]]:
        """'pkg.mod.symbol' -> (Module for pkg.mod, 'symbol'), by longest
        known-module prefix; None when no prefix parses to a module we
        hold or the remainder is not a single attribute."""
        parts = dotted.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            mod = self.by_name.get(".".join(parts[:cut]))
            if mod is not None:
                rest = parts[cut:]
                if len(rest) == 1:
                    return mod, rest[0]
                return None
        return None

    def resolve_function(self, module: Module, dotted: str
                         ) -> Optional[Tuple[Module, ast.AST]]:
        """The (defining module, FunctionDef) a dotted callable name
        denotes — same-module first, then through imports."""
        if "." not in dotted:
            fn = self.defs_of(module).get(dotted)
            if fn is not None:
                return module, fn
            dotted = module.aliases.get(dotted, dotted)
            if "." not in dotted:
                return None
        hit = self._split_dotted(dotted)
        if hit is None:
            return None
        target, symbol = hit
        fn = self.defs_of(target).get(symbol)
        # Only top-level defs are importable symbols.
        if fn is not None and isinstance(
                target.parents.get(fn), ast.Module):
            return target, fn
        return None

    def resolve_constant(self, module: Module, name: str
                         ) -> Optional[Tuple[Module, ast.AST]]:
        """The (defining module, value node) a name denotes as a
        module-level constant — locally, or through an import alias."""
        value = self.consts_of(module).get(name)
        if value is not None:
            return module, value
        dotted = module.aliases.get(name)
        if not dotted or "." not in dotted:
            return None
        hit = self._split_dotted(dotted)
        if hit is None:
            return None
        target, symbol = hit
        value = self.consts_of(target).get(symbol)
        if value is not None:
            return target, value
        return None


def _enclosing_functions(module: Module, node: ast.AST) -> List[ast.AST]:
    chain = []
    cur = module.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            chain.append(cur)
        cur = module.parents.get(cur)
    return chain


def _local_assignment(fn: ast.AST, name: str) -> Optional[ast.AST]:
    """The value of a simple ``name = <expr>`` assignment inside ``fn``
    (last one wins); None when the name is rebound in ways we cannot
    follow (aug-assign, tuple targets)."""
    value = None
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Assign):
            for t in sub.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    value = sub.value
    return value


def resolve_strings(program: Optional[Program], module: Module,
                    node: ast.AST, at: Optional[ast.AST] = None,
                    _depth: int = 0) -> Optional[Set[str]]:
    """The set of string literals ``node`` statically denotes, or None
    when any part is dynamic. ``at`` anchors Name lookups: enclosing
    function locals first, then module constants, then imports."""
    if _depth > 6:
        return None
    if isinstance(node, ast.Constant):
        return {node.value} if isinstance(node.value, str) else None
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out: Set[str] = set()
        for elt in node.elts:
            sub = resolve_strings(program, module, elt, at, _depth + 1)
            if sub is None:
                return None
            out |= sub
        return out
    if isinstance(node, ast.Call):
        # frozenset({...}) / set((...)) / tuple([...]) wrappers.
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in (
                "frozenset", "set", "tuple", "list") and len(node.args) == 1 \
                and not node.keywords:
            return resolve_strings(program, module, node.args[0], at,
                                   _depth + 1)
        return None
    if isinstance(node, ast.Name):
        anchor = at if at is not None else node
        for fn in _enclosing_functions(module, anchor):
            value = _local_assignment(fn, node.id)
            if value is not None:
                return resolve_strings(program, module, value, at,
                                       _depth + 1)
            if any(a.arg == node.id for a in
                   list(fn.args.args) + list(fn.args.kwonlyargs)
                   + list(fn.args.posonlyargs)):
                return None  # a parameter (lambdas included): dynamic
        if program is not None:
            hit = program.resolve_constant(module, node.id)
            if hit is not None:
                target, value = hit
                return resolve_strings(program, target, value, None,
                                       _depth + 1)
        else:
            value = None
            for stmt in module.tree.body:
                if isinstance(stmt, ast.Assign):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name) and t.id == node.id:
                            value = stmt.value
            if value is not None:
                return resolve_strings(program, module, value, None,
                                       _depth + 1)
        return None
    return None
