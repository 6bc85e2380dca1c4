"""TL401 — a tensor still attached to autograd stored on ``self.*`` or a
global inside a forward or a step function.

The JAX package flags a traced value stored on ``self``/a global inside a
jitted function: the stored tracer is stale after the first trace. The
port has no trace, and its hazard is the autograd graph: a tensor that
requires grad holds its ``grad_fn``, and through it every saved
activation of the step. Stored on ``self`` or a module global, it pins
the whole step's graph and activations past the step — the card's memory
high-water mark doubles, and a later ``backward`` through it raises
("Trying to backward through the graph a second time").

Functions scanned (lexically, per module):

* ``forward`` methods (an ``nn.Module``'s forward runs under autograd);
* functions wrapped by ``<monitor>.instrument(fn, ...)`` (the trainers'
  ``CompileMonitor`` / ``TrainTelemetry.instrument`` step functions);
* the body of every ``for ... in tele.timed(...)`` step loop, and the
  functions it calls directly — same-module by name, and, through the
  whole-program graph, imported ones (the finding lands in the defining
  module).

Flagged: ``self.<attr> = value`` / ``+=`` / ``self.<attr>[...] = value``
and assignments to a name declared ``global``, unless the value is
detached from autograd — ``.detach()``, ``.item()``, ``.tolist()`` or
``.numpy()`` in its call chain, a plain constant or an empty container,
a host conversion (``float``/``int``/``bool``/``len``/``str``), a
comparison — or the write sits under ``torch.no_grad()`` /
``torch.inference_mode()`` (a ``with`` block or a decorator).
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Set, Tuple

from bert_pytorch_tpu_torch.analysis.core import Finding, Module
from bert_pytorch_tpu_torch.analysis.host_sync import is_timed_loop

CHECKS = {
    "TL401": "tensor attached to autograd stored on self.*/a global in a "
             "forward or step function (pins the step's graph)",
}

_DETACHING = {"detach", "item", "tolist", "numpy", "detach_"}
_HOST_BUILTINS = {"float", "int", "bool", "len", "str", "repr", "round",
                  "isinstance", "getattr", "hasattr", "id", "type"}
_NO_GRAD = {"torch.no_grad", "torch.inference_mode",
            "torch.autograd.no_grad", "torch.autograd.inference_mode",
            "no_grad", "inference_mode"}


def _detached(module: Module, value: ast.AST) -> bool:
    """True when ``value`` provably holds no autograd graph."""
    if isinstance(value, ast.Constant):
        return True
    if isinstance(value, (ast.Compare, ast.BoolOp)) or (
            isinstance(value, ast.UnaryOp)
            and isinstance(value.op, ast.Not)):
        return True
    if isinstance(value, (ast.List, ast.Tuple, ast.Set)):
        return all(_detached(module, e) for e in value.elts)
    if isinstance(value, ast.Dict):
        return all(v is not None and _detached(module, v)
                   for v in value.values)
    if isinstance(value, ast.JoinedStr):
        return True
    if isinstance(value, ast.IfExp):
        return _detached(module, value.body) \
            and _detached(module, value.orelse)
    if isinstance(value, ast.Call):
        dotted = module.dotted(value.func)
        if dotted in _HOST_BUILTINS:
            return True
        # Walk the method chain: x.float().detach().clone() is detached.
        node = value
        while isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute):
            if node.func.attr in _DETACHING:
                return True
            node = node.func.value
            while isinstance(node, (ast.Attribute, ast.Subscript)):
                node = node.value
    return False


def _under_no_grad(module: Module, node: ast.AST, fn: ast.AST) -> bool:
    cur = module.parents.get(node)
    while cur is not None and cur is not fn:
        if isinstance(cur, (ast.With, ast.AsyncWith)):
            for item in cur.items:
                expr = item.context_expr
                target = expr.func if isinstance(expr, ast.Call) else expr
                if module.dotted(target) in _NO_GRAD:
                    return True
        cur = module.parents.get(cur)
    for dec in getattr(fn, "decorator_list", ()):
        target = dec.func if isinstance(dec, ast.Call) else dec
        if module.dotted(target) in _NO_GRAD:
            return True
    return False


def _walk_scope(root: ast.AST) -> Iterable[ast.AST]:
    """Nodes of ``root`` without descending into nested defs/classes."""
    stack = list(ast.iter_child_nodes(root))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _scan(module: Module, fn: ast.AST, label: str,
          body: Iterable[ast.AST] = None) -> List[Finding]:
    findings: List[Finding] = []
    global_names = {name for node in _walk_scope(fn)
                    if isinstance(node, ast.Global) for name in node.names}
    for node in (body if body is not None else _walk_scope(fn)):
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets, value = [node.target], node.value
        else:
            continue
        if value is None or _detached(module, value):
            continue
        for t in targets:
            leaks = None
            if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                    and t.value.id == "self":
                leaks = f"self.{t.attr}"
            elif isinstance(t, ast.Name) and t.id in global_names:
                leaks = f"global '{t.id}'"
            elif isinstance(t, ast.Subscript):
                base = t.value
                if isinstance(base, ast.Attribute) \
                        and isinstance(base.value, ast.Name) \
                        and base.value.id == "self":
                    leaks = f"self.{base.attr}[...]"
                elif isinstance(base, ast.Name) and base.id in global_names:
                    leaks = f"global '{base.id}[...]'"
            if leaks and not _under_no_grad(module, node, fn):
                findings.append(module.finding(
                    "TL401", node,
                    f"{label} stores a tensor that may still be attached "
                    f"to autograd on {leaks}: it pins the step's graph and "
                    "activations past the step; store .detach() (or "
                    "return the value instead)"))
    return findings


def _scopes(module: Module, program) -> List[Tuple[Module, ast.AST, str,
                                                   object]]:
    """(defining module, function, label, restricted body or None)."""
    defs = {}
    for node in module.nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, node)
    out = []
    for node in module.nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == "forward" \
                and isinstance(module.parents.get(node), ast.ClassDef):
            cls = module.parents[node].name
            out.append((module, node, f"'{cls}.forward'", None))
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "instrument" and node.args \
                and isinstance(node.args[0], ast.Name) \
                and node.args[0].id in defs:
            fn = defs[node.args[0].id]
            out.append((module, fn, f"instrumented '{fn.name}'", None))
        elif is_timed_loop(node):
            owner = module.parents.get(node)
            while owner is not None and not isinstance(
                    owner, (ast.FunctionDef, ast.AsyncFunctionDef)):
                owner = module.parents.get(owner)
            loop_nodes = list(_walk_scope(node))
            if owner is not None:
                out.append((module, owner, "the timed step loop",
                            loop_nodes))
            for call in loop_nodes:
                if not isinstance(call, ast.Call):
                    continue
                dotted = module.dotted(call.func)
                if not dotted or program is None:
                    continue
                hit = program.resolve_function(module, dotted)
                if hit is not None:
                    target, fn = hit
                    out.append((target, fn, f"step-loop callee "
                                f"'{fn.name}'", None))
    return out


def check(module: Module, registry=None, program=None) -> List[Finding]:
    findings: List[Finding] = []
    seen: Set[Finding] = set()
    for owner, fn, label, body in _scopes(module, program):
        for f in _scan(owner, fn, label, body):
            if f not in seen:
                seen.add(f)
                findings.append(f)
    return findings
