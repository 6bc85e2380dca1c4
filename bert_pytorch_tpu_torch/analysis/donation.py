"""DN701 — a buffer read while the card still owns it.

The JAX package's DN701 flags a buffer donated to a jitted call
(``donate_argnums``) and read after it: the call owns the buffer now.
The port has no donation, but it has the same one-way hand-off in two
places, and the same silent failure — reading bytes the device has not
finished writing:

* **async collectives.** ``torch.distributed.<collective>(t, ...,
  async_op=True)`` (and ``isend``/``irecv``, always async) returns a work
  handle; until ``work.wait()`` the collective owns ``t`` — NCCL writes
  the reduced values into it on its own stream. Today's site is the
  bucketed gradient reducer (``parallel/overlap.py`` ``GradReducer.
  _launch_locked``), which hands ``(work, flat, grads)`` to ``finish`` and reads
  ``flat`` only after the wait.
* **non-blocking device->host copies.** ``x.to("cpu",
  non_blocking=True)`` (or ``dst.copy_(x, non_blocking=True)`` into a
  pinned host buffer) returns before the copy lands: the destination
  holds garbage until a stream or event sync (``torch.cuda.
  synchronize()``, ``event.synchronize()``, ``stream.synchronize()``).
  Host->device copies (``pinned.to(device, non_blocking=True)``, the
  device prefetcher and ``pretrain.to_device``) are the card's reads of
  host memory, ordered on the copying stream, and are not flagged.

Lexical, as the JAX check is: for each such call, the first later access
of the owned name in the enclosing function (by line) must be a Store (a
rebind clears the hazard) or come after the wait/sync; a Load before it
is flagged. Handing the reference on without touching its bytes — as an
element of a tuple/list/dict, a ``return``, an alias ``y = x`` — is not a
read (the receiver inherits the duty to wait).
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from bert_pytorch_tpu_torch.analysis.core import Finding, Module
from bert_pytorch_tpu_torch.analysis.graph import Program
from bert_pytorch_tpu_torch.analysis.host_sync import is_host_device

CHECKS = {
    "DN701": "buffer read while the card still owns it (an async_op "
             "collective's tensor before work.wait(), a non-blocking "
             "device->host copy's destination before a sync)",
}

_DIST = "torch.distributed."
# Always-async point-to-point calls (they return a work handle).
_ALWAYS_ASYNC = {"isend", "irecv"}
# Keywords of a collective that are not its tensors.
_NOT_TENSORS = {"group", "op", "async_op", "src", "dst", "group_src",
                "group_dst", "tag", "device_ids"}
_PINNING = {"pin_memory"}


def _is_true(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _enclosing_scope(module: Module, node: ast.AST) -> ast.AST:
    cur = module.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = module.parents.get(cur)
    return module.tree


def _enclosing_statement(module: Module, node: ast.AST) -> ast.AST:
    cur = node
    parent = module.parents.get(cur)
    while parent is not None and not isinstance(parent, ast.stmt):
        cur = parent
        parent = module.parents.get(cur)
    return parent if parent is not None else cur


def _assigned_name(module: Module, call: ast.Call) -> Optional[str]:
    """``name = <call>``: the bound name, else None."""
    parent = module.parents.get(call)
    if isinstance(parent, ast.Assign) and len(parent.targets) == 1 \
            and isinstance(parent.targets[0], ast.Name):
        return parent.targets[0].id
    return None


def _is_handoff(module: Module, load: ast.Name) -> bool:
    """The reference passed on without reading its bytes."""
    parent = module.parents.get(load)
    if isinstance(parent, (ast.Tuple, ast.List, ast.Set, ast.Return,
                           ast.Starred)):
        return True
    if isinstance(parent, ast.Dict) and load in parent.values:
        return True
    return isinstance(parent, ast.Assign) and parent.value is load


def _async_collective(module: Module, call: ast.Call
                      ) -> Optional[Tuple[List[str], Optional[str]]]:
    """(owned tensor names, work-handle name) of an async collective."""
    dotted = module.dotted(call.func) or ""
    if not dotted.startswith(_DIST):
        return None
    name = dotted[len(_DIST):]
    asynchronous = name in _ALWAYS_ASYNC or any(
        kw.arg == "async_op" and _is_true(kw.value) for kw in call.keywords)
    if not asynchronous:
        return None
    owned = [a.id for a in call.args if isinstance(a, ast.Name)]
    owned += [kw.value.id for kw in call.keywords
              if kw.arg not in _NOT_TENSORS and isinstance(kw.value,
                                                           ast.Name)]
    parent = module.parents.get(call)
    if isinstance(parent, ast.Attribute) and parent.attr == "wait":
        return None  # dist.all_reduce(t, async_op=True).wait()
    return owned, _assigned_name(module, call)


def _host_buffers(scope: ast.AST) -> Set[str]:
    """Names bound in ``scope`` to pinned host memory (``pin_memory=True``
    or ``.pin_memory()``): the destinations a non-blocking copy_ fills
    from the card."""
    out: Set[str] = set()
    for node in ast.walk(scope):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Call):
            call = node.value
            pinned = any(kw.arg == "pin_memory" and _is_true(kw.value)
                         for kw in call.keywords) or (
                isinstance(call.func, ast.Attribute)
                and call.func.attr in _PINNING)
            if pinned:
                out.add(node.targets[0].id)
    return out


def _nonblocking_d2h(module: Module, call: ast.Call, pinned: Set[str]
                     ) -> Optional[str]:
    """The destination name of a non-blocking device->host copy."""
    func = call.func
    if not isinstance(func, ast.Attribute) or not any(
            kw.arg == "non_blocking" and _is_true(kw.value)
            for kw in call.keywords):
        return None
    if func.attr == "to":
        targets = list(call.args[:1]) + [kw.value for kw in call.keywords
                                         if kw.arg == "device"]
        if any(is_host_device(module, t) for t in targets):
            return _assigned_name(module, call)
    elif func.attr == "copy_" and isinstance(func.value, ast.Name) \
            and func.value.id in pinned:
        return func.value.id
    return None


def _first_hazard(module: Module, scope: ast.AST, stmt: ast.AST, var: str,
                  cleared_by) -> Optional[ast.Name]:
    """The first read of ``var`` after ``stmt`` (by line) that comes
    before any clearing call (``cleared_by(call) -> bool``) and before a
    rebind; None when there is none."""
    after = max(getattr(stmt, "end_lineno", stmt.lineno) or stmt.lineno,
                stmt.lineno)
    events: List[Tuple[int, int, str, ast.AST]] = []
    for sub in ast.walk(scope):
        line = getattr(sub, "lineno", 0)
        if line <= after:
            continue
        if isinstance(sub, ast.Name) and sub.id == var:
            kind = "store" if isinstance(sub.ctx, (ast.Store, ast.Del)) \
                else ("handoff" if _is_handoff(module, sub) else "read")
            events.append((line, sub.col_offset, kind, sub))
        elif isinstance(sub, ast.Call) and cleared_by(sub):
            events.append((line, sub.col_offset, "clear", sub))
    events.sort(key=lambda e: (e[0], e[1]))
    for _, _, kind, node in events:
        if kind in ("store", "clear"):
            return None
        if kind == "read":
            return node
    return None


def _is_sync(call: ast.Call) -> bool:
    return isinstance(call.func, ast.Attribute) \
        and call.func.attr == "synchronize"


def _check_module(module: Module) -> List[Finding]:
    findings: List[Finding] = []
    pinned_by_scope: dict = {}
    for node in module.nodes:
        if not isinstance(node, ast.Call):
            continue
        hit = _async_collective(module, node)
        nonblocking = any(kw.arg == "non_blocking" and _is_true(kw.value)
                          for kw in node.keywords)
        if hit is None and not nonblocking:
            continue
        scope = _enclosing_scope(module, node)
        stmt = _enclosing_statement(module, node)
        if hit is not None:
            owned, work = hit

            def waited(call, work=work):
                return (isinstance(call.func, ast.Attribute)
                        and call.func.attr == "wait"
                        and (work is None or (
                            isinstance(call.func.value, ast.Name)
                            and call.func.value.id == work)))

            for var in owned:
                load = _first_hazard(module, scope, stmt, var, waited)
                if load is not None:
                    findings.append(module.finding(
                        "DN701", load,
                        f"'{var}' is read while the async "
                        f"'{module.dotted(node.func)}' of line "
                        f"{node.lineno} may still be writing it; read it "
                        f"after {work or 'the work handle'}.wait()"))
            continue
        if id(scope) not in pinned_by_scope:
            pinned_by_scope[id(scope)] = _host_buffers(scope)
        dest = _nonblocking_d2h(module, node, pinned_by_scope[id(scope)])
        if dest is not None:
            load = _first_hazard(module, scope, stmt, dest, _is_sync)
            if load is not None:
                findings.append(module.finding(
                    "DN701", load,
                    f"'{dest}' is read before the non-blocking "
                    f"device->host copy of line {node.lineno} is known to "
                    "have landed; synchronize the stream or an event "
                    "recorded after the copy first"))
    return findings


def check_program(program: Program, registry=None) -> List[Finding]:
    findings: List[Finding] = []
    for module in program.modules:
        if module.rel in program.target_rels:
            findings.extend(_check_module(module))
    return findings
