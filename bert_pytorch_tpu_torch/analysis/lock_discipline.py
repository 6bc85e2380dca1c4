"""LK501/LK502/LK503 — enforcement of the port's concurrency registry
(``analysis/concurrency.py``), the JAX package's check unchanged: the
hazards are Python's, not the framework's.

For every registered shared attribute in its owning module:

* **LK501** (kind="lock") — a read or write lexically outside a
  ``with <lock>:`` block. Module-level initialization and ``__init__``
  bodies are implicitly allowed (no second thread can hold a reference
  yet); the entry's ``allow`` tuple names additional functions that are
  documented to run with the lock already held.

* **LK502** (kind="frozen") — any assignment outside ``__init__``.
  Frozen attributes are safe to share precisely because the binding
  never changes; reads are unrestricted.

* **LK503** (kind="confined") — any access inside one of the entry's
  ``forbidden_in`` functions (the targets that run on *other* threads).

The check is lexical, not a race detector: it proves the declared
discipline is followed at every access site, which is exactly the
property review memory fails to hold (an unlocked JSONL sink write, a
stale shared pending-save slot).
"""

from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from bert_pytorch_tpu_torch.analysis.core import Finding, Module

CHECKS = {
    "LK501": "registered shared attribute accessed outside its declared "
             "lock",
    "LK502": "registered frozen attribute reassigned after __init__",
    "LK503": "thread-confined attribute accessed in a forbidden thread "
             "function",
}


def _enclosing(module: Module, node: ast.AST
               ) -> Tuple[Optional[str], Optional[str], List[ast.AST]]:
    """(innermost function name, innermost class name, ancestor chain)."""
    fn = cls = None
    chain = []
    cur = module.parents.get(node)
    while cur is not None:
        chain.append(cur)
        if fn is None and isinstance(cur, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)):
            fn = cur.name
        if cls is None and isinstance(cur, ast.ClassDef):
            cls = cur.name
        cur = module.parents.get(cur)
    return fn, cls, chain


def _lock_names_in_with(item_expr: ast.AST) -> List[str]:
    """Candidate guard names a with-item takes: ``with _lock:`` /
    ``with self._cond:`` / ``with obj.lock:``."""
    names = []
    if isinstance(item_expr, ast.Name):
        names.append(item_expr.id)
    elif isinstance(item_expr, ast.Attribute):
        names.append(item_expr.attr)
    elif isinstance(item_expr, ast.Call):
        # with lock.acquire_timeout(...) style wrappers: use the method's
        # receiver attribute name.
        names.extend(_lock_names_in_with(item_expr.func))
    return names


def _held_locks(chain: List[ast.AST]) -> List[str]:
    held: List[str] = []
    for ancestor in chain:
        if isinstance(ancestor, (ast.With, ast.AsyncWith)):
            for item in ancestor.items:
                held.extend(_lock_names_in_with(item.context_expr))
    return held


def _accesses(module: Module, entry) -> List[Tuple[ast.AST, bool]]:
    """(node, is_store) for every access of the registered attribute."""
    out: List[Tuple[ast.AST, bool]] = []
    for node in module.nodes:
        if entry.cls:
            if isinstance(node, ast.Attribute) and node.attr == entry.attr \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "self":
                out.append((node, isinstance(node.ctx,
                                             (ast.Store, ast.Del))))
        else:
            if isinstance(node, ast.Name) and node.id == entry.attr:
                out.append((node, isinstance(node.ctx,
                                             (ast.Store, ast.Del))))
    return out


def check(module: Module, registry=None, program=None) -> List[Finding]:
    if registry is None:
        from bert_pytorch_tpu_torch.analysis import concurrency
        registry = concurrency.REGISTRY
    entries = [e for e in registry
               if module.rel.endswith(e.module.replace("\\", "/"))]
    findings: List[Finding] = []
    for entry in entries:
        for node, is_store in _accesses(module, entry):
            fn, cls, chain = _enclosing(module, node)
            if entry.cls and cls != entry.cls:
                continue
            if entry.kind == "confined":
                if fn in entry.forbidden_in:
                    findings.append(module.finding(
                        "LK503", node,
                        f"'{entry.attr}' is confined to its owner thread "
                        f"({entry.why}) but is accessed in '{fn}', a "
                        "declared other-thread function"))
                continue
            if entry.kind == "frozen":
                if is_store and fn != "__init__":
                    findings.append(module.finding(
                        "LK502", node,
                        f"'{entry.attr}' is registered frozen "
                        f"({entry.why}); reassigning it outside __init__ "
                        "races every thread reading the binding"))
                continue
            # kind == "lock"
            if fn is None or fn == "__init__" or fn in entry.allow:
                continue
            held = _held_locks(chain)
            if not any(lock in held for lock in entry.locks):
                want = " or ".join(f"'with {name}:'"
                                   for name in entry.locks)
                findings.append(module.finding(
                    "LK501", node,
                    f"'{entry.attr}' ({entry.why}) accessed in '{fn}' "
                    f"outside its guard — wrap the access in {want}"))
    return findings
