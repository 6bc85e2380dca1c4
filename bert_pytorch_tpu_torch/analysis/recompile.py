"""RC201/RC202/RC203 — recompile and rebuild hazards at the port's compile
boundaries and cache-keyed builders.

The JAX package guards ``jax.jit``'s static arguments. The port has two
kinds of boundary where a Python value becomes a cache key, and a fresh
key costs a compile:

* **compiled callables** — ``torch.compile`` and ``torch.jit.script`` /
  ``trace`` (the direct counterpart of ``jax.jit``; the port uses none
  today, so these checks guard future use). ``torch.compile`` guards on
  every Python scalar and container it is called with: a new value
  recompiles (``dynamic=True`` marks the call dynamic, as a jit's
  non-static arguments are);
* **cache-keyed builders** — functions under ``functools.lru_cache`` /
  ``cache``, the kernel library cache of ``ops/kernels/build.py``
  (``load``/``load_bound``/``load_host``/``build_host``, keyed by the
  library name) and the measured geometry registry of
  ``ops/kernels/autotune.py`` (``lookup``/``record_winner``/
  ``name_digest``/``measure``, keyed by ``(kernel, seq, bh)``).

The three checks:

* **RC201** — a *fresh collection* (list/dict/set literal or
  comprehension) at a key position. Unhashable keys raise at best
  (``lru_cache``); a compiled callable guards on the container's length
  and contents, and a rebuilt one misses every call.

* **RC202** — a compiled function closing over *module-level mutable
  state* (a lowercase module global bound to a list/dict/set). The
  compiled graph guards on it: a mutation is a guard failure and then a
  recompile. ALL_CAPS module constants are exempt by convention — the
  name says "never mutated".

* **RC203** — a *numeric Python literal* at a key position. Each
  distinct value is a new cache entry: a new graph for a compiled
  callable, a new build for a builder (for the library cache each
  distinct name is a new ``nvcc`` run). String/bool/None keys are mode
  flags of tiny cardinality and are not flagged.

Call sites are resolved per module (``g = torch.compile(f)`` records g;
decorated defs are handled the same way) and, through the whole-program
graph, to builders defined in other modules.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from bert_pytorch_tpu_torch.analysis.core import Finding, Module

CHECKS = {
    "RC201": "fresh collection at a key position of a compiled callable "
             "or cache-keyed builder (unhashable, or a miss every call)",
    "RC202": "compiled function closes over module-level mutable state",
    "RC203": "numeric Python literal at a key position of a compiled "
             "callable or cache-keyed builder (a new compile per value)",
}

_COMPILE_CALLS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
                  "torch.jit.trace_module"}
_PARTIAL_CALLS = {"functools.partial", "partial"}
_CACHE_DECORATORS = {"functools.lru_cache", "functools.cache", "lru_cache",
                     "cache"}
# (module path suffix, function) -> the parameters that key its cache.
KEYED_BUILDERS: Dict[Tuple[str, str], Tuple[str, ...]] = {
    ("ops/kernels/build.py", "load"): ("name",),
    ("ops/kernels/build.py", "load_bound"): ("name",),
    ("ops/kernels/build.py", "load_host"): ("name",),
    ("ops/kernels/build.py", "build_host"): ("name",),
    ("ops/kernels/autotune.py", "lookup"): ("kernel", "seq", "bh"),
    ("ops/kernels/autotune.py", "record_winner"): ("kernel", "seq", "bh"),
    ("ops/kernels/autotune.py", "name_digest"): ("kernel", "seq", "bh"),
    ("ops/kernels/autotune.py", "measure"): ("kernel", "seq", "bh"),
}
_COLLECTION_NODES = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                     ast.DictComp, ast.SetComp, ast.GeneratorExp)
_MUTABLE_CTORS = {"list", "dict", "set", "collections.defaultdict",
                  "collections.deque", "collections.OrderedDict",
                  "collections.Counter"}


@dataclass
class _KeySig:
    """Which arguments of a call key a cache: positions and names, or
    every argument (``all_args``, a compiled callable)."""
    what: str                          # for messages
    positions: Tuple[int, ...] = ()
    names: Tuple[str, ...] = ()
    all_args: bool = False

    def key_args(self, call: ast.Call) -> List[Tuple[str, ast.AST]]:
        if self.all_args:
            return ([(f"position {i}", a) for i, a in enumerate(call.args)]
                    + [(f"'{kw.arg}'", kw.value) for kw in call.keywords
                       if kw.arg is not None])
        out = [(f"position {i}", call.args[i]) for i in self.positions
               if i < len(call.args)]
        out += [(f"'{kw.arg}'", kw.value) for kw in call.keywords
                if kw.arg in self.names]
        return out


def _params(fn: ast.AST) -> Tuple[str, ...]:
    """The positional parameters a caller passes (a method's receiver
    left out)."""
    sig = fn.args
    params = tuple(a.arg for a in sig.posonlyargs + sig.args)
    if params and params[0] in ("self", "cls"):
        params = params[1:]
    return params


def _sig_for_params(fn: ast.AST, keys: Tuple[str, ...], what: str
                    ) -> _KeySig:
    params = _params(fn)
    return _KeySig(what=what,
                   positions=tuple(params.index(k) for k in keys
                                   if k in params),
                   names=keys)


def _is_compile_call(module: Module, call: ast.Call) -> bool:
    dotted = module.dotted(call.func)
    if dotted in _COMPILE_CALLS:
        return True
    # partial(torch.compile, ...) — the decorator idiom.
    return dotted in _PARTIAL_CALLS and bool(call.args) \
        and module.dotted(call.args[0]) in _COMPILE_CALLS


def _dynamic(call: ast.Call) -> bool:
    """``torch.compile(..., dynamic=True)``: scalars are symbolic, not
    guarded on."""
    return any(kw.arg == "dynamic" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in call.keywords)


def _is_cache_decorated(module: Module, fn: ast.AST) -> bool:
    for dec in getattr(fn, "decorator_list", ()):
        target = dec.func if isinstance(dec, ast.Call) else dec
        if module.dotted(target) in _CACHE_DECORATORS:
            return True
    return False


def _builder_sig(module: Module, fn: ast.AST) -> Optional[_KeySig]:
    """The key signature of a def: a known builder of the port, or any
    lru_cache/cache function (every parameter keys it)."""
    for (suffix, name), keys in KEYED_BUILDERS.items():
        if fn.name == name and module.rel.endswith(suffix):
            return _sig_for_params(fn, keys, "cache-keyed builder")
    if _is_cache_decorated(module, fn):
        params = _params(fn)
        return _KeySig(what="cached function",
                       positions=tuple(range(len(params))), names=params)
    return None


class _State:
    def __init__(self, module: Module):
        self.module = module
        # name -> key signature, for names bound to a compiled callable.
        self.compiled_names: Dict[str, _KeySig] = {}
        # FunctionDefs / lambdas compiled (decorated, or passed by name).
        self.compiled_fns: List[ast.AST] = []
        self.compiled_lambdas: List[ast.Lambda] = []
        # lowercase module-level names bound to mutable collections.
        self.mutable_globals: Set[str] = set()


def _collect(module: Module) -> _State:
    state = _State(module)
    fn_defs = {n.name: n for n in module.nodes
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}

    for stmt in module.tree.body:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            value = stmt.value
            if value is None:
                continue
            is_mutable = isinstance(value, _COLLECTION_NODES) or (
                isinstance(value, ast.Call)
                and module.dotted(value.func) in _MUTABLE_CTORS)
            if is_mutable:
                for t in targets:
                    if isinstance(t, ast.Name) and not t.id.isupper():
                        state.mutable_globals.add(t.id)

    for node in module.nodes:
        if isinstance(node, ast.Call) and _is_compile_call(module, node) \
                and module.dotted(node.func) not in _PARTIAL_CALLS:
            wrapped = node.args[0] if node.args else None
            if isinstance(wrapped, ast.Name) and wrapped.id in fn_defs:
                state.compiled_fns.append(fn_defs[wrapped.id])
            if isinstance(wrapped, ast.Lambda):
                state.compiled_lambdas.append(wrapped)
            sig = None if _dynamic(node) else _KeySig(
                what="compiled callable", all_args=True)
            parent = module.parents.get(node)
            # name = torch.compile(f, ...), or through one wrapper call
            # (tele.instrument(torch.compile(f), "name")).
            for holder in (parent, module.parents.get(parent)
                           if isinstance(parent, ast.Call) else None):
                if isinstance(holder, ast.Assign) \
                        and len(holder.targets) == 1 \
                        and isinstance(holder.targets[0], ast.Name) \
                        and sig is not None:
                    state.compiled_names[holder.targets[0].id] = sig
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if module.dotted(dec) in _COMPILE_CALLS:
                    state.compiled_fns.append(node)
                    state.compiled_names[node.name] = _KeySig(
                        what="compiled callable", all_args=True)
                elif isinstance(dec, ast.Call) \
                        and _is_compile_call(module, dec):
                    state.compiled_fns.append(node)
                    if not _dynamic(dec):
                        state.compiled_names[node.name] = _KeySig(
                            what="compiled callable", all_args=True)
    return state


def _call_sig(state: _State, node: ast.Call, program) -> Optional[
        Tuple[str, _KeySig]]:
    """(callee label, key signature) of a call, or None."""
    module = state.module
    if isinstance(node.func, ast.Name) \
            and node.func.id in state.compiled_names:
        return node.func.id, state.compiled_names[node.func.id]
    dotted = module.dotted(node.func)
    if not dotted or program is None:
        return None
    hit = program.resolve_function(module, dotted)
    if hit is None:
        return None
    target, fn = hit
    sig = _builder_sig(target, fn)
    return (fn.name, sig) if sig is not None else None


def _check_call_sites(state: _State, program=None) -> List[Finding]:
    module = state.module
    findings: List[Finding] = []
    for node in module.nodes:
        if not isinstance(node, ast.Call):
            continue
        found = _call_sig(state, node, program)
        if found is None:
            continue
        label, sig = found
        for where, arg in sig.key_args(node):
            if isinstance(arg, _COLLECTION_NODES):
                findings.append(module.finding(
                    "RC201", arg,
                    f"fresh collection at key {where} of {sig.what} "
                    f"'{label}': an unhashable key raises, a rebuilt one "
                    "misses the cache every call; pass a tuple or a "
                    "module constant"))
            elif isinstance(arg, ast.Constant) \
                    and isinstance(arg.value, (int, float)) \
                    and not isinstance(arg.value, bool):
                findings.append(module.finding(
                    "RC203", arg,
                    f"numeric literal {arg.value!r} at key {where} of "
                    f"{sig.what} '{label}' is a new cache entry per value "
                    "(a recompile, or a rebuild); pass it as a tensor "
                    "or hoist it into the function"))
    return findings


def _check_closures(state: _State) -> List[Finding]:
    module = state.module
    findings: List[Finding] = []
    if not state.mutable_globals:
        return findings

    def scan(fn_node: ast.AST, name: str) -> None:
        # Names rebound locally shadow the module global.
        local: Set[str] = set()
        for sub in ast.walk(fn_node):
            if isinstance(sub, ast.arg):
                local.add(sub.arg)
            elif isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Store):
                local.add(sub.id)
        for sub in ast.walk(fn_node):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load) \
                    and sub.id in state.mutable_globals \
                    and sub.id not in local:
                findings.append(module.finding(
                    "RC202", sub,
                    f"compiled {name} reads module-level mutable "
                    f"'{sub.id}': the compiled graph guards on it (a "
                    "mutation is a guard failure and a recompile); pass "
                    "it as an argument or make it an ALL_CAPS constant"))

    for fn in state.compiled_fns:
        scan(fn, f"function '{fn.name}'")
    for lam in state.compiled_lambdas:
        scan(lam, "lambda")
    return findings


def check(module: Module, registry=None, program=None) -> List[Finding]:
    state = _collect(module)
    return _check_call_sites(state, program) + _check_closures(state)
