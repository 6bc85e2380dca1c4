"""HS101 — blocking device->host syncs in step-loop hot paths.

The port's step loops dispatch work to the card and let telemetry own
the device sync at a declared cadence (``TrainTelemetry.step_done``:
``StepTimer.should_sync``, then ``last_step_synced`` for the runner). One
stray ``.item()`` / ``float(loss)`` / ``.cpu()`` on a CUDA tensor inside
the step loop silently makes the host wait for the card EVERY step — the
failure mode the step timer can only observe after the fact.

**What is hot.** Purely lexical, as in the JAX package's check:

* the body of any ``for`` loop iterating ``...tele.timed(...)`` — the
  canonical step loop of the five trainers;
* any function whose ``def`` line (or the line above) carries a
  ``# torchlint: hot`` marker;
* transitively: any function called from a non-exempt hot statement —
  same-module bare-name calls, and, through the whole-program graph,
  functions IMPORTED from another module (the finding lands in the
  helper's file, honoring ITS suppression comments).

**Declared sync-cadence sites** (exempt — the body only; the test still
runs per step and is scanned):

* ``if`` blocks whose test references one of the telemetry facade's
  cadence gates, :data:`_SYNC_GATES` (``last_step_synced`` /
  ``should_sync``, read off ``telemetry/runner.py``; a test pins the two
  together);
* ``if`` blocks whose test contains a ``%`` cadence gate
  (``global_step % args.log_steps == 0`` — amortized by construction);
* ``if`` blocks testing equality against an integer literal
  (``if step_in_run == 1:`` — a once-per-run warmup gate).

**What is flagged** inside non-exempt hot code:

* ``x.item()``, ``x.tolist()``, ``x.cpu()``, ``x.numpy()``;
* ``x.to("cpu")`` / ``x.to(device="cpu")`` (and ``.cpu()``) without
  ``non_blocking=True``;
* ``torch.cuda.synchronize()``, ``event.synchronize()``,
  ``stream.synchronize()`` — any ``.synchronize()``;
* ``numpy.asarray(...)`` / ``numpy.array(...)`` (of a tensor: a copy to
  the host);
* ``float(x)`` / ``int(x)`` / ``bool(x)`` unless ``x`` is host-known: a
  constant, arithmetic over constants, ``len(...)``, shape metadata
  (``.shape``/``.ndim``, ``.size()``/``.dim()``/``.numel()``), wall-clock
  calls, or an ``args.*`` attribute (argparse values).

False positives on genuinely-host values (a CPU generator's draw, a
numpy mask) are expected occasionally; that is what ``# torchlint:
disable=HS101`` with a justifying comment is for — the suppression
documents the host-ness.
"""

from __future__ import annotations

import ast
from typing import List, Set

from bert_pytorch_tpu_torch.analysis.core import Finding, Module

CHECKS = {
    "HS101": "blocking device->host sync (.item/.cpu/float(tensor)/"
             "np.asarray/synchronize) in a step-loop hot path",
}

# Dotted callables that force a device->host copy or a sync.
_SYNC_CALLS = {"numpy.asarray", "numpy.array", "torch.cuda.synchronize"}
# Method names that sync regardless of receiver spelling.
_SYNC_METHODS = {"item", "tolist", "numpy", "synchronize"}
# Methods that copy to the host unless told ``non_blocking=True``.
_COPY_METHODS = {"cpu", "to"}
# Names whose appearance in an if-test declares a sync-cadence site: the
# telemetry facade's (telemetry/runner.py TrainTelemetry.last_step_synced,
# telemetry/step_timer.py StepTimer.should_sync).
_SYNC_GATES = {"last_step_synced", "should_sync"}
# Host-only callables float()/int() may safely wrap.
_HOST_CALLS = {"len", "round", "min", "max", "abs", "time.time",
               "time.perf_counter", "time.monotonic", "time.time_ns"}
_HOST_ATTRS = {"shape", "ndim"}
# Shape-metadata methods of a tensor: answered on the host.
_HOST_METHODS = {"size", "dim", "numel", "element_size", "nelement",
                 "get_device", "is_contiguous"}
# Conversions that block on a device value.
_CONVERSIONS = ("float", "int", "bool")


def _is_exempt_test(test: ast.AST) -> bool:
    for node in ast.walk(test):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
            return True
        if isinstance(node, ast.Name) and node.id in _SYNC_GATES:
            return True
        if isinstance(node, ast.Attribute) and node.attr in _SYNC_GATES:
            return True
        if (isinstance(node, ast.Compare)
                and len(node.ops) == 1 and isinstance(node.ops[0], ast.Eq)
                and any(isinstance(c, ast.Constant)
                        and isinstance(c.value, int)
                        for c in node.comparators)):
            return True
    return False


def _host_safe(module: Module, node: ast.AST) -> bool:
    """Conservatively: True only when the expression provably lives on
    the host (so float()/int() of it is free)."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.UnaryOp):
        return _host_safe(module, node.operand)
    if isinstance(node, ast.BinOp):
        return _host_safe(module, node.left) and _host_safe(module, node.right)
    if isinstance(node, ast.BoolOp):
        return all(_host_safe(module, v) for v in node.values)
    if isinstance(node, ast.IfExp):
        return (_host_safe(module, node.body)
                and _host_safe(module, node.orelse))
    if isinstance(node, ast.Subscript):
        return _host_safe(module, node.value)
    if isinstance(node, ast.Attribute):
        if node.attr in _HOST_ATTRS:
            return True
        dotted = module.dotted(node)
        # argparse namespaces hold parsed host scalars.
        return bool(dotted) and dotted.split(".")[0] in ("args", "self_args")
    if isinstance(node, ast.Call):
        dotted = module.dotted(node.func)
        if dotted == "len":
            return True
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _HOST_METHODS:
            return True
        if dotted in _HOST_CALLS:
            return all(_host_safe(module, a) for a in node.args)
    return False


def is_host_device(module: Module, node: ast.AST) -> bool:
    """``"cpu"`` / ``torch.device("cpu")`` (the host as a copy target)."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.startswith("cpu")
    if isinstance(node, ast.Call) and module.dotted(node.func) \
            == "torch.device" and node.args:
        return is_host_device(module, node.args[0])
    return False


def _blocking_copy_to_host(module: Module, call: ast.Call) -> bool:
    """``x.cpu()`` / ``x.to("cpu")`` / ``x.to(device="cpu")`` without
    ``non_blocking=True`` (which makes the copy asynchronous: DN701 then
    guards its destination)."""
    func = call.func
    if not isinstance(func, ast.Attribute) or func.attr not in _COPY_METHODS:
        return False
    for kw in call.keywords:
        if kw.arg == "non_blocking" and not (
                isinstance(kw.value, ast.Constant) and not kw.value.value):
            return False
    if func.attr == "cpu":
        return not call.args
    targets = list(call.args[:1]) + [kw.value for kw in call.keywords
                                     if kw.arg == "device"]
    return any(is_host_device(module, t) for t in targets)


def _function_defs(module: Module) -> dict:
    defs: dict = {}
    for node in module.nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # Last definition wins on name collisions — matches runtime
            # rebinding closely enough for a lint.
            defs[node.name] = node
    return defs


def is_timed_loop(node: ast.AST) -> bool:
    if not isinstance(node, ast.For):
        return False
    for sub in ast.walk(node.iter):
        if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "timed"):
            return True
    return False


class _HotScanner:
    """Scans one module's hot regions; with ``program``, hotness
    propagates through imports — the scan queue carries (module, fn)
    pairs and findings land in the defining module."""

    def __init__(self, module: Module, program=None):
        self.root = module
        self.program = program
        self._defs_cache: dict = {}
        self.findings: List[Finding] = []
        self._scanned: Set[tuple] = set()
        self._pending: List[tuple] = []  # (Module, FunctionDef)

    def _defs(self, module: Module) -> dict:
        if self.program is not None:
            # Same last-def-wins table, cached program-wide instead of
            # per scanner (one _HotScanner is built per target module).
            return self.program.defs_of(module)
        defs = self._defs_cache.get(module.rel)
        if defs is None:
            defs = _function_defs(module)
            self._defs_cache[module.rel] = defs
        return defs

    def run(self) -> List[Finding]:
        module = self.root
        for node in module.nodes:
            if is_timed_loop(node):
                self._scan_stmts(module, node.body)
        for name, fn in self._defs(module).items():
            marker_lines = {fn.lineno, fn.lineno - 1}
            if fn.decorator_list:
                marker_lines.add(fn.decorator_list[0].lineno - 1)
            if marker_lines & module.hot_lines:
                self._queue_local(module, name)
        while self._pending:
            mod, fn = self._pending.pop()
            self._scan_stmts(mod, fn.body)
        return self.findings

    def _queue_local(self, module: Module, name: str) -> None:
        fn = self._defs(module).get(name)
        if fn is not None:
            self._queue(module, name, fn)
            return
        # Not defined here: resolve through the program graph (imported
        # helpers called from a hot loop are hot regions too).
        if self.program is not None:
            hit = self.program.resolve_function(module, name)
            if hit is not None:
                target, target_fn = hit
                self._queue(target, getattr(target_fn, "name", name),
                            target_fn)

    def _queue(self, module: Module, name: str, fn) -> None:
        key = (module.rel, name)
        if key not in self._scanned:
            self._scanned.add(key)
            self._pending.append((module, fn))

    def _scan_stmts(self, module: Module, stmts: List[ast.stmt]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # a def is not execution; calls propagate hotness
            if isinstance(stmt, ast.If):
                self._scan_expr(module, stmt.test)
                if _is_exempt_test(stmt.test):
                    # The body is a declared sync-cadence site; the else
                    # branch is the common per-step path and stays hot.
                    self._scan_stmts(module, stmt.orelse)
                else:
                    self._scan_stmts(module, stmt.body)
                    self._scan_stmts(module, stmt.orelse)
                continue
            for expr in ast.iter_child_nodes(stmt):
                if isinstance(expr, ast.stmt):
                    continue
                self._scan_expr(module, expr)
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, attr, None)
                if isinstance(sub, list) and sub \
                        and isinstance(sub[0], ast.stmt):
                    self._scan_stmts(module, sub)
            for handler in getattr(stmt, "handlers", []) or []:
                self._scan_stmts(module, handler.body)

    def _scan_expr(self, module: Module, expr: ast.AST) -> None:
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            self._check_call(module, node)
            if isinstance(node.func, ast.Name):
                self._queue_local(module, node.func.id)
            elif self.program is not None \
                    and isinstance(node.func, ast.Attribute):
                # helpers.fetch(...) through an imported module object.
                dotted = module.dotted(node.func)
                if dotted and dotted not in _SYNC_CALLS:
                    hit = self.program.resolve_function(module, dotted)
                    if hit is not None:
                        target, fn = hit
                        self._queue(target, getattr(fn, "name", dotted), fn)

    def _check_call(self, module: Module, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in _SYNC_METHODS:
            dotted = module.dotted(func)
            self.findings.append(module.finding(
                "HS101", node,
                f"'{dotted or '...' + func.attr}()' makes the host wait "
                "for the card in a step-loop hot path; fetch on the "
                "telemetry sync cadence instead"))
            return
        if _blocking_copy_to_host(module, node):
            self.findings.append(module.finding(
                "HS101", node,
                f"'...{func.attr}(...)' is a blocking device->host copy "
                "in a step-loop hot path; keep the value on the card and "
                "fetch on the sync cadence (or copy non_blocking=True "
                "into pinned memory)"))
            return
        dotted = module.dotted(func)
        if dotted in _SYNC_CALLS:
            self.findings.append(module.finding(
                "HS101", node,
                f"'{dotted}(...)' forces a device->host transfer in a "
                "step-loop hot path; stage/accumulate on device and fetch "
                "on the sync cadence"))
            return
        if dotted in _CONVERSIONS and len(node.args) == 1 \
                and not node.keywords \
                and not _host_safe(module, node.args[0]):
            self.findings.append(module.finding(
                "HS101", node,
                f"'{dotted}(...)' on a (possibly device) value in a "
                "step-loop hot path is a blocking host fetch; accumulate "
                "on device, or suppress with a comment proving the value "
                "is host-resident"))


def check(module: Module, registry=None, program=None) -> List[Finding]:
    # A timed loop inside a hot-marked function is scanned by both entry
    # points; report each flagged node once.
    seen: Set[Finding] = set()
    out: List[Finding] = []
    for f in _HotScanner(module, program=program).run():
        if f not in seen:
            seen.add(f)
            out.append(f)
    return out
