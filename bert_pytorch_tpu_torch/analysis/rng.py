"""RN301/RN302 — dropout-seed hygiene, in the port's seed idiom.

The port draws dropout from explicit integer seeds, not from a global
generator: ``models/bert.py`` draws one seed per layer per forward
(``draw_dropout_seeds``), derives one per dropout site (``_sub_seed``)
and per rank (``fold_dropout_seeds``), and every consumer turns its seed
into a Philox mask (``ops/dropout.py`` ``dropout(x, rate, seed)``, the
kernels' ``dropout_seed=``, ``torch.Generator().manual_seed``). The same
seed consumed twice is the same mask twice — the JAX package's "PRNG key
consumed twice" hazard, with no runtime error either.

* **RN301** — a seed consumed twice without a new derivation. Tracked
  per function scope: names bound from ``draw_dropout_seeds`` /
  ``_sub_seed`` / ``fold_dropout_seeds`` are seeds; passing one as
  ``dropout``'s seed, as ``dropout_seed=`` / ``dropout_seeds=``, or to
  ``manual_seed`` consumes it; a second consumption without a re-bind
  flags. Derivations (``_sub_seed(seed, site)``, ``fold_dropout_seeds``)
  read their seed without consuming it, as ``fold_in`` reads a key. Loop
  bodies are scanned twice, so a seed made outside a loop and consumed
  inside it flags on the simulated second iteration — "the same dropout
  mask every step". Re-seeding a generator from one constant inside a
  loop (``gen.manual_seed(0)`` per iteration) flags too: the same stream
  every iteration.

* **RN302** — a seed taken from a wall clock or a process id
  (``torch.manual_seed(int(time.time()))``,
  ``torch.Generator().manual_seed(os.getpid())``). It destroys the
  bit-exact resume/replay the checkpoints promise, and two processes
  started in the same second share a stream. Seeds come from config.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from bert_pytorch_tpu_torch.analysis.core import Finding, Module

CHECKS = {
    "RN301": "dropout seed consumed twice without a new derivation (the "
             "same Philox mask twice)",
    "RN302": "RNG seed derived from a wall clock or a process id",
}

# Last dotted component of the calls that bind a fresh seed (or a fresh
# list of seeds): models/bert.py.
_SEED_MAKERS = {"draw_dropout_seeds", "_sub_seed", "fold_dropout_seeds"}
# Keywords that hand a seed (or a forward's seeds) to a consumer.
_SEED_KEYWORDS = {"dropout_seed", "dropout_seeds", "seed"}
_SEED_SINKS = {"torch.manual_seed", "torch.cuda.manual_seed",
               "torch.cuda.manual_seed_all", "torch.random.manual_seed",
               "numpy.random.seed", "numpy.random.default_rng",
               "numpy.random.RandomState", "random.seed", "random.Random"}
_CLOCK_CALLS = {"time.time", "time.time_ns", "time.monotonic",
                "time.monotonic_ns", "time.perf_counter",
                "time.perf_counter_ns", "datetime.datetime.now",
                "datetime.datetime.utcnow", "datetime.datetime.today",
                "os.getpid", "os.getppid"}


def _tail(dotted: str) -> str:
    return dotted.rsplit(".", 1)[-1]


def _is_seed_sink(module: Module, call: ast.Call) -> bool:
    dotted = module.dotted(call.func) or ""
    if dotted in _SEED_SINKS:
        return True
    # gen.manual_seed(...) / torch.Generator(...).manual_seed(...)
    return isinstance(call.func, ast.Attribute) \
        and call.func.attr == "manual_seed"


def _wallclock_seed_findings(module: Module) -> List[Finding]:
    findings = []
    for node in module.nodes:
        if not isinstance(node, ast.Call) or not _is_seed_sink(module, node):
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            for sub in ast.walk(arg):
                if isinstance(sub, ast.Call) \
                        and module.dotted(sub.func) in _CLOCK_CALLS:
                    findings.append(module.finding(
                        "RN302", node,
                        f"seed derived from '{module.dotted(sub.func)}()' "
                        "breaks bit-exact resume/replay; take the seed "
                        "from config (and fold run identifiers into it "
                        "if needed)"))
                    break
    return findings


class _KeyTracker:
    """Linear abstract interpretation of one function body: which names
    hold seeds, and has each been consumed since its last bind."""

    def __init__(self, module: Module):
        self.module = module
        self.findings: List[Finding] = []
        self._reseeds: Set[int] = set()  # constant re-seeds already flagged

    # state: name -> consumed? (True after one consumption)

    def scan_function(self, body: List[ast.stmt]) -> None:
        self._scan(body, {})

    def _scan(self, stmts: List[ast.stmt], state: Dict[str, bool]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # separate scope; scanned by its own tracker
            if isinstance(stmt, ast.If):
                self._consume_in_expr(stmt.test, state)
                body_state = dict(state)
                else_state = dict(state)
                self._scan(stmt.body, body_state)
                self._scan(stmt.orelse, else_state)
                # Merge: consumed in either branch counts as consumed
                # after the join (one dynamic path uses it; a later use
                # would be that path's second). Keys created in only one
                # branch are dropped — conservatively untracked.
                for name in list(state):
                    state[name] = body_state.get(name, True) \
                        or else_state.get(name, True)
                continue
            if isinstance(stmt, (ast.For, ast.While)):
                if isinstance(stmt, ast.For):
                    self._consume_in_expr(stmt.iter, state)
                else:
                    self._consume_in_expr(stmt.test, state)
                self._constant_reseeds(stmt.body)
                # Two passes simulate the second iteration: a seed made
                # outside the loop and consumed inside it flags here.
                self._scan(stmt.body, state)
                self._scan(stmt.body, state)
                self._scan(stmt.orelse, state)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    self._consume_in_expr(item.context_expr, state)
                self._scan(stmt.body, state)
                continue
            if isinstance(stmt, ast.Try):
                self._scan(stmt.body, state)
                for handler in stmt.handlers:
                    self._scan(handler.body, state)
                self._scan(stmt.orelse, state)
                self._scan(stmt.finalbody, state)
                continue
            if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                value = stmt.value
                if value is not None:
                    self._consume_in_expr(value, state)
                targets = stmt.targets if isinstance(stmt, ast.Assign) \
                    else [stmt.target]
                fresh = value is not None and isinstance(value, ast.Call) \
                    and _tail(self.module.dotted(value.func) or "") \
                    in _SEED_MAKERS
                for t in targets:
                    names = [t] if isinstance(t, ast.Name) else (
                        [e for e in t.elts if isinstance(e, ast.Name)]
                        if isinstance(t, (ast.Tuple, ast.List)) else [])
                    for n in names:
                        if fresh:
                            state[n.id] = False
                        else:
                            state.pop(n.id, None)
                continue
            # Any other statement: scan its expressions for consumption.
            for node in ast.iter_child_nodes(stmt):
                if not isinstance(node, ast.stmt):
                    self._consume_in_expr(node, state)

    def _constant_reseeds(self, body: List[ast.stmt]) -> None:
        """``manual_seed(<constant>)`` anywhere in a loop body (not in a
        nested def): every iteration restarts the same stream."""
        stack = list(body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
                continue
            stack.extend(ast.iter_child_nodes(node))
            if not (isinstance(node, ast.Call)
                    and _is_seed_sink(self.module, node)) \
                    or id(node) in self._reseeds:
                continue
            args = list(node.args) + [kw.value for kw in node.keywords]
            if args and all(isinstance(a, ast.Constant) for a in args):
                self._reseeds.add(id(node))
                self.findings.append(self.module.finding(
                    "RN301", node,
                    "generator re-seeded from one constant inside a loop: "
                    "every iteration draws the same stream (seed once "
                    "outside the loop, or derive a seed per iteration)"))

    def _consumed(self, node: ast.Call) -> List[ast.Name]:
        """The seed names a call consumes."""
        dotted = self.module.dotted(node.func) or ""
        out: List[ast.Name] = []
        if _tail(dotted) in _SEED_MAKERS:
            return out  # a derivation reads its seed, it does not draw
        if _tail(dotted) == "dropout" and not dotted.startswith("torch."):
            # ops/dropout.py dropout(x, rate, seed)
            if len(node.args) > 2 and isinstance(node.args[2], ast.Name):
                out.append(node.args[2])
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "manual_seed":
            out.extend(a for a in node.args[:1] if isinstance(a, ast.Name))
        for kw in node.keywords:
            if kw.arg in _SEED_KEYWORDS and isinstance(kw.value, ast.Name):
                out.append(kw.value)
        return out

    def _consume_in_expr(self, expr: ast.AST, state: Dict[str, bool]) -> None:
        if expr is None:
            return
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            for name_node in self._consumed(node):
                name = name_node.id
                if name not in state:
                    continue
                if state[name]:
                    self.findings.append(self.module.finding(
                        "RN301", node,
                        f"dropout seed '{name}' consumed again without a "
                        "new derivation: the same Philox mask both times "
                        "(draw new seeds, or derive one per site with "
                        "_sub_seed)"))
                else:
                    state[name] = True


def _seeded_scopes(module: Module) -> Set[int]:
    """ids of the function defs (and 0 for the module body) that bind a
    seed or seed a generator: the only scopes RN301 can flag in."""
    scopes: Set[int] = set()
    for node in module.nodes:
        if not isinstance(node, ast.Call):
            continue
        if _tail(module.dotted(node.func) or "") not in _SEED_MAKERS \
                and not _is_seed_sink(module, node):
            continue
        cur = module.parents.get(node)
        while cur is not None and not isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            cur = module.parents.get(cur)
        scopes.add(0 if cur is None else id(cur))
    return scopes


def check(module: Module, registry=None, program=None) -> List[Finding]:
    findings = _wallclock_seed_findings(module)
    scopes = _seeded_scopes(module)
    if not scopes:
        return findings
    for node in module.nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and id(node) in scopes:
            tracker = _KeyTracker(module)
            tracker.scan_function(node.body)
            findings.extend(tracker.findings)
    if 0 not in scopes:
        return findings
    tracker = _KeyTracker(module)
    tracker.scan_function(
        [s for s in module.tree.body
         if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef))])
    findings.extend(tracker.findings)
    return findings
