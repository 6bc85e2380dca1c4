"""SD601/SD602/SD603 — sharding discipline against the axes registry
(``analysis/axes.py``), restated for the port's process groups.

The JAX package checks the axis names of ``lax`` collectives, logical
partitioning rules and ``PartitionSpec`` entries. The port names its axes
in other places: a torch ``DeviceMesh`` (``init_device_mesh(...,
mesh_dim_names=...)``, ``mesh["fsdp"]``, ``mesh.get_group("fsdp")``) and
the c10d groups of its layout (``Layout.axis("model")``, which hands out
an ``AxisGroup``; ``layout.coords["seq"]``). A typo'd name there raises
only under the mesh shape that reaches it — or, for a group name the
layout does not make, returns None and silently skips a collective.

* **SD601** axis discipline: every statically-resolvable axis name
  handed to ``get_group``/``get_local_rank``, a mesh subscript
  (``mesh[...]``: a parameter or attribute whose name ends in ``mesh``),
  ``mesh_dim_names=`` or
  ``coords[...]`` must be a registered mesh axis; one handed to
  ``.axis(...)`` must be a group the layout makes (``GROUP_AXES``).
  Dynamic names (a parameter, a computed name) are skipped — this tier
  proves what is statically knowable.

* **SD602** split-table coverage: every logical name in a Megatron split
  table (an assignment to ``SPLITS`` or a name ending in ``_SPLITS`` of
  ``(pattern, dim, logical axis)`` entries, as ``parallel/
  tensor_parallel.py`` holds) must have a rule under EVERY declared
  strategy (``axes.logical_coverage``) — an unmatched name silently
  REPLICATES — and that rule must put it on ``model``, the axis the
  tensor-parallel code splits over.

* **SD603** raw mesh-axis literals outside ``parallel/``: axis-position
  string literals equal to a mesh axis (the SD601 sites, ``axis``/
  ``axis_name``/``*_axis`` keywords and parameter defaults, axis-named
  assignment targets and comparisons) must import the ``AXIS_*``
  constants from ``parallel/mesh.py`` instead, so renaming an axis edits
  one module. ``parallel/`` itself (the defining layer) and this
  analysis package (the mirror) are exempt.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from bert_pytorch_tpu_torch.analysis import axes as axes_registry
from bert_pytorch_tpu_torch.analysis.core import Finding, Module
from bert_pytorch_tpu_torch.analysis.graph import Program, resolve_strings

CHECKS = {
    "SD601": "process-group axis name not registered in the axes "
             "registry (a mesh axis, or a group the layout makes)",
    "SD602": "split-table logical axis without a model rule under every "
             "declared strategy (silently replicates)",
    "SD603": "raw mesh-axis string literal outside parallel/ (import the "
             "AXIS_* constants from parallel/mesh.py)",
}

# Methods whose first argument names a DeviceMesh dimension.
_MESH_DIM_METHODS = ("get_group", "get_local_rank")
# Methods whose first argument names a layout group (Layout.axis).
_GROUP_METHODS = ("axis",)
# Subscripted attributes keyed by mesh axes (Layout.coords).
_AXIS_KEYED = ("coords",)
_DIM_NAME_KEYWORDS = ("mesh_dim_names",)
# Keywords/defaults/targets whose string payload is axis-positioned for
# SD603 (the spellings this codebase uses).
_AXIS_NAMED = ("axis", "axis_name", "axis_names", "seq_axis")
# Modules allowed to spell mesh axes as raw literals: the defining
# parallel layer and the analysis mirror itself.
_SD603_EXEMPT_PREFIXES = ("bert_pytorch_tpu_torch/parallel/",
                          "bert_pytorch_tpu_torch/analysis/")


def _is_mesh_expr(module: Module, node: ast.AST) -> bool:
    """A DeviceMesh expression: an attribute ending in ``mesh``
    (``layout.device_mesh``, ``self.mesh``), or a PARAMETER ending in
    ``mesh`` of the enclosing function (``fsdp_mesh(mesh)``) — a local
    of that name may be anything (a result dict, say)."""
    if isinstance(node, ast.Attribute):
        return node.attr.endswith("mesh")
    if not isinstance(node, ast.Name) or not node.id.endswith("mesh"):
        return False
    cur = module.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            sig = cur.args
            return any(a.arg == node.id for a in
                       sig.posonlyargs + sig.args + sig.kwonlyargs)
        cur = module.parents.get(cur)
    return False


def _axis_sites(module: Module) -> List[Tuple[ast.AST, ast.AST, str]]:
    """(anchor node, axis-name expression, kind) for every SD601 site;
    kind is "mesh" (a mesh axis) or "group" (a layout group)."""
    sites = []
    for node in module.nodes:
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) and node.args:
                if func.attr in _MESH_DIM_METHODS:
                    sites.append((node, node.args[0], "mesh"))
                elif func.attr in _GROUP_METHODS and len(node.args) == 1 \
                        and not node.keywords:
                    sites.append((node, node.args[0], "group"))
            for kw in node.keywords:
                if kw.arg in _DIM_NAME_KEYWORDS:
                    sites.append((node, kw.value, "mesh"))
        elif isinstance(node, ast.Subscript):
            if _is_mesh_expr(module, node.value) or (
                    isinstance(node.value, ast.Attribute)
                    and node.value.attr in _AXIS_KEYED):
                sites.append((node, node.slice, "mesh"))
    return sites


def _check_axes(program: Optional[Program], module: Module
                ) -> List[Finding]:
    findings: List[Finding] = []
    for anchor, expr, kind in _axis_sites(module):
        resolved = resolve_strings(program, module, expr, at=anchor)
        if resolved is None:
            continue  # dynamic (or an int dimension): out of reach
        for name in sorted(resolved):
            if kind == "group":
                if axes_registry.is_group(name):
                    continue
                findings.append(module.finding(
                    "SD601", expr,
                    f"layout group '{name}' is not one the layout makes "
                    f"({', '.join(axes_registry.GROUP_AXES)}; "
                    "analysis/axes.py): Layout.axis returns None for it "
                    "and the collective on it is silently skipped"))
            elif not axes_registry.is_mesh_axis(name):
                findings.append(module.finding(
                    "SD601", expr,
                    f"mesh axis '{name}' is not a registered mesh axis "
                    f"({', '.join(axes_registry.MESH_AXES)}; "
                    "analysis/axes.py) — it fails only under the mesh "
                    "shape that reaches it"))
    return findings


def _split_tables(module: Module) -> List[ast.AST]:
    """Literal split tables: ``SPLITS = ((pattern, dim, axis), ...)``."""
    tables = []
    for node in module.nodes:
        if not isinstance(node, ast.Assign) \
                or not isinstance(node.value, (ast.Tuple, ast.List)):
            continue
        if any(isinstance(t, ast.Name) and (t.id == "SPLITS"
                                            or t.id.endswith("_SPLITS"))
               for t in node.targets):
            tables.append(node.value)
    return tables


def _check_splits(program: Optional[Program], module: Module
                  ) -> List[Finding]:
    findings: List[Finding] = []
    for table in _split_tables(module):
        for entry in table.elts:
            if not isinstance(entry, (ast.Tuple, ast.List)) \
                    or not entry.elts:
                continue
            logical = entry.elts[-1]
            resolved = resolve_strings(program, module, logical, at=entry)
            if resolved is None:
                continue
            for name in sorted(resolved):
                missing = axes_registry.uncovered_strategies(name)
                if missing:
                    findings.append(module.finding(
                        "SD602", logical,
                        f"split-table logical axis '{name}' has no rule "
                        f"under {len(missing)} declared strateg"
                        f"{'y' if len(missing) == 1 else 'ies'} (e.g. "
                        f"{missing[0]}) — an unmatched logical name "
                        "silently replicates; add its rule to "
                        "analysis/axes.py and parallel/mesh.py's table"))
                elif axes_registry.template_axis(name) \
                        != axes_registry.AXIS_MODEL:
                    findings.append(module.finding(
                        "SD602", logical,
                        f"split-table logical axis '{name}' is split over "
                        "'model' here, but its rule puts it on "
                        f"{axes_registry.template_axis(name)!r}"))
    return findings


def _axis_literals(node: ast.AST) -> List[ast.Constant]:
    """Constant mesh-axis strings anywhere in an axis-positioned
    expression subtree."""
    return [sub for sub in ast.walk(node)
            if isinstance(sub, ast.Constant)
            and isinstance(sub.value, str)
            and axes_registry.is_mesh_axis(sub.value)]


def _is_axis_named(name: Optional[str]) -> bool:
    return bool(name) and (name in _AXIS_NAMED or name.endswith("_axis")
                           or name.endswith("_axes"))


def _sd603_sites(module: Module) -> List[ast.Constant]:
    sites: List[ast.Constant] = []
    for _, expr, _ in _axis_sites(module):
        sites.extend(_axis_literals(expr))
    for node in module.nodes:
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if _is_axis_named(kw.arg):
                    sites.extend(_axis_literals(kw.value))
        elif isinstance(node, ast.Assign):
            if any(isinstance(t, ast.Name) and _is_axis_named(t.id)
                   for t in node.targets):
                sites.extend(_axis_literals(node.value))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            sig = node.args
            # Trailing positional defaults pair with the last params.
            pos_args = list(sig.posonlyargs) + list(sig.args)
            paired = zip(pos_args[-len(sig.defaults):], sig.defaults) \
                if sig.defaults else []
            for arg, default in list(paired) + list(
                    zip(sig.kwonlyargs, sig.kw_defaults)):
                if default is not None and _is_axis_named(arg.arg):
                    sites.extend(_axis_literals(default))
        elif isinstance(node, ast.Compare):
            operands = [node.left] + list(node.comparators)
            if any(isinstance(op, ast.Name) and _is_axis_named(op.id)
                   or isinstance(op, ast.Attribute)
                   and _is_axis_named(op.attr) for op in operands):
                for op in operands:
                    if isinstance(op, ast.Constant):
                        sites.extend(_axis_literals(op))
    return sites


def _check_literals(module: Module) -> List[Finding]:
    if any(module.rel.startswith(p) or ("/" + p) in module.rel
           for p in _SD603_EXEMPT_PREFIXES):
        return []
    findings: List[Finding] = []
    seen: Set[int] = set()
    for lit in _sd603_sites(module):
        if id(lit) in seen:
            continue
        seen.add(id(lit))
        const = axes_registry.constant_for(lit.value)
        findings.append(module.finding(
            "SD603", lit,
            f"raw mesh-axis literal '{lit.value}' outside parallel/ — "
            f"import {const} from bert_pytorch_tpu_torch.parallel.mesh so "
            "an axis is renamed in one place"))
    return findings


def check_program(program: Program, registry=None) -> List[Finding]:
    findings: List[Finding] = []
    for module in program.modules:
        if module.rel not in program.target_rels:
            continue
        findings.extend(_check_axes(program, module))
        findings.extend(_check_splits(program, module))
        findings.extend(_check_literals(module))
    return findings
