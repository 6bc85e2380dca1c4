"""The axes registry: mesh-axis names, the process groups a rank's layout
makes, and the logical-axis rules — the declarative authority the
sharding checks (SD601/SD602/SD603) enforce against.

This mirrors the port's ``parallel/mesh.py`` (``MESH_AXES`` and the
``AXIS_*`` constants, ``_STRATEGY_AXES``, ``GROUP_AXES``) the same way
``analysis/concurrency.py`` mirrors the lock discipline: the analysis
package stays stdlib-only and torch-free (files are parsed, never
imported), so it cannot import the real tables — instead this module
restates them and ``tests/test_torch_lint.py`` pins the copies together
by PARSING mesh.py. Drift fails tier-1, not a layout three PRs later.

The logical rules. The JAX package maps logical parameter axes to mesh
axes with XLA rules; the port realizes the same table by hand (its
mesh.py docstring): FSDP2's wrap policy shards ``embed`` over ``fsdp``,
the Megatron splits of ``parallel/tensor_parallel.py`` put ``heads``,
``mlp``, ``vocab`` and ``embed_out`` on ``model`` (``kv`` never), the
GPipe stages put ``layers`` on ``pipe``. :data:`RULE_TEMPLATE` and
:data:`BASE_RULES` state that table; the test pins the split table's
(``SPLITS``) logical names to the ``model`` rules, and SD602 holds any
split table in the program to it.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Optional, Tuple

# -- mesh axes (mirror of parallel/mesh.py MESH_AXES + AXIS_*) -----------

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_PIPE = "pipe"
AXIS_SEQ = "seq"
AXIS_MODEL = "model"

MESH_AXES: Tuple[str, ...] = (
    AXIS_DATA, AXIS_FSDP, AXIS_PIPE, AXIS_SEQ, AXIS_MODEL)

# The constant spellings code outside parallel/ must import instead of
# raw literals (the SD603 contract). Name -> axis value, for messages and
# the mesh.py mirror test.
AXIS_CONSTANTS: Dict[str, str] = {
    "AXIS_DATA": AXIS_DATA,
    "AXIS_FSDP": AXIS_FSDP,
    "AXIS_PIPE": AXIS_PIPE,
    "AXIS_SEQ": AXIS_SEQ,
    "AXIS_MODEL": AXIS_MODEL,
}

# -- the layout's process groups (mirror of mesh.py GROUP_AXES) ----------
# Layout.axis(name) takes one of these names: the group of the axes it
# spans (None for a group of one rank).
GROUP_AXES: Dict[str, Tuple[str, ...]] = {
    AXIS_PIPE: (AXIS_PIPE,),
    AXIS_SEQ: (AXIS_SEQ,),
    AXIS_MODEL: (AXIS_MODEL,),
    "batch": (AXIS_DATA, AXIS_FSDP),
    "grad": (AXIS_DATA, AXIS_FSDP, AXIS_SEQ),
    "norm": (AXIS_FSDP, AXIS_PIPE, AXIS_MODEL),
}

# -- logical-axis rules ----------------------------------------------------
# Values are mesh axes (or None = replicated); only the KEY COVERAGE is
# what SD602 enforces — an unmatched logical name silently replicates —
# but the table keeps the values too so the test can pin the split table
# to the model rules.

BASE_RULES: Tuple[Tuple[str, object], ...] = (
    ("batch", (AXIS_DATA, AXIS_FSDP)),
    ("seq_act", AXIS_SEQ),
    ("pos", None),
    ("types", None),
    ("classes", None),
    ("layers", None),
)

# Per param logical axis, the mesh axis that controls it when active in
# the mesh spec (else replicated): every strategy product's rules derive
# from this one table.
RULE_TEMPLATE: Tuple[Tuple[str, object], ...] = (
    ("embed", AXIS_FSDP),
    ("embed_out", AXIS_MODEL),
    ("vocab", AXIS_MODEL),
    ("heads", AXIS_MODEL),
    ("kv", None),
    ("mlp", AXIS_MODEL),
)

# Mirror of mesh.py _STRATEGY_AXES: legacy alias -> activated mesh axes.
STRATEGY_AXES: Dict[str, Tuple[str, ...]] = {
    "dp": (),
    "sp": (AXIS_SEQ,),
    "fsdp": (AXIS_FSDP,),
    "tp": (AXIS_MODEL,),
    "tp_fsdp": (AXIS_FSDP, AXIS_MODEL),
    "pp": (AXIS_PIPE,),
    "pp_tp": (AXIS_PIPE, AXIS_MODEL),
}


def derive_rules(active) -> Tuple[Tuple[str, object], ...]:
    """Param rules for a set of active mesh axes (an active 'pipe'
    prepends the stacked-layer rule; template rules resolve to their
    controlling axis when active, else None)."""
    active = frozenset(active)
    rules = []
    if AXIS_PIPE in active:
        rules.append(("layers", AXIS_PIPE))
    for name, axis in RULE_TEMPLATE:
        rules.append((name, axis if axis is not None and axis in active
                      else None))
    return tuple(rules)


STRATEGY_RULES: Dict[str, Tuple[Tuple[str, object], ...]] = {
    name: derive_rules(axes) for name, axes in STRATEGY_AXES.items()
}

# Every expressible strategy PRODUCT over the param-sharding axes
# (fsdp × pipe × model, with/without seq): SD602 coverage runs over
# these generated products too, so a logical name that resolves under
# the legacy aliases but not under some composed mesh is still caught.
_PRODUCT_AXES = (AXIS_FSDP, AXIS_PIPE, AXIS_SEQ, AXIS_MODEL)

PRODUCT_RULES: Dict[str, Tuple[Tuple[str, object], ...]] = {}
for _mask in range(1 << len(_PRODUCT_AXES)):
    _active = tuple(a for i, a in enumerate(_PRODUCT_AXES)
                    if _mask & (1 << i))
    _name = "dp" if not _active else "dp*" + "*".join(_active)
    PRODUCT_RULES[_name] = derive_rules(_active)
del _mask, _active, _name


def strategies() -> Tuple[str, ...]:
    """Legacy aliases plus every generated axis product."""
    return tuple(sorted(set(STRATEGY_RULES) | set(PRODUCT_RULES)))


def logical_coverage(strategy: str) -> FrozenSet[str]:
    """Logical names that RESOLVE (to a mesh axis or an explicit None =
    replicated) under ``strategy`` (a legacy alias or a generated
    product name): its own rules plus the shared base rules."""
    rules = (STRATEGY_RULES.get(strategy)
             if strategy in STRATEGY_RULES else PRODUCT_RULES[strategy])
    return frozenset(name for name, _ in rules + BASE_RULES)


def uncovered_strategies(logical_name: str) -> Tuple[str, ...]:
    """Declared strategies under which ``logical_name`` has NO rule (and
    would silently replicate). Empty = fully covered."""
    return tuple(s for s in strategies()
                 if logical_name not in logical_coverage(s))


def template_axis(logical_name: str) -> Optional[str]:
    """The mesh axis a logical parameter axis is split over when that
    axis is active (RULE_TEMPLATE), or None."""
    return dict(RULE_TEMPLATE).get(logical_name)


def is_mesh_axis(name: str) -> bool:
    return name in MESH_AXES


def is_group(name: str) -> bool:
    """A name ``Layout.axis`` takes (mesh.py GROUP_AXES)."""
    return name in GROUP_AXES


def constant_for(axis: str) -> Optional[str]:
    """The AXIS_* constant name for a mesh axis value (for messages)."""
    for const, value in AXIS_CONSTANTS.items():
        if value == axis:
            return const
    return None
