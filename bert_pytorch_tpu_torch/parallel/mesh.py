"""The ``--mesh`` grammar and the device mesh: the port of the JAX
package's ``parallel/mesh.py`` (``MeshSpec``, ``MeshSpecError``,
``create_mesh``) on a torch ``DeviceMesh``.

:class:`MeshSpec` is the JAX package's, copied so that its behaviour is
the same: ``parse`` with the key aliases, ``from_strategy``,
``canonical``, ``as_dict``/``from_dict``, ``active_axes`` and ``validate``
with the packing rule. The XLA logical-rule table is not copied: FSDP2's
wrap policy (parallel/sharding.py) takes its place.

:func:`create_mesh` realises the ``data`` and ``fsdp`` axes, in the JAX
order, as ``init_device_mesh(device_type, (data, fsdp),
mesh_dim_names=("data", "fsdp"))`` over the run's process group (one rank
per device). The other axes (``pipe``, ``seq``, ``model``, ``dcn``) above
1 are refused by name: they wait for ROADMAP.md's "Multi-GPU layouts".
"""

from __future__ import annotations

import dataclasses
from typing import Optional

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_PIPE = "pipe"
AXIS_SEQ = "seq"
AXIS_MODEL = "model"

MESH_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_PIPE, AXIS_SEQ, AXIS_MODEL)
# The axes the port realises, in the JAX mesh's order.
PORTED_AXES = (AXIS_DATA, AXIS_FSDP)
ROADMAP_LAYOUTS = "ROADMAP.md, \"Multi-GPU layouts\""

# Legacy strategy aliases -> the mesh axes they activate (JAX
# parallel/mesh.py _STRATEGY_AXES; only the names matter here).
_STRATEGY_AXES = {
    "dp": (),
    "sp": (AXIS_SEQ,),
    "fsdp": (AXIS_FSDP,),
    "tp": (AXIS_MODEL,),
    "tp_fsdp": (AXIS_FSDP, AXIS_MODEL),
    "pp": (AXIS_PIPE,),
    "pp_tp": (AXIS_PIPE, AXIS_MODEL),
}


class MeshSpecError(ValueError):
    """A mesh spec that cannot be realized, with the reason why."""


# Accepted spelling aliases for spec keys: strategy-flavored names map
# onto the canonical mesh axes.
_SPEC_KEY_ALIASES = {
    "dp": "data",
    "data": "data",
    "fsdp": "fsdp",
    "pipe": "pipe",
    "pp": "pipe",
    "seq": "seq",
    "sp": "seq",
    "ring": "seq",
    "model": "model",
    "tp": "model",
    "dcn": "dcn_data",
    "dcn_data": "dcn_data",
}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative parallelism product: sizes of every mesh axis
    (``--mesh dp=4,fsdp=2``). ``data == -1`` means 'all remaining
    devices'. Legacy ``--parallel_strategy`` names lower onto specs via
    :meth:`from_strategy`."""

    data: int = -1
    fsdp: int = 1
    pipe: int = 1
    seq: int = 1
    model: int = 1
    dcn_data: int = 1

    @staticmethod
    def parse(text: str) -> "MeshSpec":
        """Parse ``"dp=4,fsdp=2,pipe=2,seq=1"`` (keys accept the
        strategy-flavored aliases pp→pipe, sp/ring→seq, tp→model)."""
        sizes = {}
        for item in str(text).split(","):
            item = item.strip()
            if not item:
                continue
            key, sep, value = item.partition("=")
            key = key.strip().lower()
            if key not in _SPEC_KEY_ALIASES:
                raise MeshSpecError(
                    f"unknown mesh-spec key '{key}' in {text!r}; "
                    f"options: {sorted(set(_SPEC_KEY_ALIASES))}")
            canon = _SPEC_KEY_ALIASES[key]
            if not sep:
                raise MeshSpecError(
                    f"mesh-spec entry {item!r} wants KEY=SIZE")
            try:
                size = int(value)
            except ValueError:
                raise MeshSpecError(
                    f"mesh-spec size for '{key}' must be an integer, "
                    f"got {value!r}") from None
            if canon in sizes:
                raise MeshSpecError(
                    f"mesh-spec key '{canon}' given twice in {text!r}")
            sizes[canon] = size
        spec = MeshSpec(**sizes)
        spec.validate()
        return spec

    @staticmethod
    def from_strategy(strategy: str, *, data: int = -1, fsdp: int = 1,
                      pipe: int = 1, seq: int = 1, model: int = 1,
                      dcn_data: int = 1) -> "MeshSpec":
        """Lower a legacy ``--parallel_strategy`` name plus the legacy
        ``--mesh_*`` sizes onto a spec."""
        if strategy not in _STRATEGY_AXES:
            raise MeshSpecError(
                f"unknown strategy '{strategy}'; "
                f"options: {sorted(_STRATEGY_AXES)}")
        return MeshSpec(data=data, fsdp=fsdp, pipe=pipe, seq=seq,
                        model=model, dcn_data=dcn_data)

    def canonical(self) -> str:
        """Round-trippable spec string; inactive axes are elided."""
        parts = [f"dp={self.data}"]
        for key in ("fsdp", "pipe", "seq", "model"):
            size = getattr(self, key)
            if size != 1:
                parts.append(f"{key}={size}")
        if self.dcn_data != 1:
            parts.append(f"dcn={self.dcn_data}")
        return ",".join(parts)

    def as_dict(self) -> dict:
        """Plain-int dict for the (stdlib-only) checkpoint manifest."""
        return {"data": self.data, "fsdp": self.fsdp, "pipe": self.pipe,
                "seq": self.seq, "model": self.model,
                "dcn_data": self.dcn_data}

    @staticmethod
    def from_dict(d: dict) -> "MeshSpec":
        known = {f.name for f in dataclasses.fields(MeshSpec)}
        return MeshSpec(**{k: int(v) for k, v in dict(d).items()
                           if k in known})

    def active_axes(self) -> frozenset:
        """Mesh axes with size > 1 (data counts when -1 = 'remaining')."""
        active = set()
        if self.data != 1:
            active.add(AXIS_DATA)
        for axis, size in ((AXIS_FSDP, self.fsdp), (AXIS_PIPE, self.pipe),
                           (AXIS_SEQ, self.seq), (AXIS_MODEL, self.model)):
            if size > 1:
                active.add(axis)
        return frozenset(active)

    def resolve(self, n_devices: int) -> tuple:
        """(data, fsdp, pipe, seq, model) for ``n_devices`` devices, with
        the JAX ``MeshConfig.resolve`` divisibility errors (as
        :class:`MeshSpecError`)."""
        fixed = self.fsdp * self.pipe * self.seq * self.model
        denom = fixed * self.dcn_data
        data = self.data
        if data == -1:
            if n_devices % denom != 0:
                raise MeshSpecError(
                    f"{n_devices} devices not divisible by "
                    f"fsdp*pipe*seq*model*dcn_data={denom}")
            data = n_devices // denom
        if data * denom != n_devices:
            raise MeshSpecError(
                f"mesh {data}x{self.fsdp}x{self.pipe}x{self.seq}"
                f"x{self.model} (x{self.dcn_data} dcn)"
                f" != {n_devices} devices")
        return (data, self.fsdp, self.pipe, self.seq, self.model)

    def validate(self, *, n_devices: Optional[int] = None,
                 packed: bool = False) -> None:
        """Reject specs that cannot be realized, naming the reason.

        ``packed`` enables the sequence-packing compatibility check; pass
        ``n_devices`` to also enforce the axis-product divisibility."""
        for key in ("fsdp", "pipe", "seq", "model", "dcn_data"):
            size = getattr(self, key)
            if size < 1:
                raise MeshSpecError(
                    f"mesh-spec axis '{key}' must be >= 1, got {size}")
        if self.data < 1 and self.data != -1:
            raise MeshSpecError(
                f"mesh-spec axis 'data' must be >= 1 or -1 "
                f"(= all remaining devices), got {self.data}")
        if packed and self.seq > 1:
            raise MeshSpecError(
                "sequence packing composes with dp/fsdp/pipe/model but "
                "not with seq>1 (ring context parallelism): the packed "
                "block-diagonal attention mask ties together positions "
                "of one packed row, and the ring shards exactly that "
                "axis — segment boundaries cannot cross seq shards "
                "without a per-segment halo exchange")
        if n_devices is not None:
            self.resolve(n_devices)

    def require_ported(self) -> None:
        """Refuse the axes the port does not realise yet, by name."""
        unported = {key: getattr(self, key)
                    for key in ("pipe", "seq", "model", "dcn_data")
                    if getattr(self, key) > 1}
        if unported:
            raise MeshSpecError(
                f"mesh axes {unported} ({self.canonical()}) are not ported: "
                f"the port realises dp and fsdp only; pipeline, ring, tensor "
                f"and multi-slice layouts wait for {ROADMAP_LAYOUTS}")


def parse_mesh_spec(text: str) -> MeshSpec:
    """Module-level alias for :meth:`MeshSpec.parse`."""
    return MeshSpec.parse(text)


def resolved(spec: MeshSpec, world_size: int) -> MeshSpec:
    """``spec`` with ``data`` realised for ``world_size`` ranks (the JAX
    runner records the resolved spec in manifests and telemetry); refuses
    the unported axes and a product that is not the world size."""
    spec.require_ported()
    data, fsdp = spec.resolve(world_size)[:2]
    return dataclasses.replace(spec, data=data, fsdp=fsdp)


def create_mesh(spec: MeshSpec, device_type: str = "cuda"):
    """The run's ``DeviceMesh``: ``(data, fsdp)`` named ``("data",
    "fsdp")``, one rank per device, over the default process group
    (which must exist: :func:`~bert_pytorch_tpu_torch.parallel.launcher.
    initialize`). ``data=-1`` resolves to ``world // fsdp``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "create_mesh needs the run's process group: call "
            "parallel.launcher.initialize first (torchrun, or the JAX or "
            "SLURM environment)")
    spec = resolved(spec, dist.get_world_size())
    return init_device_mesh(device_type, (spec.data, spec.fsdp),
                            mesh_dim_names=PORTED_AXES)
