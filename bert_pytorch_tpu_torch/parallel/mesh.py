"""The ``--mesh`` grammar and the device mesh: the port of the JAX
package's ``parallel/mesh.py`` (``MeshSpec``, ``MeshSpecError``,
``create_mesh``) on a torch ``DeviceMesh``.

:class:`MeshSpec` is the JAX package's, copied so that its behaviour is
the same: ``parse`` with the key aliases, ``from_strategy``,
``canonical``, ``as_dict``/``from_dict``, ``active_axes`` and ``validate``
with the packing rule. The XLA logical-rule table is realised by hand:
FSDP2's wrap policy (parallel/sharding.py) for ``fsdp``, the Megatron
splits of parallel/tensor_parallel.py for ``model`` (``heads``, ``mlp``,
``vocab`` and ``embed_out`` on ``model``, ``kv`` never), the GPipe stages
of parallel/pipeline.py for ``pipe`` (``layers`` on ``pipe``) and the
ring of ops/ring.py for ``seq``.

:func:`create_mesh` lays the run's ranks out in the JAX order, ``(data,
fsdp, pipe, seq, model)`` with ``model`` fastest, as one
``init_device_mesh`` over the run's process group (one rank per device),
``dcn`` the outer factor of ``data`` (JAX ``MeshConfig.resolve`` and
``create_mesh``). :class:`Layout` is a rank's place in it: its
coordinates and the process groups of its axes, including the **data
coordinate** (the rank's index along ``dcn x data x fsdp``; the port of
``check_batch_process_locality``), which decides the rows it reads. Ranks
along ``pipe``, ``seq`` and ``model`` that share a data coordinate read
the same rows.

``dcn=N`` is the multi-slice data axis. On GPUs a slice is a node: the
ranks of one node must be contiguous, so the nodes (``WORLD_SIZE /
LOCAL_WORLD_SIZE``) must divide by N (the GPU reading of the JAX
``dcn_process_granule``). The gradient sum runs over the whole data axis
in one collective; NCCL picks its own hierarchy across nodes.
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


def parse_mesh_spec(text: str) -> MeshSpec:
    """Module-level alias for :meth:`MeshSpec.parse`."""
    return MeshSpec.parse(text)


def resolved(spec: MeshSpec, world_size: int) -> MeshSpec:
    """``spec`` with ``data`` realised for ``world_size`` ranks (per
    ``dcn`` granule, as the JAX runner records the resolved spec in
    manifests and telemetry); refuses a product that is not the world
    size."""
    data = spec.resolve(world_size)[0]
    return dataclasses.replace(spec, data=data)


def check_dcn(spec: MeshSpec, world_size: int, local_world_size: int) -> None:
    """``dcn=N`` needs whole nodes in every granule: the nodes
    (``world_size / local_world_size``) must divide by N."""
    if spec.dcn_data <= 1:
        return
    nodes = max(1, world_size // max(1, local_world_size))
    if world_size % max(1, local_world_size) or nodes % spec.dcn_data:
        raise MeshSpecError(
            f"dcn={spec.dcn_data} needs the ranks of one node contiguous "
            f"and the nodes divisible by it: {world_size} ranks, "
            f"{local_world_size} a node ({nodes} nodes)")


def mesh_shape(spec: MeshSpec) -> tuple:
    """The resolved spec's device-mesh shape: ``(dcn * data, fsdp, pipe,
    seq, model)``."""
    return (spec.dcn_data * spec.data, spec.fsdp, spec.pipe, spec.seq,
            spec.model)


def coordinates(rank: int, shape: tuple) -> dict:
    """``rank``'s index along each axis of a row-major ``shape`` mesh (the
    ``model`` axis fastest)."""
    coords = {}
    for axis, size in zip(reversed(MESH_AXES), reversed(shape)):
        coords[axis] = rank % size
        rank //= size
    return {axis: coords[axis] for axis in MESH_AXES}


def axis_ranks(shape: tuple, axes) -> list:
    """The rank lists of every group along ``axes`` (the ranks that differ
    only in those coordinates), each sorted, in the order of the other
    coordinates."""
    axes = [MESH_AXES.index(a) for a in axes]
    groups: dict = {}
    world = 1
    for size in shape:
        world *= size
    for rank in range(world):
        c = coordinates(rank, shape)
        key = tuple(c[a] for i, a in enumerate(MESH_AXES) if i not in axes)
        groups.setdefault(key, []).append(rank)
    return [groups[k] for k in sorted(groups)]


# The groups a Layout makes, by name: the axes each spans.
GROUP_AXES = {
    AXIS_PIPE: (AXIS_PIPE,),
    AXIS_SEQ: (AXIS_SEQ,),
    AXIS_MODEL: (AXIS_MODEL,),
    # The data coordinate: the ranks that read different rows.
    "batch": (AXIS_DATA, AXIS_FSDP),
    # The rows and the tokens: what the gradients of a replicated
    # parameter, the loss sums and the masked counts are summed over.
    "grad": (AXIS_DATA, AXIS_FSDP, AXIS_SEQ),
    # The splits of one parameter: what a norm's squares are summed over.
    "norm": (AXIS_FSDP, AXIS_PIPE, AXIS_MODEL),
}


@dataclasses.dataclass
class Layout:
    """A rank's place in the run's mesh: the resolved ``spec``, ``rank``
    and ``world``, its ``coords`` along each axis (``data`` counts the
    ``dcn`` granules too), the c10d ``groups`` of :data:`GROUP_AXES`
    (None for a group of one rank) with their ``group_ranks`` (global
    ranks, in coordinate order), the ``backend`` and the torch
    ``device_mesh`` (FSDP2 slices its ``(data, fsdp)`` sub-mesh)."""

    spec: MeshSpec
    rank: int
    world: int
    coords: dict
    groups: dict
    group_ranks: dict
    backend: str
    device_mesh: object = None

    @property
    def data_index(self) -> int:
        """The data coordinate: this rank's index along ``dcn x data x
        fsdp`` (which rows it reads)."""
        return self.coords[AXIS_DATA] * self.spec.fsdp + self.coords[AXIS_FSDP]

    @property
    def n_data(self) -> int:
        """The data replicas: ``dcn * data * fsdp``."""
        return self.spec.dcn_data * self.spec.data * self.spec.fsdp

    @property
    def dropout_index(self) -> int:
        """The index folded into the dropout seeds: one per (data
        coordinate, seq shard), so ranks that hold other tokens draw other
        masks and ranks that hold the same tokens (``pipe``, ``model``)
        the same ones; 0 on the data coordinate 0's seq shard 0."""
        return self.data_index * self.spec.seq + self.coords[AXIS_SEQ]

    @property
    def host_staged(self) -> bool:
        """Point-to-point transfers (the pipeline's activations, the
        ring's K/V) go through host memory: gloo's send and recv take host
        tensors."""
        return self.backend == "gloo"

    def transports(self) -> dict:
        """Each group's transport, for the ``event mesh`` line: the
        backend, and for the point-to-point axes under gloo ``gloo+host``
        (pinned host buffers)."""
        out = {}
        for name in ("batch", AXIS_PIPE, AXIS_SEQ, AXIS_MODEL):
            if self.groups.get(name) is None:
                continue
            p2p = name in (AXIS_PIPE, AXIS_SEQ) and self.host_staged
            out[name] = self.backend + ("+host" if p2p else "")
        return out

    def axis(self, name: str):
        """The ``AxisGroup`` (parallel/tensor_parallel.py) of group
        ``name``, or None for a group of one rank."""
        from bert_pytorch_tpu_torch.parallel.tensor_parallel import AxisGroup

        if self.groups.get(name) is None:
            return None
        ranks = tuple(self.group_ranks[name])
        return AxisGroup(self.groups[name], ranks.index(self.rank),
                         len(ranks), ranks, self.host_staged)

    @property
    def model_parallel(self) -> bool:
        """Whether parameters are split over ``pipe`` or ``model``."""
        return self.spec.pipe > 1 or self.spec.model > 1


def make_layout(spec: MeshSpec, rank: int, world: int, backend: str,
                device_mesh=None) -> Layout:
    """The :class:`Layout` of ``rank`` under the resolved ``spec``: every
    group of :data:`GROUP_AXES` is created on every rank in one order (a
    c10d rule), and a group of one rank is None."""
    import torch.distributed as dist

    shape = mesh_shape(spec)
    groups, group_ranks = {}, {}
    for name, axes in GROUP_AXES.items():
        lists = axis_ranks(shape, axes)
        mine = next(r for r in lists if rank in r)
        group_ranks[name] = mine
        if len(mine) == 1:
            groups[name] = None
            continue
        group, _ = dist.new_subgroups_by_enumeration(lists)
        groups[name] = group
    return Layout(spec=spec, rank=rank, world=world,
                  coords=coordinates(rank, shape), groups=groups,
                  group_ranks=group_ranks, backend=backend,
                  device_mesh=device_mesh)


def create_mesh(spec: MeshSpec, device_type: str = "cuda"):
    """The run's ``DeviceMesh``: ``(data, fsdp, pipe, seq, model)`` (``data``
    the ``dcn x data`` ranks), one rank per device, over the default
    process group (which must exist: :func:`~bert_pytorch_tpu_torch.
    parallel.launcher.initialize`). ``data=-1`` resolves to the ranks
    left over by the other axes."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "create_mesh needs the run's process group: call "
            "parallel.launcher.initialize first (torchrun, or the JAX or "
            "SLURM environment)")
    spec = resolved(spec, dist.get_world_size())
    return init_device_mesh(device_type, mesh_shape(spec),
                            mesh_dim_names=MESH_AXES)


def place_model(model, layout: Optional[Layout]):
    """Lay ``model`` (whole weights, seeded or converted) out for this
    rank before FSDP2 wraps it: its ``model`` part (tensor_parallel.
    split_model), its pipeline stage's layers (pipeline.stage_model) and
    the ring on its ``seq`` shard (each attention's ``ring``, the
    embeddings' position offset). ``model.layout`` records ``layout``."""
    from bert_pytorch_tpu_torch.models import bert
    from bert_pytorch_tpu_torch.parallel import pipeline, tensor_parallel

    model.layout = layout
    if layout is None:
        return model
    tensor_parallel.split_model(model, layout.axis(AXIS_MODEL))
    pipeline.stage_model(model, layout.axis(AXIS_PIPE))
    seq = layout.axis(AXIS_SEQ)
    if seq is not None:
        for module in model.modules():
            if isinstance(module, bert.BertSelfAttention):
                module.ring = seq
            elif isinstance(module, bert.BertEmbeddings):
                module.seq = seq
    return model


def mark_norms(model, layout: Optional[Layout]) -> None:
    """Under ``pipe`` or ``model``, give every parameter (FSDP2's, once it
    has wrapped them) ``norm_group`` (the ``fsdp x pipe x model`` group its
    parts are spread over) and ``norm_copies`` (how many ranks of that
    group hold the same part), so a norm is one all-reduce of local sums
    of squares over the copies (optim/transforms.py)."""
    if layout is None or not layout.model_parallel:
        return
    from bert_pytorch_tpu_torch.parallel import sharding, tensor_parallel

    group = layout.groups["norm"]
    size = len(layout.group_ranks["norm"])
    for name, p in model.named_parameters():
        parts = layout.spec.fsdp if sharding.is_sharded(p) else 1
        if tensor_parallel.split_of(name) is not None:
            parts *= layout.spec.model
        if ".encoder.layers." in name:
            parts *= layout.spec.pipe
        p.norm_group = group
        p.norm_copies = size // parts
