"""The ``model`` mesh axis: tensor parallelism, the port of the JAX
package's logical rule table (``parallel/mesh.py`` ``_RULE_TEMPLATE``:
``heads``, ``mlp``, ``vocab`` and ``embed_out`` on ``model``, ``kv``
never) as Megatron's column and row splits.

Each rank of a ``model`` group holds 1/M of every parameter the table
splits (:data:`SPLITS`, by the port's parameter names):

* ``heads``: the query, key and value Dense layers (rows of their weight
  and bias, whole heads: H/M heads of D each) and the attention output
  (its weight's columns; the bias is whole);
* ``mlp``: the intermediate Dense (rows) and the layer's output Dense
  (columns; the bias is whole);
* ``vocab``: the word table (rows) and the MLM decoder's bias; the decoder
  is the tied word table, so it is split with it;
* ``embed_out``: the pooler's and the MLM transform's Dense (rows).

The collectives are explicit c10d calls inside autograd Functions,
Megatron's f/g pair: :func:`copy_to` (identity forward, all-reduce of the
gradient) before a column-split layer, :func:`reduce_from` (all-reduce
forward, identity backward) after a row-split one, and
:func:`gather_last` (all-gather of the last dimension, the gradient's own
slice back) after a column-split layer whose output the next layer needs
whole (``embed_out``, the decoder's logits). Every replicated parameter
sees the same inputs and gradients on every model rank, so no gradient is
reduced over ``model``. Over gloo a bf16 or fp16 all-reduce runs in fp32.

:func:`split_model` takes a model that holds the whole weights (seeded,
or converted from a JAX tree) and keeps this rank's part of each split
parameter in place; :func:`shard_window` says which part a rank holds
(the optimizer's norms, the checkpoints).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

import torch
import torch.distributed as dist

# (pattern on the port's parameter name, dimension split, logical axis).
SPLITS = (
    (r"\.attention\.(query|key|value)\.(weight|bias)$", 0, "heads"),
    (r"\.attention\.output\.weight$", 1, "heads"),
    (r"\.intermediate\.dense\.(weight|bias)$", 0, "mlp"),
    (r"encoder\.layers\.\d+\.output\.weight$", 1, "mlp"),
    (r"^bert\.embeddings\.word_embeddings\.weight$", 0, "vocab"),
    (r"^predictions\.bias$", 0, "vocab"),
    (r"^bert\.pooler\.dense_act\.dense\.(weight|bias)$", 0, "embed_out"),
    (r"^predictions\.transform\.dense_act\.dense\.(weight|bias)$", 0,
     "embed_out"),
)
_SPLITS = tuple((re.compile(p), d, a) for p, d, a in SPLITS)


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One axis group of a rank: the c10d ``group``, this rank's
    ``index`` in it, its ``size``, its members' global ``ranks`` (in
    coordinate order) and whether point-to-point transfers are staged
    through host memory (``host_staged``: the gloo backend)."""

    group: object
    index: int
    size: int
    ranks: Tuple[int, ...]
    host_staged: bool = False

    def peer(self, offset: int) -> int:
        """The global rank ``offset`` steps along the group (cyclic)."""
        return self.ranks[(self.index + offset) % self.size]


def split_of(name: str):
    """(dimension, logical axis) of the parameter ``name`` under the rule
    table, or None for a replicated one."""
    for pattern, dim, axis in _SPLITS:
        if pattern.search(name):
            return dim, axis
    return None


def _reduced(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a new tensor); half types add in
    fp32 over gloo."""
    wide = (x.dtype in (torch.bfloat16, torch.float16)
            and dist.get_backend(group) == "gloo")
    y = x.float() if wide else x.clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype) if wide else y


class _CopyToModel(torch.autograd.Function):
    """f: identity forward, the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _reduced(grad.contiguous(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """g: the sum over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _reduced(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_gather_last(x: torch.Tensor, axis: Optional[AxisGroup]
                    ) -> torch.Tensor:
    """The parts ``x`` of the ``axis`` group's ranks concatenated on the
    last dimension, in rank order (no autograd); ``x`` itself without an
    axis."""
    if axis is None:
        return x
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return torch.cat(parts, dim=-1)


class _GatherLast(torch.autograd.Function):
    """The group's parts concatenated on the last dimension; the gradient
    of this rank's part is its slice."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.index, ctx.width = axis.index, x.shape[-1]
        return all_gather_last(x, axis)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.width
        return grad[..., lo:lo + ctx.width].contiguous(), None


def copy_to(x: torch.Tensor, axis: Optional[AxisGroup]) -> torch.Tensor:
    return x if axis is None else _CopyToModel.apply(x, axis.group)


def reduce_from(x: torch.Tensor, axis: Optional[AxisGroup]) -> torch.Tensor:
    return x if axis is None else _ReduceFromModel.apply(x, axis.group)


def gather_last(x: torch.Tensor, axis: Optional[AxisGroup]) -> torch.Tensor:
    return x if axis is None else _GatherLast.apply(x, axis)


def shard_window(name: str, full_shape, axis: AxisGroup):
    """(dimension, start, stop) of the full tensor ``name`` that model
    rank ``axis.index`` holds, or None for a replicated one."""
    found = split_of(name)
    if found is None:
        return None
    dim = found[0]
    n = full_shape[dim]
    if n % axis.size:
        raise ValueError(f"{name}: dimension {dim} of {tuple(full_shape)} "
                         f"does not divide over model={axis.size}")
    part = n // axis.size
    return dim, axis.index * part, (axis.index + 1) * part


def local_part(name: str, full: torch.Tensor, axis: Optional[AxisGroup]
               ) -> torch.Tensor:
    """This model rank's part of the whole tensor ``full`` named ``name``
    (``full`` itself for a replicated one or without a ``model`` axis)."""
    if axis is None:
        return full
    window = shard_window(name, full.shape, axis)
    if window is None:
        return full
    dim, lo, hi = window
    return full.narrow(dim, lo, hi - lo)


def check_divisible(config, size: int) -> None:
    """The widths the rule table splits must divide over ``size``."""
    for what, n in (("num_attention_heads", config.num_attention_heads),
                    ("intermediate_size", config.intermediate_size),
                    ("hidden_size", config.hidden_size),
                    ("vocab_size", config.vocab_size)):
        if n % size:
            raise ValueError(f"model={size}: {what}={n} does not divide "
                             "over the model axis")


@torch.no_grad()
def split_model(model: torch.nn.Module, axis: Optional[AxisGroup]
                ) -> torch.nn.Module:
    """Keep this rank's part of every parameter :data:`SPLITS` names (in
    place), and wire the modules' collectives (``tp`` on the attention, layer, embedding, Dense and
    prediction modules). The model itself without a ``model`` axis."""
    if axis is None:
        return model
    from bert_pytorch_tpu_torch.models import bert

    check_divisible(model.config, axis.size)
    for name, p in list(model.named_parameters()):
        window = shard_window(name, p.shape, axis)
        if window is None:
            continue
        dim, lo, hi = window
        p.data = p.data.narrow(dim, lo, hi - lo).contiguous()
    for module in model.modules():
        if isinstance(module, bert.BertSelfAttention):
            module.heads //= axis.size
            module.tp = axis
            module.output.tp = ("row", axis)
        elif isinstance(module, bert.BertLayer):
            module.tp = axis
            module.output.tp = ("row", axis)
        elif isinstance(module, bert.BertEmbeddings):
            table = module.word_embeddings
            rows = table.weight.shape[0]
            table.tp = (axis, axis.index * rows)
        elif isinstance(module, bert.BertLMPredictionHead):
            module.tp = axis
            module.transform.dense_act.dense.tp = ("gather", axis)
        elif isinstance(module, bert.BertPooler):
            module.dense_act.dense.tp = ("gather", axis)
    return model
