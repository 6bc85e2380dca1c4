"""BERT model family in PyTorch: the port of the JAX package's
``models/bert.py``: the serving heads, the pretraining model and the
finetuning heads (sequence classification and regression, token
classification, multiple choice, question answering).

Component parity with reference src/modeling.py (cited per class). The
dtype semantics follow the JAX package's flax modules:

  - parameters are kept in fp32;
  - Dense and Embed layers compute in the model's ``dtype`` (bf16 when
    serving), casting their fp32 parameters to it;
  - LayerNorm statistics and the attention softmax run in fp32.

Serving heads take ``quant`` (None | ``"bf16"`` | ``"int8"``, the JAX
package's inference weight formats, ops/quant.py) for every Dense they
share with training, through :func:`make_dense`: None keeps the fp32
``Dense``, ``"bf16"`` stores its weight and bias in bf16, ``"int8"``
swaps in ``Int8Dense``; the output classifier takes ``quant.exclude``
(bf16 under int8). Embeddings, LayerNorm and the MLM vocab bias stay fp32.

For serving (a forward under ``no_grad``/``inference_mode``), each
Dense/Embed keeps one cached copy of its parameters in the compute dtype
(rebuilt whenever the fp32 parameter changes), so a bf16 forward does not
re-cast the weights on every call. A forward that records a graph casts
with autograd on every call instead, so the gradient reaches the fp32
master parameters.

Training: dropout runs where the JAX model's ``nn.Dropout`` and attention
dropout run (the classifier heads' dropout too, keyed on the embeddings'
seed), but only when the caller passes ``dropout_seeds``
(:func:`draw_dropout_seeds`: one for the embeddings, one per encoder
layer), never from a global generator, so a layer
recomputed under ``torch.utils.checkpoint`` (``remat``) draws the masks
its first forward drew. ``remat="dots"`` saves the matmul outputs of each
layer and recomputes the rest, the counterpart of the JAX encoder's
``checkpoint_dots_with_no_batch_dims``; ``"full"`` saves nothing.

Every model takes ``layer_norm_backend`` (``"plain"``, the default, or
``"kernel"``), the flax ``LayerNorm.backend`` field, and hands it to each
of its LayerNorms.

K-FAC taps (optim/kfac.py; the JAX model's ``kfac_tap``): the encoder's
q/k/v, attention-output and MLP-output Dense layers (``KFAC_TAPS`` of
:class:`BertSelfAttention` and :class:`BertLayer`; not the intermediate,
the pooler, the embeddings or the predictions head, as neither package
registers them) add their factor statistics to the ``kfac_sink`` an
optimizer arms on the module: Σ x̃x̃ᵀ of each layer input with the bias
coordinate appended (the A factor, one for q/k/v) and Σ ĝĝᵀ of each layer
output's fp32 cotangent (the G factor). Both are computed in backward
nodes, which run once per backward whatever the remat (a forward under
``torch.utils.checkpoint`` runs twice). Disarmed (``kfac_sink`` None, the
default) a tap is the identity and adds nothing to the graph. Under
``model`` the taps that see a rank's slice of the features (q/k/v's
outputs, the attention context, the MLP's intermediate) gather the slices
over the ``model`` group before the statistic.

Across ranks (parallel/): ``tp`` attributes, set by
``parallel/tensor_parallel.py`` ``split_model``, make a module hold its
``model`` rank's part and run Megatron's collectives (a Dense ``tp`` of
``("row", axis)`` sums its partial product over the axis before the
bias, ``("gather", axis)`` gathers its split output); ``ring`` on the
attention and ``seq`` on the embeddings put a layer on a ``seq`` shard
(ops/ring.py; the shard's position offset); a pipeline stage's encoder
holds its own layers under their global indices (``layer_ids``).

Module and parameter names mirror the flax tree (``query``, ``dense_act``,
``output_layer_norm``, ...), so :mod:`.convert` maps the JAX params onto
this state dict name by name. The encoder's ``nn.scan`` over layers is an
``nn.ModuleList`` here.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.ops import quant as quant_ops
from bert_pytorch_tpu_torch.ops.activations import ACT2FN
from bert_pytorch_tpu_torch.ops.attention import (dot_product_attention,
                                                  make_attention_bias,
                                                  resolve_backend)
from bert_pytorch_tpu_torch.ops.dropout import dropout
from bert_pytorch_tpu_torch.ops.layernorm import BACKENDS as LN_BACKENDS
from bert_pytorch_tpu_torch.ops.layernorm import layer_norm
from bert_pytorch_tpu_torch.parallel.tensor_parallel import (
    all_gather_last, copy_to, gather_last, reduce_from)

REMAT_POLICIES = ("none", "dots", "full")
# Seeds drawn per call site from one layer seed (see _sub_seed).
_ATTENTION_PROBS, _ATTENTION_OUT, _LAYER_OUT, _HEAD = range(4)


class _CastCache:
    """A module's fp32 parameters in the compute dtype.

    Under ``no_grad``/``inference_mode`` (serving) it keeps cached copies,
    keyed by each parameter's storage and version counter so an in-place
    update (``load_state_dict``, an optimizer step) invalidates them. When
    autograd records and a parameter requires grad, it casts with autograd
    on every call (no cache), so the gradient reaches the fp32 master."""

    def __init__(self):
        self._key = None
        self._values = None

    def get(self, params, dtype):
        if all(p.dtype == dtype for p in params):
            return tuple(params)
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            return tuple(p.to(dtype) for p in params)
        key = (dtype,) + tuple((p.data_ptr(), p._version) for p in params)
        if key != self._key:
            self._values = tuple(p.detach().to(dtype) for p in params)
            self._key = key
        return self._values


# The profiler range of every tap's statistic (tools/profile_train.py).
KFAC_CAPTURE_RANGE = "kfac.capture"


def _augmented(x: torch.Tensor) -> torch.Tensor:
    """x̃ = [x, 1]: the rows of ``x`` [..., d] in fp32 with the bias
    coordinate appended, [rows, d + 1]."""
    a = x.reshape(-1, x.shape[-1]).float()
    return torch.cat([a, a.new_ones(a.shape[0], 1)], dim=1)


class _InputStatistic(torch.autograd.Function):
    """Identity on ``x``; its backward adds Σ x̃x̃ᵀ over the rows of ``x``
    into ``out``, the K-FAC A statistic of a Dense layer consuming ``x``
    (JAX ``_kfac_input_stat``), in a backward node: once per backward,
    also under remat, where the forward runs again. With ``split`` (the
    ``model`` AxisGroup of a row-split layer, whose input is this rank's
    slice of the features) the slices are gathered whole first: the
    cross-blocks of A need the whole vector."""

    @staticmethod
    def forward(ctx, x, out, split):
        ctx.save_for_backward(x)
        ctx.out, ctx.split = out, split
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        with record_function(KFAC_CAPTURE_RANGE):
            a = _augmented(all_gather_last(x, ctx.split))
            ctx.out.addmm_(a.t(), a)
        return grad, None, None


class _OutputStatistic(torch.autograd.Function):
    """Identity on ``y``; its backward adds Σ ĝĝᵀ of the fp32 cotangent ĝ
    of ``y`` [..., d] into ``out`` (JAX ``_g_factor_probe``); with
    ``split`` (a column-split layer's ``model`` AxisGroup) the cotangent's
    slices gathered whole first."""

    @staticmethod
    def forward(ctx, y, out, split):
        ctx.out, ctx.split = out, split
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        with record_function(KFAC_CAPTURE_RANGE):
            whole = all_gather_last(grad, ctx.split)
            g = whole.reshape(-1, whole.shape[-1]).float()
            ctx.out.addmm_(g.t(), g)
        return grad, None, None


def kfac_input_tap(x: torch.Tensor, sink: Optional[dict], name: str,
                   split=None) -> torch.Tensor:
    """``x``, through an A-statistic tap into ``sink[name]`` when the
    module is armed and the factor is kept; ``split``: the ``model``
    AxisGroup over which ``x``'s features are split (None: whole)."""
    out = None if sink is None else sink.get(name)
    return x if out is None else _InputStatistic.apply(x, out, split)


def kfac_output_tap(y: torch.Tensor, sink: Optional[dict], name: str,
                    split=None) -> torch.Tensor:
    """``y``, through a G-statistic tap into ``sink[name]`` when the
    module is armed and the layer is kept; ``split`` as
    :func:`kfac_input_tap`'s."""
    out = None if sink is None else sink.get(name)
    return y if out is None else _OutputStatistic.apply(y, out, split)


class Dense(nn.Module):
    """``flax.linen.Dense``/``DenseGeneral`` counterpart: a weight in
    torch's [out, in] layout and a bias, stored in ``param_dtype`` (fp32,
    or bf16 for ``quant="bf16"``) and computed in ``dtype``. A DenseGeneral
    over (heads, head_dim) is this layer with the two axes flattened, which
    is what the caller reshapes to and from."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, device=None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features, dtype=param_dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=param_dtype,
                                             device=device))
        self.dtype = dtype
        self._cast = _CastCache()
        self.tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self._cast.get((self.weight, self.bias), self.dtype)
        x = x.to(self.dtype)
        if self.tp is None:
            return F.linear(x, weight, bias)
        mode, axis = self.tp
        if mode == "row":
            return reduce_from(F.linear(x, weight), axis) + bias
        return gather_last(F.linear(copy_to(x, axis), weight, bias), axis)


def make_dense(quant: Optional[str], in_features: int, out_features: int,
               dtype: torch.dtype, device=None) -> nn.Module:
    """The Dense of one serving-head call site (JAX ``quant.make_dense``):
    ``None`` the fp32 :class:`Dense` training uses, ``"bf16"`` the same
    module with bf16 storage, ``"int8"`` an ``Int8Dense``."""
    quant_ops.check_mode(quant)
    if quant == "int8":
        return quant_ops.Int8Dense(in_features, out_features, dtype, device)
    return Dense(in_features, out_features, dtype, device,
                 torch.bfloat16 if quant == "bf16" else torch.float32)


class Embed(nn.Module):
    """``flax.linen.Embed`` counterpart: an fp32 table looked up in
    ``dtype``. :meth:`compute_weight` hands the same table to the tied MLM
    decoder."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(num_embeddings, features, device=device))
        self.dtype = dtype
        self._cast = _CastCache()
        self.tp = None  # (model axis, first row held) of a vocab split

    def compute_weight(self) -> torch.Tensor:
        return self._cast.get((self.weight,), self.dtype)[0]

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        weight = self.compute_weight()
        if self.tp is None:
            return F.embedding(ids, weight)
        axis, start = self.tp
        local = ids - start
        inside = (local >= 0) & (local < weight.shape[0])
        rows = F.embedding(torch.where(inside, local, torch.zeros_like(
            local)), weight)
        return reduce_from(rows * inside[..., None].to(rows.dtype), axis)


class _FewRowsEmbedding(torch.autograd.Function):
    """``F.embedding`` whose weight gradient sums each row's tokens by one
    masked reduction per row, in a fixed order. ``F.embedding``'s CUDA
    backward sums the rows of a small table, each repeated thousands of
    times, in an order that varies from run to run: on an H100, BERT's two
    token-type rows in fp16 differed between two runs of the same step
    (``tools/probe_determinism.py --dtype float16 --pair repeat``; equal
    under PyTorch's deterministic mode), so a resumed fp16 run did not
    repeat the uninterrupted one bit for bit."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        grad = grad.reshape(-1, grad.shape[-1])
        flat = ids.reshape(-1, 1)
        zero = grad.new_zeros(())
        dweight = torch.stack([torch.where(flat == row, grad, zero).sum(0)
                               for row in range(ctx.rows)])
        return None, dweight


def embed_few_rows(ids: torch.Tensor, table: Embed) -> torch.Tensor:
    """``table(ids)`` with a weight gradient that is the same on every
    run (:class:`_FewRowsEmbedding`), for tables of a few rows (one masked
    pass over the gradient per row)."""
    return _FewRowsEmbedding.apply(ids, table.compute_weight())


class LayerNorm(nn.Module):
    """Affine LayerNorm; parity with ``BertLayerNorm`` (modeling.py:311-336).
    fp32 statistics, result in the input's dtype. ``backend`` is the flax
    module's field: ``"plain"`` (the JAX ``"xla"``) or ``"kernel"`` (the
    JAX ``"pallas"``: the hand-written forward kernel,
    ops/kernels/layernorm.py)."""

    def __init__(self, features: int, eps: float = 1e-12, device=None,
                 backend: str = "plain"):
        super().__init__()
        if backend not in LN_BACKENDS:
            raise ValueError(f"layer_norm_backend must be one of "
                             f"{LN_BACKENDS}, got {backend!r}")
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.eps = eps
        self.backend = backend

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.eps, self.backend)


class LinearActivation(nn.Module):
    """Linear + activation; parity with modeling.py:141-180. ``bias_gelu``
    and ``bias_tanh`` name the reference's fused bias+activation path; the
    Dense already added the bias, so the plain activation follows."""

    def __init__(self, in_features: int, out_features: int, act: str,
                 dtype: torch.dtype, device=None,
                 quant: Optional[str] = None):
        super().__init__()
        self.dense = make_dense(quant, in_features, out_features, dtype,
                                device)
        self.act = act[5:] if act.startswith("bias_") else act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ACT2FN[self.act](self.dense(x))


class BertEmbeddings(nn.Module):
    """word + position (+ token-type iff next_sentence) embeddings → LN.

    Parity with modeling.py:338-373. Packed rows restart their position ids
    at 0 for every packed sequence (a cummax of the segment starts), so a
    sequence embeds identically alone or packed at some row offset."""

    def __init__(self, config: BertConfig, dtype: torch.dtype, device=None,
                 layer_norm_backend: str = "plain"):
        super().__init__()
        cfg = config
        self.config = cfg
        self.word_embeddings = Embed(cfg.vocab_size, cfg.hidden_size, dtype,
                                     device)
        self.position_embeddings = Embed(cfg.max_position_embeddings,
                                         cfg.hidden_size, dtype, device)
        if cfg.next_sentence:
            self.token_type_embeddings = Embed(cfg.type_vocab_size,
                                               cfg.hidden_size, dtype, device)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                    device, layer_norm_backend)
        self.seq = None  # the seq AxisGroup of a sequence shard

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                sequence_ids: Optional[torch.Tensor] = None,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        seq_len = input_ids.shape[-1]
        idx = torch.arange(seq_len, device=input_ids.device)[None, :]
        if sequence_ids is not None:
            is_start = torch.ones_like(sequence_ids, dtype=torch.bool)
            is_start[:, 1:] = sequence_ids[:, 1:] != sequence_ids[:, :-1]
            starts = torch.where(is_start, idx, torch.zeros_like(idx))
            position_ids = idx - torch.cummax(starts, dim=-1).values
        elif self.seq is not None:
            position_ids = idx + self.seq.index * seq_len
        else:
            position_ids = idx
        x = self.word_embeddings(input_ids) + self.position_embeddings(
            position_ids)
        if self.config.next_sentence:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            x = x + embed_few_rows(token_type_ids,
                                   self.token_type_embeddings)
        x = self.layer_norm(x)
        if dropout_seed is None:
            return x
        return dropout(x, self.config.hidden_dropout_prob, dropout_seed)


class BertSelfAttention(nn.Module):
    """Multi-head self-attention + its output projection and residual
    LayerNorm; parity with modeling.py:376-443. q/k/v are [B, S, H, D]
    projections; the attention core routes through
    :func:`~bert_pytorch_tpu_torch.ops.attention.dot_product_attention`."""

    # K-FAC: (Dense submodule, its A factor); q/k/v share their input's.
    KFAC_TAPS = (("query", "attn_in"), ("key", "attn_in"),
                 ("value", "attn_in"), ("output", "attn_ctx"))

    def __init__(self, config: BertConfig, dtype: torch.dtype,
                 attention_backend: str, device=None,
                 quant: Optional[str] = None,
                 layer_norm_backend: str = "plain"):
        super().__init__()
        cfg = config
        self.heads, self.head_dim = cfg.num_attention_heads, cfg.head_dim
        width = self.heads * self.head_dim
        self.query = make_dense(quant, cfg.hidden_size, width, dtype, device)
        self.key = make_dense(quant, cfg.hidden_size, width, dtype, device)
        self.value = make_dense(quant, cfg.hidden_size, width, dtype, device)
        self.output = make_dense(quant, width, cfg.hidden_size, dtype, device)
        self.output_layer_norm = LayerNorm(cfg.hidden_size,
                                           cfg.layer_norm_eps, device,
                                           layer_norm_backend)
        self.attention_backend = attention_backend
        self.attention_dropout = cfg.attention_probs_dropout_prob
        self.hidden_dropout = cfg.hidden_dropout_prob
        self.kfac_sink: Optional[dict] = None
        self.tp = None  # the model AxisGroup: H / model heads here
        self.ring = None  # the seq AxisGroup of the ring backend

    def forward(self, hidden: torch.Tensor, bias: Optional[torch.Tensor],
                sequence_ids: Optional[torch.Tensor] = None,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        batch, seq = hidden.shape[0], hidden.shape[1]
        shape = (batch, seq, self.heads, self.head_dim)
        sink = self.kfac_sink
        x = copy_to(kfac_input_tap(hidden, sink, "attn_in_a"), self.tp)
        # Under ``model`` q, k, v and the context hold this rank's heads.
        tp = self.tp
        q = kfac_output_tap(self.query(x), sink, "query__attn_in",
                            tp).view(shape)
        k = kfac_output_tap(self.key(x), sink, "key__attn_in", tp).view(shape)
        v = kfac_output_tap(self.value(x), sink, "value__attn_in",
                            tp).view(shape)
        train = dropout_seed is not None
        probs_seed = None
        if train:
            probs_seed = _sub_seed(dropout_seed, _ATTENTION_PROBS)
            if self.tp is not None:
                # Each model rank's heads draw masks of their own.
                probs_seed = fold_dropout_seeds([probs_seed],
                                                self.tp.index)[0]
        context = dot_product_attention(
            q, k, v, bias=bias, dropout_rate=self.attention_dropout,
            deterministic=not train, backend=self.attention_backend,
            sequence_ids=sequence_ids, dropout_seed=probs_seed,
            ring=self.ring)
        context = kfac_input_tap(context.reshape(batch, seq, -1), sink,
                                 "attn_ctx_a", tp)
        out = kfac_output_tap(self.output(context), sink, "output__attn_ctx")
        if train:
            out = dropout(out, self.hidden_dropout,
                          _sub_seed(dropout_seed, _ATTENTION_OUT))
        return self.output_layer_norm(out + hidden)


class BertLayer(nn.Module):
    """attention → intermediate (GELU) → output; parity with
    modeling.py:482-493."""

    KFAC_TAPS = (("output", "mlp_in"),)

    def __init__(self, config: BertConfig, dtype: torch.dtype,
                 attention_backend: str, device=None,
                 quant: Optional[str] = None,
                 layer_norm_backend: str = "plain"):
        super().__init__()
        cfg = config
        self.attention = BertSelfAttention(cfg, dtype, attention_backend,
                                           device, quant, layer_norm_backend)
        self.intermediate = LinearActivation(
            cfg.hidden_size, cfg.intermediate_size, cfg.hidden_act, dtype,
            device, quant)
        self.output = make_dense(quant, cfg.intermediate_size,
                                 cfg.hidden_size, dtype, device)
        self.output_layer_norm = LayerNorm(cfg.hidden_size,
                                           cfg.layer_norm_eps, device,
                                           layer_norm_backend)
        self.hidden_dropout = cfg.hidden_dropout_prob
        self.kfac_sink: Optional[dict] = None
        self.tp = None  # the model AxisGroup: intermediate / model here

    def forward(self, hidden, bias, sequence_ids=None, dropout_seed=None):
        attn_out = self.attention(hidden, bias, sequence_ids, dropout_seed)
        sink = self.kfac_sink
        intermediate = kfac_input_tap(self.intermediate(
            copy_to(attn_out, self.tp)), sink, "mlp_in_a", self.tp)
        out = kfac_output_tap(self.output(intermediate), sink,
                              "output__mlp_in")
        if dropout_seed is not None:
            out = dropout(out, self.hidden_dropout,
                          _sub_seed(dropout_seed, _LAYER_OUT))
        return self.output_layer_norm(out + attn_out)


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of the Dense matmuls (no batch dims), recompute the
    rest: attention, activations, LayerNorm, dropout."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


class BertEncoder(nn.Module):
    """num_hidden_layers × BertLayer (the JAX package's ``nn.scan`` stack,
    here a ModuleList walked in order; modeling.py:522-536), each layer
    under ``torch.utils.checkpoint`` when ``remat`` is ``"dots"`` or
    ``"full"`` (the JAX encoder's ``nn.remat`` policies)."""

    def __init__(self, config: BertConfig, dtype: torch.dtype,
                 attention_backend: str, device=None, remat: str = "none",
                 quant: Optional[str] = None,
                 layer_norm_backend: str = "plain"):
        super().__init__()
        if remat not in REMAT_POLICIES:
            raise ValueError(f"remat must be one of {REMAT_POLICIES}, got "
                             f"{remat!r}")
        self.remat = remat
        self.layers = nn.ModuleList(
            BertLayer(config, dtype, attention_backend, device, quant,
                      layer_norm_backend)
            for _ in range(config.num_hidden_layers))
        # The global index of each layer held (a pipeline stage holds a
        # contiguous block, parallel/pipeline.py).
        self.layer_ids = list(range(config.num_hidden_layers))

    def forward(self, hidden, bias, sequence_ids=None, dropout_seeds=None):
        """``dropout_seeds``: one int per layer of the whole stack (a
        stage takes its layers' by global index), or None (no
        dropout)."""
        for i, layer in zip(self.layer_ids, self.layers):
            seed = None if dropout_seeds is None else dropout_seeds[i]
            if self.remat == "none" or not torch.is_grad_enabled():
                hidden = layer(hidden, bias, sequence_ids, seed)
                continue
            context_fn = (partial(create_selective_checkpoint_contexts,
                                  _dots_policy)
                          if self.remat == "dots" else None)
            kwargs = {"context_fn": context_fn} if context_fn else {}
            hidden = checkpoint(layer, hidden, bias, sequence_ids, seed,
                                use_reentrant=False, **kwargs)
        return hidden


class BertPooler(nn.Module):
    """tanh dense over the [CLS] token; parity with modeling.py:538-549.
    For packed rows, ``positions`` [B, K] gathers each packed sequence's
    own [CLS] offset and returns [B, K, hidden]."""

    def __init__(self, config: BertConfig, dtype: torch.dtype, device=None,
                 quant: Optional[str] = None):
        super().__init__()
        self.dense_act = LinearActivation(
            config.hidden_size, config.hidden_size, "tanh", dtype, device,
            quant)

    def forward(self, sequence_output: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        cls = (sequence_output[:, 0] if positions is None
               else gather_rows(sequence_output, positions))
        return self.dense_act(cls)


class BertModel(nn.Module):
    """embeddings → encoder → (pooler iff next_sentence, or ``pooler``);
    parity with modeling.py:802-883. Returns ``(sequence_output,
    pooled)``, ``pooled`` None without a pooler. A classification head on
    a config without NSP (RoBERTa) asks for the pooler with
    ``pooler=True``: its dense + tanh over the first token is then the
    head's own fresh layer (RoBERTa's classification head), which a
    pretraining checkpoint does not hold."""

    def __init__(self, config: BertConfig, dtype: torch.dtype,
                 attention_backend: str = "dense", device=None,
                 remat: str = "none", quant: Optional[str] = None,
                 layer_norm_backend: str = "plain",
                 pooler: bool = False):
        super().__init__()
        self.config = config
        self.has_pooler = config.next_sentence or pooler
        self.attention_backend = attention_backend
        self.embeddings = BertEmbeddings(config, dtype, device,
                                         layer_norm_backend)
        self.encoder = BertEncoder(config, dtype, attention_backend, device,
                                   remat, quant, layer_norm_backend)
        if self.has_pooler:
            self.pooler = BertPooler(config, dtype, device, quant)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                sequence_ids=None, cls_positions=None, dropout_seeds=None):
        """``sequence_ids``/``cls_positions`` mark a PACKED batch:
        block-diagonal attention, per-sequence position restart and, with
        ``cls_positions`` [B, K], one pooled vector per packed sequence.
        ``dropout_seeds`` (embeddings, then one per layer) turns dropout
        on."""
        bias = self.attention_bias(input_ids, attention_mask, sequence_ids)
        self.check_seeds(dropout_seeds)
        hidden = self.embeddings(input_ids, token_type_ids, sequence_ids,
                                 None if dropout_seeds is None
                                 else dropout_seeds[0])
        sequence_output = self.encoder(
            hidden, bias, sequence_ids,
            None if dropout_seeds is None else list(dropout_seeds)[1:])
        return sequence_output, self.pool(sequence_output, cls_positions)

    def attention_bias(self, input_ids, attention_mask=None,
                       sequence_ids=None) -> Optional[torch.Tensor]:
        """The encoder's attention bias for this batch: None for packed
        rows on the fused kernels (they rebuild the block-diagonal mask
        from the ids), else :func:`make_attention_bias`'s."""
        backend = resolve_backend(self.attention_backend,
                                  input_ids.shape[-1], input_ids.device)
        if sequence_ids is not None and backend not in ("dense", "ring"):
            return None
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        return make_attention_bias(attention_mask, torch.float32,
                                   sequence_ids)

    def check_seeds(self, dropout_seeds) -> None:
        if dropout_seeds is not None and (
                len(dropout_seeds) != 1 + self.config.num_hidden_layers):
            raise ValueError(
                f"dropout_seeds holds {len(dropout_seeds)} seeds; the model "
                f"needs {1 + self.config.num_hidden_layers} (embeddings + "
                "one per layer, draw_dropout_seeds)")

    def pool(self, sequence_output, cls_positions=None):
        return (self.pooler(sequence_output, cls_positions)
                if self.has_pooler else None)


class BertPredictionHeadTransform(nn.Module):
    """dense → act → LayerNorm; parity with modeling.py:551-561."""

    def __init__(self, config: BertConfig, dtype: torch.dtype, device=None,
                 quant: Optional[str] = None,
                 layer_norm_backend: str = "plain"):
        super().__init__()
        self.dense_act = LinearActivation(
            config.hidden_size, config.hidden_size, config.hidden_act, dtype,
            device, quant)
        self.layer_norm = LayerNorm(config.hidden_size, config.layer_norm_eps,
                                    device, layer_norm_backend)

    def forward(self, hidden):
        return self.layer_norm(self.dense_act(hidden))


class BertLMPredictionHead(nn.Module):
    """MLM head whose decoder weight IS the word-embedding table plus a
    free bias; parity with modeling.py:563-599."""

    def __init__(self, config: BertConfig, dtype: torch.dtype, device=None,
                 quant: Optional[str] = None,
                 layer_norm_backend: str = "plain"):
        super().__init__()
        self.transform = BertPredictionHeadTransform(config, dtype, device,
                                                     quant, layer_norm_backend)
        self.bias = nn.Parameter(torch.zeros(config.vocab_size, device=device))
        self.dtype = dtype
        self._cast = _CastCache()
        self.tp = None  # the model AxisGroup of a vocab split

    def forward(self, hidden: torch.Tensor,
                word_embeddings: Embed) -> torch.Tensor:
        x = copy_to(self.transform(hidden), self.tp)
        (bias,) = self._cast.get((self.bias,), self.dtype)
        return gather_last(F.linear(x, word_embeddings.compute_weight(),
                                    bias), self.tp)


class BertForPreTraining(nn.Module):
    """MLM + NSP pretraining model; parity with modeling.py:886-947 and the
    JAX package's ``BertForPreTraining``. Returns ``(prediction_logits,
    seq_relationship_logits)``; the second is None when
    ``config.next_sentence`` is False."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32,
                 attention_backend: str = "dense", remat: str = "none",
                 device=None, layer_norm_backend: str = "plain"):
        super().__init__()
        self.config = config
        self.bert = BertModel(config, dtype, attention_backend, device, remat,
                              layer_norm_backend=layer_norm_backend)
        self.predictions = BertLMPredictionHead(
            config, dtype, device, layer_norm_backend=layer_norm_backend)
        if config.next_sentence:
            self.seq_relationship = Dense(config.hidden_size, 2, dtype,
                                          device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_positions=None, sequence_ids=None, cls_positions=None,
                dropout_seeds=None):
        """With ``masked_positions`` [B, P] the MLM logits are computed only
        at those positions ([B, P, V] instead of [B, S, V]): the hidden
        states are gathered before the tied decoder (the JAX model uses a
        one-hot matmul for the TPU's sake; a gather is the same values).
        ``sequence_ids``/``cls_positions`` select the packed path and give
        [B, K, 2] NSP logits, one per packed sequence."""
        sequence_output, pooled = self.bert(
            input_ids, token_type_ids, attention_mask, sequence_ids,
            cls_positions, dropout_seeds)
        return self.heads(sequence_output, pooled, masked_positions)

    def stage_forward(self, hidden, input_ids, token_type_ids, bias,
                      sequence_ids=None, cls_positions=None,
                      masked_positions=None, dropout_seeds=None,
                      first: bool = True, last: bool = True):
        """One pipeline stage's share of :meth:`forward`
        (parallel/pipeline.py): the embeddings on the ``first`` stage
        (``hidden`` None), this stage's encoder layers under the attention
        ``bias``, and on the ``last`` the heads' (MLM, NSP) logits, else
        the hidden states to send on. Under FSDP2 it is a forward of the
        root (parallel/sharding.py)."""
        if first:
            hidden = self.bert.embeddings(
                input_ids, token_type_ids, sequence_ids,
                None if dropout_seeds is None else dropout_seeds[0])
        hidden = self.bert.encoder(
            hidden, bias, sequence_ids,
            None if dropout_seeds is None else list(dropout_seeds)[1:])
        if not last:
            return hidden
        return self.heads(hidden, self.bert.pool(hidden, cls_positions),
                          masked_positions)

    def heads(self, sequence_output, pooled, masked_positions=None):
        """(MLM logits, NSP logits or None) from the encoder's output and
        the pooled vector."""
        if masked_positions is not None:
            sequence_output = gather_rows(sequence_output, masked_positions)
        prediction_logits = self.predictions(
            sequence_output, self.bert.embeddings.word_embeddings)
        seq_logits = (self.seq_relationship(pooled)
                      if self.config.next_sentence else None)
        return prediction_logits, seq_logits


def gather_rows(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """[B, P, ...] rows of ``x`` [B, S, ...] at ``positions`` [B, P] (the
    JAX model's one-hot matmul gather, as an index gather: the same
    values)."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, positions.long()]


def _sub_seed(seed: int, site: int) -> int:
    """The seed of one dropout site of a layer, from the layer's seed."""
    return seed * 4 + site


def draw_dropout_seeds(generator: torch.Generator,
                       num_layers: int) -> Sequence[int]:
    """Seeds for one training forward: one for the embeddings, then one per
    encoder layer (the JAX encoder splits its dropout rng per layer), drawn
    before the forward so a recomputed layer reuses its seed."""
    draws = torch.randint(0, 2 ** 61, (num_layers + 1,), generator=generator)
    # Host-resident: every caller passes a CPU generator, so the draw and
    # its list never leave the host.
    return [int(x) for x in draws.tolist()]  # torchlint: disable=HS101


# An odd 64-bit constant (the golden ratio's) that spreads rank r's fold.
_RANK_FOLD = 0x9E3779B97F4A7C15


def fold_dropout_seeds(seeds: Sequence[int], rank: int) -> Sequence[int]:
    """Rank ``rank``'s dropout seeds from one forward's draw: rank 0 keeps
    the draw unchanged (so a one-rank run is the single-process run), any
    other rank folds its index into each seed. The kernels key their
    Philox masks by the seed and the LOCAL batch coordinates, so ranks
    with the same seeds would drop the same positions of different
    examples (the JAX overlap step folds the shard index for the same
    reason, pretrain.py:250-255)."""
    if rank == 0:
        return list(seeds)
    return [(s ^ ((rank * _RANK_FOLD) & (2 ** 64 - 1))) % (2 ** 61)
            for s in seeds]


class BertForMaskedLM(nn.Module):
    """MLM only; parity with modeling.py:950-1008. ``sequence_ids`` selects
    the packed-row path (block-diagonal attention, position restart)."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32,
                 attention_backend: str = "dense", device=None,
                 quant: Optional[str] = None,
                 layer_norm_backend: str = "plain"):
        super().__init__()
        self.bert = BertModel(config, dtype, attention_backend, device,
                              quant=quant,
                              layer_norm_backend=layer_norm_backend)
        self.predictions = BertLMPredictionHead(config, dtype, device, quant,
                                                layer_norm_backend)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                sequence_ids=None, output_positions=None):
        """``output_positions`` [B, P] selects the fused-epilogue path: the
        hidden rows at those positions are gathered BEFORE the vocab
        projection, so the head returns [B, P, V] instead of [B, S, V]."""
        sequence_output, _ = self.bert(input_ids, token_type_ids,
                                       attention_mask, sequence_ids)
        if output_positions is not None:
            sequence_output = gather_rows(sequence_output, output_positions)
        return self.predictions(sequence_output,
                                self.bert.embeddings.word_embeddings)


class _ClassifierHead(nn.Module):
    """Dropout then the Dense classifier, shared by the task heads; the
    dropout runs only under the seeds of a training forward."""

    def __init__(self, hidden_size: int, num_labels: int,
                 dtype: torch.dtype, device=None,
                 quant: Optional[str] = None, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        # An output layer (quant.EXCLUDE_MODULES): bf16, never int8.
        self.classifier = make_dense(quant_ops.exclude(quant), hidden_size,
                                     num_labels, dtype, device)

    def forward(self, x, dropout_seeds=None):
        if dropout_seeds is not None:
            x = dropout(x, self.dropout_rate,
                        _sub_seed(dropout_seeds[0], _HEAD))
        return self.classifier(x)


class BertForSequenceClassification(nn.Module):
    """Pooled-output classifier; parity with modeling.py:1072-1128 (a
    regression when ``num_labels == 1``, STS-B: the same model, the runner
    takes the squared error). ``sequence_ids`` + ``cls_positions`` select
    the packed-row path and return [B, K, num_labels], one row per packed
    request. A config without NSP (RoBERTa) gets the pooler all the same,
    as the head's fresh dense + tanh (:class:`BertModel` ``pooler``)."""

    def __init__(self, config: BertConfig, num_labels: int,
                 dtype: torch.dtype = torch.float32,
                 attention_backend: str = "dense", device=None,
                 quant: Optional[str] = None,
                 layer_norm_backend: str = "plain"):
        super().__init__()
        self.bert = BertModel(config, dtype, attention_backend, device,
                              quant=quant,
                              layer_norm_backend=layer_norm_backend,
                              pooler=True)
        self.head = _ClassifierHead(config.hidden_size, num_labels, dtype,
                                    device, quant,
                                    config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                sequence_ids=None, cls_positions=None, dropout_seeds=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask,
                              sequence_ids, cls_positions, dropout_seeds)
        return self.head(pooled, dropout_seeds)


class BertForMultipleChoice(nn.Module):
    """[B, C, S] choices flattened to [B*C, S] rows, one pooled score each,
    returned as [B, C]; parity with modeling.py:1131-1197 and the JAX
    package's ``BertForMultipleChoice`` (the pooler built on a config
    without NSP, as in :class:`BertForSequenceClassification`)."""

    def __init__(self, config: BertConfig, num_choices: int,
                 dtype: torch.dtype = torch.float32,
                 attention_backend: str = "dense", device=None,
                 layer_norm_backend: str = "plain"):
        super().__init__()
        self.num_choices = num_choices
        self.bert = BertModel(config, dtype, attention_backend, device,
                              layer_norm_backend=layer_norm_backend,
                              pooler=True)
        self.head = _ClassifierHead(config.hidden_size, 1, dtype, device,
                                    dropout_rate=config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                dropout_seeds=None):
        batch, choices, seq = input_ids.shape

        def flat(t):
            return None if t is None else t.reshape(batch * choices, seq)

        _, pooled = self.bert(flat(input_ids), flat(token_type_ids),
                              flat(attention_mask), None, None, dropout_seeds)
        return self.head(pooled, dropout_seeds).reshape(batch, choices)


class BertForTokenClassification(nn.Module):
    """Per-token classifier; parity with modeling.py:1200-1271 and the JAX
    package's ``BertForTokenClassification``. Returns [B, S, num_labels];
    ``sequence_ids`` selects the packed-row path (the engine demultiplexes
    each packed request's own run of tokens)."""

    def __init__(self, config: BertConfig, num_labels: int,
                 dtype: torch.dtype = torch.float32,
                 attention_backend: str = "dense", device=None,
                 quant: Optional[str] = None,
                 layer_norm_backend: str = "plain"):
        super().__init__()
        self.bert = BertModel(config, dtype, attention_backend, device,
                              quant=quant,
                              layer_norm_backend=layer_norm_backend)
        self.head = _ClassifierHead(config.hidden_size, num_labels, dtype,
                                    device, quant,
                                    config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                sequence_ids=None, dropout_seeds=None):
        sequence_output, _ = self.bert(input_ids, token_type_ids,
                                       attention_mask, sequence_ids, None,
                                       dropout_seeds)
        return self.head(sequence_output, dropout_seeds)


class BertForQuestionAnswering(nn.Module):
    """Start/end span logits; parity with modeling.py:1274-1327 and the JAX
    package's ``BertForQuestionAnswering``. Returns ``(start_logits,
    end_logits)``, each [B, S] fp32: the ``qa_outputs`` Dense computes in
    fp32 whatever the model's dtype (the JAX head's ``dtype=float32``).
    With ``quant=`` (serving) the encoder takes that storage and
    ``qa_outputs``, an output layer, ``quant_ops.exclude(quant)``'s: bf16
    weights, fp32 compute (JAX bert.py:978-985)."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32,
                 attention_backend: str = "dense", remat: str = "none",
                 device=None, layer_norm_backend: str = "plain",
                 quant: Optional[str] = None):
        super().__init__()
        self.config = config
        self.bert = BertModel(config, dtype, attention_backend, device, remat,
                              quant=quant,
                              layer_norm_backend=layer_norm_backend)
        self.qa_outputs = make_dense(quant_ops.exclude(quant),
                                     config.hidden_size, 2, torch.float32,
                                     device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                sequence_ids=None, dropout_seeds=None):
        """``dropout_seeds`` (:func:`draw_dropout_seeds`) turns dropout on;
        ``sequence_ids`` selects the packed-row path."""
        sequence_output, _ = self.bert(input_ids, token_type_ids,
                                       attention_mask, sequence_ids, None,
                                       dropout_seeds)
        logits = self.qa_outputs(sequence_output)
        return logits[..., 0], logits[..., 1]


@torch.no_grad()
def init_weights(model: nn.Module, initializer_range: float,
                 generator: torch.Generator) -> nn.Module:
    """Seeded random init (the demo-mode weights): Dense/Embed weights ~
    Normal(0, initializer_range) (reference modeling.py:635-640), biases
    zero, LayerNorm scale one. ``generator`` must live on the parameters'
    device."""
    for module in model.modules():
        if isinstance(module, (Dense, Embed)):
            module.weight.normal_(0.0, initializer_range,
                                  generator=generator)
        if isinstance(module, Dense):
            module.bias.zero_()
        elif isinstance(module, LayerNorm):
            module.scale.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, BertLMPredictionHead):
            module.bias.zero_()
    return model
