"""BERT model family in PyTorch: the port of the JAX package's
``models/bert.py`` for the serving heads.

Component parity with reference src/modeling.py (cited per class). The
dtype semantics follow the JAX package's flax modules:

  - parameters are kept in fp32;
  - Dense and Embed layers compute in the model's ``dtype`` (bf16 when
    serving), casting their fp32 parameters to it;
  - LayerNorm statistics and the attention softmax run in fp32.

For serving, each Dense/Embed keeps one cached copy of its parameters in
the compute dtype (rebuilt whenever the fp32 parameter changes), so a bf16
forward does not re-cast the weights on every call. The cache holds a bf16
copy of every matmul weight beside the fp32 master.

Module and parameter names mirror the flax tree (``query``, ``dense_act``,
``output_layer_norm``, ...), so :mod:`.convert` maps the JAX params onto
this state dict name by name. The encoder's ``nn.scan`` over layers is an
``nn.ModuleList`` here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.ops.activations import ACT2FN
from bert_pytorch_tpu_torch.ops.attention import (dot_product_attention,
                                                  make_attention_bias)
from bert_pytorch_tpu_torch.ops.layernorm import layer_norm


class _CastCache:
    """Copies of a module's fp32 parameters in the compute dtype, keyed by
    each parameter's storage and version counter so an in-place update
    (``load_state_dict``) invalidates them."""

    def __init__(self):
        self._key = None
        self._values = None

    def get(self, params, dtype):
        if all(p.dtype == dtype for p in params):
            return tuple(params)
        key = (dtype,) + tuple((p.data_ptr(), p._version) for p in params)
        if key != self._key:
            self._values = tuple(p.detach().to(dtype) for p in params)
            self._key = key
        return self._values


class Dense(nn.Module):
    """``flax.linen.Dense``/``DenseGeneral`` counterpart: an fp32 weight in
    torch's [out, in] layout and an fp32 bias, computed in ``dtype``. A
    DenseGeneral over (heads, head_dim) is this layer with the two axes
    flattened, which is what the caller reshapes to and from."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))
        self.dtype = dtype
        self._cast = _CastCache()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self._cast.get((self.weight, self.bias), self.dtype)
        return F.linear(x.to(self.dtype), weight, bias)


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

    def compute_weight(self) -> torch.Tensor:
        return self._cast.get((self.weight,), self.dtype)[0]

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.compute_weight())


class LayerNorm(nn.Module):
    """Affine LayerNorm; parity with ``BertLayerNorm`` (modeling.py:311-336).
    fp32 statistics, result in the input's dtype."""

    def __init__(self, features: int, eps: float = 1e-12, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.eps)


class LinearActivation(nn.Module):
    """Linear + activation; parity with modeling.py:141-180. ``bias_gelu``
    and ``bias_tanh`` name the reference's fused bias+activation path; the
    Dense already added the bias, so the plain activation follows."""

    def __init__(self, in_features: int, out_features: int, act: str,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.dense = Dense(in_features, out_features, dtype, device)
        self.act = act[5:] if act.startswith("bias_") else act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ACT2FN[self.act](self.dense(x))


class BertEmbeddings(nn.Module):
    """word + position (+ token-type iff next_sentence) embeddings → LN.

    Parity with modeling.py:338-373. Packed rows restart their position ids
    at 0 for every packed sequence (a cummax of the segment starts), so a
    sequence embeds identically alone or packed at some row offset."""

    def __init__(self, config: BertConfig, dtype: torch.dtype, device=None):
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
                                    device)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                sequence_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        seq_len = input_ids.shape[-1]
        idx = torch.arange(seq_len, device=input_ids.device)[None, :]
        if sequence_ids is not None:
            is_start = torch.ones_like(sequence_ids, dtype=torch.bool)
            is_start[:, 1:] = sequence_ids[:, 1:] != sequence_ids[:, :-1]
            starts = torch.where(is_start, idx, torch.zeros_like(idx))
            position_ids = idx - torch.cummax(starts, dim=-1).values
        else:
            position_ids = idx
        x = self.word_embeddings(input_ids) + self.position_embeddings(
            position_ids)
        if self.config.next_sentence:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            x = x + self.token_type_embeddings(token_type_ids)
        return self.layer_norm(x)


class BertSelfAttention(nn.Module):
    """Multi-head self-attention + its output projection and residual
    LayerNorm; parity with modeling.py:376-443. q/k/v are [B, S, H, D]
    projections; the attention core routes through
    :func:`~bert_pytorch_tpu_torch.ops.attention.dot_product_attention`."""

    def __init__(self, config: BertConfig, dtype: torch.dtype,
                 attention_backend: str, device=None):
        super().__init__()
        cfg = config
        self.heads, self.head_dim = cfg.num_attention_heads, cfg.head_dim
        width = self.heads * self.head_dim
        self.query = Dense(cfg.hidden_size, width, dtype, device)
        self.key = Dense(cfg.hidden_size, width, dtype, device)
        self.value = Dense(cfg.hidden_size, width, dtype, device)
        self.output = Dense(width, cfg.hidden_size, dtype, device)
        self.output_layer_norm = LayerNorm(cfg.hidden_size,
                                           cfg.layer_norm_eps, device)
        self.attention_backend = attention_backend

    def forward(self, hidden: torch.Tensor, bias: Optional[torch.Tensor],
                sequence_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        batch, seq = hidden.shape[0], hidden.shape[1]
        shape = (batch, seq, self.heads, self.head_dim)
        q = self.query(hidden).view(shape)
        k = self.key(hidden).view(shape)
        v = self.value(hidden).view(shape)
        context = dot_product_attention(
            q, k, v, bias=bias, backend=self.attention_backend,
            sequence_ids=sequence_ids)
        out = self.output(context.reshape(batch, seq, -1))
        return self.output_layer_norm(out + hidden)


class BertLayer(nn.Module):
    """attention → intermediate (GELU) → output; parity with
    modeling.py:482-493."""

    def __init__(self, config: BertConfig, dtype: torch.dtype,
                 attention_backend: str, device=None):
        super().__init__()
        cfg = config
        self.attention = BertSelfAttention(cfg, dtype, attention_backend,
                                           device)
        self.intermediate = LinearActivation(
            cfg.hidden_size, cfg.intermediate_size, cfg.hidden_act, dtype,
            device)
        self.output = Dense(cfg.intermediate_size, cfg.hidden_size, dtype,
                            device)
        self.output_layer_norm = LayerNorm(cfg.hidden_size,
                                           cfg.layer_norm_eps, device)

    def forward(self, hidden, bias, sequence_ids=None):
        attn_out = self.attention(hidden, bias, sequence_ids)
        out = self.output(self.intermediate(attn_out))
        return self.output_layer_norm(out + attn_out)


class BertEncoder(nn.Module):
    """num_hidden_layers × BertLayer (the JAX package's ``nn.scan`` stack,
    here a ModuleList walked in order; modeling.py:522-536)."""

    def __init__(self, config: BertConfig, dtype: torch.dtype,
                 attention_backend: str, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            BertLayer(config, dtype, attention_backend, device)
            for _ in range(config.num_hidden_layers))

    def forward(self, hidden, bias, sequence_ids=None):
        for layer in self.layers:
            hidden = layer(hidden, bias, sequence_ids)
        return hidden


class BertPooler(nn.Module):
    """tanh dense over the [CLS] token; parity with modeling.py:538-549.
    For packed rows, ``positions`` [B, K] gathers each packed sequence's
    own [CLS] offset and returns [B, K, hidden]."""

    def __init__(self, config: BertConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.dense_act = LinearActivation(
            config.hidden_size, config.hidden_size, "tanh", dtype, device)

    def forward(self, sequence_output: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        if positions is None:
            cls = sequence_output[:, 0]
        else:
            rows = torch.arange(sequence_output.shape[0],
                                device=sequence_output.device)[:, None]
            cls = sequence_output[rows, positions.long()]
        return self.dense_act(cls)


class BertModel(nn.Module):
    """embeddings → encoder → (pooler iff next_sentence); parity with
    modeling.py:802-883. Returns ``(sequence_output, pooled)``."""

    def __init__(self, config: BertConfig, dtype: torch.dtype,
                 attention_backend: str = "dense", device=None):
        super().__init__()
        self.config = config
        self.attention_backend = attention_backend
        self.embeddings = BertEmbeddings(config, dtype, device)
        self.encoder = BertEncoder(config, dtype, attention_backend, device)
        if config.next_sentence:
            self.pooler = BertPooler(config, dtype, device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                sequence_ids=None, cls_positions=None):
        """``sequence_ids``/``cls_positions`` mark a PACKED batch:
        block-diagonal attention, per-sequence position restart and, with
        ``cls_positions`` [B, K], one pooled vector per packed sequence."""
        if sequence_ids is not None and self.attention_backend == "flash_infer":
            # The fused kernel rebuilds the block-diagonal mask from the
            # ids, so the [B, 1, S, S] bias is never built.
            bias = None
        else:
            if attention_mask is None:
                attention_mask = torch.ones_like(input_ids)
            bias = make_attention_bias(attention_mask, torch.float32,
                                       sequence_ids)
        hidden = self.embeddings(input_ids, token_type_ids, sequence_ids)
        sequence_output = self.encoder(hidden, bias, sequence_ids)
        pooled = (self.pooler(sequence_output, cls_positions)
                  if self.config.next_sentence else None)
        return sequence_output, pooled


class BertPredictionHeadTransform(nn.Module):
    """dense → act → LayerNorm; parity with modeling.py:551-561."""

    def __init__(self, config: BertConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.dense_act = LinearActivation(
            config.hidden_size, config.hidden_size, config.hidden_act, dtype,
            device)
        self.layer_norm = LayerNorm(config.hidden_size, config.layer_norm_eps,
                                    device)

    def forward(self, hidden):
        return self.layer_norm(self.dense_act(hidden))


class BertLMPredictionHead(nn.Module):
    """MLM head whose decoder weight IS the word-embedding table plus a
    free bias; parity with modeling.py:563-599."""

    def __init__(self, config: BertConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.transform = BertPredictionHeadTransform(config, dtype, device)
        self.bias = nn.Parameter(torch.zeros(config.vocab_size, device=device))
        self.dtype = dtype
        self._cast = _CastCache()

    def forward(self, hidden: torch.Tensor,
                word_embeddings: Embed) -> torch.Tensor:
        x = self.transform(hidden)
        (bias,) = self._cast.get((self.bias,), self.dtype)
        return F.linear(x, word_embeddings.compute_weight(), bias)


class BertForMaskedLM(nn.Module):
    """MLM only; parity with modeling.py:950-1008. ``sequence_ids`` selects
    the packed-row path (block-diagonal attention, position restart)."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32,
                 attention_backend: str = "dense", device=None):
        super().__init__()
        self.bert = BertModel(config, dtype, attention_backend, device)
        self.predictions = BertLMPredictionHead(config, dtype, device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                sequence_ids=None):
        sequence_output, _ = self.bert(input_ids, token_type_ids,
                                       attention_mask, sequence_ids)
        return self.predictions(sequence_output,
                                self.bert.embeddings.word_embeddings)


class _ClassifierHead(nn.Module):
    """The Dense classifier shared by the task heads (its dropout is a
    no-op in inference)."""

    def __init__(self, hidden_size: int, num_labels: int,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.classifier = Dense(hidden_size, num_labels, dtype, device)

    def forward(self, x):
        return self.classifier(x)


class BertForSequenceClassification(nn.Module):
    """Pooled-output classifier; parity with modeling.py:1072-1128.
    ``sequence_ids`` + ``cls_positions`` select the packed-row path and
    return [B, K, num_labels], one row per packed request."""

    def __init__(self, config: BertConfig, num_labels: int,
                 dtype: torch.dtype = torch.float32,
                 attention_backend: str = "dense", device=None):
        super().__init__()
        if not config.next_sentence:
            raise ValueError("BertForSequenceClassification needs the "
                             "pooler (config.next_sentence)")
        self.bert = BertModel(config, dtype, attention_backend, device)
        self.head = _ClassifierHead(config.hidden_size, num_labels, dtype,
                                    device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                sequence_ids=None, cls_positions=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask,
                              sequence_ids, cls_positions)
        return self.head(pooled)


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
