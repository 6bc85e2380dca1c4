"""Weights from the JAX package into the port.

:func:`from_jax_params` turns the JAX package's flax params tree (nested
dicts with numpy leaves, as ``model.init(...)["params"]`` returns after
``nn.unbox`` and a ``np.asarray`` per leaf) into this package's state dict
for one head: a serving head or the pretraining model. The port's modules mirror the flax names, so the map
is name for name, with three layout changes:

* the encoder's ``nn.scan`` stacks every layer leaf on a leading ``L``
  axis: ``bert/encoder/layers/<leaf>`` [L, ...] becomes
  ``bert.encoder.layers.<i>.<leaf>``;
* flax kernels are [in, out] and torch weights [out, in]; the attention
  DenseGeneral kernels (H, heads, head_dim) and (heads, head_dim, H)
  flatten their (heads, head_dim) axes first, and their (heads, head_dim)
  biases flatten too;
* ``embedding`` tables become ``weight``.

A tree that the JAX package's ``quant.quantize_params`` produced maps the
same way onto a head built with ``quant=``: ``kernel_q`` (int8) becomes
``weight_q``, ``kernel_scale`` ``weight_scale``, and bf16 kernels and
biases stay bf16. :func:`quantize_state_dict` applies the same rules
(JAX ``quant.convert_module``) to the port's own fp32 state dict.

The JAX package's ``models/convert.py`` ``export_torch_state_dict`` shows
the same layout under HF naming.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.ops import quant as quant_ops

# Top-level subtrees each served head's params must carry.
HEAD_SUBTREES = {
    "fill_mask": ("bert", "predictions"),
    "classify": ("bert", "head"),
    "pretraining": ("bert", "predictions"),
}
_STACKED = "bert/encoder/layers/"


def _flatten(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


# Kernel leaf names (plain, int8) and the torch names they take.
_KERNELS = {"kernel": "weight", "kernel_q": "weight_q"}


def _leaf(path: str, value: np.ndarray):
    """(torch key suffix, torch-layout array) for one unstacked leaf."""
    module, _, name = path.rpartition("/")
    if name in _KERNELS:
        if value.ndim == 3:
            # DenseGeneral: (H, heads, hd) in, or (heads, hd, H) out.
            value = (value.reshape(-1, value.shape[-1])
                     if module.endswith("attention/output")
                     else value.reshape(value.shape[0], -1))
        return f"{module}/{_KERNELS[name]}", np.ascontiguousarray(value.T)
    if name == "kernel_scale":
        return f"{module}/weight_scale", value
    if name == "embedding":
        return f"{module}/weight", value
    if name == "bias" and value.ndim == 2:
        return path, value.reshape(-1)  # (heads, head_dim) bias
    return path, value


def from_jax_params(params: dict, config: BertConfig,
                    head: str) -> Dict[str, torch.Tensor]:
    """The JAX params of one head (``"fill_mask"``: ``BertForMaskedLM``;
    ``"classify"``: ``BertForSequenceClassification``; ``"pretraining"``:
    ``BertForPreTraining``, whose ``predictions`` head keeps its decoder
    tied to the word embeddings and, with ``config.next_sentence``, whose
    ``seq_relationship`` Dense maps like any other) as a state dict for
    the port's model of the same head: fp32 for fp32 params; for a tree
    from JAX ``quantize_params``, int8 and bf16 leaves keep their type (the
    head built with the same ``quant`` loads it)."""
    if head not in HEAD_SUBTREES:
        raise ValueError(f"unknown head {head!r}; known: {sorted(HEAD_SUBTREES)}")
    required = HEAD_SUBTREES[head]
    if head == "pretraining" and config.next_sentence:
        required = required + ("seq_relationship",)
    missing = [k for k in required if k not in params]
    if missing:
        raise KeyError(f"{head} params lack subtrees {missing} "
                       f"(have {sorted(params)})")
    state: Dict[str, torch.Tensor] = {}

    def put(path, value):
        state[path.replace("/", ".")] = _to_torch(value)

    for path, value in _flatten(params).items():
        if path.startswith(_STACKED):
            rest = path[len(_STACKED):]
            if value.shape[0] != config.num_hidden_layers:
                raise ValueError(
                    f"{path}: {value.shape[0]} stacked layers, config has "
                    f"{config.num_hidden_layers}")
            for i in range(config.num_hidden_layers):
                put(*_leaf(f"{_STACKED}{i}/{rest}", value[i]))
        else:
            put(*_leaf(path, value))
    return state


def _to_torch(value) -> torch.Tensor:
    """int8 stays int8, bf16 (numpy's ``bfloat16`` extension type, as the
    JAX quantizer stores it) becomes torch bf16, the rest fp32."""
    value = np.asarray(value)
    if value.dtype == np.int8:
        return torch.from_numpy(np.array(value))
    if value.dtype.name == "bfloat16":
        return torch.from_numpy(value.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(value, dtype=np.float32))


def quantize_state_dict(state: Dict[str, torch.Tensor],
                        mode: str) -> Dict[str, torch.Tensor]:
    """A serving head's fp32 state dict in the layout of the same head
    built with ``quant=mode`` (JAX ``quant.convert_module``'s rules).

    Only Dense modules convert (a 2-D ``weight`` with a sibling ``bias``);
    embeddings, LayerNorm and the MLM vocab bias pass through fp32. int8:
    ``weight_q`` (int8) and ``weight_scale`` (0-dim fp32) from the
    host-side :func:`~bert_pytorch_tpu_torch.ops.quant.quantize_array`,
    bias bf16. bf16, and the output layers of ``EXCLUDE_MODULES`` under
    int8: weight and bias bf16. The JAX encoder quantizes its stacked
    kernels with one scale per layer; each of the port's layers is its own
    module with its own per-tensor scale, the same number."""
    quant_ops.check_mode(mode)
    out = dict(state)
    for key, weight in state.items():
        module, _, name = key.rpartition(".")
        bias_key = f"{module}.bias"
        if name != "weight" or weight.dim() != 2 or bias_key not in state:
            continue
        excluded = any(part in quant_ops.EXCLUDE_MODULES
                       for part in module.split("."))
        if mode == "int8" and not excluded:
            q, scale = quant_ops.quantize_array(
                weight.detach().float().cpu().numpy())
            del out[key]
            out[f"{module}.weight_q"] = torch.from_numpy(q)
            out[f"{module}.weight_scale"] = torch.from_numpy(scale)
        else:
            out[key] = weight.detach().to(torch.bfloat16)
        out[bias_key] = state[bias_key].detach().to(torch.bfloat16)
    return out
