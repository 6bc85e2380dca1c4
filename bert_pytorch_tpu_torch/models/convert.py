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

The JAX package's ``models/convert.py`` ``export_torch_state_dict`` shows
the same layout under HF naming.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from bert_pytorch_tpu_torch.config import BertConfig

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


def _leaf(path: str, value: np.ndarray):
    """(torch key suffix, torch-layout array) for one unstacked leaf."""
    module, _, name = path.rpartition("/")
    if name == "kernel":
        if value.ndim == 3:
            # DenseGeneral: (H, heads, hd) in, or (heads, hd, H) out.
            value = (value.reshape(-1, value.shape[-1])
                     if module.endswith("attention/output")
                     else value.reshape(value.shape[0], -1))
        return f"{module}/weight", np.ascontiguousarray(value.T)
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
    ``seq_relationship`` Dense maps like any other) as a fp32 state dict
    for the port's model of the same head."""
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
        key = path.replace("/", ".")
        state[key] = torch.from_numpy(np.array(value, dtype=np.float32))

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
