"""Weight quantization for the serving fast path: the port of the JAX
package's ``ops/quant.py``.

Serving never updates weights, so the fp32 master copies that training
needs are overhead there: a BERT-large head holds ~1.3 GB of fp32 weights,
~1.2 GB of them in matmuls that int8 stores in ~0.3 GB. Two levels (the
ZeroQuant lineage, arXiv:2206.01861):

* ``"bf16"`` — Dense weights and biases stored bfloat16 (a storage cast;
  the Dense computes in the model's dtype as before);
* ``"int8"`` — Dense weights stored int8 with ONE symmetric scale per
  tensor (per layer: the port's encoder layers are separate modules); the
  forward quantizes activations per token on the fly and runs
  ``int8 x int8 -> int32`` GEMMs (``torch._int_mm``), rescaling once by
  ``act_scale * weight_scale``. Biases are stored bf16.

Embeddings, LayerNorm parameters and the MLM vocab bias stay fp32 in both
modes, and the task-head output layers (``EXCLUDE_MODULES``) take bf16
instead of int8. The rules are applied to a state dict by
``models/convert.py`` ``quantize_state_dict``; the weight values come from
the host-side numpy :func:`quantize_array`, which gives the JAX package's
int8 values and scales exactly.

The int8 GEMM is a library call (cuBLASLt through ``torch._int_mm``), as
the JAX package leaves this product to XLA outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

MODES = ("bf16", "int8")

# Dense modules whose weights stay OUT of int8 (stored bf16 instead): the
# per-task output layers, each a [hidden, <=num_labels] matmul that is
# noise-sensitive (pre-softmax) and byte-irrelevant.
EXCLUDE_MODULES = frozenset({"classifier", "qa_outputs", "seq_relationship"})

# Symmetric int8 range. 127 (not 128) keeps the scale symmetric around
# zero so -w and +w quantize to -q and +q exactly.
_QMAX = 127.0
# torch._int_mm on a CUDA tensor needs more than 16 rows in its first
# operand; smaller products are padded with zero rows up to this count.
_INT_MM_MIN_ROWS = 32


def check_mode(mode: Optional[str]) -> Optional[str]:
    if mode is not None and mode not in MODES:
        raise ValueError(f"quantize mode must be one of {MODES} or None, "
                         f"got {mode!r}")
    return mode


def exclude(quant: Optional[str]) -> Optional[str]:
    """Quant mode of the EXCLUDE_MODULES output layers: int8 downgrades to
    bf16 storage, bf16/None pass through."""
    return "bf16" if quant == "int8" else quant


def quantize_array(w, per_axis0: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """``(q_int8, scale_fp32)`` with symmetric per-tensor scaling.

    ``per_axis0=True`` treats the leading axis as a stack of independent
    tensors and returns one scale per slice. Host-side numpy, as in the
    JAX package, so the int8 values and scales are that package's own."""
    w = np.asarray(w, dtype=np.float32)
    if per_axis0 and w.ndim >= 2:
        axes = tuple(range(1, w.ndim))
        amax = np.max(np.abs(w), axis=axes)
        scale = np.maximum(amax, 1e-12) / _QMAX
        bshape = (-1,) + (1,) * (w.ndim - 1)
        q = np.rint(w / scale.reshape(bshape))
    else:
        amax = np.max(np.abs(w)) if w.size else 0.0
        scale = np.float32(max(float(amax), 1e-12) / _QMAX)
        q = np.rint(w / scale)
    q = np.clip(q, -_QMAX, _QMAX).astype(np.int8)
    return q, np.asarray(scale, np.float32)


def dequantize_array(q, scale) -> np.ndarray:
    """Inverse of :func:`quantize_array` (tests / debugging)."""
    q = np.asarray(q, np.float32)
    scale = np.asarray(scale, np.float32)
    if scale.ndim:
        scale = scale.reshape((-1,) + (1,) * (q.ndim - 1))
    return q * scale


def quantize_symmetric(x: torch.Tensor, axes: Union[int, Sequence[int]]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q_int8, scale)`` symmetric dynamic quantization, one fp32 scale
    per slice of the axes NOT in ``axes`` (kept as size-1 dims, so the
    scale broadcasts back over ``q``). ``x / scale`` stays a division and
    ``torch.round`` rounds half to even, as ``jnp.round`` does, so the
    ints are the JAX package's for the same fp32 input."""
    axes = (axes,) if isinstance(axes, int) else tuple(axes)
    xf = x.float()
    amax = xf.abs().amax(dim=axes, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / _QMAX
    q = torch.clamp(torch.round(xf / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def int8_matmul(x: torch.Tensor, q_weight: torch.Tensor,
                weight_scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(q_weight).T`` computed as an int8 GEMM; fp32 out.

    ``x`` [..., K] float activations; ``q_weight`` [N, K] int8 (torch's
    [out, in] layout, the transpose of the JAX package's [K, N] kernel);
    ``weight_scale`` a 0-dim fp32 tensor. Activations are quantized PER
    TOKEN (last-axis abs-max), one ``int8 x int8 -> int32`` product runs
    (``torch._int_mm``, cuBLASLt on the card), and the result rescales by
    ``act_scale`` then ``weight_scale``, in the JAX package's order."""
    qx, a_scale = quantize_symmetric(x, -1)
    lead = qx.shape[:-1]
    rows = qx.reshape(-1, qx.shape[-1])
    m = rows.shape[0]
    if rows.is_cuda and m < _INT_MM_MIN_ROWS:
        rows = torch.cat([rows, rows.new_zeros(_INT_MM_MIN_ROWS - m,
                                               rows.shape[1])])
    acc = torch._int_mm(rows, q_weight.t())[:m]
    return (acc.reshape(*lead, -1).float() * a_scale
            * weight_scale.float())


class Int8Dense(nn.Module):
    """The serving heads' Dense with an int8 weight: ``weight_q`` [out, in]
    int8 and ``weight_scale`` (0-dim fp32) are buffers, ``bias`` a bf16
    parameter that takes no gradient. Computes ``int8_matmul`` in fp32,
    then ``y.to(dtype) + bias.to(dtype)`` (the JAX ``Int8Dense``'s order).
    The values are placeholders until a quantized state dict is loaded
    (``models/convert.py quantize_state_dict``); never trained."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.register_buffer("weight_q", torch.zeros(
            out_features, in_features, dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(
            (), dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(
            out_features, dtype=torch.bfloat16, device=device),
            requires_grad=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int8_matmul(x, self.weight_q, self.weight_scale)
        return y.to(self.dtype) + self.bias.to(self.dtype)


def weight_bytes(module: nn.Module) -> int:
    """Bytes of a module's parameters AND buffers (the int8 weights and
    their scales are buffers): the device memory the weights pin."""
    return sum(t.numel() * t.element_size()
               for t in (*module.parameters(), *module.buffers()))
