"""LayerNorm — the plain path of the JAX package's ``ops.layernorm``
(reference src/modeling.py:299-336's ``BertLayerNorm``).

Statistics are computed in fp32 whatever the activation dtype, and the
result is cast back to the input's dtype.
"""

from __future__ import annotations

import torch


def layer_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-12,
) -> torch.Tensor:
    """Normalize the last axis of ``x`` and apply the affine transform."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    out = normed * scale.float() + bias.float()
    return out.to(x.dtype)
