"""LayerNorm — the port of the JAX package's ``ops.layernorm`` (reference
src/modeling.py:299-336's ``BertLayerNorm``).

Statistics are computed in fp32 whatever the activation dtype, and the
result is cast back to the input's dtype. Two backends, the counterparts of
the JAX package's:

* ``"plain"`` (its ``"xla"``, the default) — plain tensor ops;
* ``"kernel"`` (its ``"pallas"``) — the hand-written forward kernel with a
  plain backward (ops/kernels/layernorm.py ``layer_norm_kernel``): the CUDA
  kernel on a CUDA tensor, its plain version on a CPU tensor.
"""

from __future__ import annotations

import torch

from bert_pytorch_tpu_torch.ops.kernels.layernorm import layer_norm_kernel

BACKENDS = ("plain", "kernel")
# The JAX package's names for the same backends (runner flags take both).
BACKEND_ALIASES = {"xla": "plain", "pallas": "kernel"}


def resolve_backend(name: str) -> str:
    """``name`` or its JAX alias as one of :data:`BACKENDS`; raises on any
    other."""
    backend = BACKEND_ALIASES.get(name, name)
    if backend not in BACKENDS:
        raise ValueError(f"layer_norm backend {name!r} is not one of "
                         f"{BACKENDS} (or {sorted(BACKEND_ALIASES)})")
    return backend


def layer_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-12,
    backend: str = "plain",
) -> torch.Tensor:
    """Normalize the last axis of ``x`` and apply the affine transform."""
    if backend == "kernel":
        return layer_norm_kernel(x, scale, bias, eps)
    if backend != "plain":
        raise ValueError(f"layer_norm backend {backend!r} is not one of "
                         f"{BACKENDS}")
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    out = normed * scale.float() + bias.float()
    return out.to(x.dtype)
