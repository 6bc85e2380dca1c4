"""Dropout from an explicit seed: the counterpart of ``flax.linen.Dropout``
in the JAX package's model (keep with probability ``1 - rate``, kept values
scaled by ``1 / (1 - rate)``, in the input's dtype).

The seed, not a global generator, decides the mask: a layer recomputed
under ``torch.utils.checkpoint`` draws the mask its first forward drew,
whatever the global RNG state. Masks are torch's own Philox draws and do
not reproduce the JAX package's; parity tests run at rate 0.
"""

from __future__ import annotations

import torch


def dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Drop elements of ``x`` with probability ``rate`` under ``seed``."""
    if rate <= 0.0:
        return x
    gen = torch.Generator(device=x.device)
    gen.manual_seed(int(seed))
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
