"""Multi-head dot-product attention core.

The port of the JAX package's ``ops.attention``: the additive mask uses the
reference's ``(1 - mask) * -10000`` bias convention (modeling.py:862-870),
and scores are softmaxed in fp32 for bf16 safety.

Backends (``backend=``):

* ``"dense"`` — the counterpart of the JAX package's ``"xla"`` path: plain
  tensor ops that materialize the [B, H, S, S] scores;
* ``"flash_infer"`` — the counterpart of ``"pallas_infer"``: the
  forward-only fused kernel (ops/kernels/attention.py), a hand-written CUDA
  kernel on the card and its plain version on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from bert_pytorch_tpu_torch.ops.kernels.attention import flash_attention_infer

BACKENDS = ("dense", "flash_infer")


def make_attention_bias(
    input_mask: torch.Tensor,
    dtype: torch.dtype = torch.float32,
    sequence_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[B, S] {0,1} mask -> [B, 1, 1, S] additive bias, (1-m) * -10000.

    With ``sequence_ids`` ([B, S] int, 0 = pad, k = k-th packed sequence)
    returns the BLOCK-DIAGONAL [B, 1, S, S] bias instead: position q may
    attend to position k iff both carry the same nonzero sequence id
    (Krell et al. 2021). Padding is excluded by id 0, so ``input_mask`` is
    ignored on this path.
    """
    if sequence_ids is not None:
        seg = sequence_ids
        same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0)
        bias = (1.0 - same.float()) * -10000.0
        return bias[:, None, :, :].to(dtype)
    bias = (1.0 - input_mask.float()) * -10000.0
    return bias[:, None, None, :].to(dtype)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    backend: str = "dense",
    sequence_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over [B, S, H, D] query/key/value tensors; returns
    [B, S, H, D].

    ``sequence_ids`` ([B, S], 0 = pad) marks a PACKED batch: on the dense
    path the caller's ``bias`` is then the [B, 1, S, S] block-diagonal mask
    from :func:`make_attention_bias`; the fused kernel drops that bias and
    rebuilds the block-diagonal mask per tile from the id vectors.
    """
    if backend not in BACKENDS:
        raise ValueError(f"attention backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if backend == "flash_infer":
        if not deterministic and dropout_rate > 0.0:
            raise ValueError(
                "backend='flash_infer' is forward-only; training dropout "
                "needs backend='dense'")
        kbias = None if sequence_ids is not None else bias
        return flash_attention_infer(q, k, v, bias=kbias,
                                     sequence_ids=sequence_ids)
    if not deterministic and dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout is not ported yet (serving runs "
            "deterministic forwards)")
    # The dense path scales q in q's dtype BEFORE QK^T, as the JAX
    # package's XLA path does (ops/attention.py:180-192).
    depth = q.shape[-1]
    scale = 1.0 / torch.sqrt(
        torch.tensor(float(depth), dtype=torch.float32)).to(q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q * scale, k).float()
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
