"""Ring attention: context parallelism over the mesh's ``seq`` axis, the
port of the JAX package's ``ops/ring.py`` (``_ring_shard``,
``ring_attention``).

Each rank of a ``seq`` group holds an S/n slice of the sequence (the
same rows as its peers). Its queries attend to every key: the K/V blocks
(and their key bias) rotate around the group, rank r sending to r + 1,
while the rank accumulates its queries' attention with the running
softmax of flash attention (the m/num/den carry). Attention-probability
dropout follows the JAX semantics: probabilities are dropped after
normalisation, so the numerator accumulates the dropped p and the
denominator the full p. Each (rank, ring step) block draws its own mask
from the layer's seed.

:class:`RingAttention` is a ``torch.autograd.Function``: the forward keeps
q, k, v, the output and the log-sum-exp; the backward rotates the K/V
blocks again, recomputes each block's probabilities from the
log-sum-exp, and passes the dK/dV accumulators around the ring with
them, one last step bringing each block's home. The block products are
``torch.einsum``, as JAX computes them outside any Pallas kernel, so ring
layers launch none of the flash kernels. Scores, softmax and the backward
run in fp32; the P·V product of the forward in v's dtype, as in JAX.

Refused, as in JAX: packed batches (the block-diagonal mask would need
the ids rotated too) and a sequence the group does not divide.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bert_pytorch_tpu_torch.parallel import p2p

_MIX_RANK = 0x9E3779B97F4A7C15
_MIX_STEP = 0xC2B2AE3D27D4EB4F


def block_seed(seed: int, rank: int, step: int) -> int:
    """The dropout seed of ring step ``step`` on seq rank ``rank``."""
    return ((int(seed) ^ ((rank + 1) * _MIX_RANK) ^ ((step + 1) * _MIX_STEP))
            & (2 ** 64 - 1)) % (2 ** 61)


def keep_scale(shape, rate: float, seed: int, device) -> torch.Tensor:
    """The kept-and-rescaled mask of one block: 1 / (1 - rate) where kept
    (probability 1 - rate), 0 where dropped, fp32."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    keep = torch.rand(shape, generator=gen, device=device) >= rate
    return keep.float() / (1.0 - rate)


def _rotate(tensors, axis):
    """``tensors`` sent one step round the ring (to rank + 1), the
    previous rank's received in their place."""
    return p2p.exchange(tensors, axis.peer(1), axis.peer(-1), axis.group,
                        axis.host_staged)


class RingAttention(torch.autograd.Function):
    """q, k, v [B, S/n, H, D], kbias [B, S/n] (additive, fp32) ->
    [B, S/n, H, D] over the ``axis`` ring (an ``AxisGroup``)."""

    @staticmethod
    def forward(ctx, q, k, v, kbias, axis, rate, seed):
        n, r = axis.size, axis.index
        batch, s_q, heads, depth = q.shape
        scale = 1.0 / math.sqrt(depth)
        qs = q * torch.tensor(scale, dtype=q.dtype)
        m = torch.full((batch, heads, s_q), -math.inf, device=q.device)
        den = torch.zeros((batch, heads, s_q), device=q.device)
        num = torch.zeros((batch, s_q, heads, depth), device=q.device)
        kk, vv, kb = k, v, kbias
        for step in range(n):
            if step:
                kk, vv, kb = _rotate([kk, vv, kb], axis)
            scores = torch.einsum("bqhd,bkhd->bhqk", qs, kk).float()
            scores = scores + kb[:, None, None, :].float()
            m_new = torch.maximum(m, scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None])
            corr = torch.exp(m - m_new)
            p_num = p
            if rate > 0.0:
                p_num = p * keep_scale(p.shape, rate,
                                       block_seed(seed, r, step), p.device)
            blk = torch.einsum("bhqk,bkhd->bqhd", p_num.to(v.dtype),
                               vv).float()
            num = num * corr.transpose(1, 2)[..., None] + blk
            den = den * corr + p.sum(dim=-1)
            m = m_new
        out = num / den.transpose(1, 2)[..., None]
        lse = m + torch.log(den)
        ctx.save_for_backward(q, k, v, kbias, out, lse)
        ctx.axis, ctx.rate, ctx.seed = axis, rate, seed
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, kbias, out, lse = ctx.saved_tensors
        axis, rate, seed = ctx.axis, ctx.rate, ctx.seed
        n, r = axis.size, axis.index
        depth = q.shape[-1]
        scale = 1.0 / math.sqrt(depth)
        qs = (q * torch.tensor(scale, dtype=q.dtype)).float()
        d_out = grad.float()
        delta = (d_out * out).sum(dim=-1).transpose(1, 2)  # [B, H, Sq]
        dqs = torch.zeros_like(qs)
        kk, vv, kb = k, v, kbias
        dk = torch.zeros(k.shape, device=k.device)
        dv = torch.zeros(v.shape, device=v.device)
        for step in range(n):
            if step:
                kk, vv, kb, dk, dv = _rotate([kk, vv, kb, dk, dv], axis)
            scores = torch.einsum("bqhd,bkhd->bhqk", qs, kk.float())
            scores = scores + kb[:, None, None, :].float()
            probs = torch.exp(scores - lse[..., None])
            d_p = torch.einsum("bqhd,bkhd->bhqk", d_out, vv.float())
            dropped = probs
            if rate > 0.0:
                keep = keep_scale(probs.shape, rate,
                                  block_seed(seed, r, step), probs.device)
                dropped = probs * keep
                d_p = d_p * keep
            dv = dv + torch.einsum("bhqk,bqhd->bkhd", dropped, d_out)
            d_s = probs * (d_p - delta[..., None])
            dqs = dqs + torch.einsum("bhqk,bkhd->bqhd", d_s, kk.float())
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", d_s, qs)
        if n > 1:
            # The accumulators held now are block r + 1's: one step home.
            dk, dv = _rotate([dk, dv], axis)
        return ((dqs * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: Optional[torch.Tensor], axis,
                   dropout_rate: float = 0.0,
                   dropout_seed: Optional[int] = None,
                   sequence_ids: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Sequence-sharded attention over this rank's [B, S/n, H, D] slices
    (``axis``: the ``seq`` ``AxisGroup``); ``bias`` is the local [B, 1, 1,
    S/n] (or [B, S/n]) additive key bias. Dropout runs when
    ``dropout_rate`` > 0 and a ``dropout_seed`` is given."""
    if sequence_ids is not None:
        raise ValueError(
            "sequence packing (sequence_ids) is not supported with "
            "backend='ring'; use 'dense' or 'flash'")
    batch, s_local = q.shape[0], q.shape[1]
    if bias is None:
        kbias = torch.zeros((batch, s_local), device=q.device)
    else:
        kbias = bias.reshape(batch, s_local).float()
    rate = dropout_rate if dropout_seed is not None else 0.0
    return RingAttention.apply(q, k, v, kbias.contiguous(), axis, rate,
                               dropout_seed or 0)
