"""Multi-head dot-product attention core.

The port of the JAX package's ``ops.attention``: the additive mask uses the
reference's ``(1 - mask) * -10000`` bias convention (modeling.py:862-870),
and scores are softmaxed in fp32 for bf16 safety.

Backends (``backend=``):

* ``"dense"`` — the counterpart of the JAX package's ``"xla"`` path: plain
  tensor ops that materialize the [B, H, S, S] scores;
* ``"flash_infer"`` — the counterpart of ``"pallas_infer"``: the
  forward-only fused kernel (ops/kernels/attention.py), a hand-written CUDA
  kernel on the card and its plain version on the CPU;
* ``"flash_infer_int8"`` — the counterpart of ``"pallas_infer_int8"``:
  the same forward-only contract with int8 QK^T (q and k quantized per
  (batch, head); ops/kernels/attention.py ``flash_attention_infer_int8``);
* ``"flash"`` — the counterpart of ``"pallas"``: the training kernels with
  a gradient and in-kernel attention dropout (ops/kernels/attention.py
  ``flash_attention``);
* ``"ring"`` — the counterpart of ``"ring"``/``"ring_manual"``: context
  parallelism over the ``seq`` axis group the caller passes as ``ring``
  (ops/ring.py), each rank holding an S/n slice; without a group (no
  sequence sharding) it runs the dense path, as the JAX route falls back;
* ``"auto"`` — ``"flash"`` at S >= 256 on a CUDA tensor, ``"dense"``
  otherwise. The 256 crossover is the JAX package's (ops/attention.py
  :70-78, measured on a TPU); it is not measured on the H100.

Training dropout takes an explicit ``dropout_seed``: the flash kernels draw
their Philox mask from it, the dense path a torch generator seeded with it
(ops/dropout.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from bert_pytorch_tpu_torch.ops.dropout import dropout
from bert_pytorch_tpu_torch.ops.kernels.attention import (
    flash_attention, flash_attention_infer, flash_attention_infer_int8)

BACKENDS = ("dense", "flash_infer", "flash_infer_int8", "flash", "ring",
            "auto")
# The forward-only serving kernels: no dropout, packed rows drop the bias.
INFER_BACKENDS = {"flash_infer": flash_attention_infer,
                  "flash_infer_int8": flash_attention_infer_int8}
AUTO_FLASH_MIN_SEQ = 256


def resolve_backend(backend: str, seq: int, device: torch.device) -> str:
    """The backend ``backend`` runs as: ``"auto"`` becomes ``"flash"`` at
    ``seq >= AUTO_FLASH_MIN_SEQ`` on a CUDA device, else ``"dense"``."""
    if backend not in BACKENDS:
        raise ValueError(f"attention backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if backend == "auto":
        return ("flash" if seq >= AUTO_FLASH_MIN_SEQ
                and device.type == "cuda" else "dense")
    return backend


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
    dropout_seed: Optional[int] = None,
    ring=None,
) -> torch.Tensor:
    """Attention over [B, S, H, D] query/key/value tensors; returns
    [B, S, H, D].

    ``sequence_ids`` ([B, S], 0 = pad) marks a PACKED batch: on the dense
    path the caller's ``bias`` is then the [B, 1, S, S] block-diagonal mask
    from :func:`make_attention_bias` (or None); the fused kernels drop that
    bias and rebuild the block-diagonal mask per tile from the id vectors.
    Dropout of the attention probabilities runs when ``deterministic`` is
    False and ``dropout_rate > 0``, from ``dropout_seed``. ``ring`` (an
    ``AxisGroup`` of the ``seq`` axis) is the ring backend's group.
    """
    backend = resolve_backend(backend, q.shape[1], q.device)
    active = not deterministic and dropout_rate > 0.0
    if active and backend not in INFER_BACKENDS and dropout_seed is None:
        raise ValueError("attention dropout needs dropout_seed")
    if backend == "ring" and ring is not None:
        from bert_pytorch_tpu_torch.ops.ring import ring_attention

        return ring_attention(q, k, v, bias, ring,
                              dropout_rate if active else 0.0,
                              dropout_seed if active else None, sequence_ids)
    if backend == "flash":
        kbias = None if sequence_ids is not None else bias
        return flash_attention(
            q, k, v, bias=kbias, dropout_rate=dropout_rate if active else 0.0,
            seed=dropout_seed if active else None, sequence_ids=sequence_ids)
    if backend in INFER_BACKENDS:
        if active:
            raise ValueError(
                f"backend={backend!r} is forward-only; training dropout "
                "needs backend='flash' or 'dense'")
        kbias = None if sequence_ids is not None else bias
        return INFER_BACKENDS[backend](q, k, v, bias=kbias,
                                       sequence_ids=sequence_ids)
    # The dense path scales q in q's dtype BEFORE QK^T, as the JAX
    # package's XLA path does (ops/attention.py:180-192).
    depth = q.shape[-1]
    scale = 1.0 / torch.sqrt(
        torch.tensor(float(depth), dtype=torch.float32)).to(q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q * scale, k).float()
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if active:
        probs = dropout(probs, dropout_rate, dropout_seed)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
