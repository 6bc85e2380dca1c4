"""Read the attention-dropout keep mask that a training kernel drew, from
its outputs alone, so that the kernels' routes and the plain Philox twin
(``philox_keep_mask``) can be compared bit for bit.

* The forward: q = k = 0, so every key of a 64-key window scores 0 and the
  keys outside it carry the -10000 key bias (probability exp(-10000) = 0);
  v is one-hot, key ``w + d`` of the window to column d. Then out[q, d] is
  keep[q, w + d] / (64 (1 - rate)): nonzero exactly where the key is kept.
* The dq kernel: q = 0, so p = exp(0 - lse) = 1/S with lse = log(S);
  v = dO = e_0 in every row, so dA = 1; out = 0, so delta = 0; k is
  one-hot, key ``w + d`` of a 64-key window to column d, and zero
  outside it. Then dq[q, d] is keep[q, w + d] / (S (1 - rate)) * scale:
  nonzero exactly where the key is kept.
* The dkv kernel: q = k = v = 0, so p = exp(0 - lse) = 1/S with the
  forward's lse = log(S); dO is one-hot, q row ``w + d`` of a 64-row
  window to column d, and zero outside it. Then dv[k, d] is
  keep[w + d, k] p / (1 - rate): nonzero exactly where the key is kept.

Each reading is a [B*H, S, S] bool mask (rows are q, columns keys), as
``philox_keep_mask`` returns it. A route of ``None`` calls the wrapper
(the plain version on CPU tensors, the route ``train_route`` picks on
CUDA tensors); a named route calls that route's launch directly (CUDA
only). Head dim 64, bf16 on the tensor cores' route, as the model runs.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bert_pytorch_tpu_torch.ops.kernels import attention as kattn

DEPTH = 64  # the window: one key (or q row) per column of the output


def _zeros(batch, seq, heads, dtype, device):
    return torch.zeros(batch, seq, heads, DEPTH, dtype=dtype, device=device)


def forward_keep_mask(batch: int, seq: int, heads: int, seed: int,
                      rate: float, dtype=torch.bfloat16, device="cpu",
                      route: Optional[str] = None) -> torch.Tensor:
    """The keep mask the forward kernel drew, read from its output."""
    q = _zeros(batch, seq, heads, dtype, device)
    keep = torch.zeros(batch * heads, seq, seq, dtype=torch.bool,
                       device=device)
    for w in range(0, seq, DEPTH):
        width = min(DEPTH, seq - w)
        v = _zeros(batch, seq, heads, dtype, device)
        keys = torch.arange(w, w + width, device=device)
        v[:, keys, :, keys - w] = 1.0
        key_bias = torch.full((batch, seq), -10000.0, device=device)
        key_bias[:, w:w + width] = 0.0
        if route is None:
            out, _ = kattn.flash_attention_fwd(q, q, v, key_bias, None, seed,
                                               rate)
        else:
            out, _ = kattn._launch_fwd(q, q, v, key_bias, None, seed, rate,
                                       route)
        # [B, S, H, D] -> [B*H, S q, window keys]
        seen = out.permute(0, 2, 1, 3).reshape(batch * heads, seq, DEPTH)
        keep[:, :, w:w + width] = seen[:, :, :width] != 0
    return keep


def dq_keep_mask(batch: int, seq: int, heads: int, seed: int, rate: float,
                 dtype=torch.bfloat16, device="cpu",
                 route: Optional[str] = None) -> torch.Tensor:
    """The keep mask the dq kernel drew, read from its dq output."""
    zeros = _zeros(batch, seq, heads, dtype, device)
    e0 = _zeros(batch, seq, heads, dtype, device)
    e0[..., 0] = 1.0
    lse = torch.full((batch * heads, seq), math.log(seq), device=device)
    keep = torch.zeros(batch * heads, seq, seq, dtype=torch.bool,
                       device=device)
    for w in range(0, seq, DEPTH):
        width = min(DEPTH, seq - w)
        k = _zeros(batch, seq, heads, dtype, device)
        keys = torch.arange(w, w + width, device=device)
        k[:, keys, :, keys - w] = 1.0
        args = (zeros, k, e0, zeros, e0, lse, None, None, seed, rate)
        if route is None:
            dq, _ = kattn.flash_attention_dq(*args)
        else:
            dq, _ = kattn._launch_dq(*args, route)
        # dq [B, S q, H, D] -> [B*H, S q, window keys]
        seen = dq.permute(0, 2, 1, 3).reshape(batch * heads, seq, DEPTH)
        keep[:, :, w:w + width] = seen[:, :, :width] != 0
    return keep


def dkv_keep_mask(batch: int, seq: int, heads: int, seed: int, rate: float,
                  dtype=torch.bfloat16, device="cpu",
                  route: Optional[str] = None) -> torch.Tensor:
    """The keep mask the dkv kernel drew, read from its dv output."""
    zeros = _zeros(batch, seq, heads, dtype, device)
    lse = torch.full((batch * heads, seq), math.log(seq), device=device)
    delta = torch.zeros(batch * heads, seq, device=device)
    keep = torch.zeros(batch * heads, seq, seq, dtype=torch.bool,
                       device=device)
    for w in range(0, seq, DEPTH):
        width = min(DEPTH, seq - w)
        do = _zeros(batch, seq, heads, dtype, device)
        rows = torch.arange(w, w + width, device=device)
        do[:, rows, :, rows - w] = 1.0
        args = (zeros, zeros, zeros, do, lse, delta, None, None, seed, rate)
        if route is None:
            _, dv, _ = kattn.flash_attention_dkv(*args)
        else:
            _, dv, _ = kattn._launch_dkv(*args, route)
        # dv [B, S keys, H, D] -> [B*H, window q rows, S keys]
        seen = dv.permute(0, 2, 3, 1).reshape(batch * heads, DEPTH, seq)
        keep[:, w:w + width, :] = seen[:, :width, :] != 0
    return keep


def philox_mask(batch: int, seq: int, heads: int, seed: int, rate: float,
                device="cpu") -> torch.Tensor:
    """The same [B*H, S, S] mask from the plain Philox twin."""
    idx = torch.arange(max(batch * heads, seq), device=device)
    return kattn.philox_keep_mask(seed, rate, idx[:batch * heads],
                                  idx[:seq], idx[:seq])
