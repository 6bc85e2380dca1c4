"""Forward-only fused attention for serving: the port of the JAX package's
``flash_attention_infer`` (ops/pallas/attention.py, the Pallas kernel
``_infer_fwd_kernel`` + ``_infer_stream``).

* :func:`flash_attention_infer` — the wrapper. A CUDA tensor launches the
  hand-written kernel (csrc/flash_attention_infer.cu) on the current
  stream, or raises; a CPU tensor takes the plain version. Nothing falls
  back from the card to the plain version.
* :func:`flash_attention_infer_reference` — the plain PyTorch version of
  the same function: the CPU tests hold it against the JAX kernel, and the
  chip smoke holds the CUDA kernel against it.

Numerics (both versions): fp32 scores ``(q k^T) * (1/sqrt(D)) + key bias``
(+ the -10000 block-diagonal mask for packed rows), an fp32 softmax, P
rounded to v's dtype before the PV product with fp32 accumulation, and the
output in q's dtype. The scale is applied to the fp32 scores, as the
Pallas kernel does; the dense path (ops/attention.py) scales q in its own
dtype instead, so in bf16 the two routes round differently.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from bert_pytorch_tpu_torch.ops.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NAME = "flash_attention_infer"


def _infer_bias_seg(
    bias: Optional[torch.Tensor],
    sequence_ids: Optional[torch.Tensor],
    batch: int,
    seq: int,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(key_bias [B, S] fp32 or None, sequence ids [B, S] int32 or None).

    ``bias`` is the [B, 1, 1, S] key bias of ``make_attention_bias`` (any
    shape whose trailing S entries per row are the key bias). Passing both
    raises: packed rows exclude padding through id 0, so a key bias there
    is a caller's mistake."""
    if sequence_ids is not None and bias is not None:
        raise ValueError(
            f"{_NAME}: pass either bias (padded batches) or sequence_ids "
            "(packed batches), not both")
    key_bias = None
    if bias is not None:
        key_bias = bias.reshape(batch, -1)[:, -seq:].float().contiguous()
    seg = None
    if sequence_ids is not None:
        seg = sequence_ids.to(torch.int32).contiguous()
    return key_bias, seg


def _reference(q, k, v, key_bias, seg):
    batch, seq, heads, depth = q.shape
    scale = 1.0 / float(depth) ** 0.5
    # fp32 scores; the scale applies to the fp32 product, as in the kernel.
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if key_bias is not None:
        s = s + key_bias[:, None, None, :]
    if seg is not None:
        same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0)
        s = s + torch.where(same, 0.0, -10000.0)[:, None, :, :]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)  # the unrounded probabilities
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return (pv / denom).permute(0, 2, 1, 3).to(q.dtype)


def flash_attention_infer_reference(q, k, v, bias=None, sequence_ids=None):
    """The plain PyTorch version of :func:`flash_attention_infer`, on any
    device (one full softmax instead of the kernel's tiled online one)."""
    key_bias, seg = _infer_bias_seg(bias, sequence_ids, q.shape[0],
                                    q.shape[1])
    return _reference(q, k, v, key_bias, seg)


def _library() -> ctypes.CDLL:
    lib = build.load(_NAME)
    fn = lib.flash_attention_infer
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        lib.flash_attention_infer_error.argtypes = [ctypes.c_int]
        lib.flash_attention_infer_error.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, key_bias, seg) -> None:
    if q.dim() != 4:
        raise ValueError(f"{_NAME}: q must be [B, S, H, D], got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{_NAME}: {name} shape {tuple(t.shape)} != "
                             f"q shape {tuple(q.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{_NAME}: {name} must match q's dtype and "
                             f"device ({q.dtype}, {q.device})")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{_NAME}: dtype {q.dtype} not supported "
                        "(float32, bfloat16)")
    depth = q.shape[-1]
    if depth % 8 or depth > 128:
        raise ValueError(f"{_NAME}: head_dim {depth} must be a multiple of "
                         "8 up to 128")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{_NAME}: {name} must be contiguous")
    for name, t in (("bias", key_bias), ("sequence_ids", seg)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{_NAME}: {name} must be on {q.device}")


def flash_attention_infer(q, k, v, bias=None, sequence_ids=None):
    """Forward-only fused attention over [B, S, H, D] tensors; returns
    [B, S, H, D] in q's dtype. ``bias`` is the [B, 1, 1, S] key bias for
    padded batches; ``sequence_ids`` ([B, S], 0 = pad) marks a packed batch
    and rebuilds the block-diagonal mask inside the kernel.

    On a CUDA tensor this launches the CUDA kernel, counting the launch in
    ``flash_attention_infer.launches``; on a CPU tensor it returns the plain
    version and counts nothing."""
    batch, seq = q.shape[0], q.shape[1]
    key_bias, seg = _infer_bias_seg(bias, sequence_ids, batch, seq)
    if q.device.type == "cpu":
        return _reference(q, k, v, key_bias, seg)
    if q.device.type != "cuda":
        raise ValueError(f"{_NAME}: unsupported device {q.device}")
    _check(q, k, v, key_bias, seg)
    heads, depth = q.shape[2], q.shape[3]
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_infer(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            key_bias.data_ptr() if key_bias is not None else None,
            seg.data_ptr() if seg is not None else None,
            batch, seq, heads, depth, _DTYPE_CODES[q.dtype],
            1.0 / float(depth) ** 0.5, stream)
    if rc != 0:
        raise RuntimeError(
            f"{_NAME}: kernel launch failed: "
            f"{lib.flash_attention_infer_error(rc).decode()} (cudaError {rc})")
    flash_attention_infer.launches += 1
    return out


flash_attention_infer.launches = 0
