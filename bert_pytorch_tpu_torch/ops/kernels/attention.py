"""Fused attention kernels of the port: the counterparts of the JAX
package's Pallas kernels in ops/pallas/attention.py.

Serving (forward only), the port of ``flash_attention_infer``
(``_infer_fwd_kernel`` + ``_infer_stream``):

* :func:`flash_attention_infer` — the wrapper. A CUDA tensor launches the
  hand-written kernel (csrc/flash_attention_infer.cu) on the current
  stream, or raises; a CPU tensor takes the plain version. Nothing falls
  back from the card to the plain version.
* :func:`infer_route` — which of the kernel's two routes a launch takes,
  from dtype and head_dim alone, before the launch: ``"tensor_cores"``
  (Hopper ``wgmma`` fed by TMA, csrc/flash_infer_wgmma.cuh) for bf16 with
  head_dim in :data:`TENSOR_CORE_HEAD_DIMS`, ``"cuda_cores"`` for the rest
  (fp32, other head dims). A failed build or launch raises on either route;
  neither falls back to the other. Each wrapper counts launches per route
  in ``.route_launches`` beside ``.launches``.
* :func:`flash_attention_infer_reference` — the plain PyTorch version of
  the same function: the CPU tests hold it against the JAX kernel, and the
  chip smoke holds the CUDA kernel against it.

Serving with int8 scores, the port of ``flash_attention_infer_int8``
(``_infer_fwd_kernel_int8`` + ``_infer_stream``):

* :func:`flash_attention_infer_int8` — the wrapper: quantizes q and k to
  int8 with one symmetric scale per (batch, head) (:func:`quantize_qk`,
  plain tensor ops outside the kernel, as the JAX wrapper does), then
  :func:`flash_attention_infer_int8_prequantized` launches
  csrc/flash_attention_infer_int8.cu on a CUDA tensor (or raises) and
  takes the plain version on a CPU tensor. The kernel shares its online
  softmax and PV stream with the fp kernel (csrc/flash_infer_stream.cuh).
* :func:`flash_attention_infer_int8_reference` — its plain version: the
  exact int32 scores (products summed in float64), rescaled by
  ``(q_scale * k_scale) * (1/sqrt(D))`` in fp32, then the fp kernel's
  softmax and PV.

Training, the port of ``flash_attention`` (``_flash_fwd_kernel``,
``_flash_dq_kernel``, ``_flash_dkv_kernel``):

* :func:`flash_attention` — a ``torch.autograd.Function`` over [B, S, H, D]
  tensors with key bias, packed sequence ids and attention dropout. Its
  forward launches csrc/flash_attention_fwd.cu (out and ``lse``), its
  backward csrc/flash_attention_bwd.cu (dq with ``delta = rowsum(dO * O)``
  folded in, then dk, dv and the key-bias gradient). Each kernel has its
  own wrapper and launch count (:func:`flash_attention_fwd`,
  :func:`flash_attention_dq`, :func:`flash_attention_dkv`) and plain
  version, which the wrapper takes for CPU tensors.
* :func:`train_route` — the route of a training kernel's launch, from
  the kernel, dtype and head_dim alone, before the launch, as
  :func:`infer_route` is for serving: ``"tensor_cores"`` (``wgmma`` + TMA;
  the forward on the serving kernels' stream, csrc/flash_infer_wgmma.cuh)
  for bf16 and fp16 with head_dim in :data:`TRAIN_TENSOR_CORE_HEAD_DIMS`,
  ``"cuda_cores"`` for the rest. A failed build or launch raises on either
  route; neither falls back to the other, and an fp16 tensor is never
  converted to bf16. Each wrapper counts launches per route in
  ``.route_launches``. The training kernels take fp32, bf16 and fp16; the
  serving kernels fp32 and bf16 (no JAX entry point serves fp16).
* :func:`flash_attention_reference` — the plain, differentiable PyTorch
  version of :func:`flash_attention` (autograd through tensor ops).
* :func:`philox_keep_mask` — the dropout mask: Philox4x32-10 keyed by the
  seed and counted by (key / 4, query row, batch*head), the same generator
  the kernels run (csrc/flash_attention_common.cuh), so kernel and plain
  version draw identical masks. The TPU kernels drew theirs from the
  hardware PRNG per tile; those bits cannot be reproduced, so the JAX
  parity tests run at rate 0.

Numerics (every version): fp32 scores ``(q k^T) * (1/sqrt(D)) + key bias``
(+ the -10000 block-diagonal mask for packed rows), an fp32 softmax whose
row sum ``l`` counts the undropped probabilities, P rounded to v's dtype
before the PV product with fp32 accumulation, 1/(1-rate) applied at the
normalisation, and the output in q's dtype. In the backward, dS is rounded
to k's / q's dtype before the dq / dk products and the kept P / (1-rate)
to dO's dtype before dv, as the Pallas kernels do. Each rounding is to
nearest and not saturating: an fp16 value past 65504 becomes inf, as the
JAX kernels' ``astype`` makes it, so an overflow under a large loss scale
reaches the gradients and the step is skipped. The scale is applied to
the fp32 scores; the dense path (ops/attention.py) scales q in its own
dtype instead, so in bf16 the two routes round differently.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from bert_pytorch_tpu_torch.ops import quant
from bert_pytorch_tpu_torch.ops.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The dtypes each kernel family takes.
_INFER_DTYPES = (torch.float32, torch.bfloat16)
_TRAIN_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# The tensor-core entry points are one per 16-bit type: the name's suffix.
_WGMMA_SUFFIX = {torch.bfloat16: "", torch.float16: "_fp16"}
# Head dims of the serving kernels' tensor-core route: rows of 32, 64 or a
# multiple of 128 bytes in int8 and bf16, the widths a TMA swizzle span
# takes whole.
TENSOR_CORE_HEAD_DIMS = (32, 64, 128)
# The training kernels' tensor-core route: the forward takes the serving
# kernels' head dims (its stream is theirs), and so does dq (dQ is
# head_dim / 2 fp32 values a thread, as the forward's output); dkv keeps dK
# and dV, head_dim fp32 values a thread, in one warpgroup's registers, so
# head_dim 128 keeps its CUDA-core route.
TRAIN_TENSOR_CORE_HEAD_DIMS = {"flash_attention_fwd": (32, 64, 128),
                               "flash_attention_dq": (32, 64, 128),
                               "flash_attention_dkv": (32, 64)}
ROUTES = ("tensor_cores", "cuda_cores")
_NAME = "flash_attention_infer"
_INT8 = "flash_attention_infer_int8"
_MASK32 = 0xFFFFFFFF
_PTR, _INT, _U32, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                          ctypes.c_float)


def _infer_bias_seg(
    bias: Optional[torch.Tensor],
    sequence_ids: Optional[torch.Tensor],
    batch: int,
    seq: int,
    name: str = _NAME,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(key_bias [B, S] fp32 or None, sequence ids [B, S] int32 or None).

    ``bias`` is the [B, 1, 1, S] key bias of ``make_attention_bias`` (any
    shape whose trailing S entries per row are the key bias). Passing both
    raises: packed rows exclude padding through id 0, so a key bias there
    is a caller's mistake."""
    if sequence_ids is not None and bias is not None:
        raise ValueError(
            f"{name}: pass either bias (padded batches) or sequence_ids "
            "(packed batches), not both")
    key_bias = None
    if bias is not None:
        key_bias = bias.reshape(batch, -1)[:, -seq:].float().contiguous()
    seg = None
    if sequence_ids is not None:
        seg = sequence_ids.to(torch.int32).contiguous()
    return key_bias, seg


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The accumulation dtype of the plain versions: fp32, or float64 for
    float64 inputs (``gradcheck``)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _scores(q, k, key_bias, seg):
    """[B, H, S, S] scores in the accumulation dtype, scaled after the
    product, with the key bias and the packed mask added."""
    acc = _acc_dtype(q)
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    return _masked(s, key_bias, seg)


def _masked(s, key_bias, seg):
    """Scaled [B, H, S, S] scores plus the key bias and the packed mask."""
    acc = s.dtype
    if key_bias is not None:
        s = s + key_bias.to(acc)[:, None, None, :]
    if seg is not None:
        same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0)
        s = s + torch.where(same, 0.0, -10000.0).to(acc)[:, None, :, :]
    return s


def flash_attention_infer_reference(q, k, v, bias=None, sequence_ids=None):
    """The plain PyTorch version of :func:`flash_attention_infer`, on any
    device (one full softmax instead of the kernel's tiled online one):
    the training forward's plain version without dropout."""
    key_bias, seg = _infer_bias_seg(bias, sequence_ids, q.shape[0],
                                    q.shape[1])
    return _forward_math(q, k, v, key_bias, seg, 0, 0.0)[0]


def infer_route(dtype: torch.dtype, head_dim: int) -> str:
    """The route a CUDA launch of a serving attention kernel takes, from
    the dtype of its values (q for :func:`flash_attention_infer`, v for
    the int8-score kernel) and head_dim: ``"tensor_cores"`` for bf16 with
    head_dim in :data:`TENSOR_CORE_HEAD_DIMS`, else ``"cuda_cores"``."""
    if dtype == torch.bfloat16 and head_dim in TENSOR_CORE_HEAD_DIMS:
        return "tensor_cores"
    return "cuda_cores"


def train_route(dtype: torch.dtype, head_dim: int, kernel: str) -> str:
    """The route a CUDA launch of the training kernel ``kernel``
    (``"flash_attention_fwd"``, ``"flash_attention_dq"`` or
    ``"flash_attention_dkv"``) takes, from q's dtype and head_dim:
    ``"tensor_cores"`` for bf16 or fp16 with head_dim in
    ``TRAIN_TENSOR_CORE_HEAD_DIMS[kernel]`` (32, 64 and 128 for the forward
    and dq; 32 and 64 for dkv, whose dK and dV at 128 would not fit one
    warpgroup's registers), else ``"cuda_cores"``."""
    if (dtype in _WGMMA_SUFFIX
            and head_dim in TRAIN_TENSOR_CORE_HEAD_DIMS[kernel]):
        return "tensor_cores"
    return "cuda_cores"


def _count(wrapper, route: str) -> None:
    wrapper.launches += 1
    wrapper.route_launches[route] += 1


def reset_counts(wrapper) -> None:
    """Set a kernel wrapper's launch count (and its per-route counts,
    where it has them) to 0."""
    wrapper.launches = 0
    for route in getattr(wrapper, "route_launches", {}):
        wrapper.route_launches[route] = 0


# The C entry points of each kernel library and their argument types.
_ENTRY_POINTS: Dict[str, Dict[str, list]] = {
    "flash_attention_infer": {
        "flash_attention_infer": [_PTR] * 6 + [_INT] * 5 + [_F32, _PTR],
        "flash_attention_infer_wgmma": [_PTR] * 6 + [_INT] * 4 + [_F32, _PTR],
    },
    "flash_attention_infer_int8": {
        "flash_attention_infer_int8": [_PTR] * 8 + [_INT] * 5 + [_F32, _PTR],
        "flash_attention_infer_int8_wgmma": ([_PTR] * 8 + [_INT] * 4
                                             + [_F32, _PTR]),
    },
    "flash_attention_fwd": {
        "flash_attention_fwd": ([_PTR] * 7 + [_INT] * 5 + [_F32, _INT]
                                + [_U32] * 3 + [_F32, _PTR]),
        **dict.fromkeys(("flash_attention_fwd_wgmma",
                         "flash_attention_fwd_wgmma_fp16"),
                        [_PTR] * 7 + [_INT] * 4 + [_F32, _INT]
                        + [_U32] * 3 + [_F32, _PTR]),
    },
    "flash_attention_bwd": {
        "flash_attention_dq": ([_PTR] * 10 + [_INT] * 5 + [_F32, _INT]
                               + [_U32] * 3 + [_F32, _PTR]),
        **dict.fromkeys(("flash_attention_dq_wgmma",
                         "flash_attention_dq_wgmma_fp16"),
                        [_PTR] * 10 + [_INT] * 4 + [_F32, _INT]
                        + [_U32] * 3 + [_F32, _PTR]),
        "flash_attention_dkv": ([_PTR] * 11 + [_INT] * 5 + [_F32, _INT]
                                + [_U32] * 3 + [_F32, _PTR]),
        **dict.fromkeys(("flash_attention_dkv_wgmma",
                         "flash_attention_dkv_wgmma_fp16"),
                        [_PTR] * 11 + [_INT] * 4 + [_F32, _INT]
                        + [_U32] * 3 + [_F32, _PTR]),
    },
}


def _library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed, with
    ``argtypes`` set on every entry point."""
    return build.load_bound(name, _ENTRY_POINTS[name])


def _check(name: str, q: torch.Tensor, same: Dict[str, torch.Tensor],
           key_bias, seg, stats: Optional[Dict[str, torch.Tensor]] = None,
           q_label: str = "q", dtypes: Sequence = _INFER_DTYPES) -> None:
    """Raise on what the kernels do not take: q [B, S, H, D] contiguous
    in one of ``dtypes`` (the serving kernels' float32/bfloat16 unless
    given) with head_dim a multiple of 8 up to 128; ``same``
    tensors of q's shape, dtype and device; the key bias [B, S] fp32 and
    the ids [B, S] int32; ``stats`` (lse, delta) [B*H, S] fp32 — each
    contiguous and on q's device, since the kernels read them by pointer.
    ``q_label`` names q in the messages."""
    if q.dim() != 4:
        raise ValueError(f"{name}: {q_label} must be [B, S, H, D], got "
                         f"{tuple(q.shape)}")
    for label, t in same.items():
        if t.shape != q.shape:
            raise ValueError(f"{name}: {label} shape {tuple(t.shape)} != "
                             f"{q_label} shape {tuple(q.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {label} must match {q_label}'s dtype "
                             f"and device ({q.dtype}, {q.device})")
    if q.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        f"({', '.join(str(d)[6:] for d in dtypes)})")
    batch, seq, heads, depth = q.shape
    if depth % 8 or depth > 128:
        raise ValueError(f"{name}: head_dim {depth} must be a multiple of "
                         "8 up to 128")
    expected = [(label, t, (batch, seq), dtype) for label, t, dtype in (
        ("bias", key_bias, torch.float32), ("sequence_ids", seg, torch.int32))
        if t is not None]
    expected += [(label, t, (batch * heads, seq), torch.float32)
                 for label, t in (stats or {}).items()]
    for label, t, shape, dtype in expected:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {label} must be {list(shape)} {dtype}, "
                             f"got {list(t.shape)} {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name}: {label} must be on {q.device}")
    for label, t in ((q_label, q), *same.items(),
                     *((label, t) for label, t, _, _ in expected)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def _device_of(name: str, q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    return q.device.type


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _stream(q: torch.Tensor) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def _check_aligned(name: str, tensors: Dict[str, torch.Tensor]) -> None:
    """The tensor-core route reads its operands by TMA, which needs 16-byte
    aligned bases."""
    for label, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned for "
                             "the tensor-core route")


def flash_attention_infer(q, k, v, bias=None, sequence_ids=None):
    """Forward-only fused attention over [B, S, H, D] tensors; returns
    [B, S, H, D] in q's dtype. ``bias`` is the [B, 1, 1, S] key bias for
    padded batches; ``sequence_ids`` ([B, S], 0 = pad) marks a packed batch
    and rebuilds the block-diagonal mask inside the kernel.

    On a CUDA tensor this launches the CUDA kernel on the route
    :func:`infer_route` picks, counting the launch in
    ``flash_attention_infer.launches`` and ``.route_launches[route]``; on
    a CPU tensor it returns the plain version and counts nothing."""
    batch, seq = q.shape[0], q.shape[1]
    key_bias, seg = _infer_bias_seg(bias, sequence_ids, batch, seq)
    if _device_of(_NAME, q) == "cpu":
        return _forward_math(q, k, v, key_bias, seg, 0, 0.0)[0]
    _check(_NAME, q, {"k": k, "v": v}, key_bias, seg)
    return _launch_infer(q, k, v, key_bias, seg,
                         infer_route(q.dtype, q.shape[3]))


def _launch_infer(q, k, v, key_bias, seg, route: str):
    """Launch the fp-score kernel on ``route`` (checked CUDA inputs)."""
    batch, seq, heads, depth = q.shape
    out = torch.empty_like(q)
    scale = 1.0 / float(depth) ** 0.5
    lib = _library(_NAME)
    with torch.cuda.device(q.device):
        if route == "tensor_cores":
            _check_aligned(_NAME, {"q": q, "k": k, "v": v, "out": out})
            rc = lib.flash_attention_infer_wgmma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _ptr(key_bias), _ptr(seg), batch, seq, heads, depth, scale,
                _stream(q))
        else:
            rc = lib.flash_attention_infer(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _ptr(key_bias), _ptr(seg), batch, seq, heads, depth,
                _DTYPE_CODES[q.dtype], scale, _stream(q))
    build.raise_on(rc, lib, _NAME, _NAME)
    _count(flash_attention_infer, route)
    return out


flash_attention_infer.launches = 0
flash_attention_infer.route_launches = dict.fromkeys(ROUTES, 0)


# -- serving with int8 scores ------------------------------------------------

def quantize_qk(q: torch.Tensor, k: torch.Tensor):
    """(q8, q_scale, k8, k_scale): [B, S, H, D] q and k quantized to int8
    with one symmetric fp32 scale per (batch, head) over (S, D), the
    scales as contiguous [B, H] arrays. The JAX wrapper's
    ``quantize_symmetric(x3, axes=(1, 2))`` on the [B*H, S, D] layout: the
    same elements per scale, so the same ints and scales. The scale spans
    every position of the row (padding and, in packed rows, every packed
    request), as in the JAX package."""
    batch, _, heads, _ = q.shape
    q8, q_scale = quant.quantize_symmetric(q, (1, 3))
    k8, k_scale = quant.quantize_symmetric(k, (1, 3))
    return (q8, q_scale.reshape(batch, heads).contiguous(),
            k8, k_scale.reshape(batch, heads).contiguous())


def _int8_forward_math(q8, k8, q_scale, k_scale, v, key_bias, seg):
    """The int8 kernel's function on pre-quantized inputs: exact int32
    scores (int8 products summed in float64: every sum is an integer below
    2**24, so the fp32 value is exact), times ``(q_scale * k_scale) *
    (1/sqrt(D))`` in fp32, plus the key bias and packed mask, then the fp
    kernel's softmax and PV; out in v's dtype."""
    scale = 1.0 / float(q8.shape[-1]) ** 0.5
    s32 = torch.einsum("bqhd,bkhd->bhqk", q8.double(), k8.double()).float()
    rescale = (q_scale.float() * k_scale.float()) * scale
    s = _masked(s32 * rescale[:, :, None, None], key_bias, seg)
    out, _ = _softmax_pv(s, v, None, 0.0)
    return out.to(v.dtype).contiguous()


def _check_int8(name, q8, k8, q_scale, k_scale, v, key_bias, seg) -> None:
    """Raise on what the int8 kernel does not take: q8 and k8 int8 of v's
    shape, 4-byte aligned (the kernel reads them as 32-bit words); scales
    [B, H] fp32; v [B, S, H, D] float32/bfloat16 with head_dim a multiple
    of 8 up to 128; the key bias and ids as for the fp kernel. All
    contiguous and on v's device."""
    _check(name, v, {}, key_bias, seg, q_label="v")
    batch, _, heads, _ = v.shape
    for label, t in (("q8", q8), ("k8", k8)):
        if t.shape != v.shape or t.dtype != torch.int8:
            raise ValueError(f"{name}: {label} must be int8 of v's shape "
                             f"{tuple(v.shape)}, got {tuple(t.shape)} "
                             f"{t.dtype}")
        if t.device != v.device or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous on "
                             f"{v.device}")
        if t.data_ptr() % 4:
            raise ValueError(f"{name}: {label} must be 4-byte aligned")
    for label, t in (("q_scale", q_scale), ("k_scale", k_scale)):
        if tuple(t.shape) != (batch, heads) or t.dtype != torch.float32:
            raise ValueError(f"{name}: {label} must be [{batch}, {heads}] "
                             f"float32, got {list(t.shape)} {t.dtype}")
        if t.device != v.device or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous on "
                             f"{v.device}")


def flash_attention_infer_int8_prequantized(q8, k8, q_scale, k_scale, v,
                                            key_bias=None, seg=None):
    """The int8-score kernel on pre-quantized inputs (:func:`quantize_qk`):
    q8, k8 [B, S, H, D] int8, q_scale, k_scale [B, H] fp32, v [B, S, H, D],
    the [B, S] fp32 key bias or [B, S] int32 ids (each optional); returns
    [B, S, H, D] in v's dtype. A CUDA tensor launches
    csrc/flash_attention_infer_int8.cu on the current stream, on the route
    :func:`infer_route` picks from v's dtype and head_dim, counting the
    launch in ``flash_attention_infer_int8.launches`` and
    ``.route_launches[route]``, or raises; a CPU tensor takes the plain
    version and counts nothing."""
    if _device_of(_INT8, v) == "cpu":
        return _int8_forward_math(q8, k8, q_scale, k_scale, v, key_bias, seg)
    _check_int8(_INT8, q8, k8, q_scale, k_scale, v, key_bias, seg)
    return _launch_int8(q8, k8, q_scale, k_scale, v, key_bias, seg,
                        infer_route(v.dtype, v.shape[3]))


def _launch_int8(q8, k8, q_scale, k_scale, v, key_bias, seg, route: str):
    """Launch the int8-score kernel on ``route`` (checked CUDA inputs)."""
    batch, seq, heads, depth = v.shape
    out = torch.empty_like(v)
    scale = 1.0 / float(depth) ** 0.5
    lib = _library(_INT8)
    with torch.cuda.device(v.device):
        if route == "tensor_cores":
            _check_aligned(_INT8, {"q8": q8, "k8": k8, "v": v, "out": out})
            rc = lib.flash_attention_infer_int8_wgmma(
                q8.data_ptr(), k8.data_ptr(), v.data_ptr(), out.data_ptr(),
                q_scale.data_ptr(), k_scale.data_ptr(), _ptr(key_bias),
                _ptr(seg), batch, seq, heads, depth, scale, _stream(v))
        else:
            rc = lib.flash_attention_infer_int8(
                q8.data_ptr(), k8.data_ptr(), v.data_ptr(), out.data_ptr(),
                q_scale.data_ptr(), k_scale.data_ptr(), _ptr(key_bias),
                _ptr(seg), batch, seq, heads, depth, _DTYPE_CODES[v.dtype],
                scale, _stream(v))
    build.raise_on(rc, lib, _INT8, _INT8)
    _count(flash_attention_infer_int8, route)
    return out


def flash_attention_infer_int8(q, k, v, bias=None, sequence_ids=None):
    """Forward-only fused attention with int8 QK^T over [B, S, H, D]
    tensors; returns [B, S, H, D] in v's dtype. The contract of
    :func:`flash_attention_infer` (``bias`` for padded batches,
    ``sequence_ids`` for packed ones) with q and k quantized per (batch,
    head) by :func:`quantize_qk` before the kernel. On a CUDA tensor this
    launches the int8 kernel (counted in ``.launches`` and
    ``.route_launches``); on a CPU tensor it returns the plain version."""
    key_bias, seg = _infer_bias_seg(bias, sequence_ids, q.shape[0],
                                    q.shape[1], _INT8)
    q8, q_scale, k8, k_scale = quantize_qk(q, k)
    return flash_attention_infer_int8_prequantized(
        q8, k8, q_scale, k_scale, v, key_bias, seg)


flash_attention_infer_int8.launches = 0
flash_attention_infer_int8.route_launches = dict.fromkeys(ROUTES, 0)


def flash_attention_infer_int8_reference(q, k, v, bias=None,
                                         sequence_ids=None):
    """The plain PyTorch version of :func:`flash_attention_infer_int8`, on
    any device: the same quantization, exact int32 scores, one full
    softmax."""
    key_bias, seg = _infer_bias_seg(bias, sequence_ids, q.shape[0],
                                    q.shape[1], _INT8)
    q8, q_scale, k8, k_scale = quantize_qk(q, k)
    return _int8_forward_math(q8, k8, q_scale, k_scale, v, key_bias, seg)


# -- training: dropout masks ---------------------------------------------

def dropout_threshold(rate: float) -> int:
    """Keep iff 32 random bits >= this (the JAX kernels' convention)."""
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def _mulhilo(a: int, b: torch.Tensor):
    """(high, low) 32-bit words of a * b for a uint32 constant and a tensor
    of uint32 values held in int64, without overflowing int64."""
    t1 = (b & 0xFFFF) * a          # < 2^48
    t2 = (b >> 16) * a             # < 2^48
    s = t1 + ((t2 & 0xFFFF) << 16)
    return (t2 >> 16) + (s >> 32), s & _MASK32


def philox4x32_10(c0, c1, c2, c3, seed: int):
    """Philox4x32-10 of the counter (c0, c1, c2, c3) (int64 tensors holding
    uint32 values, broadcast together) under the 64-bit key ``seed``; the
    plain twin of ``philox4x32_10`` in csrc/flash_attention_common.cuh."""
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _MASK32
        k1 = (k1 + 0xBB67AE85) & _MASK32
    return c0, c1, c2, c3


def philox_keep_mask(seed: int, rate: float, bh: torch.Tensor,
                     rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The attention-dropout keep mask at the given coordinates: bool
    [len(bh), len(rows), len(cols)], element (b*H + h, q, k) kept iff word
    ``k % 4`` of Philox(counter=(k // 4, q, b*H + h, 0), key=seed) is >=
    :func:`dropout_threshold`. Depends only on the coordinates, so any
    block of the mask computed alone equals that block of the whole."""
    cols = cols.long()
    zero = torch.zeros((), dtype=torch.int64, device=cols.device)
    words = philox4x32_10(
        (cols // 4)[None, None, :], rows.long()[None, :, None],
        bh.long()[:, None, None], zero, int(seed))
    lane = (cols % 4)[None, None, :]
    bits = torch.where(lane == 0, words[0], torch.where(
        lane == 1, words[1], torch.where(lane == 2, words[2], words[3])))
    return bits >= dropout_threshold(rate)


def _keep(q: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """The whole [B, H, S, S] keep mask of one attention call."""
    batch, seq, heads = q.shape[:3]
    idx = torch.arange(max(batch * heads, seq), device=q.device)
    return philox_keep_mask(seed, rate, idx[:batch * heads], idx[:seq],
                            idx[:seq]).view(batch, heads, seq, seq)


# -- training: plain versions of the three kernels ------------------------

def _forward_math(q, k, v, key_bias, seg, seed, rate):
    """(out [B, S, H, D] in q's dtype, lse [B*H, S]): the forward kernel's
    function, differentiable through autograd."""
    s = _scores(q, k, key_bias, seg)
    keep = _keep(q, seed, rate) if rate > 0.0 else None
    out, lse = _softmax_pv(s, v, keep, rate)
    return out.to(q.dtype).contiguous(), lse


def _softmax_pv(s, v, keep, rate):
    """(out [B, S, H, D] in the scores' dtype, lse [B*H, S]) from masked
    [B, H, S, S] scores: the softmax and PV shared by the forward kernels'
    plain versions (the counterpart of the kernels' shared stream)."""
    batch, heads, seq = s.shape[:3]
    acc = s.dtype
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)  # the undropped probabilities
    lse = (m + torch.log(l)).reshape(batch * heads, seq)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).to(acc), v.to(acc))
    out = pv / (l * (1.0 - rate))
    return out.permute(0, 2, 1, 3), lse


def _probs_and_da(q, k, v, do, lse, key_bias, seg, seed, rate):
    """The backward kernels' shared start: (p = exp(s - lse), dA = dO v^T
    with the dropout mask and 1/(1-rate) applied, keep mask or None)."""
    batch, seq, heads, _ = q.shape
    acc = _acc_dtype(q)
    p = torch.exp(_scores(q, k, key_bias, seg)
                  - lse.to(acc).view(batch, heads, seq, 1))
    da = torch.einsum("bqhd,bkhd->bhqk", do.to(acc), v.to(acc))
    keep = None
    if rate > 0.0:
        keep = _keep(q, seed, rate)
        da = torch.where(keep, da * (1.0 / (1.0 - rate)), 0.0)
    return p, da, keep


def _dq_math(q, k, v, out, do, lse, key_bias, seg, seed, rate):
    """(dq in q's dtype, delta [B*H, S]): the dq kernel's function."""
    batch, seq, heads, depth = q.shape
    acc = _acc_dtype(q)
    delta = (do.to(acc) * out.to(acc)).sum(-1).permute(0, 2, 1)  # [B,H,S]
    p, da, _ = _probs_and_da(q, k, v, do, lse, key_bias, seg, seed, rate)
    ds = p * (da - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).to(acc), k.to(acc))
    dq = dq * (1.0 / float(depth) ** 0.5)
    return dq.to(q.dtype).contiguous(), delta.reshape(batch * heads, seq)


def _dkv_math(q, k, v, do, lse, delta, key_bias, seg, seed, rate):
    """(dk, dv in k's / v's dtype, dbias [B*H, S]): the dkv kernel's
    function; dbias is the sum over queries of dS."""
    batch, seq, heads, depth = q.shape
    acc = _acc_dtype(q)
    p, da, keep = _probs_and_da(q, k, v, do, lse, key_bias, seg, seed, rate)
    p_v = p if keep is None else torch.where(
        keep, p * (1.0 / (1.0 - rate)), 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p_v.to(do.dtype).to(acc), do.to(acc))
    ds = p * (da - delta.to(acc).view(batch, heads, seq, 1))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).to(acc), q.to(acc))
    dk = dk * (1.0 / float(depth) ** 0.5)
    dbias = ds.sum(dim=2).reshape(batch * heads, seq)
    return dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous(), dbias


# -- training: kernel wrappers ---------------------------------------------

def _dropout_args(seed, rate):
    """(dropout flag, seed words, threshold) for a C entry point."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    seed = int(seed or 0)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"dropout seed must be in [0, 2**64), got {seed}")
    return (int(rate > 0.0), seed & _MASK32, seed >> 32,
            dropout_threshold(rate))


def flash_attention_fwd(q, k, v, key_bias=None, seg=None, seed=None,
                        rate=0.0):
    """The forward kernel: (out [B, S, H, D], lse [B*H, S] fp32) for
    [B, S, H, D] q, k, v, a [B, S] fp32 key bias and [B, S] int32 sequence
    ids (each optional), and dropout ``rate`` drawn from ``seed``. A CUDA
    tensor launches csrc/flash_attention_fwd.cu on the route
    :func:`train_route` picks, counting the launch in
    ``flash_attention_fwd.launches`` and ``.route_launches[route]``; a CPU
    tensor takes the plain version and counts nothing."""
    name = "flash_attention_fwd"
    _dropout_args(seed, rate)
    if _device_of(name, q) == "cpu":
        return _forward_math(q, k, v, key_bias, seg, seed, rate)
    _check(name, q, {"k": k, "v": v}, key_bias, seg, dtypes=_TRAIN_DTYPES)
    return _launch_fwd(q, k, v, key_bias, seg, seed, rate,
                       train_route(q.dtype, q.shape[3], name))


def _launch_fwd(q, k, v, key_bias, seg, seed, rate, route: str):
    """Launch the forward kernel on ``route`` (checked CUDA inputs)."""
    name = "flash_attention_fwd"
    flag, lo, hi, threshold = _dropout_args(seed, rate)
    batch, seq, heads, depth = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(batch * heads, seq, dtype=torch.float32,
                      device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _ptr(key_bias), _ptr(seg), batch, seq, heads,
            depth)
    tail = (1.0 / float(depth) ** 0.5, flag, lo, hi, threshold, 1.0 - rate,
            _stream(q))
    lib = _library(name)
    with torch.cuda.device(q.device):
        if route == "tensor_cores":
            _check_aligned(name, {"q": q, "k": k, "v": v, "out": out})
            rc = getattr(lib, "flash_attention_fwd_wgmma"
                         + _WGMMA_SUFFIX[q.dtype])(*args, *tail)
        else:
            rc = lib.flash_attention_fwd(*args, _DTYPE_CODES[q.dtype], *tail)
    build.raise_on(rc, lib, name, name)
    _count(flash_attention_fwd, route)
    return out, lse


def flash_attention_dq(q, k, v, out, do, lse, key_bias=None, seg=None,
                       seed=None, rate=0.0):
    """The dq kernel: (dq [B, S, H, D], delta [B*H, S] fp32) from the
    forward's out and lse and the output gradient ``do``; ``delta =
    rowsum(do * out)`` is computed in the kernel and feeds
    :func:`flash_attention_dkv`. CUDA launches csrc/flash_attention_bwd.cu
    on the route :func:`train_route` picks (counted in
    ``flash_attention_dq.launches`` and ``.route_launches[route]``); CPU
    takes the plain version."""
    name = "flash_attention_dq"
    _dropout_args(seed, rate)
    if _device_of(name, q) == "cpu":
        return _dq_math(q, k, v, out, do, lse, key_bias, seg, seed, rate)
    _check(name, q, {"k": k, "v": v, "out": out, "do": do}, key_bias, seg,
           {"lse": lse}, dtypes=_TRAIN_DTYPES)
    return _launch_dq(q, k, v, out, do, lse, key_bias, seg, seed, rate,
                      train_route(q.dtype, q.shape[3], name))


def _launch_dq(q, k, v, out, do, lse, key_bias, seg, seed, rate,
               route: str):
    """Launch the dq kernel on ``route`` (checked CUDA inputs)."""
    name = "flash_attention_dq"
    flag, lo, hi, threshold = _dropout_args(seed, rate)
    batch, seq, heads, depth = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty(batch * heads, seq, dtype=torch.float32,
                        device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _ptr(key_bias), _ptr(seg), batch, seq, heads, depth)
    tail = (1.0 / float(depth) ** 0.5, flag, lo, hi, threshold,
            1.0 / (1.0 - rate), _stream(q))
    lib = _library("flash_attention_bwd")
    with torch.cuda.device(q.device):
        if route == "tensor_cores":
            _check_aligned(name, {"q": q, "k": k, "v": v, "out": out,
                                  "do": do, "dq": dq})
            rc = getattr(lib, "flash_attention_dq_wgmma"
                         + _WGMMA_SUFFIX[q.dtype])(*args, *tail)
        else:
            rc = lib.flash_attention_dq(*args, _DTYPE_CODES[q.dtype], *tail)
    build.raise_on(rc, lib, "flash_attention_bwd", name)
    _count(flash_attention_dq, route)
    return dq, delta


def flash_attention_dkv(q, k, v, do, lse, delta, key_bias=None, seg=None,
                        seed=None, rate=0.0):
    """The dkv kernel: (dk, dv [B, S, H, D], dbias [B*H, S] fp32, the sum
    over queries of dS). CUDA launches csrc/flash_attention_bwd.cu on the
    route :func:`train_route` picks (counted in
    ``flash_attention_dkv.launches`` and ``.route_launches[route]``); CPU
    takes the plain version."""
    name = "flash_attention_dkv"
    _dropout_args(seed, rate)
    if _device_of(name, q) == "cpu":
        return _dkv_math(q, k, v, do, lse, delta, key_bias, seg, seed, rate)
    _check(name, q, {"k": k, "v": v, "do": do}, key_bias, seg,
           {"lse": lse, "delta": delta}, dtypes=_TRAIN_DTYPES)
    return _launch_dkv(q, k, v, do, lse, delta, key_bias, seg, seed, rate,
                       train_route(q.dtype, q.shape[3], name))


def _launch_dkv(q, k, v, do, lse, delta, key_bias, seg, seed, rate,
                route: str):
    """Launch the dkv kernel on ``route`` (checked CUDA inputs)."""
    name = "flash_attention_dkv"
    flag, lo, hi, threshold = _dropout_args(seed, rate)
    batch, seq, heads, depth = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty(batch * heads, seq, dtype=torch.float32,
                        device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dbias.data_ptr(), _ptr(key_bias), _ptr(seg), batch, seq, heads,
            depth)
    tail = (1.0 / float(depth) ** 0.5, flag, lo, hi, threshold,
            1.0 / (1.0 - rate), _stream(q))
    lib = _library("flash_attention_bwd")
    with torch.cuda.device(q.device):
        if route == "tensor_cores":
            _check_aligned(name, {"q": q, "k": k, "v": v, "do": do,
                                  "dk": dk, "dv": dv})
            rc = getattr(lib, "flash_attention_dkv_wgmma"
                         + _WGMMA_SUFFIX[q.dtype])(*args, *tail)
        else:
            rc = lib.flash_attention_dkv(*args, _DTYPE_CODES[q.dtype], *tail)
    build.raise_on(rc, lib, "flash_attention_bwd", name)
    _count(flash_attention_dkv, route)
    return dk, dv, dbias


flash_attention_fwd.launches = 0
flash_attention_fwd.route_launches = dict.fromkeys(ROUTES, 0)
flash_attention_dq.launches = 0
flash_attention_dq.route_launches = dict.fromkeys(ROUTES, 0)
flash_attention_dkv.launches = 0
flash_attention_dkv.route_launches = dict.fromkeys(ROUTES, 0)
TRAINING_KERNELS: Sequence = (flash_attention_fwd, flash_attention_dq,
                              flash_attention_dkv)


class _FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v); the backward runs the dq kernel, then the
    dkv kernel, from the saved out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, seg, seed, rate):
        out, lse = flash_attention_fwd(q, k, v, key_bias, seg, seed, rate)
        ctx.save_for_backward(q, k, v, out, lse, key_bias, seg)
        ctx.seed, ctx.rate = seed, rate
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, key_bias, seg = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        dq, delta = flash_attention_dq(q, k, v, out, dout, lse, key_bias,
                                       seg, ctx.seed, ctx.rate)
        dk, dv, dbias = flash_attention_dkv(q, k, v, dout, lse, delta,
                                            key_bias, seg, ctx.seed,
                                            ctx.rate)
        d_key_bias = None
        if key_bias is not None and ctx.needs_input_grad[3]:
            batch, seq, heads = q.shape[:3]
            d_key_bias = dbias.view(batch, heads, seq).sum(1).to(
                key_bias.dtype)
        return dq, dk, dv, d_key_bias, None, None, None


def _training_inputs(name, q, bias, sequence_ids, dropout_rate, seed):
    batch, seq = q.shape[0], q.shape[1]
    if bias is not None and bias.numel() != batch * seq:
        raise ValueError(
            f"{name}: bias must be the [B, 1, 1, S] key bias, got "
            f"{tuple(bias.shape)} (packed batches pass sequence_ids)")
    key_bias, seg = _infer_bias_seg(bias, sequence_ids, batch, seq, name)
    rate = float(dropout_rate)
    if rate > 0.0 and seed is None:
        raise ValueError(f"{name}: dropout_rate > 0 requires seed")
    return key_bias, seg, rate, int(seed or 0)


def flash_attention(q, k, v, bias=None, dropout_rate=0.0, seed=None,
                    sequence_ids=None):
    """Fused attention with a gradient over [B, S, H, D] tensors; returns
    out in q's dtype. ``bias`` is the [B, 1, 1, S] key bias of padded
    batches (its gradient is the sum over queries and heads of dS);
    ``sequence_ids`` ([B, S], 0 = pad) marks a packed batch instead.
    ``dropout_rate > 0`` drops attention probabilities with the Philox
    mask of ``seed`` (an int in [0, 2**64)), regenerated by the backward.

    CUDA tensors run the three kernels (forward now, dq and dkv in the
    backward); CPU tensors run their plain versions."""
    key_bias, seg, rate, seed = _training_inputs(
        "flash_attention", q, bias, sequence_ids, dropout_rate, seed)
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), key_bias, seg, seed, rate)


def flash_attention_reference(q, k, v, bias=None, dropout_rate=0.0,
                              seed=None, sequence_ids=None):
    """The plain, differentiable PyTorch version of
    :func:`flash_attention`: the same arithmetic and the same Philox mask,
    differentiated by autograd."""
    key_bias, seg, rate, seed = _training_inputs(
        "flash_attention_reference", q, bias, sequence_ids, dropout_rate,
        seed)
    return _forward_math(q, k, v, key_bias, seg, seed, rate)[0]
