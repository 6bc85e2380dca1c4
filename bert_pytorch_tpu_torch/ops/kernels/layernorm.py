"""The LayerNorm forward kernel of the port: the counterpart of the JAX
package's Pallas kernel in ops/pallas/layernorm.py (``_ln_fwd_kernel``
through ``_ln_forward`` and ``layer_norm_pallas``).

* :func:`layer_norm_fwd` — the wrapper over x [rows, H]: a CUDA tensor
  launches the hand-written kernel (csrc/layer_norm_fwd.cu) on the current
  stream, counting the launch in ``layer_norm_fwd.launches``, or raises; a
  CPU tensor takes the plain version and counts nothing.
* :func:`layer_norm_fwd_reference` — the plain PyTorch version of the same
  function: the CPU tests hold it against the JAX kernel, and the chip
  smoke holds the CUDA kernel against it.
* :func:`layer_norm_kernel` — LayerNorm over the last axis of any rank,
  differentiable: a ``torch.autograd.Function`` whose forward is
  :func:`layer_norm_fwd` and whose backward is the port of the JAX
  package's ``_layer_norm_p_bwd`` in plain PyTorch (the JAX backward is
  plain XLA, so there is no backward kernel to port).

Numerics (every version): fp32 mean, variance as the mean of the centered
squares, ``rstd = rsqrt(var + eps)``, ``out = (x - mean) * rstd * scale +
bias`` cast to x's dtype (fp32, bf16 or fp16; rounded to nearest), and
mean/rstd kept as fp32 [rows, 1].
"""

from __future__ import annotations

import ctypes

import torch

from bert_pytorch_tpu_torch.ops.kernels import build

_NAME = "layer_norm_fwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The largest hidden size the kernel holds in registers (128 values a lane).
MAX_HIDDEN = 4096
_PTR = ctypes.c_void_p
_ENTRY_POINTS = {
    _NAME: [_PTR] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                         ctypes.c_float, _PTR],
}


def layer_norm_fwd_reference(x2d: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, eps: float):
    """(out in x2d's dtype, mean [rows, 1] fp32, rstd [rows, 1] fp32): the
    kernel's function in plain PyTorch, on any device."""
    x = x2d.float()
    mean = x.mean(dim=-1, keepdim=True)
    centered = x - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = centered * rstd * scale.float() + bias.float()
    return out.to(x2d.dtype), mean, rstd


def _check(x2d: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    """Raise on what the kernel does not take: x [rows, H] contiguous
    float32/bfloat16/float16 with 0 < H <= MAX_HIDDEN and rows > 0; scale and bias
    contiguous fp32 [H] on x's device."""
    if x2d.dim() != 2:
        raise ValueError(f"{_NAME}: x must be [rows, H], got "
                         f"{tuple(x2d.shape)}")
    if x2d.dtype not in _DTYPE_CODES:
        raise TypeError(f"{_NAME}: dtype {x2d.dtype} not supported "
                        "(float32, bfloat16, float16)")
    rows, hidden = x2d.shape
    if rows == 0 or not 0 < hidden <= MAX_HIDDEN:
        raise ValueError(f"{_NAME}: needs rows > 0 and 0 < H <= "
                         f"{MAX_HIDDEN}, got {tuple(x2d.shape)}")
    if not x2d.is_contiguous():
        raise ValueError(f"{_NAME}: x must be contiguous")
    for label, t in (("scale", scale), ("bias", bias)):
        if tuple(t.shape) != (hidden,) or t.dtype != torch.float32:
            raise ValueError(f"{_NAME}: {label} must be [{hidden}] float32, "
                             f"got {list(t.shape)} {t.dtype}")
        if t.device != x2d.device or not t.is_contiguous():
            raise ValueError(f"{_NAME}: {label} must be contiguous on "
                             f"{x2d.device}")


def layer_norm_fwd(x2d: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, eps: float = 1e-12):
    """(out [rows, H] in x2d's dtype, mean [rows, 1] fp32, rstd [rows, 1]
    fp32) for x2d [rows, H] and fp32 scale/bias [H]. A CUDA tensor launches
    csrc/layer_norm_fwd.cu (counted in ``layer_norm_fwd.launches``) or
    raises; a CPU tensor takes the plain version and counts nothing."""
    if x2d.device.type == "cpu":
        return layer_norm_fwd_reference(x2d, scale, bias, eps)
    if x2d.device.type != "cuda":
        raise ValueError(f"{_NAME}: unsupported device {x2d.device}")
    _check(x2d, scale, bias)
    rows, hidden = x2d.shape
    out = torch.empty_like(x2d)
    mean = torch.empty(rows, 1, dtype=torch.float32, device=x2d.device)
    rstd = torch.empty(rows, 1, dtype=torch.float32, device=x2d.device)
    lib = build.load_bound(_NAME, _ENTRY_POINTS)
    with torch.cuda.device(x2d.device):
        rc = lib.layer_norm_fwd(
            x2d.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), rows, hidden,
            _DTYPE_CODES[x2d.dtype], float(eps),
            torch.cuda.current_stream(x2d.device).cuda_stream)
    build.raise_on(rc, lib, _NAME, _NAME)
    layer_norm_fwd.launches += 1
    return out, mean, rstd


layer_norm_fwd.launches = 0


def layer_norm_bwd(g: torch.Tensor, x2d: torch.Tensor, scale: torch.Tensor,
                   mean: torch.Tensor, rstd: torch.Tensor):
    """(dx in x2d's dtype, dscale, dbias in scale's dtype) from the output
    gradient and the saved statistics: the JAX package's
    ``_layer_norm_p_bwd``, in fp32."""
    x = x2d.float()
    g32 = g.float()
    normed = (x - mean) * rstd
    dscale = (g32 * normed).sum(dim=0)
    dbias = g32.sum(dim=0)
    gs = g32 * scale.float()
    dx = rstd * (gs - gs.mean(dim=-1, keepdim=True)
                 - normed * (gs * normed).mean(dim=-1, keepdim=True))
    return dx.to(x2d.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype)


class _LayerNormKernel(torch.autograd.Function):
    """out = LayerNorm(x2d); the forward kernel saves mean and rstd, and the
    backward is plain PyTorch."""

    @staticmethod
    def forward(ctx, x2d, scale, bias, eps):
        out, mean, rstd = layer_norm_fwd(x2d, scale, bias, eps)
        ctx.save_for_backward(x2d, scale, mean, rstd)
        return out

    @staticmethod
    def backward(ctx, g):
        x2d, scale, mean, rstd = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(g, x2d, scale, mean, rstd)
        return dx, dscale, dbias, None


def layer_norm_kernel(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (any rank) through the kernel
    on a CUDA tensor (its plain version on a CPU tensor), with a gradient
    for x, scale and bias."""
    hidden = x.shape[-1]
    out = _LayerNormKernel.apply(x.reshape(-1, hidden).contiguous(), scale,
                                 bias, float(eps))
    return out.reshape(x.shape)
