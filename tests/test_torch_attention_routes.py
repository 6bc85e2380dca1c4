"""The two routes of the serving attention kernels (#4, #5) and of the
training forward, dq and dkv kernels (#1, #2, #3), on the CPU: which route a
launch takes (``infer_route`` and ``train_route``, from dtype and head_dim
alone), that a CPU tensor takes the plain version and counts no launch on
any route, and that the wrappers call the route's C entry point, count
it, and raise on a failed launch without falling back to the other route
(a stand-in library replaces the built one; no kernel runs here). Also
the keep-mask readers of testing/dropout_masks.py, which the card tests
use to compare the routes' masks, on the plain versions."""

import contextlib

import numpy as np
import pytest
import torch

from bert_pytorch_tpu_torch.ops.attention import make_attention_bias
from bert_pytorch_tpu_torch.ops.kernels import attention as kattn

KERNELS = (kattn.flash_attention_infer, kattn.flash_attention_infer_int8,
           kattn.flash_attention_fwd, kattn.flash_attention_dq,
           kattn.flash_attention_dkv)


@pytest.mark.parametrize("dtype,head_dim,route", [
    (torch.bfloat16, 64, "tensor_cores"),
    (torch.bfloat16, 128, "tensor_cores"),
    (torch.bfloat16, 32, "tensor_cores"),
    (torch.float32, 64, "cuda_cores"),
    (torch.float32, 128, "cuda_cores"),
    (torch.bfloat16, 24, "cuda_cores"),
    (torch.bfloat16, 16, "cuda_cores"),
    (torch.bfloat16, 96, "cuda_cores"),
    (torch.float16, 64, "cuda_cores"),
])
def test_route_from_dtype_and_head_dim(dtype, head_dim, route):
    """bf16 with head_dim 32, 64 or 128 takes the tensor cores (#4 by q's
    dtype, #5 by v's); fp32, D=24 and every other head_dim the CUDA
    cores."""
    assert kattn.infer_route(dtype, head_dim) == route
    assert route in kattn.ROUTES


def _inputs(dtype, seq=40, depth=64, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2, seq, 3, depth)).astype(np.float32)).to(dtype) for _ in range(3))
    mask = np.ones((2, seq), np.int32)
    mask[1, seq // 2:] = 0
    sids = np.zeros((2, seq), np.int32)
    sids[0, :seq // 3], sids[0, seq // 3:] = 1, 2
    return q, k, v, make_attention_bias(torch.from_numpy(mask)), \
        torch.from_numpy(sids)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_take_the_plain_version_and_count_nothing(dtype):
    """A CPU tensor on either route's dtype takes the plain version: equal
    to the reference bit for bit, no launch counted, on any route."""
    q, k, v, bias, sids = _inputs(dtype)
    before = [(f.launches, dict(f.route_launches)) for f in KERNELS]
    for kw in ({"bias": bias}, {"sequence_ids": sids}):
        torch.testing.assert_close(
            kattn.flash_attention_infer(q, k, v, **kw),
            kattn.flash_attention_infer_reference(q, k, v, **kw),
            atol=0, rtol=0)
        torch.testing.assert_close(
            kattn.flash_attention_infer_int8(q, k, v, **kw),
            kattn.flash_attention_infer_int8_reference(q, k, v, **kw),
            atol=0, rtol=0)
    assert [(f.launches, dict(f.route_launches)) for f in KERNELS] == before


def test_reset_counts_zeroes_every_route():
    wrappers = (kattn.flash_attention_infer, kattn.flash_attention_dq)
    saved = [(w.launches, dict(w.route_launches)) for w in wrappers]
    try:
        for wrapper in wrappers:
            wrapper.launches = 5
            wrapper.route_launches.update(tensor_cores=3, cuda_cores=2)
            kattn.reset_counts(wrapper)
            assert wrapper.launches == 0
            assert wrapper.route_launches == {"tensor_cores": 0,
                                              "cuda_cores": 0}
    finally:
        for wrapper, (launches, routes) in zip(wrappers, saved):
            wrapper.launches, wrapper.route_launches = launches, routes


class _FakeLibrary:
    """Records the C entry point each launch calls and returns ``rc``."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def __getattr__(self, name):
        if name.endswith("_error"):
            return lambda code: b"stand-in launch failure"

        def entry(*args):
            self.calls.append((name, args))
            return self.rc
        return entry


@pytest.fixture()
def fake_library(monkeypatch):
    """The launch helpers with the built library and the CUDA device
    context replaced, and the launch counts restored afterwards."""
    saved = [(f.launches, dict(f.route_launches)) for f in KERNELS]
    lib = _FakeLibrary()
    monkeypatch.setattr(kattn, "_library", lambda name: lib)
    monkeypatch.setattr(kattn, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    yield lib
    for f, (launches, routes) in zip(KERNELS, saved):
        f.launches, f.route_launches = launches, routes


@pytest.mark.parametrize("dtype,depth,entry,route", [
    (torch.bfloat16, 64, "flash_attention_infer_wgmma", "tensor_cores"),
    (torch.bfloat16, 128, "flash_attention_infer_wgmma", "tensor_cores"),
    (torch.float32, 64, "flash_attention_infer", "cuda_cores"),
    (torch.bfloat16, 24, "flash_attention_infer", "cuda_cores"),
])
def test_fp_kernel_calls_its_routes_entry_point(fake_library, dtype, depth,
                                                entry, route):
    q, k, v, _, sids = _inputs(dtype, depth=depth)
    kb, seg = kattn._infer_bias_seg(None, sids, 2, q.shape[1])
    before = dict(kattn.flash_attention_infer.route_launches)
    out = kattn._launch_infer(q, k, v, kb, seg,
                              kattn.infer_route(dtype, depth))
    assert out.shape == q.shape and out.dtype == dtype
    ((name, args),) = fake_library.calls
    assert name == entry
    # The tensor-core entry takes no dtype code; both end with the scale
    # and the stream, after (batch, seq, heads, head_dim).
    assert args[6:10] == (2, q.shape[1], 3, depth)
    assert args[-2] == pytest.approx(depth ** -0.5)
    after = kattn.flash_attention_infer.route_launches
    assert after[route] == before[route] + 1
    assert sum(after.values()) == sum(before.values()) + 1


@pytest.mark.parametrize("dtype,depth,entry,route", [
    (torch.bfloat16, 64, "flash_attention_infer_int8_wgmma",
     "tensor_cores"),
    (torch.bfloat16, 32, "flash_attention_infer_int8_wgmma",
     "tensor_cores"),
    (torch.float32, 64, "flash_attention_infer_int8", "cuda_cores"),
    (torch.bfloat16, 96, "flash_attention_infer_int8", "cuda_cores"),
])
def test_int8_kernel_calls_its_routes_entry_point(fake_library, dtype, depth,
                                                  entry, route):
    q, k, v, bias, _ = _inputs(dtype, depth=depth)
    kb, seg = kattn._infer_bias_seg(bias, None, 2, q.shape[1])
    q8, q_scale, k8, k_scale = kattn.quantize_qk(q, k)
    before = dict(kattn.flash_attention_infer_int8.route_launches)
    out = kattn._launch_int8(q8, k8, q_scale, k_scale, v, kb, seg,
                             kattn.infer_route(v.dtype, depth))
    assert out.shape == v.shape and out.dtype == dtype
    ((name, args),) = fake_library.calls
    assert name == entry
    assert args[8:12] == (2, q.shape[1], 3, depth)
    after = kattn.flash_attention_infer_int8.route_launches
    assert after[route] == before[route] + 1


def test_failed_launch_raises_and_falls_back_to_nothing(fake_library):
    """A launch that returns a CUDA error raises; the other route's entry
    point is never called and no launch is counted."""
    fake_library.rc = 1
    q, k, v, _, _ = _inputs(torch.bfloat16)
    before = kattn.flash_attention_infer.launches
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        kattn._launch_infer(q, k, v, None, None, "tensor_cores")
    assert [name for name, _ in fake_library.calls] == [
        "flash_attention_infer_wgmma"]
    assert kattn.flash_attention_infer.launches == before


def test_tensor_core_route_needs_16_byte_aligned_operands(fake_library):
    q, k, v, _, _ = _inputs(torch.bfloat16)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype)
    shifted = flat[1:].view(q.shape)  # 2 bytes past an aligned base
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kattn._launch_infer(shifted, k, v, None, None, "tensor_cores")
    assert fake_library.calls == []


# -- the training forward (#1), dq (#2) and dkv (#3) kernels -----------------

FWD, DQ, DKV = ("flash_attention_fwd", "flash_attention_dq",
                "flash_attention_dkv")


@pytest.mark.parametrize("dtype,head_dim,fwd_route,dkv_route", [
    (torch.bfloat16, 64, "tensor_cores", "tensor_cores"),
    (torch.bfloat16, 32, "tensor_cores", "tensor_cores"),
    (torch.bfloat16, 128, "tensor_cores", "cuda_cores"),
    (torch.bfloat16, 24, "cuda_cores", "cuda_cores"),
    (torch.bfloat16, 96, "cuda_cores", "cuda_cores"),
    (torch.float32, 64, "cuda_cores", "cuda_cores"),
    (torch.float32, 128, "cuda_cores", "cuda_cores"),
    (torch.float16, 64, "tensor_cores", "tensor_cores"),
])
def test_train_route_from_dtype_and_head_dim(dtype, head_dim, fwd_route,
                                             dkv_route):
    """bf16 and fp16 forward at head_dim 32, 64 and 128 and dkv at 32 and
    64 (dK and dV of head_dim 128 do not fit one warpgroup's registers)
    take the tensor cores; fp32 and other head dims the CUDA cores."""
    assert kattn.train_route(dtype, head_dim, FWD) == fwd_route
    assert kattn.train_route(dtype, head_dim, DKV) == dkv_route


@pytest.mark.parametrize("dtype,head_dim,route", [
    (torch.bfloat16, 64, "tensor_cores"),
    (torch.bfloat16, 32, "tensor_cores"),
    (torch.bfloat16, 128, "tensor_cores"),
    (torch.bfloat16, 24, "cuda_cores"),
    (torch.bfloat16, 96, "cuda_cores"),
    (torch.float32, 64, "cuda_cores"),
    (torch.float16, 64, "tensor_cores"),
])
def test_dq_train_route_from_dtype_and_head_dim(dtype, head_dim, route):
    """bf16 and fp16 dq at head_dim 32, 64 and 128 (dQ is head_dim / 2
    fp32 values a thread, as the forward's output) takes the tensor cores;
    fp32 and other head dims the CUDA cores."""
    assert kattn.train_route(dtype, head_dim, DQ) == route


def _training_args(dtype, depth, seq=40):
    q, k, v, bias, _ = _inputs(dtype, seq=seq, depth=depth)
    do = torch.ones_like(q)
    kb, _ = kattn._infer_bias_seg(bias, None, 2, seq)
    lse = torch.zeros(2 * 3, seq)
    return q, k, v, do, lse, kb


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_training_cpu_tensors_take_the_plain_versions_and_count_nothing(
        dtype):
    """The forward, dq and dkv wrappers on CPU tensors return their plain
    versions bit for bit and count no launch on any route."""
    q, k, v, do, lse, kb = _training_args(dtype, 64)
    before = [(f.launches, dict(f.route_launches)) for f in KERNELS]
    args = (kb, None, 99, 0.1)
    for got, want in zip(kattn.flash_attention_fwd(q, k, v, *args),
                         kattn._forward_math(q, k, v, *args)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    for got, want in zip(
            kattn.flash_attention_dq(q, k, v, v, do, lse, *args),
            kattn._dq_math(q, k, v, v, do, lse, *args)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    for got, want in zip(
            kattn.flash_attention_dkv(q, k, v, do, lse, lse, *args),
            kattn._dkv_math(q, k, v, do, lse, lse, *args)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert [(f.launches, dict(f.route_launches)) for f in KERNELS] == before


@pytest.mark.parametrize("dtype,depth,entry,route", [
    (torch.bfloat16, 64, "flash_attention_fwd_wgmma", "tensor_cores"),
    (torch.bfloat16, 128, "flash_attention_fwd_wgmma", "tensor_cores"),
    (torch.float32, 64, "flash_attention_fwd", "cuda_cores"),
    (torch.bfloat16, 24, "flash_attention_fwd", "cuda_cores"),
    (torch.float16, 64, "flash_attention_fwd_wgmma_fp16", "tensor_cores"),
    (torch.float16, 24, "flash_attention_fwd", "cuda_cores"),
])
def test_forward_calls_its_routes_entry_point(fake_library, dtype, depth,
                                              entry, route):
    q, k, v, _, _, kb = _training_args(dtype, depth)
    before = dict(kattn.flash_attention_fwd.route_launches)
    out, lse = kattn._launch_fwd(q, k, v, kb, None, 5, 0.1,
                                 kattn.train_route(dtype, depth, FWD))
    assert out.shape == q.shape and out.dtype == dtype
    assert lse.shape == (2 * 3, q.shape[1]) and lse.dtype == torch.float32
    ((name, args),) = fake_library.calls
    assert name == entry
    # Both take (batch, seq, heads, head_dim) after the seven pointers and
    # end with 1 - rate and the stream; only the CUDA-core entry takes the
    # dtype code.
    assert args[7:11] == (2, q.shape[1], 3, depth)
    assert args[-2] == pytest.approx(0.9)
    after = kattn.flash_attention_fwd.route_launches
    assert after[route] == before[route] + 1
    assert sum(after.values()) == sum(before.values()) + 1


@pytest.mark.parametrize("dtype,depth,entry,route", [
    (torch.bfloat16, 64, "flash_attention_dkv_wgmma", "tensor_cores"),
    (torch.bfloat16, 32, "flash_attention_dkv_wgmma", "tensor_cores"),
    (torch.bfloat16, 128, "flash_attention_dkv", "cuda_cores"),
    (torch.float32, 64, "flash_attention_dkv", "cuda_cores"),
    (torch.float16, 32, "flash_attention_dkv_wgmma_fp16", "tensor_cores"),
    (torch.float16, 128, "flash_attention_dkv", "cuda_cores"),
])
def test_dkv_calls_its_routes_entry_point(fake_library, dtype, depth, entry,
                                          route):
    q, k, v, do, lse, kb = _training_args(dtype, depth)
    before = dict(kattn.flash_attention_dkv.route_launches)
    dk, dv, dbias = kattn._launch_dkv(q, k, v, do, lse, lse, kb, None, 5,
                                      0.1, kattn.train_route(dtype, depth,
                                                             DKV))
    assert dk.shape == dv.shape == q.shape and dbias.shape == lse.shape
    ((name, args),) = fake_library.calls
    assert name == entry
    assert args[11:15] == (2, q.shape[1], 3, depth)
    assert args[-2] == pytest.approx(1 / 0.9)
    after = kattn.flash_attention_dkv.route_launches
    assert after[route] == before[route] + 1
    assert sum(after.values()) == sum(before.values()) + 1


@pytest.mark.parametrize("dtype,depth,entry,route", [
    (torch.bfloat16, 64, "flash_attention_dq_wgmma", "tensor_cores"),
    (torch.bfloat16, 32, "flash_attention_dq_wgmma", "tensor_cores"),
    (torch.bfloat16, 128, "flash_attention_dq_wgmma", "tensor_cores"),
    (torch.float32, 64, "flash_attention_dq", "cuda_cores"),
    (torch.bfloat16, 24, "flash_attention_dq", "cuda_cores"),
    (torch.float16, 128, "flash_attention_dq_wgmma_fp16", "tensor_cores"),
    (torch.float16, 96, "flash_attention_dq", "cuda_cores"),
])
def test_dq_calls_its_routes_entry_point(fake_library, dtype, depth, entry,
                                         route):
    q, k, v, do, lse, kb = _training_args(dtype, depth)
    before = dict(kattn.flash_attention_dq.route_launches)
    dq, delta = kattn._launch_dq(q, k, v, v, do, lse, kb, None, 5, 0.1,
                                 kattn.train_route(dtype, depth, DQ))
    assert dq.shape == q.shape and dq.dtype == dtype
    assert delta.shape == lse.shape and delta.dtype == torch.float32
    ((name, args),) = fake_library.calls
    assert name == entry
    # Both take (batch, seq, heads, head_dim) after the ten pointers and
    # end with 1 / (1 - rate) and the stream; only the CUDA-core entry
    # takes the dtype code.
    assert args[10:14] == (2, q.shape[1], 3, depth)
    assert args[-2] == pytest.approx(1 / 0.9)
    if route == "tensor_cores":
        assert args[14] == pytest.approx(depth ** -0.5)
    else:
        assert args[14] == kattn._DTYPE_CODES[dtype]
    after = kattn.flash_attention_dq.route_launches
    assert after[route] == before[route] + 1
    assert sum(after.values()) == sum(before.values()) + 1


def _launch_on_tensor_cores(kernel, q, k, v, do, lse, kb):
    """One tensor-core launch of the training kernel ``kernel``."""
    if kernel == FWD:
        return kattn._launch_fwd(q, k, v, kb, None, 5, 0.1, "tensor_cores")
    if kernel == DQ:
        return kattn._launch_dq(q, k, v, v, do, lse, kb, None, 5, 0.1,
                                "tensor_cores")
    return kattn._launch_dkv(q, k, v, do, lse, lse, kb, None, 5, 0.1,
                             "tensor_cores")


@pytest.mark.parametrize("kernel", [FWD, DKV, DQ])
def test_failed_training_launch_raises_and_falls_back_to_nothing(
        fake_library, kernel):
    """A tensor-core launch of #1, #2 or #3 that returns a CUDA error
    raises; the CUDA-core entry point is never called and nothing is
    counted."""
    fake_library.rc = 1
    q, k, v, do, lse, kb = _training_args(torch.bfloat16, 64)
    wrapper = getattr(kattn, kernel)
    before = wrapper.launches, dict(wrapper.route_launches)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        _launch_on_tensor_cores(kernel, q, k, v, do, lse, kb)
    assert [name for name, _ in fake_library.calls] == [f"{kernel}_wgmma"]
    assert (wrapper.launches, dict(wrapper.route_launches)) == before


@pytest.mark.parametrize("kernel", [FWD, DKV, DQ])
def test_training_tensor_core_route_needs_16_byte_aligned_operands(
        fake_library, kernel):
    q, k, v, do, lse, kb = _training_args(torch.bfloat16, 64)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype)
    shifted = flat[1:].view(q.shape)  # 2 bytes past an aligned base
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _launch_on_tensor_cores(kernel, shifted, k, v, do, lse, kb)
    assert fake_library.calls == []


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_keep_mask_readers_see_the_philox_mask(dtype, rate):
    """The mask readers the card tests hold the routes to, on the plain
    versions: the forward's and dkv's masks read from their outputs equal
    philox_keep_mask bit for bit, ragged windows included (S = 100)."""
    from bert_pytorch_tpu_torch.testing import dropout_masks as dm

    want = dm.philox_mask(2, 100, 2, 77, rate)
    assert torch.equal(dm.forward_keep_mask(2, 100, 2, 77, rate, dtype),
                       want)
    assert torch.equal(dm.dkv_keep_mask(2, 100, 2, 77, rate, dtype), want)


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dq_keep_mask_reader_sees_the_philox_mask(dtype, rate):
    """dq's mask read from its output (route None: the wrapper, here the
    plain version) equals philox_keep_mask bit for bit at a ragged S."""
    from bert_pytorch_tpu_torch.testing import dropout_masks as dm

    assert torch.equal(dm.dq_keep_mask(2, 100, 2, 77, rate, dtype),
                       dm.philox_mask(2, 100, 2, 77, rate))
