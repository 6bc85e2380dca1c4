"""The port's hand-written CUDA kernels on the card, held against their
plain PyTorch versions. Every test here is ``cuda``-marked and skips where no
CUDA card exists (the kernel has no CPU mode). This file imports no JAX,
so it runs on a machine without it; run it there with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest pins JAX to the CPU and imports
it). Tolerances: the inference kernels fp32 2e-5 (summation order), bf16
2e-2 (P rounded to bf16 before PV at each tile's running maximum; the
int8-score kernel is fed the same int8 q/k as its plain version, so its
int32 scores are exact and the same bars apply); the
training kernels per output as (atol, rtol) in TRAIN_TOL, the bars of
chip_smoke.py (lse carries rtol for the packed pad rows near -10000).
"""

import json

import numpy as np
import pytest
import torch

from bert_pytorch_tpu_torch.ops.attention import make_attention_bias
from bert_pytorch_tpu_torch.ops.kernels import attention as kattn

pytestmark = pytest.mark.cuda
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _inputs(dtype, batch, seq, heads, depth, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (batch, seq, heads, depth)).astype(np.float32)).to("cuda", dtype)
        for _ in range(3))
    mask = np.zeros((batch, seq), np.int32)
    for b, n in enumerate(rng.integers(1, seq + 1, batch)):
        mask[b, :n] = 1
    sids = np.zeros((batch, seq), np.int32)
    sids[0, :seq // 3], sids[0, seq // 3:] = 1, 2
    sids[1, :seq // 2] = 1  # then pad; any further rows are all pad
    return q, k, v, torch.from_numpy(mask).cuda(), torch.from_numpy(sids).cuda()


@pytest.mark.parametrize("depth", [24, 32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version(dtype, depth):
    """Padded and packed rows at a ragged S (not a multiple of the 64-row
    tile), for head_dim 64 (the repo's configs) and other multiples of 8;
    each launch counted on the route ``infer_route`` names (bf16 at 32, 64
    and 128: the tensor cores)."""
    _need_card()
    q, k, v, mask, sids = _inputs(getattr(torch, dtype), 3, 100, 4, depth, 9)
    route = kattn.infer_route(q.dtype, depth)
    for kw in ({"bias": make_attention_bias(mask)}, {"sequence_ids": sids}):
        before = kattn.flash_attention_infer.launches
        routed = kattn.flash_attention_infer.route_launches[route]
        out = kattn.flash_attention_infer(q, k, v, **kw)
        torch.cuda.synchronize()
        assert kattn.flash_attention_infer.launches == before + 1
        assert kattn.flash_attention_infer.route_launches[route] == routed + 1
        ref = kattn.flash_attention_infer_reference(q, k, v, **kw)
        assert out.dtype == q.dtype and out.shape == q.shape
        assert torch.isfinite(out).all()
        assert (out.float() - ref.float()).abs().max().item() <= ATOL[dtype]


def _edge_inputs(depth, seed):
    """bf16 at S=200 (ragged: 3 key tiles and 8 keys), padded with row 0's
    every key masked, packed with row 2 all pad."""
    q, k, v, mask, sids = _inputs(torch.bfloat16, 3, 200, 4, depth, seed)
    mask[0] = 0
    return q, k, v, ({"bias": make_attention_bias(mask)},
                     {"sequence_ids": sids})


@pytest.mark.parametrize("depth", [64, 128])
def test_tensor_core_route_edges(depth):
    """Both serving kernels on their tensor-core route at a ragged S, with
    a fully masked padded row and an all-pad packed row: finite, within
    the bf16 bar of their plain versions, one tensor-core launch each."""
    _need_card()
    q, k, v, cases = _edge_inputs(depth, 4)
    q8, q_scale, k8, k_scale = kattn.quantize_qk(q, k)
    for kw in cases:
        key_bias, seg = kattn._infer_bias_seg(kw.get("bias"),
                                              kw.get("sequence_ids"), 3, 200)
        int8_args = (q8, k8, q_scale, k_scale, v, key_bias, seg)
        for wrapper, run, plain in (
                (kattn.flash_attention_infer,
                 lambda: kattn.flash_attention_infer(q, k, v, **kw),
                 lambda: kattn.flash_attention_infer_reference(q, k, v,
                                                               **kw)),
                (kattn.flash_attention_infer_int8,
                 lambda: kattn.flash_attention_infer_int8_prequantized(
                     *int8_args),
                 lambda: kattn._int8_forward_math(*int8_args))):
            routed = wrapper.route_launches["tensor_cores"]
            out = run()
            torch.cuda.synchronize()
            assert wrapper.route_launches["tensor_cores"] == routed + 1
            assert torch.isfinite(out).all()
            err = (out.float() - plain().float()).abs().max().item()
            assert err <= ATOL["bfloat16"], err


def test_tensor_core_and_cuda_core_routes_agree():
    """The same bf16 inputs through both routes of each serving kernel
    (the CUDA-core route reached directly): within the bf16 bar."""
    _need_card()
    q, k, v, cases = _edge_inputs(64, 6)
    q8, q_scale, k8, k_scale = kattn.quantize_qk(q, k)
    for kw in cases:
        key_bias, seg = kattn._infer_bias_seg(kw.get("bias"),
                                              kw.get("sequence_ids"), 3, 200)
        int8_args = (q8, k8, q_scale, k_scale, v, key_bias, seg)
        pairs = [[kattn._launch_infer(q, k, v, key_bias, seg, route)
                  for route in kattn.ROUTES],
                 [kattn._launch_int8(*int8_args, route)
                  for route in kattn.ROUTES]]
        torch.cuda.synchronize()
        for tensor_cores, cuda_cores in pairs:
            err = (tensor_cores.float() - cuda_cores.float()).abs().max()
            assert err.item() <= ATOL["bfloat16"], err.item()


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    _need_card()
    q, k, v, _, _ = _inputs(torch.float32, 2, 16, 2, 64, 1)
    with pytest.raises(TypeError, match="not supported"):
        kattn.flash_attention_infer(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        kattn.flash_attention_infer(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2))
    with pytest.raises(ValueError, match="head_dim"):
        kattn.flash_attention_infer(q[..., :12].contiguous(),
                                    k[..., :12].contiguous(),
                                    v[..., :12].contiguous())
    with pytest.raises(ValueError, match="dtype and device"):
        kattn.flash_attention_infer(q, k.cpu(), v)


def test_engine_flash_matches_dense_on_card(tmp_path):
    """A tiny fp32 engine on the card: the flash_infer and dense backends
    give the same fill_mask result from the same seeded weights."""
    _need_card()
    from bert_pytorch_tpu_torch import run_server
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
        write_trace_vocab)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(dict(
        vocab_size=40, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=1, intermediate_size=128,
        max_position_embeddings=64)))
    vocab = write_trace_vocab(str(tmp_path / "vocab.txt"))
    payload = {"text": "the capital of [MASK] is paris"}
    results = {}
    for backend in ("flash_infer", "dense"):
        engine = run_server.build_service(run_server.parse_arguments([
            "--model_config_file", str(cfg), "--vocab_file", vocab,
            "--dtype", "float32", "--attention_backend", backend,
            "--tasks", "fill_mask", "--buckets", "16,32"])).engine
        assert engine.device.type == "cuda"
        results[backend] = engine.run_direct("fill_mask", payload)
    flash, dense = (results[b]["masks"][0] for b in ("flash_infer", "dense"))
    assert [s["id"] for s in flash] == [s["id"] for s in dense]
    np.testing.assert_allclose([s["score"] for s in flash],
                               [s["score"] for s in dense], atol=1e-5)


TRAIN_TOL = {
    "float32": {"out": (2e-5, 1e-5), "lse": (2e-5, 1e-6), "dq": (1e-4, 1e-4),
                "delta": (1e-4, 1e-5), "dk": (1e-4, 1e-4),
                "dv": (1e-4, 1e-4), "dbias": (1e-4, 1e-4)},
    "bfloat16": {"out": (2e-2, 2e-2), "lse": (2e-5, 1e-6),
                 "dq": (2e-2, 2e-2), "delta": (2e-3, 1e-3),
                 "dk": (2e-2, 2e-2), "dv": (2e-2, 2e-2),
                 "dbias": (2e-3, 2e-2)},
}


def _close(got, ref, tol):
    atol, rtol = tol
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    assert ((got - ref).abs() <= atol + rtol * ref.abs()).all(), (
        (got - ref).abs().max().item())


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("depth", [24, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_kernels_match_plain_versions(dtype, depth, rate):
    """Forward, dq and dkv at a ragged S, padded and packed, with and
    without dropout; each kernel is fed the same inputs as its plain
    version and counts one launch."""
    _need_card()
    tol = TRAIN_TOL[dtype]
    q, k, v, mask, sids = _inputs(getattr(torch, dtype), 3, 100, 4, depth, 9)
    do = torch.randn_like(q.float()).to(q.dtype)
    for kb, seg in ((kattn._infer_bias_seg(make_attention_bias(mask), None,
                                           3, 100)[0], None),
                    (None, sids.to(torch.int32))):
        args = (kb, seg, 12345, rate)
        counts = [f.launches for f in kattn.TRAINING_KERNELS]
        out, lse = kattn.flash_attention_fwd(q, k, v, *args)
        ref_out, ref_lse = kattn._forward_math(q, k, v, *args)
        dq, delta = kattn.flash_attention_dq(q, k, v, ref_out, do, ref_lse,
                                             *args)
        ref_dq, ref_delta = kattn._dq_math(q, k, v, ref_out, do, ref_lse,
                                           *args)
        dk, dv, dbias = kattn.flash_attention_dkv(q, k, v, do, ref_lse,
                                                  ref_delta, *args)
        ref_dk, ref_dv, ref_db = kattn._dkv_math(q, k, v, do, ref_lse,
                                                 ref_delta, *args)
        torch.cuda.synchronize()
        assert [f.launches for f in kattn.TRAINING_KERNELS] == [
            c + 1 for c in counts]
        for name, got, ref in (("out", out, ref_out), ("lse", lse, ref_lse),
                               ("dq", dq, ref_dq), ("delta", delta, ref_delta),
                               ("dk", dk, ref_dk), ("dv", dv, ref_dv),
                               ("dbias", dbias, ref_db)):
            _close(got, ref, tol[name])


def test_flash_attention_autograd_on_card():
    """The autograd Function on CUDA tensors (three kernel launches) gives
    the differentiable reference's output and grads, with dropout."""
    _need_card()
    q, k, v, mask, _ = _inputs(torch.float32, 2, 130, 4, 64, 3)
    bias = make_attention_bias(mask).requires_grad_()
    leaves = [t.requires_grad_() for t in (q, k, v)] + [bias]
    results = []
    for fn in (kattn.flash_attention, kattn.flash_attention_reference):
        out = fn(q, k, v, bias=bias, dropout_rate=0.1, seed=77)
        results.append((out, torch.autograd.grad(out.square().sum(), leaves)))
    (out, grads), (ref, ref_grads) = results
    _close(out, ref, (2e-5, 1e-5))
    for got, want in zip(grads, ref_grads):
        _close(got, want, (2e-4, 1e-4))


TRAIN_WRAPPERS = (kattn.flash_attention_fwd, kattn.flash_attention_dq,
                  kattn.flash_attention_dkv)


def _train_routes(depth):
    """The routes ``train_route`` names for bf16 forward, dq and dkv."""
    return tuple(kattn.train_route(torch.bfloat16, depth, f.__name__)
                 for f in TRAIN_WRAPPERS)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("depth", [32, 64, 128])
def test_training_tensor_core_route_edges(depth, rate):
    """The forward (#1), dq (#2) and dkv (#3) kernels on the route
    ``train_route`` names for bf16 (the tensor cores at 32, 64 and 128
    for the forward and dq, at 32 and 64 for dkv) at a ragged S, with a
    fully masked padded row and an all-pad packed row: within TRAIN_TOL of
    their plain versions, one launch counted on that route each."""
    _need_card()
    tol = TRAIN_TOL["bfloat16"]
    q, k, v, cases = _edge_inputs(depth, 5)
    do = torch.randn_like(q.float()).to(q.dtype)
    routes = _train_routes(depth)
    assert routes == ("tensor_cores", "tensor_cores",
                      "cuda_cores" if depth == 128 else "tensor_cores")
    for kw in cases:
        kb, seg = kattn._infer_bias_seg(kw.get("bias"),
                                        kw.get("sequence_ids"), 3, 200)
        args = (kb, seg, 4242, rate)
        before = [f.route_launches[r] for f, r in zip(TRAIN_WRAPPERS, routes)]
        out, lse = kattn.flash_attention_fwd(q, k, v, *args)
        ref_out, ref_lse = kattn._forward_math(q, k, v, *args)
        dq, delta = kattn.flash_attention_dq(q, k, v, ref_out, do, ref_lse,
                                             *args)
        ref_dq, ref_delta = kattn._dq_math(q, k, v, ref_out, do, ref_lse,
                                           *args)
        dk, dv, dbias = kattn.flash_attention_dkv(q, k, v, do, ref_lse,
                                                  ref_delta, *args)
        ref_dk, ref_dv, ref_db = kattn._dkv_math(q, k, v, do, ref_lse,
                                                 ref_delta, *args)
        torch.cuda.synchronize()
        assert [f.route_launches[r] for f, r in zip(TRAIN_WRAPPERS, routes)
                ] == [c + 1 for c in before]
        for name, got, ref in (("out", out, ref_out), ("lse", lse, ref_lse),
                               ("dq", dq, ref_dq), ("delta", delta, ref_delta),
                               ("dk", dk, ref_dk), ("dv", dv, ref_dv),
                               ("dbias", dbias, ref_db)):
            _close(got, ref, tol[name])


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("seq", [200, 512])
def test_keep_masks_equal_between_routes(seq, rate):
    """The keep mask each route of the forward, dq and dkv drew, read from
    their outputs (testing/dropout_masks.py), equals the plain Philox twin
    bit for bit: any kernel and any tiling see the same mask."""
    _need_card()
    from bert_pytorch_tpu_torch.testing import dropout_masks as dm

    want = dm.philox_mask(2, seq, 3, 0xC0FFEE, rate, "cuda")
    for route in kattn.ROUTES:
        for read in (dm.forward_keep_mask, dm.dq_keep_mask,
                     dm.dkv_keep_mask):
            got = read(2, seq, 3, 0xC0FFEE, rate, device="cuda", route=route)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (route, read.__name__)


def test_flash_attention_autograd_on_tensor_cores():
    """bf16 autograd through the Function with #1, #2 and #3 on the tensor
    cores, dropout 0.1: out within the bf16 bar of
    flash_attention_reference, each gradient within 2e-2 of its largest
    magnitude (bf16 gradients, one ulp ~4e-3 relative, and dS rounded to
    bf16 before the kernels' products but not in autograd)."""
    _need_card()
    q, k, v, mask, _ = _inputs(torch.bfloat16, 2, 130, 4, 64, 3)
    assert _train_routes(64) == ("tensor_cores",) * 3
    bias = make_attention_bias(mask).requires_grad_()
    leaves = [t.requires_grad_() for t in (q, k, v)] + [bias]
    routed = [f.route_launches["tensor_cores"] for f in TRAIN_WRAPPERS]
    results = []
    for fn in (kattn.flash_attention, kattn.flash_attention_reference):
        out = fn(q, k, v, bias=bias, dropout_rate=0.1, seed=77)
        results.append((out, torch.autograd.grad(out.float().square().sum(),
                                                 leaves)))
    torch.cuda.synchronize()
    assert [f.route_launches["tensor_cores"] for f in TRAIN_WRAPPERS] == [
        c + 1 for c in routed]
    (out, grads), (ref, ref_grads) = results
    _close(out, ref, TRAIN_TOL["bfloat16"]["out"])
    for got, want in zip(grads, ref_grads):
        assert torch.isfinite(got).all()
        bar = 2e-2 * want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= bar


def test_training_wrappers_raise_on_what_the_kernels_do_not_take():
    _need_card()
    q, k, v, _, _ = _inputs(torch.float32, 2, 16, 2, 64, 1)
    with pytest.raises(TypeError, match="not supported"):
        kattn.flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        kattn.flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2))
    with pytest.raises(ValueError, match="must match"):
        kattn.flash_attention_dq(q, k, v, q, q.cpu(), q[:, :, 0, 0].clone())
    with pytest.raises(ValueError, match="seed"):
        kattn.flash_attention_fwd(q, k, v, seed=-1, rate=0.1)
    _, lse = kattn.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="lse must be"):
        kattn.flash_attention_dq(q, k, v, q, q, lse[:1])
    with pytest.raises(ValueError, match="bias must be"):
        kattn.flash_attention_fwd(q, k, v, torch.zeros(2, 16, device="cuda",
                                                       dtype=torch.float64))
    with pytest.raises(ValueError, match="sequence_ids must be"):
        kattn.flash_attention_fwd(q, k, v, None, torch.ones(
            2, 16, device="cuda", dtype=torch.int64))


# -- the int8-score serving kernel (TPU kernel #5) --------------------------

@pytest.mark.parametrize("kernel", ["infer", "infer_int8"])
def test_every_candidate_geometry_matches_plain_version(kernel):
    """Each candidate tile geometry of the tensor-core route
    (ops/kernels/autotune.py) at S=256, B*H=8, D=64, bf16, padded and
    packed, against the plain version; a geometry the route does not take
    raises on the card too, and the CUDA-core route takes the default
    only."""
    from bert_pytorch_tpu_torch.ops.kernels import autotune

    _need_card()
    q, k, v, mask, sids = _inputs(torch.bfloat16, 2, 256, 4, 64, 19)
    for kw in ({"bias": make_attention_bias(mask)}, {"sequence_ids": sids}):
        key_bias, seg = kattn._infer_bias_seg(
            kw.get("bias"), kw.get("sequence_ids"), 2, 256)
        q8, q_scale, k8, k_scale = kattn.quantize_qk(q, k)
        args8 = (q8, k8, q_scale, k_scale, v, key_bias, seg)
        if kernel == "infer":
            ref = kattn.flash_attention_infer_reference(q, k, v, **kw)
            call = lambda g: kattn.flash_attention_infer(q, k, v, geometry=g,
                                                         **kw)
        else:
            ref = kattn._int8_forward_math(*args8)
            call = lambda g: kattn.flash_attention_infer_int8_prequantized(
                *args8, geometry=g)
        grid = autotune.candidates(256, 8, 64, kernel)
        assert len(grid) == 16
        for geom in grid:
            out = call(geom)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            assert torch.isfinite(out).all() and err <= ATOL["bfloat16"], (
                geom, err)
        with pytest.raises(ValueError, match="not instantiated"):
            call((32, 32, 1))
    with pytest.raises(ValueError, match="tensor-core route"):
        kattn.flash_attention_infer(q.float(), k.float(), v.float(),
                                    geometry=(128, 64, 1))


def test_measured_winner_serves_the_engine_on_card(tmp_path):
    """autotune.measure on the card ranks every candidate by CUDA events,
    stamps the card, and a loaded winner is the geometry a later call
    without one launches (its output equals the forced call's bit for
    bit)."""
    from bert_pytorch_tpu_torch.ops.kernels import autotune

    _need_card()
    autotune.clear_winners()
    try:
        result = autotune.measure("infer", 256, 8, 64, heads=4)
        assert result["platform"] == \
            f"cuda:{torch.cuda.get_device_name(0)}"
        assert not result["interpret"] and result["failed"] == 0
        win = tuple(result["winner"][f] for f in ("block_q", "block_k",
                                                  "bh_block"))
        path = str(tmp_path / "w.json")
        autotune.save_winners(path)
        autotune.clear_winners()
        assert autotune.load_winners(path) == 1
        assert autotune.load_winners(path, "cpu") == 0
        q, k, v, mask, _ = _inputs(torch.bfloat16, 2, 256, 4, 64, 3)
        bias = make_attention_bias(mask)
        assert torch.equal(
            kattn.flash_attention_infer(q, k, v, bias=bias),
            kattn.flash_attention_infer(q, k, v, bias=bias, geometry=win))
    finally:
        autotune.clear_winners()


@pytest.mark.parametrize("depth", [32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_kernel_matches_plain_version(dtype, depth):
    """Padded and packed rows at a ragged S; kernel and plain version take
    the same int8 q/k and scales, so the int32 scores are exact on both
    sides and the fp kernel's tolerances apply. The wrapper (quantize +
    kernel) counts one launch per call, on the route ``infer_route``
    names for v."""
    _need_card()
    q, k, v, mask, sids = _inputs(getattr(torch, dtype), 3, 100, 4, depth, 5)
    q8, q_scale, k8, k_scale = kattn.quantize_qk(q, k)
    route = kattn.infer_route(v.dtype, depth)
    for kw in ({"bias": make_attention_bias(mask)}, {"sequence_ids": sids}):
        key_bias, seg = kattn._infer_bias_seg(kw.get("bias"),
                                              kw.get("sequence_ids"), 3, 100)
        args = (q8, k8, q_scale, k_scale, v, key_bias, seg)
        before = kattn.flash_attention_infer_int8.launches
        routed = kattn.flash_attention_infer_int8.route_launches[route]
        out = kattn.flash_attention_infer_int8_prequantized(*args)
        torch.cuda.synchronize()
        assert kattn.flash_attention_infer_int8.launches == before + 1
        assert (kattn.flash_attention_infer_int8.route_launches[route]
                == routed + 1)
        ref = kattn._int8_forward_math(*args)
        assert out.dtype == v.dtype and out.shape == v.shape
        assert torch.isfinite(out).all()
        assert (out.float() - ref.float()).abs().max().item() <= ATOL[dtype]
        wrapped = kattn.flash_attention_infer_int8(q, k, v, **kw)
        plain = kattn.flash_attention_infer_int8_reference(q, k, v, **kw)
        assert (wrapped.float() - plain.float()).abs().max().item() <= (
            ATOL[dtype])


def test_int8_wrapper_raises_on_what_the_kernel_does_not_take():
    _need_card()
    q, k, v, _, _ = _inputs(torch.float32, 2, 16, 2, 64, 1)
    q8, q_scale, k8, k_scale = kattn.quantize_qk(q, k)
    run = kattn.flash_attention_infer_int8_prequantized
    with pytest.raises(ValueError, match="q_scale must be"):
        run(q8, k8, q_scale.reshape(-1), k_scale, v)
    with pytest.raises(ValueError, match="k_scale must be"):
        run(q8, k8, q_scale, k_scale.double(), v)
    with pytest.raises(ValueError, match="contiguous"):
        run(q8.transpose(1, 2), k8.transpose(1, 2), q_scale, k_scale,
            v.transpose(1, 2))
    with pytest.raises(ValueError, match="q8 must be int8"):
        run(q8.float(), k8, q_scale, k_scale, v)
    with pytest.raises(ValueError, match="head_dim"):
        kattn.flash_attention_infer_int8(q[..., :12].contiguous(),
                                         k[..., :12].contiguous(),
                                         v[..., :12].contiguous())


def test_int8_matmul_pads_a_small_product_on_card():
    """torch._int_mm on the card needs more than 16 rows; an 8-row product
    (the pooler of an unpacked batch of 8) is padded with zero rows and
    gives the CPU product's values."""
    _need_card()
    from bert_pytorch_tpu_torch.ops import quant

    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    w8, w_scale = quant.quantize_array(
        rng.standard_normal((32, 64)).astype(np.float32))
    w8, w_scale = torch.from_numpy(w8), torch.from_numpy(w_scale)
    want = quant.int8_matmul(x, w8, w_scale)
    got = quant.int8_matmul(x.cuda(), w8.cuda(), w_scale.cuda())
    assert got.shape == (8, 32)
    torch.testing.assert_close(got.cpu(), want, atol=1e-6, rtol=1e-6)


def test_int8_fused_engine_on_card(tmp_path):
    """A tiny int8 engine on the card with the int8-score kernel and the
    fused gather: the fused result equals the unfused one, each forward
    launches the kernel once per layer, and it agrees with a dense-attention
    int8 engine from the same seeded weights to the int8 bound."""
    _need_card()
    from bert_pytorch_tpu_torch import run_server
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
        write_trace_vocab)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(dict(
        vocab_size=40, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=64)))
    vocab = write_trace_vocab(str(tmp_path / "vocab.txt"))
    payload = {"text": "the capital of [MASK] is [MASK]"}
    results = {}
    for backend in ("flash_infer_int8", "dense"):
        engine = run_server.build_service(run_server.parse_arguments([
            "--model_config_file", str(cfg), "--vocab_file", vocab,
            "--dtype", "float32", "--attention_backend", backend,
            "--tasks", "fill_mask", "--buckets", "16,32", "--quantize",
            "int8", "--fuse_epilogues"])).engine
        before, forwards = (kattn.flash_attention_infer_int8.launches,
                            engine.forwards)
        results[backend] = engine.run_direct("fill_mask", payload)
        if backend == "flash_infer_int8":
            assert (kattn.flash_attention_infer_int8.launches - before
                    == 2 * (engine.forwards - forwards))
            engine.fuse_epilogues = False
            unfused = engine.run_direct("fill_mask", payload)
            for a, b in zip(results[backend]["masks"], unfused["masks"]):
                assert [s["id"] for s in a] == [s["id"] for s in b]
                np.testing.assert_allclose([s["score"] for s in a],
                                           [s["score"] for s in b], atol=1e-5)
    for a, b in zip(results["flash_infer_int8"]["masks"],
                    results["dense"]["masks"]):
        np.testing.assert_allclose([s["score"] for s in a],
                                   [s["score"] for s in b], atol=1e-1)


# -- the LayerNorm forward kernel (TPU kernel #6) ---------------------------

def _ln_inputs(rows, hidden, dtype, seed):
    """x [rows, H] with an all-zero and a constant row (variance 0), fp32
    scale ~ 1 and bias ~ 0 on the card."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, hidden)).astype(np.float32) * 2.0 + 0.5
    x[0] = 0.0
    if rows > 1:
        x[1] = 0.5
    scale = 1.0 + 0.1 * rng.standard_normal(hidden).astype(np.float32)
    bias = 0.1 * rng.standard_normal(hidden).astype(np.float32)
    return (torch.from_numpy(x).to("cuda", dtype),
            torch.from_numpy(scale).cuda(), torch.from_numpy(bias).cuda())


@pytest.mark.parametrize("rows,hidden", [(1, 8), (5, 100), (33, 768),
                                         (64, 1024), (3, 4096), (17, 1000)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_kernel_matches_plain_version(dtype, rows, hidden):
    """Widths the 16-byte loads take (multiples of 8) and widths they do
    not (100, and 1000 in bf16), up to the 4096 limit: out within 1e-5
    (fp32; bf16: one bf16 ulp more, for a rounding step taken from fp32
    values up to 1e-5 apart), mean and rstd within 1e-5 relative, one
    launch counted per call."""
    _need_card()
    from bert_pytorch_tpu_torch.ops.kernels import layernorm as kln

    x, scale, bias = _ln_inputs(rows, hidden, getattr(torch, dtype), 3)
    before = kln.layer_norm_fwd.launches
    out, mean, rstd = kln.layer_norm_fwd(x, scale, bias, 1e-12)
    torch.cuda.synchronize()
    assert kln.layer_norm_fwd.launches == before + 1
    ref, ref_mean, ref_rstd = kln.layer_norm_fwd_reference(x, scale, bias,
                                                           1e-12)
    assert out.dtype == x.dtype and mean.shape == rstd.shape == (rows, 1)
    got, want = out.float(), ref.float()
    tol = torch.full_like(want, 1e-5)
    if dtype == "bfloat16":
        mag = want.abs().clamp(min=torch.finfo(torch.bfloat16).tiny)
        tol += torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert ((got - want).abs() <= tol).all()
    assert ((mean - ref_mean).abs() <= 1e-7 + 1e-5 * ref_mean.abs()).all()
    assert ((rstd - ref_rstd).abs() <= 1e-5 * ref_rstd).all()
    assert rstd[0].item() == pytest.approx(1e6, rel=1e-5)


def test_layer_norm_function_gradients_on_card():
    """The autograd Function on a CUDA tensor of rank 3 (forward kernel,
    plain backward) against autograd through the plain LayerNorm."""
    _need_card()
    from bert_pytorch_tpu_torch.ops.kernels.layernorm import layer_norm_kernel
    from bert_pytorch_tpu_torch.ops.layernorm import layer_norm

    x, scale, bias = _ln_inputs(48, 768, torch.float32, 5)
    x = x.view(4, 12, 768)
    g = torch.randn_like(x)
    leaves = [t.requires_grad_() for t in (x, scale, bias)]
    outs, grads = [], []
    for fn in (layer_norm_kernel, layer_norm):
        out = fn(x, scale, bias, 1e-12)
        outs.append(out)
        grads.append(torch.autograd.grad(out, leaves, g))
    assert outs[0].shape == x.shape
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=0)
    for got, want in zip(*grads):
        assert ((got - want).abs().max() <= 1e-5 * want.abs().max()).item()


def test_layer_norm_wrapper_raises_on_what_the_kernel_does_not_take():
    _need_card()
    from bert_pytorch_tpu_torch.ops.kernels import layernorm as kln

    x, scale, bias = _ln_inputs(8, 64, torch.float32, 1)
    with pytest.raises(ValueError, match="contiguous"):
        kln.layer_norm_fwd(x.t().contiguous().t(), scale, bias)
    with pytest.raises(TypeError, match="not supported"):
        kln.layer_norm_fwd(x.half(), scale, bias)
    with pytest.raises(ValueError, match="must be \\[rows, H\\]"):
        kln.layer_norm_fwd(x[None], scale, bias)
    with pytest.raises(ValueError, match="H <= 4096"):
        wide = torch.zeros(2, 4104, device="cuda")
        kln.layer_norm_fwd(wide, torch.ones(4104, device="cuda"),
                           torch.zeros(4104, device="cuda"))
    with pytest.raises(ValueError, match="scale must be"):
        kln.layer_norm_fwd(x, scale.to(torch.bfloat16), bias)
    with pytest.raises(ValueError, match="bias must be contiguous"):
        kln.layer_norm_fwd(x, scale, bias.cpu())


def test_squad_head_with_layer_norm_kernel_on_card():
    """A tiny fp32 QA model on the card: the LayerNorm kernel gives the
    plain LayerNorm's span logits from the same weights, launching once
    per LayerNorm (1 + 2 per layer)."""
    _need_card()
    from bert_pytorch_tpu_torch.config import BertConfig
    from bert_pytorch_tpu_torch.models import bert
    from bert_pytorch_tpu_torch.ops.kernels import layernorm as kln

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = BertConfig(vocab_size=64, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=128,
                     max_position_embeddings=64)
    models = [bert.init_weights(
        bert.BertForQuestionAnswering(cfg, device="cuda",
                                      layer_norm_backend=b), 0.02,
        torch.Generator(device="cuda").manual_seed(0))
        for b in ("kernel", "plain")]
    ids = torch.randint(0, 64, (3, 40), device="cuda")
    mask = torch.ones_like(ids)
    mask[1, 30:] = 0
    before = kln.layer_norm_fwd.launches
    with torch.no_grad():
        got, want = (m(ids, torch.zeros_like(ids), mask) for m in models)
    assert kln.layer_norm_fwd.launches == before + 5
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_heads_from_checkpoints_and_swap_on_card(tmp_path, monkeypatch):
    """A tiny engine's four heads written with the port's save_checkpoint
    and served from those files on the card: every weight equal, squad's
    stacked-span forward and ner answering as the in-memory engine does,
    and a hot-swap of classify that loads no kernel library."""
    _need_card()
    from bert_pytorch_tpu_torch import run_server
    from bert_pytorch_tpu_torch.models.convert import to_jax_params
    from bert_pytorch_tpu_torch.ops.kernels import build as kernel_build
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
        write_trace_vocab)
    from bert_pytorch_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(dict(
        vocab_size=48, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=1, intermediate_size=128,
        max_position_embeddings=64, next_sentence=True)))
    vocab = write_trace_vocab(str(tmp_path / "vocab.txt"))
    base = ["--model_config_file", str(cfg), "--vocab_file", vocab,
            "--dtype", "float32", "--buckets", "16,32"]
    memory = run_server.build_service(run_server.parse_arguments(
        base)).engine
    flags = []
    for task, spec in memory.tasks.items():
        save_checkpoint(str(tmp_path / task), 0, {"model": to_jax_params(
            spec.model.state_dict(), memory.config, task)})
        flags += [f"--{task}_checkpoint", str(tmp_path / task)]
    served = run_server.build_service(run_server.parse_arguments(
        base + flags + ["--fuse_epilogues"])).engine
    for task, spec in served.tasks.items():
        want = memory.tasks[task].model.state_dict()
        got = spec.model.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want), task
    payloads = {"squad": {"question": "who wrote hamlet",
                          "context": "william shakespeare wrote hamlet"},
                "ner": {"text": "paris is in france"}}
    for task, payload in payloads.items():
        assert (served.run_direct(task, payload)
                == memory.run_direct(task, payload))
    def refuse(*args, **kwargs):
        raise AssertionError("a hot-swap must build and load no kernel")

    # Every launch looks its library up through load(), so only the swap
    # itself runs with the build and load refused.
    with monkeypatch.context() as patch:
        patch.setattr(kernel_build, "build", refuse)
        patch.setattr(kernel_build, "load", refuse)
        info = served.swap_params("classify", str(
            tmp_path / "classify" / "ckpt_0.msgpack"), "v2")
    assert info["compiles"] == 0 and served.version() == "v2"
    assert (served.run_direct("classify", {"text": "paris is big"})
            == memory.run_direct("classify", {"text": "paris is big"}))


def _card_trainer(seed: int = 0):
    """A 2-layer BertForPreTraining on the card with LAMB and its train
    step, dropout off."""
    from bert_pytorch_tpu_torch import pretrain
    from bert_pytorch_tpu_torch.config import BertConfig
    from bert_pytorch_tpu_torch.models import bert
    from bert_pytorch_tpu_torch.optim import transforms

    cfg = BertConfig(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=128,
                     max_position_embeddings=64, next_sentence=True,
                     hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    model = bert.init_weights(bert.BertForPreTraining(cfg, device="cuda"),
                              0.02,
                              torch.Generator("cuda").manual_seed(seed))
    opt = transforms.Lamb(transforms.param_groups(model, 0.01), 1e-3)
    step = pretrain.make_train_step(model, opt, None, True, 6)
    rng = np.random.default_rng(seed)

    def batch():
        ids = rng.integers(5, 128, (8, 32))
        labels = np.where(rng.random((8, 32)) < 0.2, ids, -1)
        host = {"input_ids": ids, "segment_ids": np.zeros_like(ids),
                "input_mask": np.ones_like(ids), "masked_lm_labels": labels,
                "next_sentence_labels": rng.integers(0, 2, 8)}
        return pretrain.to_device(pretrain.stack_microbatches(host, 2),
                                  "cuda")

    return cfg, model, opt, step, batch


def test_async_save_snapshot_is_immune_to_later_steps_on_card(tmp_path):
    """An async save of the card's training state, then two more steps at
    once: the checkpoint holds the state at the save, bit for bit."""
    _need_card()
    from bert_pytorch_tpu_torch import run_pretraining
    from bert_pytorch_tpu_torch.models.convert import from_jax_params
    from bert_pytorch_tpu_torch.utils import checkpoint as ckpt

    cfg, model, opt, step, batch = _card_trainer()
    step(batch())
    at_save = {k: v.detach().cpu().clone()
               for k, v in model.state_dict().items()}
    ckpt.save_checkpoint(str(tmp_path), 1, run_pretraining
                         .checkpoint_contents(model, opt, cfg, None, 0),
                         async_write=True)
    step(batch())
    step(batch())
    ckpt.wait_for_pending_save()
    saved = ckpt.load_checkpoint(ckpt.checkpoint_path(str(tmp_path), 1))
    state = from_jax_params(saved["model"], cfg, "pretraining")
    assert int(saved["optimizer"]["count"]) == 1
    for key, value in at_save.items():
        assert torch.equal(state[key], value), key
    assert not all(torch.equal(v.cpu(), at_save[k])
                   for k, v in model.state_dict().items())


def test_resume_on_card_equals_the_saved_state(tmp_path):
    """A sync save of the card's state, restored into a fresh model and
    optimizer on the card: params, moments and count bit for bit, and the
    next step from each gives the same loss and parameters."""
    _need_card()
    from bert_pytorch_tpu_torch import run_pretraining
    from bert_pytorch_tpu_torch.utils import checkpoint as ckpt

    cfg, model, opt, step, batch = _card_trainer(seed=1)
    step(batch())
    step(batch())
    ckpt.save_checkpoint(str(tmp_path), 2, run_pretraining
                         .checkpoint_contents(model, opt, cfg, None, 0))
    _, fresh, fresh_opt, fresh_step, _ = _card_trainer(seed=2)
    step_no, extras = ckpt.load_latest_checkpoint(str(tmp_path), fresh,
                                                  fresh_opt)
    assert (step_no, extras["count"]) == (2, 2)
    named, fresh_named = (dict(model.named_parameters()),
                          dict(fresh.named_parameters()))
    for name, p in named.items():
        q = fresh_named[name]
        assert q.is_cuda and torch.equal(p, q), name
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][key], fresh_opt.state[q][key])
    b = batch()
    loss, fresh_loss = step(b)["loss"], fresh_step(b)["loss"]
    assert torch.equal(loss, fresh_loss)
    for name, p in named.items():
        assert torch.equal(p, fresh_named[name]), name


def test_step_timer_event_span_bounds_the_streams_work():
    """The timer's CUDA-event device sample is the stream's span over the
    step's work: at least the kernels' own time (a matmul chain timed
    alone by events) and at most the host's wall time from the first mark
    to the sync."""
    _need_card()
    from bert_pytorch_tpu_torch.telemetry.step_timer import (CudaEventClock,
                                                             StepTimer)

    x = torch.randn(4096, 4096, device="cuda")

    def work():
        y = x
        for _ in range(8):
            y = y @ x
        return y

    work()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    work()
    end.record()
    end.synchronize()
    alone_s = start.elapsed_time(end) / 1e3
    timer = StepTimer(window=1, sync_every=1,
                      device_clock=CudaEventClock("cuda"))
    timer.data_start()
    timer.data_end()
    work()
    timer.dispatch_end()
    timer.device_sync()
    record = timer.step_done(1)
    assert 0.9 * alone_s <= record["device_p50_s"] <= record["step_p50_s"]
    assert record["device_sum_s"] == record["device_p50_s"]


def test_memory_sampler_reads_the_allocator():
    _need_card()
    from bert_pytorch_tpu_torch.telemetry.memory import MemorySampler

    emitted = []
    sampler = MemorySampler(emitted.append, device="cuda")
    keep = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    sampler.sample(1)
    record = sampler.flush(1)
    assert record["memory_supported"] is True and emitted == [record]
    assert record["peak_bytes_in_use"] == torch.cuda.max_memory_allocated()
    assert record["bytes_in_use"] == torch.cuda.memory_allocated() >= (
        keep.numel())
    assert record["bytes_limit"] == torch.cuda.get_device_properties(
        0).total_memory
