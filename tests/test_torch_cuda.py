"""The port's hand-written CUDA kernel on the card, held against its plain
PyTorch version. Every test here is ``cuda``-marked and skips where no
CUDA card exists (the kernel has no CPU mode). This file imports no JAX,
so it runs on a machine without it; run it there with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest pins JAX to the CPU and imports
it). Tolerances: fp32 2e-5 (summation order), bf16 2e-2 (P rounded to
bf16 before PV at each tile's running maximum).
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


@pytest.mark.parametrize("depth", [24, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version(dtype, depth):
    """Padded and packed rows at a ragged S (not a multiple of the 64-row
    tile), for head_dim 64 (the repo's configs) and two other multiples
    of 8."""
    _need_card()
    q, k, v, mask, sids = _inputs(getattr(torch, dtype), 3, 100, 4, depth, 9)
    for kw in ({"bias": make_attention_bias(mask)}, {"sequence_ids": sids}):
        before = kattn.flash_attention_infer.launches
        out = kattn.flash_attention_infer(q, k, v, **kw)
        torch.cuda.synchronize()
        assert kattn.flash_attention_infer.launches == before + 1
        ref = kattn.flash_attention_infer_reference(q, k, v, **kw)
        assert out.dtype == q.dtype and out.shape == q.shape
        assert torch.isfinite(out).all()
        assert (out.float() - ref.float()).abs().max().item() <= ATOL[dtype]


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
