"""The PyTorch port's ops held against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both. Tolerances:
fp32 1e-6 for the elementwise ops and the dense attention path; 1e-5 for
the fused-attention kernel's plain version against the JAX Pallas kernel
in interpret mode (tiled online softmax vs one full softmax, fp32).
The CUDA kernel itself is held against its plain version on the card by
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert_pytorch_tpu.ops import activations as jax_act
from bert_pytorch_tpu.ops import attention as jax_att
from bert_pytorch_tpu.ops import layernorm as jax_ln
from bert_pytorch_tpu.ops.pallas.attention import (
    flash_attention_infer as jax_flash_infer)
from bert_pytorch_tpu_torch.ops import activations, attention, layernorm
from bert_pytorch_tpu_torch.ops.kernels import build
from bert_pytorch_tpu_torch.ops.kernels import attention as kattn

OP_ATOL = 1e-6
KERNEL_ATOL = 1e-5


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _padded_mask(batch, seq, seed):
    rng = np.random.default_rng(seed)
    mask = np.zeros((batch, seq), np.int32)
    for b, n in enumerate(rng.integers(1, seq + 1, batch)):
        mask[b, :n] = 1
    return mask


def _packed_ids(batch, seq):
    """Rows of 1-3 packed sequences followed by id-0 pad (row 1 ends in
    pad, row 2 is all pad)."""
    sids = np.zeros((batch, seq), np.int32)
    sids[0, :9], sids[0, 9:20], sids[0, 20:] = 1, 2, 3
    sids[1, :5], sids[1, 5:14] = 1, 2
    return sids


def test_gelu_matches_jax():
    x = np.random.default_rng(0).standard_normal((4, 37)).astype(np.float32) * 3
    ours = activations.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_act.gelu(jnp.asarray(x))),
                               atol=OP_ATOL, rtol=0)
    assert set(activations.ACT2FN) == set(jax_act.ACT2FN)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 48)) * 4 + 2).astype(np.float32)
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    ours = layernorm.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                                torch.from_numpy(bias), 1e-12).numpy()
    ref = jax_ln.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                            jnp.asarray(bias), 1e-12)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=OP_ATOL, rtol=0)


def test_layer_norm_keeps_input_dtype():
    x = torch.randn(2, 8, dtype=torch.bfloat16)
    out = layernorm.layer_norm(x, torch.ones(8), torch.zeros(8))
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_make_attention_bias_matches_jax(packed):
    mask = _padded_mask(3, 24, seed=2)
    sids = _packed_ids(3, 24) if packed else None
    ours = attention.make_attention_bias(
        torch.from_numpy(mask), torch.float32,
        None if sids is None else torch.from_numpy(sids))
    ref = jax_att.make_attention_bias(
        jnp.asarray(mask), jnp.float32,
        None if sids is None else jnp.asarray(sids))
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_dense_attention_matches_jax_xla(packed):
    q, k, v = _qkv(3, (3, 24, 4, 8))
    mask = _padded_mask(3, 24, seed=4)
    sids = _packed_ids(3, 24) if packed else None
    t_sids = None if sids is None else torch.from_numpy(sids)
    j_sids = None if sids is None else jnp.asarray(sids)
    ours = attention.dot_product_attention(
        *map(torch.from_numpy, (q, k, v)),
        bias=attention.make_attention_bias(torch.from_numpy(mask),
                                           sequence_ids=t_sids),
        backend="dense", sequence_ids=t_sids)
    ref = jax_att.dot_product_attention(
        *map(jnp.asarray, (q, k, v)),
        bias=jax_att.make_attention_bias(jnp.asarray(mask),
                                         sequence_ids=j_sids),
        backend="xla", sequence_ids=j_sids)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=OP_ATOL,
                               rtol=0)


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_flash_infer_plain_matches_jax_kernel(packed):
    """The wrapper on CPU tensors (its plain version) vs the JAX Pallas
    inference kernel in interpret mode, padded and packed, fp32."""
    B, S, H, D = 3, 32, 4, 8
    q, k, v = _qkv(5, (B, S, H, D))
    if packed:
        sids = _packed_ids(B, S)
        ours = kattn.flash_attention_infer(
            *map(torch.from_numpy, (q, k, v)),
            sequence_ids=torch.from_numpy(sids))
        ref = jax_flash_infer(*map(jnp.asarray, (q, k, v)),
                              sequence_ids=jnp.asarray(sids))
    else:
        mask = _padded_mask(B, S, seed=6)
        ours = kattn.flash_attention_infer(
            *map(torch.from_numpy, (q, k, v)),
            bias=attention.make_attention_bias(torch.from_numpy(mask)))
        ref = jax_flash_infer(
            *map(jnp.asarray, (q, k, v)),
            bias=jax_att.make_attention_bias(jnp.asarray(mask)))
    out = ours.numpy()
    assert np.isfinite(out).all()  # the all-pad row stays finite
    np.testing.assert_allclose(out, np.asarray(ref), atol=KERNEL_ATOL, rtol=0)


def test_flash_infer_cpu_call_counts_no_launch():
    q, k, v = (torch.from_numpy(t) for t in _qkv(7, (2, 16, 2, 8)))
    before = kattn.flash_attention_infer.launches
    kattn.flash_attention_infer(q, k, v)
    assert kattn.flash_attention_infer.launches == before == 0


def test_flash_infer_rejects_bias_with_sequence_ids():
    q, k, v = (torch.from_numpy(t) for t in _qkv(8, (2, 16, 2, 8)))
    sids = torch.ones(2, 16, dtype=torch.int32)
    bias = torch.zeros(2, 1, 1, 16)
    with pytest.raises(ValueError, match="not both"):
        kattn.flash_attention_infer(q, k, v, bias=bias, sequence_ids=sids)
    with pytest.raises(ValueError, match="not both"):
        kattn.flash_attention_infer_reference(q, k, v, bias=bias,
                                              sequence_ids=sids)


def test_flash_backend_rejects_training_dropout_and_unknown_backend():
    x = torch.zeros(1, 16, 2, 8)
    with pytest.raises(ValueError, match="forward-only"):
        attention.dot_product_attention(x, x, x, dropout_rate=0.1,
                                        deterministic=False,
                                        backend="flash_infer")
    with pytest.raises(ValueError, match="backend"):
        attention.dot_product_attention(x, x, x, backend="xla")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_library_path_tracks_the_source():
    path = build.library_path("flash_attention_infer")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libflash_attention_infer-")
    assert build.source_path("flash_attention_infer").is_file()
    assert build.library_path("flash_attention_infer") == path
    assert set(build.KERNEL_SOURCES) == {
        p.stem for p in build.CSRC_DIR.glob("*.cu")}
