"""The port's training attention (``flash_attention``: the forward, dq and
dkv kernels' plain versions behind one autograd Function) held against the
JAX package's Pallas ``flash_attention`` on the CPU, and its Philox
dropout mask checked on its own.

The JAX kernels run in interpret mode at rate 0, as the JAX package's own
tests run them (tests/test_ops.py): the TPU's dropout bits cannot be
reproduced. Tolerances are the JAX tests' bars: fp32 out 2e-5, fp32 grads
2e-4 (tests/test_ops.py:59, :75); bf16 out 3e-2, bf16 grads 5e-2
(tests/test_ops.py:88, :103). The grads are those of sum(tanh(out)) over
the rows that carry a sequence: a packed pad row's scores all sit near
-10000, where fp32 keeps about 1e-3, so its (meaningless) gradient rounds
differently in every formulation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert_pytorch_tpu.ops import attention as jax_att
from bert_pytorch_tpu.ops.pallas.attention import (
    flash_attention as jax_flash)
from bert_pytorch_tpu_torch.ops import attention, dropout
from bert_pytorch_tpu_torch.ops.kernels import attention as kattn

FP32_OUT, FP32_GRAD = 2e-5, 2e-4
BF16_OUT, BF16_GRAD = 3e-2, 5e-2


def _inputs(batch, seq, heads, depth, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((batch, seq, heads, depth))
               .astype(np.float32) for _ in range(3))
    mask = np.ones((batch, seq), np.int32)
    mask[:, seq - 5:] = 0
    mask[-1, seq // 3:] = 0
    sids = np.zeros((batch, seq), np.int32)
    sids[0, :seq // 4], sids[0, seq // 4:seq // 2] = 1, 2
    sids[0, seq // 2:] = 3
    sids[-1, :seq // 3] = 1  # then pad
    return q, k, v, mask, sids


def _row_weights(sids, shape):
    """1 on rows that carry a sequence (all rows when unpacked)."""
    if sids is None:
        return np.ones(shape[:2] + (1, 1), np.float32)
    return (np.asarray(sids) != 0).astype(np.float32)[:, :, None, None]


def _jax_out_and_grads(q, k, v, bias, sids, dtype=jnp.float32):
    """JAX flash attention (interpret mode) and the grads of
    sum(tanh(out)) over the non-pad rows w.r.t. q, k, v (and the key bias
    when padded)."""
    weights = jnp.asarray(_row_weights(sids, q.shape))

    def f(q, k, v, bias):
        out = jax_flash(q, k, v, bias=bias, sequence_ids=sids)
        return jnp.sum(jnp.tanh(out.astype(jnp.float32)) * weights), out

    args = [jnp.asarray(a, dtype) for a in (q, k, v)] + [bias]
    argnums = (0, 1, 2, 3) if bias is not None else (0, 1, 2)
    (_, out), grads = jax.value_and_grad(f, argnums=argnums, has_aux=True)(
        *args)
    return np.asarray(out, np.float32), [np.asarray(g, np.float32)
                                         for g in grads]


def _torch_out_and_grads(fn, q, k, v, bias, sids, dtype=torch.float32):
    q, k, v = (torch.from_numpy(a).to(dtype).requires_grad_()
               for a in (q, k, v))
    leaves = [q, k, v]
    if bias is not None:
        bias = torch.from_numpy(np.array(bias)).requires_grad_()
        leaves.append(bias)
    out = fn(q, k, v, bias=bias, sequence_ids=sids)
    weights = torch.from_numpy(_row_weights(sids, tuple(q.shape)))
    (torch.tanh(out.float()) * weights).sum().backward()
    return (out.detach().float().numpy(),
            [t.grad.float().numpy() for t in leaves])


@pytest.mark.parametrize("fn", [kattn.flash_attention,
                                kattn.flash_attention_reference],
                         ids=["function", "reference"])
@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_flash_attention_matches_jax_kernel_fp32(fn, packed):
    """Forward at 2e-5 and dq, dk, dv (and dbias, padded) at 2e-4 against
    the JAX Pallas kernels, through the autograd Function (the three
    kernels' plain versions) and through the differentiable reference."""
    q, k, v, mask, sids = _inputs(2, 32, 2, 16, seed=0)
    if packed:
        j_out, j_grads = _jax_out_and_grads(q, k, v, None, jnp.asarray(sids))
        t_out, t_grads = _torch_out_and_grads(fn, q, k, v, None,
                                              torch.from_numpy(sids))
    else:
        bias = np.asarray(jax_att.make_attention_bias(jnp.asarray(mask)))
        j_out, j_grads = _jax_out_and_grads(q, k, v, jnp.asarray(bias), None)
        t_out, t_grads = _torch_out_and_grads(fn, q, k, v, bias, None)
    assert np.isfinite(t_out).all()  # the all-pad row stays finite
    np.testing.assert_allclose(t_out, j_out, atol=FP32_OUT, rtol=0)
    assert len(t_grads) == len(j_grads)
    for ours, ref in zip(t_grads, j_grads):
        np.testing.assert_allclose(ours, ref, atol=FP32_GRAD, rtol=0)


def test_flash_attention_matches_jax_kernel_bf16():
    q, k, v, mask, _ = _inputs(1, 64, 2, 32, seed=1)
    bias = np.asarray(jax_att.make_attention_bias(jnp.asarray(mask)))
    j_out, j_grads = _jax_out_and_grads(q, k, v, jnp.asarray(bias), None,
                                        jnp.bfloat16)
    t_out, t_grads = _torch_out_and_grads(kattn.flash_attention, q, k, v,
                                          bias, None, torch.bfloat16)
    np.testing.assert_allclose(t_out, j_out, atol=BF16_OUT, rtol=0)
    for ours, ref in zip(t_grads[:3], j_grads[:3]):
        np.testing.assert_allclose(ours, ref, atol=BF16_GRAD, rtol=0)


def test_keep_rate_within_four_sigma():
    rate = 0.1
    idx = torch.arange(1024)
    keep = kattn.philox_keep_mask(1234, rate, idx[:4], idx[:512], idx[:512])
    n = keep.numel()
    assert n >= 10 ** 6
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(keep.float().mean().item() - (1 - rate)) < 4 * sigma


def test_keep_mask_depends_on_seed_and_coordinates_only():
    idx = torch.arange(64)
    whole = kattn.philox_keep_mask(7, 0.3, idx[:3], idx[:48], idx[:64])
    again = kattn.philox_keep_mask(7, 0.3, idx[:3], idx[:48], idx[:64])
    other = kattn.philox_keep_mask(8, 0.3, idx[:3], idx[:48], idx[:64])
    assert torch.equal(whole, again)
    assert not torch.equal(whole, other)
    # A block computed alone (rows 16..39, keys 21..57: not aligned to the
    # 4-key groups) is the same block of the whole.
    block = kattn.philox_keep_mask(7, 0.3, idx[1:3], idx[16:40], idx[21:58])
    assert torch.equal(block, whole[1:3, 16:40, 21:58])
    assert kattn.dropout_threshold(0.0) == 0
    assert kattn.philox_keep_mask(7, 0.0, idx[:1], idx[:4], idx[:8]).all()


def test_gradcheck_with_dropout_shares_the_mask():
    """Float64 gradcheck of the autograd Function at rate 0.1: its backward
    (the dq and dkv plain versions) regenerates the forward's mask."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 12, 2, 8, generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    mask = torch.ones(2, 12)
    mask[1, 8:] = 0
    bias = ((1 - mask) * -10000.0)[:, None, None, :].double()
    bias.requires_grad_()
    sids = torch.tensor([[1] * 4 + [2] * 5 + [0] * 3, [1] * 12])

    def padded(q, k, v, b):
        return kattn.flash_attention(q, k, v, bias=b, dropout_rate=0.1,
                                     seed=99)

    def packed(q, k, v):
        return kattn.flash_attention(q, k, v, sequence_ids=sids,
                                     dropout_rate=0.1, seed=5)

    assert torch.autograd.gradcheck(padded, (q, k, v, bias), eps=1e-6,
                                     atol=1e-5)
    assert torch.autograd.gradcheck(packed, (q, k, v), eps=1e-6, atol=1e-5)


def test_function_matches_reference_with_dropout():
    """With dropout on, the Function (plain kernels) and the autograd
    reference give the same output and grads: one mask, both passes."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 40, 3, 16, generator=g, requires_grad=True)
               for _ in range(3))
    outs, grads = [], []
    for fn in (kattn.flash_attention, kattn.flash_attention_reference):
        out = fn(q, k, v, dropout_rate=0.25, seed=2 ** 63 + 11)
        outs.append(out)
        grads.append(torch.autograd.grad(out.square().sum(), (q, k, v)))
    torch.testing.assert_close(outs[0], outs[1], atol=1e-6, rtol=0)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    # Dropout changes the output; the same seed reproduces it.
    no_drop = kattn.flash_attention(q, k, v)
    again = kattn.flash_attention(q, k, v, dropout_rate=0.25,
                                  seed=2 ** 63 + 11)
    assert not torch.allclose(no_drop, outs[0])
    assert torch.equal(again, outs[0])


def test_cpu_calls_count_no_launch():
    q, k, v = (torch.randn(1, 16, 2, 8, requires_grad=True)
               for _ in range(3))
    out = kattn.flash_attention(q, k, v, dropout_rate=0.1, seed=3)
    out.sum().backward()
    assert [f.launches for f in kattn.TRAINING_KERNELS] == [0, 0, 0]


def test_flash_attention_rejects_bad_inputs():
    x = torch.zeros(2, 8, 2, 8)
    with pytest.raises(ValueError, match="requires seed"):
        kattn.flash_attention(x, x, x, dropout_rate=0.1)
    with pytest.raises(ValueError, match="key bias"):
        kattn.flash_attention(x, x, x, bias=torch.zeros(2, 1, 8, 8))
    with pytest.raises(ValueError, match="not both"):
        kattn.flash_attention(x, x, x, bias=torch.zeros(2, 1, 1, 8),
                              sequence_ids=torch.ones(2, 8))
    with pytest.raises(ValueError, match="rate"):
        kattn.flash_attention(x, x, x, dropout_rate=1.0, seed=1)


def test_backend_routing_flash_and_auto():
    """``flash`` drops the caller's block-diagonal bias in a packed batch;
    ``auto`` is dense on the CPU at any length (the kernel is CUDA's)."""
    q, k, v, mask, sids = _inputs(2, 24, 2, 8, seed=4)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    t_sids = torch.from_numpy(sids)
    block = attention.make_attention_bias(torch.from_numpy(mask),
                                          sequence_ids=t_sids)
    flash = attention.dot_product_attention(*t, bias=block, backend="flash",
                                            sequence_ids=t_sids)
    dense = attention.dot_product_attention(*t, bias=block, backend="dense",
                                            sequence_ids=t_sids)
    torch.testing.assert_close(flash, dense, atol=1e-5, rtol=0)
    cpu = torch.device("cpu")
    assert attention.resolve_backend("auto", 512, cpu) == "dense"
    assert attention.resolve_backend("auto", 512,
                                     torch.device("cuda")) == "flash"
    assert attention.resolve_backend("auto", 128,
                                     torch.device("cuda")) == "dense"
    with pytest.raises(ValueError, match="dropout_seed"):
        attention.dot_product_attention(*t, dropout_rate=0.1,
                                        deterministic=False, backend="dense")


def test_dense_dropout_follows_its_seed():
    x = torch.ones(4, 64, 8)
    a = dropout.dropout(x, 0.2, 17)
    assert torch.equal(a, dropout.dropout(x, 0.2, 17))
    assert not torch.equal(a, dropout.dropout(x, 0.2, 18))
    kept = a != 0
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1.25))
    assert abs(kept.float().mean().item() - 0.8) < 0.05
    assert dropout.dropout(x, 0.0, 1) is x
