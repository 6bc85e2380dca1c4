"""The port's ring attention (ops/ring.py) over real gloo ranks, held
against the JAX package's dense attention on the CPU.

Each rank of a ``seq`` group of 2 and of 4 holds an S/n slice of q, k,
v, the key bias and the output's cotangent (tests/_torch_layout_worker.py
``case_ring``); the output and the gradients of its slice are compared
with the JAX dense path (``ops.attention.dot_product_attention``,
``backend="xla"``) and its ``jax.vjp`` on the whole sequence at the JAX
ring test's bars (tests/test_ring.py:43-62): forward rtol 2e-5 / atol
2e-6, gradients rtol 5e-5 / atol 5e-6. With dropout the ring is held to
a dense attention that drops the normalised probabilities with the
masks the ring's blocks draw (the JAX semantics: numerator dropped,
denominator full), forward and backward, and the masks' keep rate to
its binomial bounds. The refusals: packed rows and a sequence the group
does not divide.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import layout_common as common
from bert_pytorch_tpu.ops.attention import dot_product_attention
from bert_pytorch_tpu_torch.ops.ring import block_seed, keep_scale

B, S, H, D = 2, 32, 4, 16
FWD_RTOL, FWD_ATOL = 2e-5, 2e-6
GRAD_RTOL, GRAD_ATOL = 5e-5, 5e-6
RATE, SEED = 0.1, 1234


def _inputs(root):
    rng = np.random.default_rng(0)
    data = {n: rng.standard_normal((B, S, H, D)).astype(np.float32)
            for n in ("q", "k", "v", "d_out")}
    mask = np.ones((B, S), np.float32)
    mask[1, 23:] = 0
    data["bias"] = ((1.0 - mask) * -10000.0).astype(np.float32)
    np.savez(root / "ring_inputs.npz", **data)
    return data


def _cases(root, world):
    base = dict(kind="ring", mesh=f"seq={world}",
                inputs=str(root / "ring_inputs.npz"))
    return [dict(base, name=f"ring{world}"),
            dict(base, name=f"ring{world}_dropout", rate=RATE, seed=SEED),
            dict(kind="refuse", name=f"refuse{world}", mesh=f"seq={world}")]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    root = tmp_path_factory.mktemp("ring")
    data = _inputs(root)
    return data, {world: common.Group(root / f"w{world}", world,
                                      _cases(root, world))
                  for world in (2, 4)}


@pytest.fixture(scope="module")
def jax_ref(groups):
    """The JAX dense attention's output and (dq, dk, dv) for d_out."""
    data, _ = groups
    bias = jnp.asarray(data["bias"])[:, None, None, :]

    def f(q, k, v):
        return dot_product_attention(q, k, v, bias=bias, backend="xla")

    out, vjp = jax.vjp(f, *(jnp.asarray(data[n]) for n in ("q", "k", "v")))
    grads = vjp(jnp.asarray(data["d_out"]))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _gathered(group, name, world):
    parts = [group.npz(name, r) for r in range(world)]
    return {k: np.concatenate([p[k] for p in parts], axis=1)
            for k in ("out", "dq", "dk", "dv")}


@pytest.mark.parametrize("world", [2, 4])
def test_ring_matches_jax_dense_attention(groups, jax_ref, world):
    _, group = groups
    got = _gathered(group[world], f"ring{world}", world)
    out, (dq, dk, dv) = jax_ref
    np.testing.assert_allclose(got["out"], out, rtol=FWD_RTOL, atol=FWD_ATOL)
    for key, want in (("dq", dq), ("dk", dk), ("dv", dv)):
        np.testing.assert_allclose(got[key], want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=key)


def _dropout_masks(world):
    """The whole [B, H, S, S] kept-and-rescaled mask the ring's blocks
    draw: query shard r's step t holds key block (r - t) mod n."""
    width = S // world
    full = torch.zeros((B, H, S, S))
    for r in range(world):
        for t in range(world):
            block = (r - t) % world
            full[:, :, r * width:(r + 1) * width,
                 block * width:(block + 1) * width] = keep_scale(
                (B, H, width, width), RATE, block_seed(SEED, r, t), "cpu")
    return full


@pytest.mark.parametrize("world", [2, 4])
def test_ring_dropout_drops_normalised_probabilities(groups, world):
    data, group = groups
    got = _gathered(group[world], f"ring{world}_dropout", world)
    masks = _dropout_masks(world)
    q, k, v = (torch.from_numpy(data[n]).requires_grad_(True)
               for n in ("q", "k", "v"))
    scores = torch.einsum("bqhd,bkhd->bhqk", q / np.sqrt(D), k)
    scores = scores + torch.from_numpy(data["bias"])[:, None, None, :]
    probs = torch.softmax(scores, dim=-1) * masks
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    (out * torch.from_numpy(data["d_out"])).sum().backward()
    np.testing.assert_allclose(got["out"], out.detach().numpy(),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    for key, t in (("dq", q), ("dk", k), ("dv", v)):
        np.testing.assert_allclose(got[key], t.grad.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=key)
    # The keep rate within 4 sigma of 1 - rate over the B*H*S*S draws.
    kept = float((masks > 0).float().mean())
    sigma = np.sqrt(RATE * (1 - RATE) / masks.numel())
    assert abs(kept - (1 - RATE)) < 4 * sigma
    assert torch.all(masks[masks > 0] == 1 / (1 - RATE))


@pytest.mark.parametrize("world", [2, 4])
def test_ring_refuses_packed_rows_and_an_undivided_sequence(groups, world):
    _, group = groups
    found = group[world].json(f"refuse{world}")
    assert any("packing" in m for m in found), found
    assert any("not divisible" in m for m in found), found
