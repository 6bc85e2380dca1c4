"""The port's fp16 mixed-precision training held against the JAX package's
fp16 mode on the CPU: the ``DynamicLossScale`` wrapper against the JAX
``dynamic_loss_scale``, the fp16 plain versions of kernels #1-#3 and #6
against the Pallas kernels in interpret mode, one fp16 pretraining step
and one overflow-skipped step against the JAX step, fp16 checkpoints both
ways (the phase hand-off keeping the scale), and the runners' fp16 flags.

Inputs are numpy arrays from a seed. Tolerances:

* the wrapper: 1e-6 in params and moments, the scale, growth count and
  inner count exact (the same fp32 update math);
* attention and LayerNorm in fp16: each element within FP16_ULPS fp16
  ulps of its own magnitude plus one ulp of the tensor's largest
  magnitude (the same math rounding to fp16 at the same places; the sums
  before each rounding run in another order, so a value may land one
  rounding step away, and an element near 0 keeps the absolute error of
  the large terms that cancelled in it);
* the fp16 pretraining step: loss and true grad_norm relative STEP16_RTOL,
  params after the LAMB step STEP16_PARAM_ATOL: fp16 activations round at
  other places in XLA's CPU code than in PyTorch's (inside each GEMM's
  sum, the GELU, the residual adds), which moves single gradient elements
  by fp16 ulps and the loss and global norm by up to ~3e-5 relative on
  these seeds (STEP16_RTOL is 4x that); a LAMB step moves each weight by
  at most lr x trust ratio (<= 1 here) per unit of m/sqrt(v), which on
  the first step is sign(g), so a gradient within that noise of 0 can
  flip its sign: the parameter tolerance is twice that largest move;
* the loss scale, the skip and the counts exact; a skipped step's
  params and moments bit-equal to before it; checkpoints bit for bit.
"""

import functools
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bert_pytorch_tpu import models as jax_models
from bert_pytorch_tpu import optim as jax_optim
from bert_pytorch_tpu import pretrain as jax_pretrain
from bert_pytorch_tpu.config import BertConfig as JaxConfig
from bert_pytorch_tpu.ops import attention as jax_att
from bert_pytorch_tpu.ops.pallas import layernorm as jax_ln
from bert_pytorch_tpu.ops.pallas.attention import (
    flash_attention as jax_flash)
from bert_pytorch_tpu.utils import checkpoint as jax_ckpt
from bert_pytorch_tpu_torch import pretrain, run_pretraining, run_squad
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.models import bert
from bert_pytorch_tpu_torch.models.convert import (from_jax_params,
                                                   optimizer_from_jax,
                                                   optimizer_to_jax)
from bert_pytorch_tpu_torch.ops.kernels import attention as kattn
from bert_pytorch_tpu_torch.ops.kernels import layernorm as kln
from bert_pytorch_tpu_torch.optim import transforms
from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
    SyntheticPretrainingDataset, write_squad_json, write_trace_vocab)
from bert_pytorch_tpu_torch.utils import checkpoint as ckpt

WRAPPER_ATOL = 1e-6
FP16_ULPS = 2
STEP16_RTOL = 1e-4
LR = 1e-3
STEP16_PARAM_ATOL = 2 * LR
CONFIG = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=64,
              max_position_embeddings=32, type_vocab_size=2,
              next_sentence=True, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
S, P = 32, 6


def _fp16_ulp(x: np.ndarray) -> np.ndarray:
    """One fp16 ulp at each |x| (the smallest normal's below it)."""
    mag = np.maximum(np.abs(x.astype(np.float32)), 2.0 ** -14)
    return np.exp2(np.floor(np.log2(mag)) - 10)


def _assert_fp16_close(got, want, err_msg=""):
    got, want = (np.asarray(a, np.float32) for a in (got, want))
    tol = FP16_ULPS * _fp16_ulp(want) + _fp16_ulp(np.abs(want).max())
    bad = np.abs(got - want) > tol
    assert not bad.any(), (f"{err_msg}: {int(bad.sum())} elements beyond "
                           f"{FP16_ULPS} fp16 ulps (+1 ulp of the max), "
                           f"max |d| {np.abs(got - want).max():.3e}")


# -- the loss-scale wrapper -------------------------------------------------

def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32) * scale,
            "b": {"bias": rng.standard_normal(5).astype(np.float32) * scale}}


def _torch_params(tree):
    return {"a": torch.nn.Parameter(torch.from_numpy(tree["a"].copy())),
            "b.bias": torch.nn.Parameter(
                torch.from_numpy(tree["b"]["bias"].copy()))}


def _optimizers(name, params):
    groups = [{"params": [params["a"]], "stacks": ["a"],
               "weight_decay": 0.01},
              {"params": [params["b.bias"]], "stacks": ["b.bias"],
               "weight_decay": 0.0}]
    mask = {"a": True, "b": {"bias": False}}
    if name == "lamb":
        return (jax_optim.lamb(1e-2, weight_decay_mask=mask),
                transforms.Lamb(groups, 1e-2))
    if name == "adamw":
        return (jax_optim.adamw(1e-2, weight_decay_mask=mask),
                transforms.AdamW(groups, 1e-2))
    return (jax_optim.bert_adam(1e-2, max_grad_norm=0.5,
                                weight_decay_mask=mask),
            transforms.BertAdam(groups, 1e-2, max_grad_norm=0.5))


@pytest.mark.parametrize("name", ["lamb", "adamw", "bert_adam"])
def test_loss_scale_wrapper_matches_jax(name):
    """Six steps with growth_interval 2 from scale 2**10; step 3's
    gradients carry an inf: that step is skipped (scale halved, growth
    count 0, inner count, moments and params unchanged) on both sides,
    and every state after every step agrees (params and moments 1e-6,
    scale and counts exact)."""
    params_np = _tree(0)
    params = _torch_params(params_np)
    j_tx, inner = _optimizers(name, params)
    j_tx = jax_optim.dynamic_loss_scale(j_tx, init_scale=2.0 ** 10,
                                        growth_interval=2)
    opt = transforms.DynamicLossScale(inner, init_scale=2.0 ** 10,
                                      growth_interval=2)
    j_params = jax.tree_util.tree_map(jnp.asarray, params_np)
    j_state = j_tx.init(j_params)
    for i in range(6):
        grads = _tree(10 + i, scale=float(opt.scale))
        assert float(j_state.scale) == opt.scale
        if i == 3:
            grads["b"]["bias"][1] = np.inf
        before = {k: p.detach().clone() for k, p in params.items()}
        moments = {k: {m: v.clone() for m, v in opt.state[p].items()}
                   for k, p in params.items()}
        updates, j_state = j_tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        params["a"].grad = torch.from_numpy(grads["a"].copy())
        params["b.bias"].grad = torch.from_numpy(grads["b"]["bias"].copy())
        stepped = opt.step()
        assert stepped == (i != 3)
        assert (opt.scale, opt.growth_count,
                transforms.opt_step_count(opt)) == (
            float(j_state.scale), int(j_state.growth_count),
            int(j_state.inner.count)), i
        if i == 3:
            for k, p in params.items():
                assert torch.equal(p.detach(), before[k])
                for m, v in opt.state[p].items():
                    assert torch.equal(v, moments[k][m])
        for key, got in (("a", params["a"]), ("b.bias", params["b.bias"])):
            want = (j_params["a"] if key == "a" else j_params["b"]["bias"])
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), atol=WRAPPER_ATOL,
                                       rtol=0, err_msg=f"{key} step {i}")
        j_mu = j_state.inner.mu
        np.testing.assert_allclose(opt.state[params["a"]]["exp_avg"].numpy(),
                                   np.asarray(j_mu["a"]), atol=WRAPPER_ATOL,
                                   rtol=0)
    # 2**10, doubled after steps 1 and 5 (its growth count reset by the
    # skip at step 3), halved at step 3.
    assert opt.scale == 2.0 ** 11


def test_loss_scale_wrapper_sees_through_to_the_inner_state():
    """reset_count and opt_step_count act on the inner optimizer and keep
    the scale; moments and load_moments read and write the inner state;
    the wrapper state round-trips the JAX LossScaleState layout."""
    params = _torch_params(_tree(1))
    _, inner = _optimizers("lamb", params)
    opt = transforms.DynamicLossScale(inner, init_scale=4096.0)
    for p in params.values():
        p.grad = torch.ones_like(p) * opt.scale
    opt.step()
    transforms.reset_count(opt, 17)
    assert transforms.opt_step_count(opt) == 17 == inner.param_groups[0][
        "count"]
    assert (opt.scale, opt.growth_count) == (4096.0, 1)
    mu, _ = transforms.moments(opt, params)
    assert mu["a"] is inner.state[params["a"]]["exp_avg"]


# -- the kernels' plain versions in fp16 -------------------------------------

def _attention_inputs(seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((2, 64, 2, 32)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((2, 64), np.int32)
    mask[:, 59:] = 0
    mask[1, 21:] = 0
    sids = np.zeros((2, 64), np.int32)
    sids[0, :16], sids[0, 16:32], sids[0, 32:] = 1, 2, 3
    sids[1, :21] = 1
    return q, k, v, mask, sids


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_attention_plain_versions_match_jax_kernel_fp16(packed):
    """The forward (#1), dq (#2) and dkv (#3) plain versions behind
    ``flash_attention`` in fp16, rate 0, against the JAX Pallas
    ``flash_attention`` in interpret mode in fp16: the output and the
    gradients of sum(tanh(out)) over the rows that carry a sequence, each
    within FP16_ULPS fp16 ulps."""
    q, k, v, mask, sids = _attention_inputs(3)
    weights = ((sids != 0) if packed else np.ones((2, 64), bool)).astype(
        np.float32)[:, :, None, None]
    bias = None if packed else np.asarray(
        jax_att.make_attention_bias(jnp.asarray(mask)))

    def j_loss(q, k, v):
        out = jax_flash(q, k, v, bias=None if bias is None else
                        jnp.asarray(bias),
                        sequence_ids=jnp.asarray(sids) if packed else None)
        return jnp.sum(jnp.tanh(out.astype(jnp.float32)) * weights), out

    (_, j_out), j_grads = jax.value_and_grad(j_loss, (0, 1, 2),
                                             has_aux=True)(
        *(jnp.asarray(a, jnp.float16) for a in (q, k, v)))
    assert j_out.dtype == jnp.float16
    leaves = [torch.from_numpy(a).half().requires_grad_() for a in (q, k, v)]
    out = kattn.flash_attention(
        *leaves, bias=None if packed else torch.from_numpy(bias),
        sequence_ids=torch.from_numpy(sids) if packed else None)
    assert out.dtype == torch.float16
    (torch.tanh(out.float()) * torch.from_numpy(weights)).sum().backward()
    _assert_fp16_close(out.detach().numpy(), j_out, "out")
    for name, t, ref in zip("qkv", leaves, j_grads):
        assert t.grad.dtype == torch.float16
        _assert_fp16_close(t.grad.numpy(), ref, f"d{name}")


def test_attention_plain_versions_round_an_overflow_to_inf():
    """Under a large output gradient, dS and the dV product overflow fp16:
    the plain versions give inf where the JAX kernel does (its astype
    rounds to nearest; nothing saturates at 65504)."""
    q, k, v, _, _ = _attention_inputs(4)
    rng = np.random.default_rng(5)
    do = (rng.standard_normal(q.shape) * 3e4).astype(np.float16)
    j_args = [jnp.asarray(a, jnp.float16) for a in (q, k, v)]
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v), *j_args)
    j_grads = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).half().requires_grad_() for a in (q, k, v)]
    kattn.flash_attention(*leaves).backward(torch.from_numpy(do))
    for t, ref in zip(leaves, j_grads):
        ref = np.asarray(ref, np.float32)
        assert (~np.isfinite(ref)).any()
        np.testing.assert_array_equal(np.isinf(t.grad.float().numpy()),
                                      np.isinf(ref))


def test_layer_norm_plain_version_matches_jax_kernel_fp16():
    """#6's plain version in fp16 against the Pallas ``_ln_forward`` in
    interpret mode: out within FP16_ULPS fp16 ulps, fp32 mean and rstd
    within 1e-6 relative (the same fp32 statistics), zero-variance rows
    included."""
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((37, 96)) * 2.0 + 0.5).astype(np.float32)
    x[0], x[1] = 0.0, 0.5
    scale = (1.0 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(96)).astype(np.float32)
    j_out, j_mean, j_rstd = jax_ln._ln_forward(
        jnp.asarray(x, jnp.float16), jnp.asarray(scale), jnp.asarray(bias),
        1e-12)
    out, mean, rstd = kln.layer_norm_fwd_reference(
        torch.from_numpy(x).half(), torch.from_numpy(scale),
        torch.from_numpy(bias), 1e-12)
    assert out.dtype == torch.float16 and j_out.dtype == jnp.float16
    _assert_fp16_close(out.numpy(), j_out, "out")
    np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(j_rstd), rtol=1e-6)


# -- one fp16 pretraining step and the overflow skip --------------------------

def _host_batch(seed):
    rng = np.random.default_rng(seed)
    rows = 4
    ids = rng.integers(5, CONFIG["vocab_size"], (rows, S)).astype(np.int32)
    seg = np.zeros((rows, S), np.int32)
    seg[:, S // 2:] = 1
    mask = np.ones((rows, S), np.int32)
    mask[1, 20:] = 0
    labels = np.where(rng.random((rows, S)) < 0.2, ids, -1).astype(np.int32)
    labels[mask == 0] = -1
    return jax_pretrain.stack_microbatches(
        {"input_ids": ids, "segment_ids": seg, "input_mask": mask,
         "masked_lm_labels": labels,
         "next_sentence_labels": rng.integers(0, 2, rows).astype(np.int32)},
        2)


@functools.lru_cache(maxsize=None)
def _jax_fp16_step():
    """(model, tx, jitted step) of the JAX fp16 pretraining path: LAMB at
    LR wrapped in dynamic_loss_scale (built once: the scale is state)."""
    model = jax_models.BertForPreTraining(JaxConfig(**CONFIG),
                                          dtype=jnp.float16)
    tx = jax_optim.dynamic_loss_scale(
        jax_optim.lamb(LR, weight_decay_mask=jax_optim.no_decay_mask))
    step = jax_pretrain.make_train_step(model, tx, next_sentence=True,
                                        max_pred_per_seq=P, loss_scale=True)
    return model, tx, step


def _jax_fp16(init_scale=2.0 ** 12, seed=1):
    """(step, TrainState at loss scale ``init_scale``) of the JAX fp16
    pretraining path from seeded weights."""
    model, tx, step = _jax_fp16_step()
    ids = jnp.zeros((1, S), jnp.int32)
    params = nn.unbox(model.init(jax.random.PRNGKey(seed), ids, ids, ids))[
        "params"]
    opt_state = tx.init(params)._replace(
        scale=jnp.asarray(init_scale, jnp.float32))
    return step, jax_pretrain.TrainState(
        params=params, opt_state=opt_state, rng=jax.random.PRNGKey(2))


def _port_fp16(params, init_scale=2.0 ** 12):
    """(model, DynamicLossScale(LAMB at LR), fp16 train step) of the port
    on the JAX params."""
    cfg = BertConfig(**CONFIG)
    model = bert.BertForPreTraining(cfg, dtype=torch.float16)
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), cfg, "pretraining"))
    opt = transforms.DynamicLossScale(
        transforms.Lamb(transforms.param_groups(model, 0.01), LR),
        init_scale=init_scale)
    step = pretrain.make_train_step(model, opt, None, True, P,
                                    loss_scale=True, stats_every=1)
    return model, opt, step


def _assert_params_close(model, jax_params, atol):
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, jax_params),
                          BertConfig(**CONFIG), "pretraining")
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.detach().numpy(), ref[name].numpy(),
                                   atol=atol, rtol=0, err_msg=name)


def test_fp16_step_and_overflow_skip_match_jax():
    """One fp16 LAMB step from the same weights and batch: loss, the true
    grad_norm (STEP16_RTOL), loss_scale (exact) and params
    (STEP16_PARAM_ATOL) against the JAX fp16 step; the grad-health block
    reports unscaled grad norms. Then from a scale of 2**40 the backward
    overflows fp16 on both sides: the step is skipped (params and moments
    bit-equal, inner count 0, finite 0), the scale halves, and the growth
    count is 0."""
    j_step, state = _jax_fp16()
    model, opt, step = _port_fp16(state.params)
    batch = _host_batch(0)
    state, j_metrics = j_step(state, batch)
    metrics = step(pretrain.to_device(batch, "cpu"))
    assert float(metrics["loss_scale"]) == float(j_metrics["loss_scale"]) \
        == 2.0 ** 12
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(j_metrics[key]), rtol=STEP16_RTOL,
                                   err_msg=key)
    assert float(metrics["finite"]) == 1.0
    health = metrics["grad_health"]
    np.testing.assert_allclose(float(health["grad_norm"]),
                               float(metrics["grad_norm"]), rtol=1e-5)
    assert transforms.opt_step_count(opt) == int(
        state.opt_state.inner.count) == 1
    _assert_params_close(model, state.params, STEP16_PARAM_ATOL)

    j_step, state = _jax_fp16(init_scale=2.0 ** 40, seed=3)
    model, opt, step = _port_fp16(state.params, init_scale=2.0 ** 40)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, j_metrics = j_step(state, batch)
    metrics = step(pretrain.to_device(batch, "cpu"))
    assert float(j_metrics["finite"]) == float(metrics["finite"]) == 0.0
    assert (opt.scale, opt.growth_count, transforms.opt_step_count(opt)) == (
        float(state.opt_state.scale), int(state.opt_state.growth_count),
        int(state.opt_state.inner.count)) == (2.0 ** 39, 0, 0)
    mu, nu = transforms.moments(opt, dict(model.named_parameters()))
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), before[name]), name
        assert not mu[name].any() and not nu[name].any(), name
    _assert_params_close(model, state.params, 0.0)


def test_kfac_with_fp16_is_refused():
    """K-FAC composes with first-order optimizers only, as in the JAX
    make_train_step and runner."""
    _, state = _jax_fp16()
    model, opt, _ = _port_fp16(state.params)
    with pytest.raises(ValueError, match="first-order optimizers only"):
        pretrain.make_train_step(model, opt, lambda c: LR, True, P,
                                 kfac=object(), loss_scale=True)
    with pytest.raises(ValueError, match="DynamicLossScale"):
        pretrain.make_train_step(model, opt.inner, None, True, P,
                                 loss_scale=True)


# -- checkpoints -----------------------------------------------------------

def _port_scaled_opt(model, init_scale=2.0 ** 16):
    return transforms.DynamicLossScale(
        transforms.Lamb(transforms.param_groups(model, 0.01), LR),
        init_scale=init_scale)


def test_jax_fp16_checkpoint_resumes_in_the_port_and_steps_as_jax(tmp_path):
    """A JAX fp16 TrainState after one step, saved by the JAX
    save_checkpoint: the port restores params, moments, count, scale and
    growth count bit for bit into a DynamicLossScale, and its next fp16
    step matches JAX's own next step (the fp16 step tolerances)."""
    j_step, state = _jax_fp16(seed=5)
    state, _ = j_step(state, _host_batch(1))
    jax_ckpt.save_checkpoint(str(tmp_path), 1, {
        "model": state.params, "optimizer": state.opt_state, "epoch": 0})
    model, opt, step = _port_fp16(_jax_fp16(seed=6)[1].params,
                                  init_scale=1.0)
    step_no, extras = ckpt.load_latest_checkpoint(str(tmp_path), model, opt)
    assert (step_no, extras["count"], extras["loss_scale"]) == (
        1, 1, 2.0 ** 12)
    assert (opt.scale, opt.growth_count) == (2.0 ** 12, 1)
    _assert_params_close(model, state.params, 0.0)
    mu = from_jax_params(jax.tree_util.tree_map(
        np.asarray, state.opt_state.inner.mu), BertConfig(**CONFIG),
        "pretraining")
    for name, p in model.named_parameters():
        assert torch.equal(opt.state[p]["exp_avg"], mu[name]), name
    state, j_metrics = j_step(state, _host_batch(2))
    metrics = step(pretrain.to_device(_host_batch(2), "cpu"))
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(j_metrics["loss"]), rtol=STEP16_RTOL)
    assert float(metrics["loss_scale"]) == float(j_metrics["loss_scale"])
    _assert_params_close(model, state.params, STEP16_PARAM_ATOL)


def test_port_fp16_checkpoint_restores_in_jax(tmp_path):
    """A port fp16 run's checkpoint (one step, the scale moved by hand to
    2**13 with growth count 7) restores onto the JAX abstract TrainState
    of a loss-scaled LAMB: the LossScaleState's scale, growth count and
    inner count and moments bit for bit; the optimizer tree round-trips
    through optimizer_to_jax / optimizer_from_jax."""
    j_step, state = _jax_fp16(seed=7)
    model, opt, step = _port_fp16(state.params)
    step(pretrain.to_device(_host_batch(3), "cpu"))
    opt.load_scale_state(2.0 ** 13, 7)
    cfg = BertConfig(**CONFIG)
    path = ckpt.save_checkpoint(str(tmp_path), 1, run_pretraining
                                .checkpoint_contents(model, opt, cfg, {
                                    "epoch": 0, "seed": 0,
                                    "num_replicas": 1, "total_size": 8,
                                    "index": 0}, 0))
    loaded = jax_ckpt.load_checkpoint(path)
    abstract = jax.eval_shape(lambda: state)
    restored = jax_ckpt.restore_tree(abstract.opt_state, loaded["optimizer"])
    assert isinstance(restored, jax_optim.LossScaleState)
    assert (float(restored.scale), int(restored.growth_count),
            int(restored.inner.count)) == (2.0 ** 13, 7, 1)
    assert restored.scale.dtype == jnp.float32
    assert restored.growth_count.dtype == jnp.int32
    tree = optimizer_to_jax(model, opt, cfg, "pretraining")
    want = from_jax_params(jax.tree_util.tree_map(
        np.asarray, restored.inner.nu), cfg, "pretraining")
    for name, p in model.named_parameters():
        assert torch.equal(opt.state[p]["exp_avg_sq"], want[name]), name
    fresh, fresh_opt, _ = _port_fp16(state.params, init_scale=1.0)
    optimizer_from_jax(tree, fresh, fresh_opt, cfg, "pretraining")
    assert (fresh_opt.scale, fresh_opt.growth_count,
            transforms.opt_step_count(fresh_opt)) == (2.0 ** 13, 7, 1)


def test_fp16_tree_needs_an_fp16_run_and_leaves_the_model_alone(tmp_path):
    """A loss-scaled tree into an optimizer without the scaler, or a plain
    one into a DynamicLossScale, raises ValueError naming --dtype float16
    before anything is touched; an unknown tree raises KeyError."""
    _, state = _jax_fp16(seed=8)
    jax_ckpt.save_checkpoint(str(tmp_path / "fp16"), 1, {
        "model": state.params, "optimizer": state.opt_state, "epoch": 0})
    jax_ckpt.save_checkpoint(str(tmp_path / "bf16"), 1, {
        "model": state.params, "optimizer": state.opt_state.inner,
        "epoch": 0})
    model, opt, _ = _port_fp16(_jax_fp16(seed=9)[1].params)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    with pytest.raises(ValueError, match="float16"):
        ckpt.load_latest_checkpoint(str(tmp_path / "fp16"), model, opt.inner)
    with pytest.raises(ValueError, match="float16"):
        ckpt.load_latest_checkpoint(str(tmp_path / "bf16"), model, opt)
    for name, p in model.named_parameters():
        assert torch.equal(p, before[name]), name
    with pytest.raises(KeyError, match="LossScaleState"):
        optimizer_from_jax({"scale": 1.0, "count": 0}, model, opt,
                           BertConfig(**CONFIG), "pretraining")


def test_phase_hand_off_keeps_the_scale(tmp_path):
    """Phase 1 in fp16 for 2 steps from --init_loss_scale 2**14 with a
    growth interval of 3 (scale 2**14, growth count 2 at its final save);
    phase 2 with --previous_phase_end_step 2 resumes it: the count
    restarts at 0, the moments stay, and the scale and growth count ride
    through (JAX test_fp16.py test_reset_count_keeps_scale)."""
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps(CONFIG))

    def args(*extra):
        return run_pretraining.parse_arguments([
            "--model_config_file", str(cfg_path), "--output_dir",
            str(tmp_path / "out"), "--global_batch_size", "8",
            "--local_batch_size", "4", "--device", "cpu", "--dtype",
            "float16", "--max_predictions_per_seq", "5",
            "--loss_scale_growth_interval", "3", *extra])

    run_pretraining.main(args("--max_steps", "2", "--init_loss_scale",
                              str(2.0 ** 14)),
                         SyntheticPretrainingDataset(0, 16, S, 128, 5))
    phase1 = ckpt.load_checkpoint(ckpt.checkpoint_path(
        str(tmp_path / "out" / "pretrain_ckpts"), 2))
    assert (float(phase1["optimizer"]["scale"]),
            int(phase1["optimizer"]["growth_count"]),
            int(phase1["optimizer"]["inner"]["count"])) == (2.0 ** 14, 2, 2)
    b = run_pretraining.setup_training(args(
        "--max_steps", "4", "--previous_phase_end_step", "2"))
    model, config = run_pretraining.prepare_model(b)
    opt, _ = run_pretraining.prepare_optimizer(b, model)
    assert opt.scale == 2.0 ** 16  # the default, until the resume
    extras, global_step = run_pretraining.restore_checkpoint(b, model, opt)
    assert (b.resume_step, global_step, extras["count"]) == (2, 0, 2)
    assert transforms.opt_step_count(opt) == 0
    assert (opt.scale, opt.growth_count) == (2.0 ** 14, 2)
    tree = optimizer_to_jax(model, opt, config, "pretraining")["inner"]
    for key in ("mu", "nu"):
        got = jax.tree_util.tree_leaves_with_path(tree[key])
        want = dict(jax.tree_util.tree_leaves_with_path(
            phase1["optimizer"]["inner"][key]))
        assert len(got) == len(want)
        for path, leaf in got:
            assert torch.equal(leaf, want[path]), (key, path)


# -- the runners ----------------------------------------------------------------

@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    from bert_pytorch_tpu.tools.make_synthetic_data import make_shard

    root = tmp_path_factory.mktemp("fp16_shards")
    for s in range(2):
        make_shard(str(root / f"shard_{s}.hdf5"), 16, 32, 128, seed=s)
    config = root / "tiny.json"
    config.write_text(json.dumps(dict(CONFIG, vocab_size=125)))
    return root, config


def _runner_args(shards, out, *extra):
    root, config = shards
    return run_pretraining.parse_arguments([
        "--model_config_file", str(config), "--input_dir", str(root),
        "--output_dir", str(out), "--global_batch_size", "8",
        "--local_batch_size", "4", "--max_steps", "10", "--steps", "3",
        "--device", "cpu", "--dtype", "float16",
        "--max_predictions_per_seq", "5", "--skip_final_checkpoint",
        *extra])


def test_pretraining_runner_fp16_logs_the_scale_and_skips(shards, tmp_path):
    """run_pretraining --dtype float16 on the CPU: every train record
    carries loss_scale (the JAX runner's default 2**16 and growth
    interval 2000); with --init_loss_scale 2**40 the first steps
    overflow, are skipped (finite 0, the scale halving each time) and
    the run goes on; --kfac with fp16 is refused as the JAX runner refuses
    it."""
    args = _runner_args(shards, tmp_path / "a")
    assert (args.init_loss_scale, args.loss_scale_growth_interval) == (
        2.0 ** 16, 2000)
    run_pretraining.main(args)
    records = [json.loads(line) for line in open(
        tmp_path / "a" / "pretraining_telemetry.jsonl")]
    train = [r for r in records if r.get("tag") == "train"]
    assert [r["loss_scale"] for r in train] == [2.0 ** 16] * 3
    assert all(r["finite"] == 1.0 for r in train)
    run_pretraining.main(_runner_args(
        shards, tmp_path / "b", "--init_loss_scale", str(2.0 ** 40)))
    train = [json.loads(line) for line in open(
        tmp_path / "b" / "pretraining_telemetry.jsonl")]
    train = [r for r in train if r.get("tag") == "train"]
    assert [r["loss_scale"] for r in train] == [2.0 ** 40, 2.0 ** 39,
                                                2.0 ** 38]
    assert [r["finite"] for r in train] == [0.0, 0.0, 0.0]
    with pytest.raises(ValueError, match="float16"):
        run_pretraining.setup_training(_runner_args(
            shards, tmp_path / "c", "--kfac"))


def test_squad_runner_fp16_trains_with_loss_scaling(tmp_path):
    """A tiny run_squad --dtype float16: two loss-scaled AdamW steps with
    finite losses, prediction and the eval script; the optimizer is a
    DynamicLossScale at --init_loss_scale, and its final checkpoint reads
    back."""
    vocab = write_trace_vocab(str(tmp_path / "vocab.txt"))
    data = write_squad_json(str(tmp_path / "squad.json"), 0, 2)
    config = tmp_path / "tiny.json"
    config.write_text(json.dumps(dict(
        CONFIG, vocab_size=48, max_position_embeddings=64,
        tokenizer="wordpiece")))
    args = run_squad.parse_args([
        "--config_file", str(config), "--vocab_file", vocab,
        "--do_lower_case", "--train_file", data, "--predict_file", data,
        "--do_train", "--do_predict", "--do_eval", "--eval_script",
        "scripts/squad_evaluate_v11.py", "--output_dir",
        str(tmp_path / "out"), "--max_seq_length", "64", "--doc_stride",
        "32", "--train_batch_size", "4", "--max_steps", "2", "--device",
        "cpu", "--dtype", "float16", "--init_loss_scale", "1024",
        "--skip_cache", "--layer_norm_backend", "kernel"])
    summary, model, _ = run_squad.run(args)
    assert len(summary["step_losses"]) == 2
    assert np.isfinite(summary["step_losses"]).all()
    assert summary["exact_match"] is not None and summary["F1"] is not None
    assert model.qa_outputs.weight.dtype == torch.float32
    assert summary["loss_scale"] == 1024.0  # no overflow at this scale
    optimizer = run_squad.make_optimizer(args, model, 2)
    assert isinstance(optimizer, transforms.DynamicLossScale)


def test_kernel_checks_take_fp16_for_training_only():
    """The training kernels' and #6's input checks take fp16 (their CUDA
    launches then go to the kernels' fp16 instances); the serving kernels
    #4 and #5, which no JAX entry point feeds fp16, refuse it."""
    q = torch.zeros(2, 16, 2, 64, dtype=torch.float16)
    kattn._check("flash_attention_fwd", q, {"k": q, "v": q}, None, None,
                 dtypes=kattn._TRAIN_DTYPES)
    with pytest.raises(TypeError, match="float16 not supported"):
        kattn._check("flash_attention_infer", q, {"k": q, "v": q}, None,
                     None)
    kln._check(torch.zeros(4, 64, dtype=torch.float16), torch.ones(64),
               torch.zeros(64))
