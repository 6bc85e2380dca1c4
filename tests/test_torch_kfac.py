"""The port's K-FAC (``bert_pytorch_tpu_torch/optim/kfac.py``, the taps of
``models/bert.py``, the K-FAC train step and the runner's ``--kfac``) held
against the JAX package's on the CPU.

Both packages get the same weights (``from_jax_params``) and the same
numpy batches from a seed, on the JAX package's K-FAC test config
(tests/test_kfac.py: vocab 64, hidden 16, 2 layers) with dropout 0; the
attention is dense on the CPU.

Tolerances:
- factors: rtol 2e-4, atol 1e-5, the JAX package's own bar between its two
  capture paths (tests/test_kfac.py:242-247); factors under the three remat
  policies: 1e-6;
- inverses, preconditioned gradients and stepped parameters (with loss and
  grad_norm): rtol 1e-4, atol 1e-6 (tests/test_kfac.py:252). Those
  comparisons store the inverses in fp32 (``inv_dtype``) in both packages:
  the default bf16 storage rounds two fp32 values 1e-6 apart to bf16
  numbers one bf16 ulp (2⁻⁸ relative) apart; the bf16 inverses are held to
  one bf16 ulp of the JAX package's;
- the eigen method's preconditioned gradients: rtol 1e-4 and an atol of
  4e-6 of each gradient's largest entry. The two fp32 eigensolvers (LAPACK
  through torch and through jaxlib) each land 2-4e-6 from an fp64
  eigendecomposition of the same factors at entries of magnitude 2.5-3.6
  (factor eigenvalues from 0 to 7.5), so entries near 0 cannot agree to
  1e-6 absolute.
"""

import json
import math

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert_pytorch_tpu import optim as jax_optim
from bert_pytorch_tpu import pretrain as jax_pretrain
from bert_pytorch_tpu.config import BertConfig as JaxConfig
from bert_pytorch_tpu.models import BertForPreTraining as JaxPreTraining
from bert_pytorch_tpu_torch import pretrain, run_pretraining
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.models import bert
from bert_pytorch_tpu_torch.models.convert import from_jax_params
from bert_pytorch_tpu_torch.optim import KFAC, KFACState
from bert_pytorch_tpu_torch.optim import kfac as kfac_lib
from bert_pytorch_tpu_torch.optim import schedules, transforms
from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
    SyntheticPretrainingDataset)
from bert_pytorch_tpu_torch.utils import checkpoint as ckpt

FACTOR_RTOL, FACTOR_ATOL = 2e-4, 1e-5
REMAT_ATOL = 1e-6
RTOL, ATOL = 1e-4, 1e-6
EIGEN_ATOL_OF_MAX = 4e-6
CONFIG = dict(vocab_size=64, hidden_size=16, num_hidden_layers=2,
              num_attention_heads=2, intermediate_size=32,
              max_position_embeddings=32, next_sentence=True,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
A, B, S = 2, 4, 16


def _batch(seed: int, rows=(A, B)):
    """Seeded numpy rows of shape ``rows`` + (S,) (the JAX K-FAC test's
    recipe: uniform ids, 20% of positions labelled)."""
    rng = np.random.default_rng(seed)
    shape = tuple(rows) + (S,)
    return {
        "input_ids": rng.integers(0, 64, shape).astype(np.int32),
        "segment_ids": np.zeros(shape, np.int32),
        "input_mask": np.ones(shape, np.int32),
        "masked_lm_labels": np.where(rng.random(shape) < 0.2,
                                     rng.integers(0, 64, shape),
                                     -1).astype(np.int32),
        "next_sentence_labels": rng.integers(0, 2, rows).astype(np.int32),
    }


def _mb(seed: int):
    return _batch(seed, rows=(B,))


def _t(batch):
    return pretrain.to_device(batch, "cpu")


@pytest.fixture(scope="module")
def ref():
    """The JAX side: plain and tapped models, params, a default KFAC and one
    with fp32 inverses, and the schedule."""
    cfg = JaxConfig(**CONFIG)
    model = JaxPreTraining(cfg, dtype=jnp.float32)
    tapped = JaxPreTraining(cfg, dtype=jnp.float32, kfac_tap=True)
    params = nn.unbox(model.init(
        jax.random.PRNGKey(0), *(jnp.zeros((1, S), jnp.int32),) * 3)
    )["params"]
    apply_loss, tap_shape_fn = jax_pretrain.make_kfac_fns(tapped, True)

    def make(**kw):
        k = jax_optim.KFAC(apply_loss, tap_shape_fn, **kw)
        return k, k.init(params, _mb(0))

    return {"model": model, "tapped": tapped, "params": params,
            "make": make,
            "schedule": jax_optim.warmup_poly_schedule(1e-3, 0.1, 100)}


def _port(ref, remat="none", dtype=torch.float32, **kfac_kw):
    """(model with the JAX weights, KFAC with the stats-pass loss, its
    zeroed state)."""
    cfg = BertConfig(**CONFIG)
    model = bert.BertForPreTraining(cfg, dtype=dtype, remat=remat)
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, ref["params"]), cfg,
        "pretraining"))
    kfac = KFAC(model, pretrain.make_kfac_loss(model), **kfac_kw)
    return model, kfac, kfac.init()


def _np(x):
    return np.asarray(jax.device_get(x), np.float32)


def _assert_close(got: torch.Tensor, want, rtol, atol, what):
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want),
                               rtol=rtol, atol=atol, err_msg=what)


def _assert_factors(state: KFACState, jstate, rtol=FACTOR_RTOL,
                    atol=FACTOR_ATOL):
    assert set(state.a) == set(jstate.a) and set(state.g) == set(jstate.g)
    for field in ("a", "g"):
        for key, value in getattr(state, field).items():
            _assert_close(value, getattr(jstate, field)[key], rtol, atol,
                          f"{field} {key}")
    assert int(state.count) == int(jstate.count)


def _port_grads(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree),
                           BertConfig(**CONFIG), "pretraining")


def _random_grads(ref, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 1e-2).astype(np.float32),
        ref["params"])


def _assert_grads(port: dict, jax_tree, what, atol_of_max=None):
    want = _port_grads(jax_tree)
    assert set(port) == set(want)
    for name, value in want.items():
        atol = ATOL if atol_of_max is None else (
            atol_of_max * float(value.abs().max()))
        np.testing.assert_allclose(port[name].detach().numpy(),
                                   value.numpy(), rtol=RTOL, atol=atol,
                                   err_msg=f"{what}: {name}")


# -- the state and its keys ----------------------------------------------------

def test_layer_specs_match_jax(ref):
    """The same (g_key, a_key, a_dim, g_dim, stacked) rows, kernel and bias
    paths, in the same order, as JAX build_layer_specs; every spec's
    modules are the port's layers 0 and 1."""
    jkfac, _ = ref["make"]()
    _, kfac, _ = _port(ref)
    rows = [(s.g_key, s.a_key, s.a_dim, s.g_dim, s.stacked, s.kernel_path,
             s.bias_path) for s in kfac.specs]
    assert rows == [(s.g_key, s.a_key, s.a_dim, s.g_dim, s.stacked,
                     s.kernel_path, s.bias_path) for s in jkfac.specs]
    for spec in kfac.specs:
        assert len(spec.modules) == 2 and spec.modules[1].startswith(
            "bert.encoder.layers.1.")


def test_state_keys_shapes_and_dtypes_match_jax_init(ref):
    """KFAC.init keys, shapes and dtypes equal the JAX kfac.init's on the
    tiny config: a/g fp32 zeros, qa/qg bf16 identities, la/lg fp32 ones,
    count int32 0."""
    _, jstate = ref["make"]()
    _, _, state = _port(ref)
    dtypes = {torch.float32: "float32", torch.bfloat16: "bfloat16",
              torch.int32: "int32"}
    for field in kfac_lib.FIELDS:
        got, want = getattr(state, field), getattr(jstate, field)
        assert set(got) == set(want), field
        for key in want:
            assert tuple(got[key].shape) == want[key].shape, (field, key)
            assert dtypes[got[key].dtype] == str(want[key].dtype), (field,
                                                                    key)
            np.testing.assert_array_equal(got[key].float().numpy(),
                                          _np(want[key]))
    assert state.count.dtype == torch.int32 and int(state.count) == 0
    assert str(jstate.count.dtype) == "int32"


# -- factors -------------------------------------------------------------------

@pytest.mark.parametrize("updates", [1, 2])
def test_factors_match_jax(ref, updates):
    """update_factors (the stats pass) once, then again on another batch
    (the EMA): equal to JAX's within the factor tolerance, and symmetric."""
    jkfac, jstate = ref["make"]()
    _, kfac, state = _port(ref)
    for seed in range(updates):
        jstate = jkfac.update_factors(jstate, ref["params"], _mb(seed),
                                      jax.random.PRNGKey(seed))
        kfac.update_factors(state, _t(_mb(seed)))
    _assert_factors(state, jstate)
    for fac in list(state.a.values()) + list(state.g.values()):
        torch.testing.assert_close(fac, fac.transpose(-1, -2), rtol=0,
                                   atol=1e-6)


def _fused_step(model, kfac, **kw):
    opt = transforms.Lamb(transforms.param_groups(model, 0.01),
                          schedules.warmup_poly_schedule(1e-3, 0.1, 100))
    return pretrain.make_train_step(
        model, opt, schedules.warmup_poly_schedule(1e-3, 0.1, 100), True,
        kfac=kfac, kfac_fused=True, **kw)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_factors_equal_under_every_remat(ref, remat):
    """One fused K-FAC step under remat dots and full captures the factors
    remat none captures (within 1e-6): the statistics are computed in
    backward nodes, once, although the forward runs twice."""
    batch = _t(_batch(3))
    states = {}
    for policy in ("none", remat):
        model, kfac, state = _port(ref, remat=policy)
        _fused_step(model, kfac)(batch, state)
        states[policy] = state
    assert int(states[remat].count) == 1
    for field in ("a", "g"):
        for key, value in getattr(states["none"], field).items():
            torch.testing.assert_close(getattr(states[remat], field)[key],
                                       value, rtol=0, atol=REMAT_ATOL)


def test_fused_first_capture_equals_the_stats_pass(ref):
    """The fused step's microbatch-0 capture equals update_factors on
    microbatch 0 from the same weights, and JAX's fused capture."""
    batch = _batch(4)
    model, kfac, state = _port(ref)
    stats = kfac.init()
    kfac.update_factors(stats, _t({k: v[0] for k, v in batch.items()}))
    _fused_step(model, kfac)(_t(batch), state)
    for field in ("a", "g"):
        for key, value in getattr(stats, field).items():
            torch.testing.assert_close(getattr(state, field)[key], value,
                                       rtol=FACTOR_RTOL, atol=FACTOR_ATOL)
    jkfac, jstate = ref["make"]()
    tx = jax_optim.lamb(ref["schedule"],
                        weight_decay_mask=jax_optim.no_decay_mask)
    jstep = jax_pretrain.make_train_step(
        ref["model"], tx, schedule=ref["schedule"], next_sentence=True,
        kfac=jkfac, kfac_capture_model=ref["tapped"])
    jtrain = jax_pretrain.TrainState(
        params=jax.tree_util.tree_map(jnp.array, ref["params"]),
        opt_state=tx.init(ref["params"]), rng=jax.random.PRNGKey(7))
    _, _, jstate = jstep(jtrain, batch, jstate)
    _assert_factors(state, jstate)


def test_all_microbatches_over_identical_ones_equal_first(ref):
    """'all' over two identical microbatches (twice the sums over twice
    the rows) equals 'first'."""
    one = _batch(5)
    dup = _t({k: np.stack([v[0], v[0]]) for k, v in one.items()})
    states = {}
    for mode in ("first", "all"):
        model, kfac, state = _port(ref)
        _fused_step(model, kfac, kfac_capture_microbatches=mode)(dup, state)
        states[mode] = state
    for field in ("a", "g"):
        for key, value in getattr(states["first"], field).items():
            torch.testing.assert_close(getattr(states["all"], field)[key],
                                       value, rtol=FACTOR_RTOL,
                                       atol=FACTOR_ATOL)


def test_factor_interval_holds_the_count_between_due_steps(ref):
    """kfac_factor_interval=2: counts 0 and 2 capture, count 1 does not
    (the factors stay), and the skipped step still trains."""
    model, kfac, state = _port(ref)
    step = _fused_step(model, kfac, kfac_factor_interval=2)
    step(_t(_batch(6)), state)
    assert int(state.count) == 1
    factors = {k: v.clone() for k, v in state.a.items()}
    before = [p.detach().clone() for p in model.parameters()]
    step(_t(_batch(7)), state)
    assert int(state.count) == 1
    assert all(torch.equal(state.a[k], v) for k, v in factors.items())
    assert any(not torch.equal(p, q) for p, q in zip(model.parameters(),
                                                     before))
    step(_t(_batch(8)), state)
    assert int(state.count) == 2


# -- inverses ------------------------------------------------------------------

@pytest.mark.parametrize("inv_dtype", ["float32", "bfloat16"])
def test_cholesky_inverses_match_jax(ref, inv_dtype):
    """qa/qg = (F + √γ·I)⁻¹ (la/lg ones), equal to JAX's: fp32 within the
    inverse tolerance, bf16 within one bf16 ulp."""
    jdtype = getattr(jnp, inv_dtype)
    jkfac, jstate = ref["make"](inv_dtype=jdtype)
    _, kfac, state = _port(ref, inv_dtype=getattr(torch, inv_dtype))
    jstate = jkfac.update_inverses(jkfac.update_factors(
        jstate, ref["params"], _mb(9), jax.random.PRNGKey(0)))
    kfac.update_inverses(kfac.update_factors(state, _t(_mb(9))))
    for factors, ops, lams, jops in ((state.a, state.qa, state.la, jstate.qa),
                                     (state.g, state.qg, state.lg,
                                      jstate.qg)):
        for key, fac in factors.items():
            eye = torch.eye(fac.shape[-1], dtype=torch.float64)
            damped = fac.double() + math.sqrt(kfac.damping) * eye
            assert ops[key].dtype == getattr(torch, inv_dtype)
            bound = 1e-4 if inv_dtype == "float32" else 0.1
            assert (damped @ ops[key].double() - eye).abs().max() < bound, key
            assert torch.equal(lams[key], torch.ones_like(lams[key]))
            got, want = ops[key].float().numpy(), _np(jops[key])
            if inv_dtype == "float32":
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                           err_msg=key)
            else:
                ulp = np.maximum(np.abs(want), np.finfo(np.float32).tiny
                                 ) * 2.0 ** -7
                assert (np.abs(got - want) <= ulp).all(), key


def test_cholesky_failure_names_the_factor(ref):
    """A factor that is not positive definite after damping raises, naming
    its key and layer; nothing falls back to eigen."""
    _, kfac, state = _port(ref)
    key = "bert/encoder/layers/mlp_in_a"
    state.a[key][1] = -torch.eye(state.a[key].shape[-1])
    with pytest.raises(kfac_lib.FactorNotPositiveDefinite,
                       match=f"{key} \\(layer 1\\)"):
        kfac.update_inverses(state)


def test_eigen_preconditioned_gradients_match_jax(ref):
    """inv_method eigen: the preconditioned gradients (not the
    eigenvectors, whose signs differ) equal JAX's; la/lg the clamped
    eigenvalues."""
    jkfac, jstate = ref["make"](inv_method="eigen", inv_dtype=jnp.float32)
    _, kfac, state = _port(ref, inv_method="eigen", inv_dtype=torch.float32)
    for seed in (10, 11):
        jstate = jkfac.update_factors(jstate, ref["params"], _mb(seed),
                                      jax.random.PRNGKey(0))
        kfac.update_factors(state, _t(_mb(seed)))
    jstate = jkfac.update_inverses(jstate)
    kfac.update_inverses(state)
    for key, lam in state.la.items():
        _assert_close(lam, jstate.la[key], RTOL, 1e-5, key)
        assert (lam >= 0).all()
    grads = _random_grads(ref, 12)
    _assert_grads(kfac.precondition(state, _port_grads(grads), 1e-2),
                  jkfac.precondition(jstate, grads, 1e-2), "eigen",
                  atol_of_max=EIGEN_ATOL_OF_MAX)


@pytest.mark.parametrize("case", ["identity", "kl_clipped"])
def test_precondition_matches_jax(ref, case):
    """precondition from the identity state, and after factors and
    inverses at an lr where kl_clip rescales (ν < 1, checked against a
    KFAC whose kl_clip cannot bind): equal to JAX's, untapped gradients
    passed through untouched."""
    jkfac, jstate = ref["make"](inv_dtype=jnp.float32)
    _, kfac, state = _port(ref, inv_dtype=torch.float32)
    lr = 0.01 if case == "identity" else 1.0
    if case == "kl_clipped":
        jstate = jkfac.update_inverses(jkfac.update_factors(
            jstate, ref["params"], _mb(13), jax.random.PRNGKey(0)))
        kfac.update_inverses(kfac.update_factors(state, _t(_mb(13))))
    grads = _random_grads(ref, 14)
    port = kfac.precondition(state, _port_grads(grads), lr)
    _assert_grads(port, jkfac.precondition(jstate, grads, lr), case)
    if case == "kl_clipped":
        kfac.kl_clip = 1e30
        free = kfac.precondition(state, _port_grads(grads), lr)
        name = "bert.encoder.layers.0.output.weight"
        nu = (port[name] / free[name]).flatten()
        assert 0 < float(nu[0]) < 1
        torch.testing.assert_close(nu, torch.full_like(nu, float(nu[0])))
    untapped = "bert.embeddings.word_embeddings.weight"
    assert torch.equal(port[untapped], _port_grads(grads)[untapped])


# -- the train step ------------------------------------------------------------

def test_three_fused_kfac_lamb_steps_match_jax(ref):
    """Three fused K-FAC + LAMB steps with the inverses rebuilt inside every
    step (JAX make_train_step(kfac=..., kfac_capture_model=...,
    kfac_inv_interval=1)): loss, grad_norm (of the preconditioned
    gradients) and parameters within the step tolerance."""
    jkfac, jstate = ref["make"](inv_dtype=jnp.float32)
    tx = jax_optim.lamb(ref["schedule"],
                        weight_decay_mask=jax_optim.no_decay_mask)
    jstep = jax_pretrain.make_train_step(
        ref["model"], tx, schedule=ref["schedule"], next_sentence=True,
        kfac=jkfac, kfac_capture_model=ref["tapped"], kfac_factor_interval=1,
        kfac_inv_interval=1)
    jtrain = jax_pretrain.TrainState(
        params=jax.tree_util.tree_map(jnp.array, ref["params"]),
        opt_state=tx.init(ref["params"]), rng=jax.random.PRNGKey(7))
    model, kfac, state = _port(ref, inv_dtype=torch.float32)
    step = _fused_step(model, kfac, kfac_inv_interval=1)
    for seed in (20, 21, 22):
        jtrain, jmetrics, jstate = jstep(jtrain, _batch(seed), jstate)
        metrics = step(_t(_batch(seed)), state)
        for key in ("loss", "grad_norm", "learning_rate"):
            np.testing.assert_allclose(float(metrics[key]),
                                       float(jmetrics[key]), rtol=RTOL,
                                       atol=0, err_msg=f"{seed} {key}")
    assert int(state.count) == int(jstate.count) == 3
    want = _port_grads(jtrain.params)
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.detach().numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


REFUSALS = {
    "no_schedule": (dict(schedule=None), dict(schedule=None), "schedule"),
    "fused_without_kfac": (dict(kfac=None, kfac_fused=True),
                           dict(kfac=None, kfac_capture_model=True),
                           "kfac_capture_model"),
    "inverses_without_fused": (dict(kfac_inv_interval=10),
                               dict(kfac_inv_interval=10),
                               "kfac_inv_interval"),
    "capture_mode": (dict(kfac_fused=True, kfac_capture_microbatches="last"),
                     dict(kfac_capture_model=True,
                          kfac_capture_microbatches="last"),
                     "first\\|all"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_train_step_refusals_match_jax(ref, case):
    """The JAX package's refusals (pretrain.py:429-449), in both packages."""
    port_kw, jax_kw, match = REFUSALS[case]
    model, kfac, _ = _port(ref)
    jkfac, _ = ref["make"]()
    opt = transforms.Lamb(transforms.param_groups(model, 0.01), 1e-3)
    kw = dict(schedule=schedules.warmup_poly_schedule(1e-3, 0.1, 100),
              kfac=kfac)
    kw.update(port_kw)
    with pytest.raises(ValueError, match=match):
        pretrain.make_train_step(model, opt, **kw)
    jkw = dict(schedule=ref["schedule"], kfac=jkfac)
    jkw.update({k: (ref["tapped"] if v is True else v)
                for k, v in jax_kw.items()})
    with pytest.raises(ValueError, match=match):
        jax_pretrain.make_train_step(ref["model"], jax_optim.lamb(1e-3),
                                     **jkw)


# -- the taps ------------------------------------------------------------------

def _graph_names(tensor) -> list:
    names, seen, todo = [], set(), [tensor.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        todo.extend(fn for fn, _ in node.next_functions)
    return names


def test_taps_disarmed_are_identities_and_armed_add_two_kinds_of_node(ref):
    """Disarmed, the forward's graph holds no tap node and its loss equals
    the armed forward's; armed, each layer adds 3 A taps and 5 G taps."""
    model, kfac, _ = _port(ref)
    mb = _t(_mb(15))
    plain, _ = pretrain.pretraining_loss_and_accuracy(model, mb, True, None)
    assert not any("Statistic" in n for n in _graph_names(plain))
    with kfac.capture(kfac.zero_statistics()):
        armed, _ = pretrain.pretraining_loss_and_accuracy(model, mb, True,
                                                          None)
    names = _graph_names(armed)
    assert names.count("_InputStatisticBackward") == 3 * 2
    assert names.count("_OutputStatisticBackward") == 5 * 2
    assert torch.equal(plain, armed)
    assert all(m.kfac_sink is None for m in model.modules()
               if hasattr(m, "KFAC_TAPS"))


def test_bf16_cast_cache_gives_every_master_its_gradient_while_armed(ref):
    """bf16 compute with the taps armed: every fp32 master parameter gets
    a finite gradient through the cast with autograd, and every sum
    fills."""
    model, kfac, _ = _port(ref, dtype=torch.bfloat16)
    sums = kfac.zero_statistics()
    with kfac.capture(sums):
        loss, _ = pretrain.pretraining_loss_and_accuracy(
            model, _t(_mb(16)), True, None)
        loss.backward()
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None, name
        assert torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0, name
    for group in sums.values():
        for key, total in group.items():
            assert total.abs().sum() > 0, key


# -- the runner ----------------------------------------------------------------

@pytest.mark.parametrize("capture,microbatches,method", [
    ("train", "first", "cholesky"), ("train", "all", "eigen"),
    ("stats", "first", "cholesky")])
def test_runner_trains_with_kfac(tmp_path, capture, microbatches, method):
    """``--kfac`` end to end on the CPU in every capture mode and inverse
    method: finite steps, the preconditioner saved with the count of
    factor updates (interval 1: one per step; the stats pass on 2 strided
    rows), symmetric factors."""
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps(dict(CONFIG, vocab_size=128)))
    out = run_pretraining.main(run_pretraining.parse_arguments([
        "--model_config_file", str(cfg_path), "--output_dir",
        str(tmp_path / "out"), "--global_batch_size", "8",
        "--local_batch_size", "4", "--max_steps", "3", "--device", "cpu",
        "--dtype", "float32", "--max_predictions_per_seq", "5",
        "--remat", "dots", "--kfac", "--kfac_factor_interval", "1",
        "--kfac_inv_interval", "2", "--kfac_capture", capture,
        "--kfac_capture_microbatches", microbatches,
        "--kfac_inv_method", method, "--kfac_stats_batch", "2"]),
        SyntheticPretrainingDataset(0, 24, S, 128, 5))
    assert out["global_step"] == 3 and out["finite"] == 1.0
    tree = ckpt.load_checkpoint(ckpt.checkpoint_path(
        str(tmp_path / "out" / "pretrain_ckpts"), 3))
    pre = tree["preconditioner"]
    assert int(np.asarray(pre["count"])) == 3
    for fac in list(pre["a"].values()) + list(pre["g"].values()):
        assert fac.abs().sum() > 0
        torch.testing.assert_close(fac, fac.transpose(-1, -2), rtol=0,
                                   atol=1e-6)


def test_stats_rows_are_strided_over_microbatch_zero():
    batch = {"input_ids": torch.arange(2 * 8 * 3).reshape(2, 8, 3)}
    rows = run_pretraining.stats_rows(batch, 3)["input_ids"]
    assert torch.equal(rows, batch["input_ids"][0][[0, 2, 4]])
    assert torch.equal(run_pretraining.stats_rows(batch, 0)["input_ids"],
                       batch["input_ids"][0])
