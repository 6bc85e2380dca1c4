"""The port's training checkpoints held against the JAX package's on the
CPU: the full ``{model, optimizer, sampler, epoch}`` state written and
read by ``utils/checkpoint.py``, resumed by the port's runner, and
crossing between the two packages in both directions.

Tolerances: a checkpoint round trip is bit for bit (``torch.equal``); the
optimizer step after a resume against the JAX package's own next step is
fp32 1e-6 in parameters, loss and grad_norm (the ROADMAP gate for one
step); a resumed run against an uninterrupted one is bit for bit.
Dropout is off wherever two runs are compared (the JAX resume draws its
dropout rng afresh, as the port does; the masks of the two packages
differ).
"""

import json
import os
import signal
import subprocess
import sys
import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from bert_pytorch_tpu import models as jax_models
from bert_pytorch_tpu import optim as jax_optim
from bert_pytorch_tpu import pretrain as jax_pretrain
from bert_pytorch_tpu.config import BertConfig as JaxConfig
from bert_pytorch_tpu.data.sampler import DistributedSampler as JaxSampler
from bert_pytorch_tpu.utils import checkpoint as jax_ckpt
from bert_pytorch_tpu.utils import integrity as jax_integrity
from bert_pytorch_tpu_torch import pretrain, run_pretraining
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.data.sampler import DistributedSampler
from bert_pytorch_tpu_torch.models import bert
from bert_pytorch_tpu_torch.models.convert import (from_jax_params,
                                                   optimizer_from_jax,
                                                   optimizer_to_jax)
from bert_pytorch_tpu_torch.optim import KFAC, schedules, transforms
from bert_pytorch_tpu_torch.telemetry import schema as tschema
from bert_pytorch_tpu_torch.testing import faults
from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
    SyntheticPretrainingDataset)
from bert_pytorch_tpu_torch.utils import checkpoint as ckpt
from bert_pytorch_tpu_torch.utils import integrity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_ATOL = 1e-6
CONFIG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=128,
              max_position_embeddings=64, type_vocab_size=2,
              next_sentence=True, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
B, S, P = 4, 24, 6


def _host_batch(seed: int, rows: int = 2 * B):
    """[A*B, S] host rows (A = 2 microbatches of B)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, CONFIG["vocab_size"], (rows, S)).astype(np.int32)
    seg = np.zeros((rows, S), np.int32)
    seg[:, S // 2:] = 1
    mask = np.ones((rows, S), np.int32)
    mask[1, 15:], mask[2, 9:] = 0, 0
    labels = np.where(rng.random((rows, S)) < 0.25, ids, -1).astype(np.int32)
    labels[mask == 0] = -1
    return {"input_ids": ids, "segment_ids": seg, "input_mask": mask,
            "masked_lm_labels": labels,
            "next_sentence_labels": rng.integers(0, 2, rows).astype(
                np.int32)}


def _schedules():
    """The phase-2 recipe's lr and warmup over 100 steps (the schedule of
    test_torch_pretraining.py's one-step gate)."""
    return (jax_optim.warmup_poly_schedule(4e-3, 0.128, 100),
            schedules.warmup_poly_schedule(4e-3, 0.128, 100))


def _jax_state(seed: int = 1):
    """(model, tx, step, TrainState after init) of the JAX pretraining
    path: LAMB on the poly schedule."""
    cfg = JaxConfig(**CONFIG)
    model = jax_models.BertForPreTraining(cfg, dtype=jnp.float32)
    ids = jnp.zeros((1, S), jnp.int32)
    params = nn.unbox(model.init(jax.random.PRNGKey(seed), ids, ids, ids))[
        "params"]
    schedule, _ = _schedules()
    tx = jax_optim.lamb(schedule, weight_decay_mask=jax_optim.no_decay_mask)
    step = jax_pretrain.make_train_step(model, tx, schedule=schedule,
                                        next_sentence=True,
                                        max_pred_per_seq=P)
    state = jax_pretrain.TrainState(params=params, opt_state=tx.init(params),
                                    rng=jax.random.PRNGKey(2))
    return model, tx, step, state


def _port(params=None, seed: int = 0):
    """(model, LAMB, train step) of the port; ``params`` a JAX params tree
    to start from, else seeded random weights."""
    cfg = BertConfig(**CONFIG)
    model = bert.BertForPreTraining(cfg)
    if params is None:
        bert.init_weights(model, 0.02, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(from_jax_params(
            jax.tree_util.tree_map(np.asarray, params), cfg, "pretraining"))
    _, schedule = _schedules()
    opt = transforms.Lamb(transforms.param_groups(model, 0.01), schedule)
    step = pretrain.make_train_step(model, opt, schedule, True, P)
    return model, opt, step


def _stacked(seed: int):
    return jax_pretrain.stack_microbatches(_host_batch(seed), 2)


def _assert_params_close(model, jax_params, atol):
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, jax_params),
                          BertConfig(**CONFIG), "pretraining")
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.detach().numpy(), ref[name].numpy(),
                                   atol=atol, rtol=0, err_msg=name)


def _assert_state_equal(model_a, opt_a, model_b, opt_b):
    pa, pb = dict(model_a.named_parameters()), dict(model_b.named_parameters())
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt_a.state[pa[name]][key],
                               opt_b.state[pb[name]][key]), (name, key)
    assert [g["count"] for g in opt_a.param_groups] == [
        g["count"] for g in opt_b.param_groups]


# -- the checkpoint itself ---------------------------------------------------

@pytest.mark.parametrize("async_write", [False, True], ids=["sync", "async"])
def test_round_trip_is_bit_exact(tmp_path, async_write):
    """Port save -> port load: params, mu, nu, count, sampler and epoch back
    bit for bit, into a fresh model and optimizer."""
    model, opt, step = _port(seed=3)
    for seed in (10, 11):
        step(pretrain.to_device(_stacked(seed), "cpu"))
    sampler = {"epoch": 2, "seed": 0, "num_replicas": 1, "total_size": 96,
               "index": 40}
    cfg = BertConfig(**CONFIG)
    ckpt.save_checkpoint(
        str(tmp_path), 7, run_pretraining.checkpoint_contents(
            model, opt, cfg, sampler, 2),
        async_write=async_write)
    ckpt.wait_for_pending_save()
    fresh, fresh_opt, _ = _port(seed=4)
    step_no, extras = ckpt.load_latest_checkpoint(str(tmp_path), fresh,
                                                  fresh_opt)
    assert step_no == 7
    assert extras == {"count": 2, "sampler": sampler, "epoch": 2}
    _assert_state_equal(model, opt, fresh, fresh_opt)
    assert integrity.verify_checkpoint(
        ckpt.checkpoint_path(str(tmp_path), 7))[0] == integrity.VERIFIED


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX LAMB TrainState after 2 steps, saved by the JAX
    save_checkpoint: the port resumes it (moments and count equal to the
    JAX ones), and its next step on the same batch matches JAX's own next
    step at 1e-6."""
    _, _, j_step, state = _jax_state()
    for seed in (20, 21):
        state, _ = j_step(state, _stacked(seed))
    sampler = {"epoch": 0, "seed": 0, "num_replicas": 1, "total_size": 64,
               "index": 16}
    jax_ckpt.save_checkpoint(str(tmp_path), 2, {
        "model": state.params, "optimizer": state.opt_state,
        "sampler": sampler, "epoch": 0})
    model, opt, step = _port(seed=9)
    step_no, extras = ckpt.load_latest_checkpoint(str(tmp_path), model, opt)
    assert (step_no, extras["count"], extras["sampler"]) == (2, 2, sampler)
    cfg = BertConfig(**CONFIG)
    mu = from_jax_params(jax.tree_util.tree_map(
        np.asarray, state.opt_state.mu), cfg, "pretraining")
    for name, p in model.named_parameters():
        assert torch.equal(opt.state[p]["exp_avg"], mu[name]), name
    _assert_params_close(model, state.params, 0.0)

    state, j_metrics = j_step(state, _stacked(22))
    metrics = step(pretrain.to_device(_stacked(22), "cpu"))
    for key in ("loss", "grad_norm", "learning_rate"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(j_metrics[key]), rtol=STEP_ATOL,
                                   atol=0, err_msg=key)
    _assert_params_close(model, state.params, STEP_ATOL)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    """The other way: 2 port LAMB steps from the JAX init, saved by the
    port; the JAX package verifies the file, restores it onto its abstract
    TrainState (load_checkpoint + restore_tree, as its runner does), and
    its next step matches the port's at 1e-6."""
    _, _, j_step, state = _jax_state(seed=5)
    model, opt, step = _port(state.params)
    for seed in (30, 31):
        step(pretrain.to_device(_stacked(seed), "cpu"))
    cfg = BertConfig(**CONFIG)
    path = ckpt.save_checkpoint(str(tmp_path), 2, run_pretraining
                                .checkpoint_contents(model, opt, cfg, {
                                    "epoch": 0, "seed": 0,
                                    "num_replicas": 1, "total_size": 8,
                                    "index": 0}, 0))
    assert jax_integrity.verify_checkpoint(path)[0] == "verified"
    loaded = jax_ckpt.load_checkpoint(path)
    abstract = jax.eval_shape(lambda: state)
    restored = jax_pretrain.TrainState(
        params=jax_ckpt.restore_tree(abstract.params, loaded["model"]),
        opt_state=jax_ckpt.restore_tree(abstract.opt_state,
                                        loaded["optimizer"]),
        rng=state.rng)
    assert int(restored.opt_state.count) == 2
    restored, j_metrics = j_step(restored, _stacked(32))
    metrics = step(pretrain.to_device(_stacked(32), "cpu"))
    for key in ("loss", "grad_norm", "learning_rate"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(j_metrics[key]), rtol=STEP_ATOL,
                                   atol=0, err_msg=key)
    _assert_params_close(model, restored.params, STEP_ATOL)


def test_sharded_jax_checkpoint_resumes_equal_to_gathered(devices,
                                                          tmp_path):
    """A JAX sharded-layout training checkpoint (leaves split over the
    8-device CPU mesh where their last axis divides) restores into the
    port equal to its gathered twin: params, moments, count, sampler."""
    _, _, j_step, state = _jax_state(seed=6)
    state, _ = j_step(state, _stacked(40))
    mesh = Mesh(np.array(devices), ("x",))

    def put(x):
        spec = (PartitionSpec(*([None] * (x.ndim - 1) + ["x"]))
                if x.ndim and x.shape[-1] % 8 == 0 else PartitionSpec())
        return jax.device_put(x, NamedSharding(mesh, spec))

    sampler = {"epoch": 1, "seed": 0, "num_replicas": 1, "total_size": 32,
               "index": 8}
    contents = {"model": jax.tree_util.tree_map(put, state.params),
                "optimizer": jax.tree_util.tree_map(put, state.opt_state),
                "sampler": sampler, "epoch": 1}
    jax_ckpt.save_checkpoint(str(tmp_path / "sharded"), 1, contents,
                             layout="sharded", mesh_spec={"x": 8})
    jax_ckpt.save_checkpoint(str(tmp_path / "gathered"), 1, contents)
    index = ckpt.checkpoint_path(str(tmp_path / "sharded"), 1)
    assert integrity.read_manifest(index)["layout"] == "sharded"
    got, got_opt, _ = _port(seed=1)
    want, want_opt, _ = _port(seed=2)
    got_extras = ckpt.restore_training_state(index, got, got_opt)
    want_extras = ckpt.restore_training_state(
        ckpt.checkpoint_path(str(tmp_path / "gathered"), 1), want, want_opt)
    assert got_extras == want_extras == {"count": 1, "sampler": sampler,
                                         "epoch": 1}
    _assert_state_equal(got, got_opt, want, want_opt)


def test_optimizer_tree_round_trips_through_jax_layout():
    """optimizer_to_jax / optimizer_from_jax: the moments and count survive
    the JAX layout (transposes, head splits, stacked layers) exactly."""
    model, opt, step = _port(seed=8)
    step(pretrain.to_device(_stacked(50), "cpu"))
    cfg = BertConfig(**CONFIG)
    tree = optimizer_to_jax(model, opt, cfg, "pretraining")
    assert sorted(tree) == ["count", "mu", "nu"] and int(tree["count"]) == 1
    assert tree["mu"]["bert"]["encoder"]["layers"]["attention"]["query"][
        "kernel"].shape == (2, 64, 4, 16)
    fresh, fresh_opt, _ = _port(seed=8)
    fresh.load_state_dict(model.state_dict())
    optimizer_from_jax(tree, fresh, fresh_opt, cfg, "pretraining")
    _assert_state_equal(model, opt, fresh, fresh_opt)


@pytest.mark.parametrize("name", ["lamb", "bert_adam"])
def test_optimizer_norms_span_the_stacked_layers(name):
    """A repair of the port's optimizers: the JAX ``lamb`` trust ratio and
    ``bert_adam`` clipping norm are taken per leaf of the params tree, and
    the JAX encoder stacks every layer's copy of a parameter into one
    [L, ...] leaf, so the norm spans all layers; the port took it per
    layer. Three steps on the same gradients (layer 1's ten times layer
    0's): parameters within 1e-6 of the JAX optimizer's."""
    import optax

    _, _, _, state = _jax_state(seed=11)
    params = state.params
    rng = np.random.default_rng(0)

    def grads_of(step):
        def leaf(path, x):
            g = rng.standard_normal(x.shape).astype(np.float32) * 1e-2
            if "layers" in jax.tree_util.keystr(path):
                g[1] *= 10.0
            return g * (1.0 + step)
        return jax.tree_util.tree_map_with_path(leaf, params)

    cfg = BertConfig(**CONFIG)
    model, _, _ = _port(params)
    groups = transforms.param_groups(model, 0.01)
    if name == "lamb":
        tx = jax_optim.lamb(1e-2, weight_decay_mask=jax_optim.no_decay_mask)
        opt = transforms.Lamb(groups, 1e-2)
    else:
        tx = jax_optim.bert_adam(1e-2, max_grad_norm=1e-2,
                                 weight_decay_mask=jax_optim.no_decay_mask)
        opt = transforms.BertAdam(groups, 1e-2, max_grad_norm=1e-2)
    opt_state = tx.init(params)
    named = dict(model.named_parameters())
    for step in range(3):
        grads = grads_of(step)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for key, g in from_jax_params(grads, cfg, "pretraining").items():
            named[key].grad = g
        opt.step()
    _assert_params_close(model, params, STEP_ATOL)


# -- refusals ------------------------------------------------------------------

def test_jax_fp16_checkpoint_resumes_with_its_scale(tmp_path):
    """A JAX fp16 LossScaleState optimizer (scale 2**13, growth count 5)
    resumes into the port's DynamicLossScale: params, moments and count
    bit for bit, and the scale and growth count with them. The same file
    into an optimizer without the scaler is refused naming --dtype
    float16, before the model is touched."""
    _, _, _, state = _jax_state(seed=7)
    scaled = jax_optim.LossScaleState(jnp.asarray(2.0 ** 13, jnp.float32),
                                      jnp.asarray(5, jnp.int32),
                                      state.opt_state)
    jax_ckpt.save_checkpoint(str(tmp_path / "fp16"), 3, {
        "model": state.params, "optimizer": scaled, "epoch": 0})
    model, opt, _ = _port(seed=1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    with pytest.raises(ValueError, match="float16"):
        ckpt.load_latest_checkpoint(str(tmp_path / "fp16"), model, opt)
    for name, p in model.named_parameters():
        assert torch.equal(p, before[name]), name
    scaler = transforms.DynamicLossScale(opt)
    step_no, extras = ckpt.load_latest_checkpoint(str(tmp_path / "fp16"),
                                                  model, scaler)
    assert (step_no, extras["count"], extras["loss_scale"]) == (3, 0,
                                                                2.0 ** 13)
    assert (scaler.scale, scaler.growth_count) == (2.0 ** 13, 5)
    _assert_params_close(model, state.params, 0.0)


def test_kfac_state_is_skipped_without_kfac(tmp_path):
    """A checkpoint with a K-FAC ``preconditioner`` resumed without --kfac
    (no state to restore into) restores the rest with a warning that the
    run has no --kfac, as the JAX runner skips the subtree."""
    _, _, _, state = _jax_state(seed=7)
    model, opt, _ = _port(seed=1)
    jax_ckpt.save_checkpoint(str(tmp_path / "kfac"), 3, {
        "model": state.params, "optimizer": state.opt_state, "epoch": 0,
        "preconditioner": {"factors": np.ones((3, 4), np.float32)}})
    with pytest.warns(UserWarning, match="preconditioner.*no --kfac"):
        step_no, extras = ckpt.load_latest_checkpoint(str(tmp_path / "kfac"),
                                                      model, opt)
    assert step_no == 3 and extras["count"] == 0
    _assert_params_close(model, state.params, 0.0)


# -- K-FAC checkpoints ---------------------------------------------------------

def _jax_kfac(inv_method="cholesky"):
    """(KFAC, its init state) of the JAX package on CONFIG's tapped twin."""
    cfg = JaxConfig(**CONFIG)
    tapped = jax_models.BertForPreTraining(cfg, dtype=jnp.float32,
                                           kfac_tap=True)
    model, _, _, state = _jax_state()
    apply_loss, tap_shape_fn = jax_pretrain.make_kfac_fns(
        tapped, True, max_pred_per_seq=P)
    kfac = jax_optim.KFAC(apply_loss, tap_shape_fn, inv_method=inv_method)
    mb0 = {k: v[0] for k, v in _stacked(0).items()}
    return model, tapped, kfac, kfac.init(state.params, mb0)


def _kfac_leaves(tree, prefix=""):
    """flat '/'-path -> leaf of a KFACState checkpoint tree."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_kfac_leaves(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = value
    return out


def test_jax_kfac_checkpoint_resumes_in_the_port_runner(tmp_path):
    """A JAX K-FAC training checkpoint, as the JAX runner writes it ({model,
    optimizer, sampler, epoch, preconditioner}; two fused K-FAC + LAMB
    steps with the eigen method), resumed by the port's runner with --kfac
    (cholesky): factors and count bit-equal, the inverses recomputed from
    the restored factors (not the file's eigenvectors); the runner then
    trains on and saves the count of 3."""
    model, tapped, kfac, kstate = _jax_kfac(inv_method="eigen")
    _, tx, _, state = _jax_state()
    schedule, _ = _schedules()
    step = jax_pretrain.make_train_step(
        model, tx, schedule=schedule, next_sentence=True, max_pred_per_seq=P,
        kfac=kfac, kfac_capture_model=tapped, kfac_inv_interval=1)
    for seed in (60, 61):
        state, _, kstate = step(state, _stacked(seed), kstate)
    out = tmp_path / "out"
    jax_ckpt.save_checkpoint(str(out / "pretrain_ckpts"), 2, {
        "model": state.params, "optimizer": state.opt_state,
        "sampler": {"epoch": 0, "seed": 0, "num_replicas": 1,
                    "total_size": 32, "index": 16},
        "epoch": 0, "preconditioner": kstate})
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps(CONFIG))
    argv = ["--model_config_file", str(cfg_path), "--output_dir", str(out),
            "--global_batch_size", "8", "--local_batch_size", "4",
            "--max_steps", "10", "--device", "cpu", "--dtype", "float32",
            "--max_predictions_per_seq", str(P), "--kfac",
            "--kfac_factor_interval", "1", "--kfac_inv_interval", "5"]
    args = run_pretraining.setup_training(
        run_pretraining.parse_arguments(argv))
    port_model, config = run_pretraining.prepare_model(args)
    opt, _ = run_pretraining.prepare_optimizer(args, port_model)
    port_kfac, port_state = run_pretraining.prepare_kfac(args, port_model,
                                                         config)
    extras, global_step = run_pretraining.restore_checkpoint(
        args, port_model, opt, port_kfac, port_state)
    assert (global_step, extras["count"], extras["preconditioner"]) == (
        2, 2, True)
    assert int(port_state.count) == int(kstate.count) == 2
    for field in ("a", "g"):
        for key, value in getattr(kstate, field).items():
            assert torch.equal(getattr(port_state, field)[key],
                               torch.from_numpy(np.array(value))), key
    recomputed = port_kfac.init()
    for field in ("a", "g"):
        for key, value in getattr(port_state, field).items():
            getattr(recomputed, field)[key].copy_(value)
    port_kfac.update_inverses(recomputed)
    for field in ("qa", "qg", "la", "lg"):
        for key, value in getattr(recomputed, field).items():
            assert torch.equal(getattr(port_state, field)[key], value), key
    key = "bert/encoder/layers/mlp_in_a"
    assert not np.array_equal(port_state.qa[key].float().numpy(), np.asarray(
        kstate.qa[key], np.float32))
    result = run_pretraining.main(run_pretraining.parse_arguments(
        argv + ["--steps", "1"]), SyntheticPretrainingDataset(0, 32, S, 128,
                                                              P))
    assert result["global_step"] == 3 and result["finite"] == 1.0
    assert int(np.asarray(_final_tree(out, 3)["preconditioner"]["count"])
               ) == 3


@pytest.mark.parametrize("async_write", [False, True], ids=["sync", "async"])
def test_port_kfac_checkpoint_reads_in_jax(tmp_path, async_write):
    """Two fused K-FAC + LAMB port steps from the JAX init, saved by the
    port (sync or async): the JAX package's restore_tree(kfac.init(...),
    checkpoint["preconditioner"]) reads every leaf bit-equal to the port's
    state, in the JAX dtypes."""
    _, _, kfac, jstate = _jax_kfac()
    _, _, _, state = _jax_state(seed=5)
    model, opt, _ = _port(state.params)
    port_kfac = KFAC(model)
    kstate = port_kfac.init()
    _, schedule = _schedules()
    step = pretrain.make_train_step(model, opt, schedule, True, P,
                                    kfac=port_kfac, kfac_fused=True,
                                    kfac_inv_interval=1)
    for seed in (62, 63):
        step(pretrain.to_device(_stacked(seed), "cpu"), kstate)
    path = ckpt.save_checkpoint(
        str(tmp_path), 2, run_pretraining.checkpoint_contents(
            model, opt, BertConfig(**CONFIG), None, 0, kstate),
        async_write=async_write)
    ckpt.wait_for_pending_save()
    assert jax_integrity.verify_checkpoint(path)[0] == "verified"
    restored = jax_ckpt.restore_tree(
        jstate, jax_ckpt.load_checkpoint(path)["preconditioner"])
    assert int(restored.count) == 2
    want = _kfac_leaves(kstate.state_dict())
    got = _kfac_leaves({"count": restored.count, "a": restored.a,
                        "g": restored.g, "qa": restored.qa, "la": restored.la,
                        "qg": restored.qg, "lg": restored.lg})
    assert set(got) == set(want)
    for name, value in want.items():
        leaf = np.asarray(got[name])
        assert str(leaf.dtype) == str(value.dtype).replace("torch.", ""), name
        np.testing.assert_array_equal(leaf.astype(np.float32),
                                      value.float().numpy(), err_msg=name)


def test_kfac_state_of_other_layers_is_refused_and_leaves_all_alone(
        tmp_path):
    """A K-FAC checkpoint resumed into a state with other keys (here
    --kfac_skip_layers attention) raises CheckpointShapeError naming the
    field, and the model, optimizer and K-FAC state stay as they were."""
    model, opt, _ = _port(seed=2)
    full = KFAC(model)
    ckpt.save_checkpoint(str(tmp_path), 1, run_pretraining.checkpoint_contents(
        model, opt, BertConfig(**CONFIG), None, 0, full.init()))
    fresh, fresh_opt, _ = _port(seed=3)
    partial = KFAC(fresh, skip_layers=("attention",))
    state = partial.init()
    before = {n: p.detach().clone() for n, p in fresh.named_parameters()}
    with pytest.raises(ckpt.CheckpointShapeError, match="preconditioner/a"):
        ckpt.load_latest_checkpoint(str(tmp_path), fresh, fresh_opt,
                                    preconditioner=state)
    for name, p in fresh.named_parameters():
        assert torch.equal(p, before[name]), name
    assert not fresh_opt.state and set(state.a) == {
        "bert/encoder/layers/mlp_in_a"}


def test_shape_mismatch_raises_and_leaves_the_model_alone(tmp_path):
    model, opt, _ = _port(seed=1)
    cfg = BertConfig(**CONFIG)
    ckpt.save_checkpoint(str(tmp_path), 1, run_pretraining.checkpoint_contents(
        model, opt, cfg, None, 0))
    wide = bert.init_weights(bert.BertForPreTraining(BertConfig(**dict(
        CONFIG, intermediate_size=256))), 0.02,
        torch.Generator().manual_seed(5))
    wide_opt = transforms.Lamb(transforms.param_groups(wide, 0.01), 1e-3)
    before = {n: p.detach().clone() for n, p in wide.named_parameters()}
    with pytest.raises(ckpt.CheckpointShapeError, match="shape"):
        ckpt.load_latest_checkpoint(str(tmp_path), wide, wide_opt)
    for name, p in wide.named_parameters():
        assert torch.equal(p, before[name]), name
    assert not wide_opt.state


# -- the write path ------------------------------------------------------------

def _contents(step):
    return {"model": {"w": torch.full((4, 4), float(step))}, "epoch": step}


def _steps(path):
    return sorted(int(m.group(1)) for name in path.iterdir()
                  if (m := ckpt.CKPT_RE.search(name.name)))


@pytest.mark.parametrize("async_write", [False, True], ids=["sync", "async"])
def test_retention_keeps_newest_and_async_lands_in_order(tmp_path,
                                                         async_write):
    for step in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(str(tmp_path), step, _contents(step), keep=3,
                             async_write=async_write)
    ckpt.wait_for_pending_save()
    assert _steps(tmp_path) == [3, 4, 5]
    assert ckpt.find_resume_step(str(tmp_path)) == 5
    state = ckpt.load_checkpoint(ckpt.checkpoint_path(str(tmp_path), 5))
    assert torch.equal(state["model"]["w"], torch.full((4, 4), 5.0))
    assert state["epoch"] == 5
    assert not [p for p in tmp_path.iterdir() if p.suffix == ".tmp"]
    # The JAX package reads what the port wrote.
    assert jax_ckpt.load_checkpoint(ckpt.checkpoint_path(
        str(tmp_path), 5))["epoch"] == 5


def test_async_snapshot_immune_to_mutation(tmp_path):
    """The state is copied before save_checkpoint returns: updating the
    tensors at once (the next step's optimizer update) cannot reach the
    written checkpoint."""
    contents = _contents(7)
    ckpt.save_checkpoint(str(tmp_path), 7, contents, async_write=True)
    contents["model"]["w"].fill_(-1.0)
    ckpt.wait_for_pending_save()
    state = ckpt.load_checkpoint(ckpt.checkpoint_path(str(tmp_path), 7))
    assert torch.equal(state["model"]["w"], torch.full((4, 4), 7.0))


def test_async_write_failure_raises_at_wait_and_next_save(tmp_path,
                                                         monkeypatch):
    real = ckpt._write_and_prune

    def boom(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write_and_prune", boom)
    ckpt.save_checkpoint(str(tmp_path), 1, _contents(1), async_write=True)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ckpt.wait_for_pending_save()
    ckpt.wait_for_pending_save()  # the error was consumed
    ckpt.save_checkpoint(str(tmp_path), 2, _contents(2), async_write=True)
    monkeypatch.setattr(ckpt, "_write_and_prune", real)
    # The next save writes its own state first, then raises the old error.
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ckpt.save_checkpoint(str(tmp_path), 3, _contents(3))
    assert _steps(tmp_path) == [3]


def test_async_saves_from_many_threads_all_land(tmp_path):
    """The pending-write registry under contention: 12 threads (more than
    the cores) each make 3 async saves to a directory of their own, the
    interpreter switching threads every microsecond; after the joins every
    directory holds its 3 checkpoints, each with its own contents."""
    import threading

    def saver(i):
        for step in (1, 2, 3):
            ckpt.save_checkpoint(str(tmp_path / str(i)), step,
                                 _contents(10 * i + step), async_write=True)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=saver, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        ckpt.wait_for_pending_save()
    finally:
        sys.setswitchinterval(interval)
    for i in range(12):
        assert _steps(tmp_path / str(i)) == [1, 2, 3]
        state = ckpt.load_checkpoint(ckpt.checkpoint_path(
            str(tmp_path / str(i)), 3))
        assert state["epoch"] == 10 * i + 3
        assert torch.equal(state["model"]["w"],
                           torch.full((4, 4), float(10 * i + 3)))


def test_sharded_write_is_refused(tmp_path):
    """An unknown layout is refused; the sharded layout is written now (a
    single process writes one shard file beside the index) and reads back
    as the gathered one does (tests/test_torch_parallel.py covers ranks)."""
    with pytest.raises(ValueError, match="unknown checkpoint layout"):
        ckpt.save_checkpoint(str(tmp_path), 1, _contents(1), layout="banana")
    ckpt.save_checkpoint(str(tmp_path), 1, _contents(1), layout="sharded",
                         mesh_spec={"data": 1, "fsdp": 1})
    assert sorted(os.listdir(tmp_path)) == sorted([
        "ckpt_1.msgpack", "ckpt_1.msgpack.manifest.json",
        "ckpt_1.shard0of1.msgpack", "ckpt_1.shard0of1.msgpack.manifest.json"])
    assert integrity.read_manifest(ckpt.checkpoint_path(
        str(tmp_path), 1))["layout"] == "sharded"
    state = ckpt.load_checkpoint(ckpt.checkpoint_path(str(tmp_path), 1))
    assert state["epoch"] == 1
    assert torch.equal(state["model"]["w"], torch.full((4, 4), 1.0))


@pytest.mark.parametrize("modes", [("truncate",), ("flip", "truncate")],
                         ids=["newest-corrupt", "two-corrupt"])
def test_walk_back_skips_corrupt_checkpoints(tmp_path, modes):
    """Corrupt newest checkpoints are skipped with a record naming step,
    path and reason, and the next retained one restores."""
    model, opt, step = _port(seed=2)
    cfg = BertConfig(**CONFIG)
    states = {}
    for s in (2, 4, 6):
        step(pretrain.to_device(_stacked(60 + s), "cpu"))
        ckpt.save_checkpoint(str(tmp_path), s, run_pretraining
                             .checkpoint_contents(model, opt, cfg, None, s))
        states[s] = {n: p.detach().clone()
                     for n, p in model.named_parameters()}
    for s, mode in zip((6, 4), modes):
        faults.corrupt_checkpoint(ckpt.checkpoint_path(str(tmp_path), s),
                                  mode)
    want = 6 - 2 * len(modes) - 0
    fresh, fresh_opt, _ = _port(seed=3)
    skipped = []
    with pytest.warns(UserWarning, match="Skipping unreadable checkpoint"):
        step_no, extras = ckpt.load_latest_checkpoint(
            str(tmp_path), fresh, fresh_opt, on_skip=skipped.append)
    assert step_no == want and extras["epoch"] == want
    assert [r["step"] for r in skipped] == [6, 4][:len(modes)]
    assert all("integrity" in r["reason"] and r["path"].endswith(
        f"ckpt_{r['step']}.msgpack") for r in skipped)
    for name, p in fresh.named_parameters():
        assert torch.equal(p, states[want][name]), name
    assert ckpt.find_resume_step(str(tmp_path), verify=True) == want
    assert ckpt.find_resume_step(str(tmp_path)) == 6


def test_walk_back_with_every_checkpoint_corrupt(tmp_path):
    model, opt, _ = _port(seed=2)
    cfg = BertConfig(**CONFIG)
    for s in (1, 2):
        ckpt.save_checkpoint(str(tmp_path), s, run_pretraining
                             .checkpoint_contents(model, opt, cfg, None, 0))
    open(ckpt.checkpoint_path(str(tmp_path), 2), "wb").write(b"not msgpack")
    path = ckpt.checkpoint_path(str(tmp_path), 1)
    os.unlink(integrity.manifest_path(path))  # unverifiable, then torn
    faults.corrupt_checkpoint(path, "truncate")
    skipped = []
    with pytest.warns(UserWarning):
        assert ckpt.load_latest_checkpoint(str(tmp_path), model, opt,
                                           on_skip=skipped.append) is None
    assert [r["step"] for r in skipped] == [2, 1]
    assert "MsgpackError" in skipped[1]["reason"]
    assert ckpt.load_latest_checkpoint(str(tmp_path / "missing"), model,
                                       opt) is None


@pytest.mark.parametrize("change", ["none", "total_size", "num_replicas"])
def test_sampler_state_matches_jax(change):
    """state_dict / load_state_dict with the JAX sampler's keys and its
    warn-and-skip rules."""
    data = list(range(40))
    ours, theirs = DistributedSampler(data), JaxSampler(data, 1, 0)
    for _ in range(7):
        next(ours), next(theirs)
    ours.set_epoch(3), theirs.set_epoch(3)
    state = ours.state_dict()
    assert state == theirs.state_dict()
    other = {"none": data, "total_size": list(range(41)),
             "num_replicas": data}[change]
    replicas = 2 if change == "num_replicas" else 1
    a = DistributedSampler(other, num_replicas=replicas)
    b = JaxSampler(other, num_replicas=replicas, rank=0)
    if change == "none":
        a.load_state_dict(state), b.load_state_dict(state)
    else:
        with pytest.warns(UserWarning):
            a.load_state_dict(state)
        with pytest.warns(UserWarning):
            b.load_state_dict(state)
    assert a.state_dict() == b.state_dict()
    assert [next(a) for _ in range(3)] == [next(b) for _ in range(3)]


# -- the runner ----------------------------------------------------------------

@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    from bert_pytorch_tpu.tools.make_synthetic_data import make_shard

    root = tmp_path_factory.mktemp("resume_shards")
    for s in range(2):
        make_shard(str(root / f"shard_{s}.hdf5"), 12, 32, 128, seed=s)
    config = root / "tiny.json"
    config.write_text(json.dumps(dict(CONFIG, vocab_size=125,
                                      max_position_embeddings=32)))
    return root, config


def _runner_args(shards, out, *extra):
    root, config = shards
    return run_pretraining.parse_arguments([
        "--model_config_file", str(config), "--input_dir", str(root),
        "--output_dir", str(out), "--global_batch_size", "8",
        "--local_batch_size", "4", "--max_steps", "50", "--device", "cpu",
        "--dtype", "float32", "--max_predictions_per_seq", "5",
        "--learning_rate", "1e-3", "--warmup_proportion", "0.1", *extra])


def _final_tree(out, step):
    return ckpt.load_checkpoint(ckpt.checkpoint_path(
        os.path.join(out, "pretrain_ckpts"), step))


def _assert_trees_equal(a, b, where="root"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for key in a:
            _assert_trees_equal(a[key], b[key], f"{where}/{key}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_runner_resume_equals_an_uninterrupted_run(shards, tmp_path):
    """4 steps straight equal 2 steps + resume + 2 steps bit for bit, past
    an epoch boundary (24 samples, 8 a step): params, moments, count,
    sampler position and epoch of the final checkpoints."""
    straight = run_pretraining.main(_runner_args(
        shards, tmp_path / "a", "--steps", "4"))
    first = run_pretraining.main(_runner_args(
        shards, tmp_path / "b", "--steps", "2"))
    second = run_pretraining.main(_runner_args(
        shards, tmp_path / "b", "--steps", "2"))
    assert (straight["global_step"], first["global_step"],
            second["global_step"]) == (4, 2, 4)
    assert second["loss"] == straight["loss"]
    a, b = _final_tree(tmp_path / "a", 4), _final_tree(tmp_path / "b", 4)
    _assert_trees_equal(a, b)
    assert a["epoch"] == 1 and a["sampler"]["index"] == 8


def test_phase_surgery_resets_the_count_and_numbers_saves(tmp_path):
    """Phase 1 to step 4; phase 2 with --previous_phase_end_step 4 resumes
    it: the optimizer count reads 0 (the moments are phase 1's), the run
    counts its own steps from 0, and its checkpoints are numbered 4 + the
    step (JAX test_pretraining.py test_phase_switch_resets_optimizer_count,
    test_optim.py reset_count)."""
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps(CONFIG))

    def args(*extra):
        return run_pretraining.parse_arguments([
            "--model_config_file", str(cfg_path), "--output_dir",
            str(tmp_path / "out"), "--global_batch_size", "8",
            "--local_batch_size", "4", "--device", "cpu", "--dtype",
            "float32", "--max_predictions_per_seq", "5", *extra])

    def dataset():
        return SyntheticPretrainingDataset(0, 32, S, 128, 5)

    run_pretraining.main(args("--max_steps", "4"), dataset())
    phase1 = _final_tree(tmp_path / "out", 4)
    a = run_pretraining.setup_training(args(
        "--max_steps", "4", "--previous_phase_end_step", "4",
        "--learning_rate", "2e-3", "--warmup_proportion", "0.5"))
    model, config = run_pretraining.prepare_model(a)
    opt, _ = run_pretraining.prepare_optimizer(a, model)
    extras, global_step = run_pretraining.restore_checkpoint(a, model, opt)
    assert (a.resume_step, global_step, extras["count"]) == (4, 0, 4)
    assert transforms.opt_step_count(opt) == 0
    mu = optimizer_to_jax(model, opt, config, "pretraining")["mu"]
    _assert_trees_equal(mu, phase1["optimizer"]["mu"])
    result = run_pretraining.main(args(
        "--max_steps", "4", "--steps", "2", "--previous_phase_end_step", "4",
        "--learning_rate", "2e-3", "--warmup_proportion", "0.5"), dataset())
    assert result["global_step"] == 2
    assert ckpt.find_resume_step(str(tmp_path / "out" / "pretrain_ckpts")
                                 ) == 6
    assert int(_final_tree(tmp_path / "out", 6)["optimizer"]["count"]) == 2
    with pytest.raises(ValueError, match="cannot be larger"):
        run_pretraining.main(args("--max_steps", "9",
                                  "--previous_phase_end_step", "7"),
                             dataset())


def test_cadence_saves_async_with_retention(tmp_path):
    """--num_steps_per_checkpoint 1, --keep_checkpoints 2, async writes
    and no final save: the run ends with the newest two checkpoints, the
    last one its final state."""
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps(CONFIG))
    out = run_pretraining.main(run_pretraining.parse_arguments([
        "--model_config_file", str(cfg_path), "--output_dir",
        str(tmp_path / "out"), "--global_batch_size", "8",
        "--local_batch_size", "8", "--device", "cpu", "--dtype", "float32",
        "--max_steps", "5", "--max_predictions_per_seq", "5",
        "--num_steps_per_checkpoint", "1", "--keep_checkpoints", "2",
        "--skip_final_checkpoint"]),
        SyntheticPretrainingDataset(1, 16, S, 128, 5))
    assert [s["step"] for s in out["saves"]] == [1, 2, 3, 4, 5]
    assert _steps(tmp_path / "out" / "pretrain_ckpts") == [4, 5]
    assert int(_final_tree(tmp_path / "out", 5)["optimizer"]["count"]) == 5


def test_sigterm_writes_the_checkpoint_and_exits_75(shards, tmp_path):
    """SIGTERM mid-run: the runner stops at the next step boundary, writes
    its checkpoint (even with --skip_final_checkpoint), exits with 75, and
    the next run resumes from it (JAX test_pretraining.py
    test_sigterm_graceful_checkpoint)."""
    root, config = shards
    out = tmp_path / "out"
    argv = [sys.executable, "-m", "bert_pytorch_tpu_torch.run_pretraining",
            "--model_config_file", str(config), "--input_dir", str(root),
            "--output_dir", str(out), "--global_batch_size", "4",
            "--local_batch_size", "4", "--max_steps", "100000",
            "--steps", "100000", "--device", "cpu", "--dtype", "float32",
            "--num_steps_per_checkpoint", "100000", "--term_check_steps",
            "1", "--skip_final_checkpoint", "--max_predictions_per_seq", "5"]
    proc = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    deadline = time.monotonic() + 240
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("step 2 "):
                proc.send_signal(signal.SIGTERM)
                break
            assert time.monotonic() < deadline, "".join(lines[-20:])
        rest, _ = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    output = "".join(lines) + rest
    assert proc.returncode == 75, output[-2000:]
    assert "termination signal" in output and "SIGTERM" in output
    stopped_at = ckpt.find_resume_step(str(out / "pretrain_ckpts"))
    assert stopped_at is not None and 2 <= stopped_at < 100000
    result = run_pretraining.main(_runner_args(
        shards, out, "--global_batch_size", "4", "--steps", "1",
        "--term_check_steps", "0"))
    assert result["global_step"] == stopped_at + 1
    assert not result["terminated_by_signal"]
    # A resume past a truncated newest checkpoint: the JSONL holds the
    # preemption's fault record, then a resume record per run, the last
    # naming the step the walk-back skipped.
    faults.corrupt_checkpoint(ckpt.checkpoint_path(
        str(out / "pretrain_ckpts"), stopped_at + 1), "truncate")
    again = run_pretraining.main(_runner_args(
        shards, out, "--global_batch_size", "4", "--steps", "1",
        "--term_check_steps", "0", "--skip_final_checkpoint"))
    assert again["global_step"] == stopped_at + 1
    path = str(out / "pretraining_telemetry.jsonl")
    assert tschema.validate_file(path) == []
    records = [json.loads(line) for line in open(path)]
    fault = [r for r in records if r.get("kind") == "fault"]
    assert [(r["fault"], r["signal"], r["step"]) for r in fault] == [
        ("preemption", "SIGTERM", stopped_at)]
    resumes = [r for r in records if r.get("kind") == "resume"]
    assert [r["step"] for r in resumes] == [stopped_at, stopped_at]
    assert resumes[0]["skipped"] == []
    assert [(r["step"], os.path.basename(r["path"])) for r in
            resumes[1]["skipped"]] == [
        (stopped_at + 1, f"ckpt_{stopped_at + 1}.msgpack")]


def test_runner_records_a_walk_back_that_finds_nothing(tmp_path):
    """Every retained checkpoint corrupt: the run restarts from scratch and
    its JSONL holds the ``resume_walk_back_exhausted`` fault record
    naming each skipped file (JAX run_pretraining.py:515-523)."""
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps(CONFIG))

    def run(*extra):
        return run_pretraining.main(run_pretraining.parse_arguments([
            "--model_config_file", str(cfg_path), "--output_dir",
            str(tmp_path / "out"), "--global_batch_size", "8",
            "--local_batch_size", "8", "--device", "cpu", "--dtype",
            "float32", "--max_steps", "4", "--max_predictions_per_seq", "5",
            "--num_steps_per_checkpoint", "1", "--checkpoint_write", "sync",
            *extra]), SyntheticPretrainingDataset(1, 16, S, 128, 5))

    run("--steps", "2", "--skip_final_checkpoint")
    ckpt_dir = str(tmp_path / "out" / "pretrain_ckpts")
    for step in (1, 2):
        faults.corrupt_checkpoint(ckpt.checkpoint_path(ckpt_dir, step),
                                  "truncate")
    assert run("--steps", "1", "--skip_final_checkpoint")["global_step"] == 1
    path = str(tmp_path / "out" / "pretraining_telemetry.jsonl")
    assert tschema.validate_file(path) == []
    fault = [json.loads(line) for line in open(path)
             if '"fault"' in line]
    assert len(fault) == 1
    assert fault[0]["fault"] == "resume_walk_back_exhausted"
    assert sorted(r["step"] for r in fault[0]["skipped"]) == [1, 2]
