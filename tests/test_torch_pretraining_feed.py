"""The rest of the port's pretraining runner held to the JAX package on the
CPU: the held-out pass, LAMB's ``trust_clip`` and ``--max_grad_norm``,
``--checkpoint_activations``, the ``--fault_spec`` hooks, the loader's
worker processes and the device prefetcher inside the runner.

The held-out records of a port run are held to the JAX runner's
validation (its dataset under ``seed + 7919``, its loader and its
``make_eval_step``) on the same weights at fp32 1e-5: the run resumes a
JAX checkpoint at learning rate 0, so every pass sees the checkpoint's
weights. One LAMB step with a trust clip is held to the JAX ``lamb`` at
1e-6."""

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
from bert_pytorch_tpu.data.dataset import (
    ShardedPretrainingDataset as JaxDataset)
from bert_pytorch_tpu.data.loader import DataLoader as JaxLoader
from bert_pytorch_tpu.data.sampler import DistributedSampler as JaxSampler
from bert_pytorch_tpu.telemetry import schema as jax_schema
from bert_pytorch_tpu.utils import checkpoint as jax_ckpt
from bert_pytorch_tpu_torch import run_pretraining
from bert_pytorch_tpu_torch.optim import schedules, transforms
from bert_pytorch_tpu_torch.telemetry import schema
from bert_pytorch_tpu_torch.telemetry.sentinels import NonFiniteError
from bert_pytorch_tpu_torch.testing import faults
from bert_pytorch_tpu_torch.tools.make_synthetic_data import make_shard

VAL_ATOL = 1e-5
STEP_ATOL = 1e-6
CONFIG = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=64,
              max_position_embeddings=32, type_vocab_size=2,
              next_sentence=True, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
SEQ, MAX_PRED, BATCH, SEED = 32, 5, 8, 42


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("feed")
    for s in range(2):
        make_shard(str(root / "train" / f"shard_{s}.hdf5"), 24, SEQ, 128,
                   seed=s)
    make_shard(str(root / "val" / "shard_0.hdf5"), 32, SEQ, 128, seed=9)
    config = root / "model.json"
    config.write_text(json.dumps(CONFIG))
    return root


def _argv(data, out, *extra):
    return ["--model_config_file", str(data / "model.json"),
            "--input_dir", str(data / "train"), "--output_dir", str(out),
            "--global_batch_size", str(BATCH), "--local_batch_size", "4",
            "--max_steps", "20", "--device", "cpu", "--dtype", "float32",
            "--max_predictions_per_seq", str(MAX_PRED),
            "--seed", str(SEED), "--skip_final_checkpoint", *extra]


def _jax_params():
    model = jax_models.BertForPreTraining(JaxConfig(**CONFIG),
                                          dtype=jnp.float32)
    ids = jnp.zeros((1, SEQ), jnp.int32)
    params = nn.unbox(model.init(jax.random.PRNGKey(3), ids, ids, ids))[
        "params"]
    return model, params


def _jax_validation(model, params, val_dir, n_batches):
    """The JAX runner's held-out pass: its dataset under seed + 7919, its
    loader from index 0, its make_eval_step; (mean loss, mean accuracy)."""
    ds = JaxDataset([str(p) for p in sorted(val_dir.glob("*.hdf5"))], 4,
                    MAX_PRED, 0.15, vocab_size=128, seed=SEED + 7919)
    loader = JaxLoader(ds, JaxSampler(ds, num_replicas=1, rank=0),
                       batch_size=BATCH, drop_last=True)
    eval_step = jax_pretrain.make_eval_step(model, next_sentence=True)
    losses, accs = [], []
    for batch in loader:
        loss, acc = eval_step(params, batch)
        losses.append(float(loss))
        accs.append(float(acc))
        if len(losses) == n_batches:
            break
    return float(np.mean(losses)), float(np.mean(accs))


def test_val_records_equal_the_jax_validation(data, tmp_path):
    """A port run resumes a JAX checkpoint of step 2 at learning rate 0
    and evaluates after each of its 2 steps (3 of the 4 batches the 32
    held-out rows fill): both records equal the JAX runner's pass on the
    checkpoint's weights at fp32 1e-5, and the JSONL lints clean in both
    packages."""
    model, params = _jax_params()
    tx = jax_optim.lamb(0.0, weight_decay_mask=jax_optim.no_decay_mask)
    out = tmp_path / "out"
    jax_ckpt.save_checkpoint(str(out / "pretrain_ckpts"), 2, {
        "model": params, "optimizer": tx.init(params),
        "sampler": {"epoch": 0, "seed": 0, "num_replicas": 1,
                    "total_size": 48, "index": 16}, "epoch": 0})
    result = run_pretraining.main(run_pretraining.parse_arguments(_argv(
        data, out, "--steps", "2", "--learning_rate", "0",
        "--val_input_dir", str(data / "val"), "--num_steps_per_eval", "1",
        "--eval_batches", "3")))
    assert result["global_step"] == 4
    want_loss, want_acc = _jax_validation(model, params, data / "val", 3)
    assert [r["step"] for r in result["val"]] == [3, 4]
    for record in result["val"]:
        np.testing.assert_allclose(record["average_loss"], want_loss,
                                   atol=VAL_ATOL, rtol=0)
        np.testing.assert_allclose(record["mlm_accuracy"], want_acc,
                                   atol=VAL_ATOL, rtol=0)
    path = str(out / "pretraining_telemetry.jsonl")
    assert schema.validate_file(path) == jax_schema.validate_file(path) == []
    val = [json.loads(line) for line in open(path) if '"val"' in line]
    assert [(r["tag"], r["step"]) for r in val] == [("val", 3), ("val", 4)]


def test_eval_batches_cap_at_what_the_set_fills(data, tmp_path):
    """--eval_batches 16 over 32 held-out rows at batch 8: 4 batches."""
    args = run_pretraining.setup_training(run_pretraining.parse_arguments(
        _argv(data, tmp_path, "--val_input_dir", str(data / "val"),
              "--eval_batches", "16")))
    model, config = run_pretraining.prepare_model(args)
    val_loader = run_pretraining.prepare_val_loader(args, config)
    logger = run_pretraining.open_logger(args)
    try:
        run = run_pretraining.make_validation(args, model, config,
                                              val_loader, logger)
        record = run(5, 0)
    finally:
        logger.close()
    assert run.batches == 4
    assert record["step"] == 5 and np.isfinite(record["average_loss"])
    assert run_pretraining.prepare_val_loader(
        run_pretraining.setup_training(run_pretraining.parse_arguments(
            _argv(data, tmp_path))), config) is None


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"dense": {"weight": rng.standard_normal((6, 5)).astype(
                          np.float32),
                      "bias": rng.standard_normal(5).astype(np.float32)},
            "layer_norm": {"scale": rng.standard_normal(5).astype(
                               np.float32),
                           "bias": rng.standard_normal(5).astype(
                               np.float32)}}


def _flat(tree):
    return {f"{a}.{b}": v for a, sub in tree.items() for b, v in sub.items()}


@pytest.mark.parametrize("trust_clip", [None, 0.5])
def test_lamb_trust_clip_and_max_grad_norm_match_jax(trust_clip):
    """One LAMB step with max_grad_norm 0.5 (the gradients' norm is above
    it) and a trust clip of 0.5 (every leaf's ratio is above it) against
    the JAX lamb at 1e-6; the clip moves the result."""
    schedule = jax_optim.warmup_poly_schedule(1e-2, 0.5, 10)
    tx = jax_optim.lamb(schedule, weight_decay_mask=jax_optim.no_decay_mask,
                        max_grad_norm=0.5, trust_clip=trust_clip)
    params = jax.tree_util.tree_map(jnp.asarray, _opt_tree(0))
    grads = _opt_tree(1)
    updates, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                           tx.init(params), params)
    want = _flat(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(params, updates)))
    t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                for k, v in _flat(_opt_tree(0)).items()}
    mask = transforms.no_decay_mask(t_params.items())
    groups = [{"params": [p for k, p in t_params.items() if mask[k]],
               "weight_decay": 0.01},
              {"params": [p for k, p in t_params.items() if not mask[k]],
               "weight_decay": 0.0}]
    opt = transforms.Lamb(groups, schedules.warmup_poly_schedule(
        1e-2, 0.5, 10), max_grad_norm=0.5, trust_clip=trust_clip)
    for key, g in _flat(grads).items():
        t_params[key].grad = torch.from_numpy(g)
    opt.step()
    for key, value in want.items():
        np.testing.assert_allclose(t_params[key].detach().numpy(), value,
                                   atol=STEP_ATOL, rtol=0, err_msg=key)
    if trust_clip is not None:
        unclipped = jax_optim.lamb(
            schedule, weight_decay_mask=jax_optim.no_decay_mask,
            max_grad_norm=0.5)
        moved, _ = unclipped.update(
            jax.tree_util.tree_map(jnp.asarray, grads),
            unclipped.init(params), params)
        other = _flat(jax.tree_util.tree_map(
            np.asarray, optax.apply_updates(params, moved)))
        assert any(np.abs(other[k] - want[k]).max() > 1e-4 for k in want)


def _one_step(data, tmp_path, *extra):
    args = run_pretraining.setup_training(run_pretraining.parse_arguments(
        _argv(data, tmp_path, *extra)))
    model, config = run_pretraining.prepare_model(args)
    optimizer, schedule = run_pretraining.prepare_optimizer(args, model)
    loader, _ = run_pretraining.prepare_dataset(args, config)
    step = run_pretraining.make_step(args, model, optimizer, schedule, config)
    batch = next(iter(run_pretraining.pretrain.device_prefetch(
        loader, args.accumulation_steps, args.device, depth=0)))
    return args, float(step(batch)["loss"]), model


def test_runner_flags_reach_the_optimizer_and_the_model(data, tmp_path):
    """--checkpoint_activations is --remat full (one step bit for bit; an
    explicit --remat wins), and --max_grad_norm reaches LAMB."""
    a_flag, loss_flag, model_flag = _one_step(
        data, tmp_path / "a", "--checkpoint_activations",
        "--max_grad_norm", "0.25")
    a_full, loss_full, model_full = _one_step(
        data, tmp_path / "b", "--remat", "full", "--max_grad_norm", "0.25")
    assert a_flag.remat == a_full.remat == "full"
    assert model_flag.bert.encoder.remat == "full"
    assert loss_flag == loss_full
    for (name, p), q in zip(model_flag.named_parameters(),
                            model_full.parameters()):
        assert torch.equal(p, q), name
    args = run_pretraining.setup_training(run_pretraining.parse_arguments(
        _argv(data, tmp_path / "c", "--checkpoint_activations", "--remat",
              "dots", "--max_grad_norm", "0.25")))
    assert args.remat == "dots"
    optimizer, _ = run_pretraining.prepare_optimizer(
        args, run_pretraining.prepare_model(args)[0])
    assert optimizer.max_grad_norm == 0.25
    assert run_pretraining.setup_training(run_pretraining.parse_arguments(
        _argv(data, tmp_path / "d"))).remat == "none"


def test_nonfinite_fault_aborts_at_its_step(data, tmp_path):
    """--fault_spec nonfinite@2 under --sentinel_policy abort (patience
    1): the run raises at step 2, after the injected fault record and a
    sentinel record."""
    out = tmp_path / "out"
    try:
        with pytest.raises(NonFiniteError, match="last step 2"):
            run_pretraining.main(run_pretraining.parse_arguments(_argv(
                data, out, "--steps", "5", "--fault_spec", "nonfinite@2",
                "--sentinel_policy", "abort", "--sentinel_patience", "1",
                "--telemetry_sync_every", "1")))
    finally:
        faults.arm("")
    records = [json.loads(line)
               for line in open(out / "pretraining_telemetry.jsonl")]
    injected = [r for r in records if r.get("fault") == "injected_nonfinite"]
    assert [(r["step"], r["injected"]) for r in injected] == [(2, True)]
    assert [r["step"] for r in records if r.get("kind") == "sentinel"] == [2]
    assert [r["step"] for r in records if r.get("tag") == "train"] == [1]
    assert schema.validate_file(str(out / "pretraining_telemetry.jsonl")) \
        == []


def test_workers_and_prefetch_keep_the_trajectory(data, tmp_path):
    """--num_workers 2 --device_prefetch 0 against the defaults (a thread,
    prefetch 2) over an epoch boundary (48 rows, 8 a step): the same
    losses at every step; the windows carry h2d_wait <= data_wait."""
    runs = {}
    for label, extra in (("thread", ()), ("workers", (
            "--num_workers", "2", "--device_prefetch", "0"))):
        out = tmp_path / label
        runs[label] = run_pretraining.main(run_pretraining.parse_arguments(
            _argv(data, out, "--steps", "7", "--log_steps", "1",
                  "--telemetry_window", "2", "--telemetry_sync_every", "1",
                  *extra)))
        records = [json.loads(line)
                   for line in open(out / "pretraining_telemetry.jsonl")]
        runs[label]["losses"] = [r["loss"] for r in records
                                 if r.get("tag") == "train"]
        windows = [r for r in records if r.get("kind") == "step_window"]
        assert windows and all(
            w["h2d_wait_p50_s"] <= w["data_wait_p50_s"] for w in windows)
    assert len(runs["thread"]["losses"]) == 7
    assert runs["thread"]["losses"] == runs["workers"]["losses"]
