"""The port's pretraining path held against the JAX package on the CPU:
``BertForPreTraining`` logits, loss and grads, the optimizers and
schedules, one train step, and the runner.

Weights cross with ``from_jax_params(..., head="pretraining")``; inputs are
numpy arrays from a seed. Tolerances: logits and loss fp32 1e-5 (the
serving heads' bar); parameter grads fp32 2e-5 (a 2-layer backward sums a
few hundred products per element in another order); optimizer params
after 3 steps 1e-6; one train step 1e-6 in params, loss and grad_norm (the
ROADMAP gate); the grad-health block of that step 1e-5 relative;
schedules rtol 1e-5 (JAX computes them in fp32, the port in
float64, and the cosine decay's 1 + cos(pi + p) cancels in fp32). Dropout is off wherever the JAX package is compared (its masks
cannot be reproduced).
"""

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
from bert_pytorch_tpu.models import losses as jax_losses
from bert_pytorch_tpu_torch import pretrain, run_pretraining
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.models import bert, losses
from bert_pytorch_tpu_torch.models.convert import from_jax_params
from bert_pytorch_tpu_torch.optim import schedules, transforms

ATOL = 1e-5
GRAD_ATOL = 2e-5
STEP_ATOL = 1e-6
HEALTH_RTOL = 1e-5
CONFIG = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=64,
              max_position_embeddings=64, type_vocab_size=2,
              next_sentence=True, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
B, S, P = 3, 24, 6
BACKENDS = {"flash": "pallas", "dense": "xla"}


def _batch(packed: bool):
    rng = np.random.default_rng(0)
    ids = rng.integers(5, CONFIG["vocab_size"], (B, S)).astype(np.int32)
    seg = np.zeros((B, S), np.int32)
    seg[:, S // 2:] = 1
    mask = np.ones((B, S), np.int32)
    mask[1, 15:], mask[2, 9:] = 0, 0
    labels = np.where(rng.random((B, S)) < 0.25, ids, -1).astype(np.int32)
    labels[mask == 0] = -1
    batch = {"input_ids": ids, "segment_ids": seg, "input_mask": mask,
             "masked_lm_labels": labels,
             "next_sentence_labels": rng.integers(0, 2, B).astype(np.int32)}
    if packed:
        sids = np.zeros((B, S), np.int32)
        sids[0, :7], sids[0, 7:16], sids[0, 16:] = 1, 2, 3
        sids[1, :10], sids[1, 10:20] = 1, 2
        sids[2, :6] = 1
        batch.update(
            sequence_ids=sids,
            cls_positions=np.array([[0, 7, 16], [0, 10, 0], [0, 0, 0]],
                                   np.int32),
            next_sentence_labels=np.array([[0, 1, 1], [1, 0, -1],
                                           [0, -1, -1]], np.int32),
            input_mask=(sids != 0).astype(np.int32))
        batch["masked_lm_labels"][sids == 0] = -1
    return batch


def _positions(labels):
    is_masked = (labels != -1).astype(np.int32)
    _, pos = jax.lax.top_k(jnp.asarray(is_masked), P)
    return np.asarray(pos)


@pytest.fixture(scope="module")
def jax_params():
    ids = jnp.zeros((1, S), jnp.int32)
    params = jax_models.BertForPreTraining(JaxConfig(**CONFIG)).init(
        jax.random.PRNGKey(0), ids, ids, ids)["params"]
    return jax.tree_util.tree_map(np.asarray, nn.unbox(params))


def _torch_model(params, backend="dense", dtype=torch.float32, remat="none"):
    cfg = BertConfig(**CONFIG)
    model = bert.BertForPreTraining(cfg, dtype, backend, remat)
    model.load_state_dict(from_jax_params(params, cfg, "pretraining"))
    return model


def _jax_apply(params, backend, batch, positions):
    model = jax_models.BertForPreTraining(
        JaxConfig(**CONFIG), dtype=jnp.float32, attention_backend=backend)
    return model.apply(
        {"params": params}, *(jnp.asarray(batch[k]) for k in
                              ("input_ids", "segment_ids", "input_mask")),
        True, None if positions is None else jnp.asarray(positions),
        *(jnp.asarray(batch[k]) if k in batch else None
          for k in ("sequence_ids", "cls_positions")))


def _torch_apply(model, batch, positions):
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    return model(t["input_ids"], t["segment_ids"], t["input_mask"],
                 None if positions is None else torch.from_numpy(np.array(positions)),
                 t.get("sequence_ids"), t.get("cls_positions"))


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("backend", ["flash", "dense"])
def test_pretraining_logits_and_loss_match_jax(jax_params, backend, packed):
    batch = _batch(packed)
    positions = _positions(batch["masked_lm_labels"])
    labels = np.take_along_axis(batch["masked_lm_labels"], positions, 1)
    j_mlm, j_nsp = _jax_apply(jax_params, BACKENDS[backend], batch,
                              positions)
    with torch.no_grad():
        t_mlm, t_nsp = _torch_apply(_torch_model(jax_params, backend), batch,
                                    positions)
    assert t_mlm.shape == (B, P, CONFIG["vocab_size"])
    np.testing.assert_allclose(t_mlm.numpy(), np.asarray(j_mlm), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(t_nsp.numpy(), np.asarray(j_nsp), atol=ATOL,
                               rtol=0)
    j_loss = jax_losses.pretraining_loss(
        j_mlm, j_nsp, jnp.asarray(labels),
        jnp.asarray(batch["next_sentence_labels"]))
    t_loss = losses.pretraining_loss(
        t_mlm, t_nsp, torch.from_numpy(labels),
        torch.from_numpy(batch["next_sentence_labels"]))
    np.testing.assert_allclose(float(t_loss), float(j_loss), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(
        float(losses.mlm_accuracy(t_mlm, torch.from_numpy(labels))),
        float(jax_losses.mlm_accuracy(j_mlm, jnp.asarray(labels))),
        atol=1e-7)


@pytest.mark.parametrize("backend,packed", [("flash", True),
                                            ("dense", False)])
def test_pretraining_param_grads_match_jax(jax_params, backend, packed):
    batch = _batch(packed)
    positions = _positions(batch["masked_lm_labels"])
    labels = np.take_along_axis(batch["masked_lm_labels"], positions, 1)

    def loss_fn(params):
        mlm, nsp = _jax_apply(params, BACKENDS[backend], batch, positions)
        return jax_losses.pretraining_loss(
            mlm, nsp, jnp.asarray(labels),
            jnp.asarray(batch["next_sentence_labels"]))

    j_grads = from_jax_params(
        jax.tree_util.tree_map(np.asarray, jax.grad(loss_fn)(jax_params)),
        BertConfig(**CONFIG), "pretraining")
    model = _torch_model(jax_params, backend)
    mlm, nsp = _torch_apply(model, batch, positions)
    losses.pretraining_loss(
        mlm, nsp, torch.from_numpy(labels),
        torch.from_numpy(batch["next_sentence_labels"])).backward()
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(), j_grads[name].numpy(),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)


def test_from_jax_params_maps_the_pretraining_head(jax_params):
    cfg = BertConfig(**CONFIG)
    state = from_jax_params(jax_params, cfg, "pretraining")
    model = bert.BertForPreTraining(cfg)
    assert set(state) == set(model.state_dict())
    np.testing.assert_array_equal(state["seq_relationship.weight"].numpy(),
                                  jax_params["seq_relationship"]["kernel"].T)
    with pytest.raises(KeyError, match="seq_relationship"):
        from_jax_params({k: v for k, v in jax_params.items()
                         if k != "seq_relationship"}, cfg, "pretraining")


def test_bf16_backward_reaches_every_parameter():
    """The repaired cast cache: a bf16 training forward casts with autograd,
    so every fp32 master parameter gets a finite, non-zero gradient."""
    cfg = BertConfig(**CONFIG)
    model = bert.init_weights(
        bert.BertForPreTraining(cfg, torch.bfloat16, "flash", "dots"), 0.2,
        torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(False).items()}
    loss, _ = pretrain.pretraining_loss_and_accuracy(
        model, batch, True, P, bert.draw_dropout_seeds(
            torch.Generator().manual_seed(1), cfg.num_hidden_layers))
    loss.backward()
    for name, param in model.named_parameters():
        assert param.dtype == torch.float32, name
        assert param.grad is not None, name
        assert torch.isfinite(param.grad).all(), name
        assert param.grad.abs().sum() > 0, name


def test_serving_forward_still_uses_the_cast_cache():
    cfg = BertConfig(**CONFIG)
    model = bert.init_weights(bert.BertForPreTraining(cfg, torch.bfloat16),
                              0.2, torch.Generator().manual_seed(0))
    dense = model.bert.encoder.layers[0].attention.query
    ids = torch.randint(5, 100, (2, 8))
    with torch.no_grad():
        model(ids)
        cached = dense._cast._values
        model(ids)
        assert cached is not None and dense._cast._values is cached
        weight, _ = dense._cast.get((dense.weight, dense.bias), dense.dtype)
    assert weight is cached[0] and weight.dtype == torch.bfloat16
    live, _ = dense._cast.get((dense.weight, dense.bias), dense.dtype)
    assert live.requires_grad and live is not cached[0]


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_replays_the_dropout_masks(remat):
    """Under remat the recomputed layers draw the masks the first forward
    drew: the grads equal those of the same model without remat."""
    cfg = BertConfig(**dict(CONFIG, hidden_dropout_prob=0.1,
                            attention_probs_dropout_prob=0.1))
    batch = {k: torch.from_numpy(v) for k, v in _batch(False).items()}
    grads = {}
    for mode in ("none", remat):
        model = bert.init_weights(
            bert.BertForPreTraining(cfg, torch.float32, "flash", mode), 0.2,
            torch.Generator().manual_seed(0))
        seeds = bert.draw_dropout_seeds(torch.Generator().manual_seed(3),
                                        cfg.num_hidden_layers)
        loss, _ = pretrain.pretraining_loss_and_accuracy(model, batch, True,
                                                         P, seeds)
        loss.backward()
        grads[mode] = {n: p.grad for n, p in model.named_parameters()}
    for name, grad in grads["none"].items():
        torch.testing.assert_close(grads[remat][name], grad, atol=1e-6,
                                   rtol=0, msg=name)


def test_mlm_positions_keep_the_lowest_index_first():
    labels = torch.tensor([[-1, 5, -1, 7, 8, -1, -1, 9],
                           [-1, -1, -1, -1, -1, -1, 3, -1]])
    got, pos = pretrain._mlm_positions(labels, 3)
    ref_pos = np.asarray(jax.lax.top_k(
        jnp.asarray((labels.numpy() != -1).astype(np.int32)), 3)[1])
    np.testing.assert_array_equal(pos.numpy(), ref_pos)
    assert got.tolist() == [[5, 7, 8], [3, -1, -1]]
    assert pretrain._mlm_positions(labels, 8)[1] is None


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "dense": {"weight": rng.standard_normal((6, 5)).astype(np.float32),
                  "bias": rng.standard_normal(5).astype(np.float32)},
        "layer_norm": {"scale": rng.standard_normal(5).astype(np.float32),
                       "bias": rng.standard_normal(5).astype(np.float32)},
        "zero": {"weight": np.zeros((3, 2), np.float32)},
    }


def _flat(tree):
    return {f"{a}.{b}": v for a, sub in tree.items() for b, v in sub.items()}


@pytest.mark.parametrize("name", ["lamb", "adamw"])
def test_optimizers_match_jax_after_three_steps(name):
    schedule = jax_optim.warmup_poly_schedule(1e-2, 0.5, 10)
    if name == "lamb":
        tx = jax_optim.lamb(schedule, weight_decay_mask=jax_optim.no_decay_mask,
                            max_grad_norm=1.0)
    else:
        tx = jax_optim.adamw(schedule, weight_decay_mask=jax_optim.no_decay_mask)
    params = jax.tree_util.tree_map(jnp.asarray, _opt_tree(0))
    state = tx.init(params)
    t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                for k, v in _flat(_opt_tree(0)).items()}
    mask = transforms.no_decay_mask(t_params.items())
    groups = [{"params": [p for k, p in t_params.items() if mask[k]],
               "weight_decay": 0.01},
              {"params": [p for k, p in t_params.items() if not mask[k]],
               "weight_decay": 0.0}]
    t_schedule = schedules.warmup_poly_schedule(1e-2, 0.5, 10)
    opt = (transforms.Lamb(groups, t_schedule, max_grad_norm=1.0)
           if name == "lamb" else transforms.AdamW(groups, t_schedule))
    for step in range(3):
        grads = _opt_tree(10 + step)
        updates, state = tx.update(
            jax.tree_util.tree_map(lambda g: jnp.asarray(g) * 3.0, grads),
            state, params)
        params = optax.apply_updates(params, updates)
        for key, g in _flat(grads).items():
            t_params[key].grad = torch.from_numpy(g * 3.0)
        opt.step()
    for key, value in _flat(jax.tree_util.tree_map(np.asarray,
                                                   params)).items():
        np.testing.assert_allclose(t_params[key].detach().numpy(), value,
                                   atol=STEP_ATOL, rtol=0, err_msg=key)
    assert all(g["count"] == 3 for g in opt.param_groups)
    transforms.reset_count(opt, 7)
    assert [g["count"] for g in opt.param_groups] == [7, 7]


@pytest.mark.parametrize("name", sorted(schedules.SCHEDULES) + ["exp"])
def test_schedules_match_jax(name):
    counts = [0, 1, 5, 29, 30, 31, 99, 150, 299, 300, 450]
    if name == "exp":
        ours = schedules.warmup_exp_decay_exp_schedule(1e-3, 0.5, 50, 300,
                                                       warmup=0.1)
        ref = jax_optim.warmup_exp_decay_exp_schedule(1e-3, 0.5, 50, 300,
                                                      warmup=0.1)
    else:
        ours = schedules.make_schedule(name, 1e-3, 0.1, 300)
        ref = jax_optim.make_schedule(name, 1e-3, 0.1, 300)
    np.testing.assert_allclose([ours(c) for c in counts],
                               [float(ref(jnp.asarray(c))) for c in counts],
                               rtol=1e-5, atol=1e-12)
    with pytest.raises(ValueError, match="Unknown lr decay"):
        schedules.make_schedule("step", 1e-3, 0.1, 300)


def test_no_decay_set_matches_jax(jax_params):
    """Decay flags by name: JAX's mask tree broadcast to each leaf, carried
    through from_jax_params, equals the port's no_decay_mask."""
    mask_tree = jax_optim.no_decay_mask(jax_params)
    flags = jax.tree_util.tree_map(
        lambda p, m: np.full(np.shape(p), float(m), np.float32),
        jax_params, mask_tree)
    ref = {name: bool(t.min() == 1.0) for name, t in from_jax_params(
        flags, BertConfig(**CONFIG), "pretraining").items()}
    model = bert.BertForPreTraining(BertConfig(**CONFIG))
    assert transforms.no_decay_mask(model.named_parameters()) == ref
    assert not ref["bert.embeddings.layer_norm.scale"]
    assert ref["bert.encoder.layers.0.attention.query.weight"]


def test_train_step_matches_jax():
    """One fp32 step, A=2 microbatches, dropout off: params, loss and
    grad_norm against the JAX make_train_step within 1e-6."""
    cfg = JaxConfig(**CONFIG)
    model = jax_models.BertForPreTraining(cfg, dtype=jnp.float32)
    ids = jnp.zeros((1, S), jnp.int32)
    params = nn.unbox(model.init(jax.random.PRNGKey(1), ids, ids, ids))[
        "params"]
    schedule = jax_optim.warmup_poly_schedule(4e-3, 0.128, 100)
    tx = jax_optim.lamb(schedule, weight_decay_mask=jax_optim.no_decay_mask)
    state = jax_pretrain.TrainState(params=params, opt_state=tx.init(params),
                                    rng=jax.random.PRNGKey(2))
    rows = [_batch(False) for _ in range(2)]
    rows[1] = {k: np.roll(v, 1, axis=0) for k, v in rows[1].items()}
    host = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
    step = jax_pretrain.make_train_step(model, tx, schedule=schedule,
                                        next_sentence=True,
                                        max_pred_per_seq=P, stats_every=1)
    j_batch = jax_pretrain.stack_microbatches(host, 2)
    t_model = _torch_model(jax.tree_util.tree_map(np.asarray, params))
    state, j_metrics = step(state, j_batch)

    t_schedule = schedules.warmup_poly_schedule(4e-3, 0.128, 100)
    opt = transforms.Lamb(transforms.param_groups(t_model, 0.01), t_schedule)
    t_step = pretrain.make_train_step(t_model, opt, t_schedule, True, P,
                                      stats_every=1)
    metrics = t_step(pretrain.to_device(j_batch, "cpu"))
    for key in ("loss", "grad_norm", "mlm_accuracy", "learning_rate",
                "real_tokens", "finite"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(j_metrics[key]), rtol=STEP_ATOL,
                                   atol=0, err_msg=key)
    # The grad-health block on the same weights and batch: the JAX group
    # keys, every norm and ratio within HEALTH_RTOL.
    from bert_pytorch_tpu.telemetry import model_stats as jax_stats
    from bert_pytorch_tpu_torch.telemetry import model_stats

    got = model_stats.health_record(1, metrics["grad_health"])
    want = jax_stats.health_record(1, j_metrics["grad_health"])
    assert set(got["groups"]) == set(want["groups"]) >= {
        "bert/encoder", "bert/embeddings", "bert/pooler", "predictions"}
    assert len(got["per_layer_grad_norm"]) == CONFIG["num_hidden_layers"]
    np.testing.assert_allclose(got["per_layer_grad_norm"],
                               want["per_layer_grad_norm"],
                               rtol=HEALTH_RTOL)
    for key in ("grad_norm", "param_norm", "update_ratio"):
        np.testing.assert_allclose(got[key], want[key], rtol=HEALTH_RTOL,
                                   err_msg=key)
        for name in want["groups"]:
            np.testing.assert_allclose(
                got["groups"][name][key], want["groups"][name][key],
                rtol=HEALTH_RTOL, err_msg=f"{name} {key}")
    assert got["update_ratio"] > 0
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, state.params),
                          BertConfig(**CONFIG), "pretraining")
    for name, param in t_model.named_parameters():
        np.testing.assert_allclose(param.detach().numpy(), ref[name].numpy(),
                                   atol=STEP_ATOL, rtol=0, err_msg=name)


def test_eval_step_and_stack_microbatches():
    host = _batch(True)
    stacked = pretrain.stack_microbatches(
        {k: np.concatenate([v, v]) for k, v in host.items()}, 2)
    assert stacked["input_ids"].shape == (2, B, S)
    assert stacked["cls_positions"].shape == (2, B, 3)
    with pytest.raises(ValueError, match="divisible"):
        pretrain.stack_microbatches(host, 2)
    model = bert.init_weights(bert.BertForPreTraining(BertConfig(**CONFIG)),
                              0.02, torch.Generator().manual_seed(0))
    loss, acc = pretrain.make_eval_step(model)(
        pretrain.to_device(host, "cpu"))
    assert np.isfinite(float(loss)) and 0.0 <= float(acc) <= 1.0


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    from bert_pytorch_tpu.tools.make_synthetic_data import make_shard

    root = tmp_path_factory.mktemp("pretrain_shards")
    for s in range(2):
        make_shard(str(root / f"shard_{s}.hdf5"), 16, 32, 128, seed=s)
    config = root / "tiny.json"
    config.write_text(json.dumps(dict(CONFIG, vocab_size=125,
                                      max_position_embeddings=32)))
    return root, config


def _run_args(shards, *extra):
    """A run of its own output directory (a run resumes from the
    checkpoints it finds there)."""
    import tempfile

    root, config = shards
    return ["--model_config_file", str(config), "--input_dir", str(root),
            "--output_dir", tempfile.mkdtemp(dir=root),
            "--global_batch_size", "8", "--local_batch_size", "4",
            "--max_steps", "50", "--device", "cpu", "--skip_final_checkpoint",
            *extra]


@pytest.mark.parametrize("extra", [
    ("--dtype", "float32", "--remat", "none"),
    ("--dtype", "bfloat16", "--remat", "dots", "--attention_backend",
     "flash", "--pack_sequences", "--optimizer", "adamw"),
], ids=["fp32", "bf16-flash-packed"])
def test_runner_cpu_run(shards, capsys, extra):
    args = run_pretraining.parse_arguments(
        _run_args(shards, "--steps", "3", *extra))
    summary = run_pretraining.main(args)
    assert summary["step"] == 3 and summary["finite"] == 1.0
    assert np.isfinite(summary["loss"]) and summary["seq_per_s"] > 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("event start")
    assert [line.split()[1] for line in lines[1:]] == ["1", "2", "3"]
    assert all("learning_rate" in line and "seq_per_s" in line
               for line in lines[1:])


def test_runner_command_line_exits_zero(shards):
    """``python -m bert_pytorch_tpu_torch.run_pretraining`` as a user runs
    it: 3 fp32 steps on the CPU, rc 0, a finite loss on every step."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "bert_pytorch_tpu_torch.run_pretraining",
         *_run_args(shards, "--steps", "3", "--dtype", "float32")],
        cwd=repo, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    steps = [line for line in out.stdout.splitlines()
             if line.startswith("step ")]
    assert len(steps) == 3 and all(" finite 1 " in line for line in steps)


@pytest.mark.parametrize("phase", [1, 2])
def test_runner_takes_the_recipe_config_files(shards, phase):
    args = run_pretraining.parse_arguments(_run_args(
        shards, "--config_file",
        f"configs/bert_pretraining_phase{phase}_config.json", "--steps", "2",
        "--max_steps", "10"))
    args = run_pretraining.setup_training(args)
    assert args.remat == "dots" and args.max_steps == 10
    assert args.attention_backend == ("flash" if phase == 2 else "auto")
    assert args.accumulation_steps == 2  # the CLI batch sizes win


def test_runner_refuses_what_it_cannot_do(shards):
    for flags in (("--rng_impl", "rbg"), ("--mesh_data", "2"),
                  ("--compile_cache_dir", "x")):
        with pytest.raises(SystemExit):
            run_pretraining.parse_arguments(_run_args(shards, *flags))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        run_pretraining.setup_training(run_pretraining.parse_arguments(
            _run_args(shards, "--checkpoint_layout", "sharded")))
    # K-FAC is ported: --kfac is accepted, with the JAX runner's defaults.
    args = run_pretraining.setup_training(run_pretraining.parse_arguments(
        _run_args(shards, "--kfac")))
    assert (args.kfac, args.kfac_factor_interval, args.kfac_inv_interval,
            args.kfac_capture, args.kfac_inv_method) == (
        True, 10, 100, "train", "cholesky")
    # Checkpoints are written now: a run past --num_steps_per_checkpoint
    # with a final save is not refused; it needs somewhere to write them.
    args = run_pretraining.setup_training(run_pretraining.parse_arguments(
        [a for a in _run_args(shards, "--steps", "200")
         if a != "--skip_final_checkpoint"]))
    assert args.model_output_dir.endswith("pretrain_ckpts")
    argv = _run_args(shards)
    at = argv.index("--output_dir")
    with pytest.raises(ValueError, match="output_dir"):
        run_pretraining.setup_training(run_pretraining.parse_arguments(
            argv[:at] + argv[at + 2:]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            run_pretraining.setup_training(run_pretraining.parse_arguments(
                _run_args(shards, "--steps", "2", "--device", "cuda")))
