"""The port's GLUE, NER and SWAG finetuning held against the JAX package
on the CPU, and the finetune runners' checkpoints.

The same seeded files (``tools/make_synthetic_data.py``) go through both
packages' data modules, the same JAX weights (``from_jax_params``) through
both packages' heads and train steps. Tolerances: examples, features and
batches are equal exactly; head logits fp32 1e-5 (the serving heads'
bar); parameters after 3 finetune steps fp32 1e-6 (the ROADMAP gate for
optimizer steps); metrics exact (the same numpy arithmetic). Dropout is
off wherever the two packages are compared (their masks differ).
"""

import json
import os
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import run_glue as jax_run_glue
import run_ner as jax_run_ner
from bert_pytorch_tpu import models as jax_models
from bert_pytorch_tpu import optim as jax_optim
from bert_pytorch_tpu.config import BertConfig as JaxConfig
from bert_pytorch_tpu.data import glue as jax_glue
from bert_pytorch_tpu.data import swag as jax_swag
from bert_pytorch_tpu.data.ner_dataset import NERDataset as JaxNERDataset
from bert_pytorch_tpu.data.tokenization import \
    get_wordpiece_tokenizer as jax_tokenizer
from bert_pytorch_tpu.models.losses import _xent_ignore as jax_xent
from bert_pytorch_tpu.models.losses import \
    token_classification_loss as jax_token_loss
from bert_pytorch_tpu.ops.grad_utils import clip_by_global_norm
from bert_pytorch_tpu.utils import checkpoint as jax_ckpt
from bert_pytorch_tpu.utils import integrity as jax_integrity
from bert_pytorch_tpu_torch import (finetune, run_glue, run_ner,
                                    run_pretraining, run_squad, run_swag)
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.data import glue, swag
from bert_pytorch_tpu_torch.data.ner_dataset import NERDataset
from bert_pytorch_tpu_torch.data.tokenization import get_wordpiece_tokenizer
from bert_pytorch_tpu_torch.models import bert
from bert_pytorch_tpu_torch.models.convert import (from_jax_params,
                                                   to_jax_params)
from bert_pytorch_tpu_torch.optim.schedules import warmup_linear_schedule
from bert_pytorch_tpu_torch.tools import make_synthetic_data as synth
from bert_pytorch_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
STEP_ATOL = 1e-6
SEQ = 48
CONFIG = dict(vocab_size=40, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=128,
              max_position_embeddings=64, type_vocab_size=2,
              next_sentence=True, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
LABELS = list(synth.NER_LABELS)
# The finetune steps' peak lr: ten times the GLUE and SWAG recipes' 2e-5.
# Without bias correction a first Adam step moves each element by about
# 3.2 lr; where a gradient is near Adam's eps (1e-6) its fp32 summation
# order (the embedding gradient's scatter) moves it by a visible fraction
# of that: at 2e-3, 3 of SWAG's 2560 word-embedding elements end 1.7e-6
# apart after 3 steps, at 2e-4 none passes 1e-6.
LR = 2e-4


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The demo vocab, a model config naming it, and seeded MRPC, STS-B
    (the MRPC pairs scored 0-5), CoNLL and SWAG files."""
    root = tmp_path_factory.mktemp("finetune")
    vocab = synth.write_trace_vocab(str(root / "vocab.txt"))
    config = root / "model.json"
    config.write_text(json.dumps(dict(CONFIG, vocab_size=37,
                                      vocab_file=vocab,
                                      tokenizer="wordpiece")))
    mrpc = synth.write_mrpc_tsvs(str(root / "MRPC"), 0, 40, 12)
    stsb = root / "STS-B"
    stsb.mkdir()
    for name in ("train.tsv", "dev.tsv"):
        rows = open(os.path.join(mrpc, name)).read().splitlines()[1:]
        out = ["\t".join(f"c{i}" for i in range(7))
               + "\tsentence1\tsentence2\tscore"]
        for i, row in enumerate(rows):
            label, _, _, a, b = row.split("\t")
            out.append("\t".join(["x"] * 7 + [a, b, f"{(i * 7) % 50 / 10}"]))
        (stsb / name).write_text("\n".join(out) + "\n")
    return {"vocab": vocab, "config": str(config), "mrpc": mrpc,
            "sts-b": str(stsb),
            "conll": synth.write_conll(str(root / "train.txt"), 1, 30),
            "swag": synth.write_swag_csv(str(root / "train.csv"), 2, 20)}


def _tokenizers(files):
    return get_wordpiece_tokenizer(files["vocab"]), jax_tokenizer(
        files["vocab"])


def _assert_equal_arrays(ours: dict, theirs: dict):
    assert sorted(ours) == sorted(theirs)
    for key in theirs:
        assert ours[key].dtype == theirs[key].dtype, key
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


# -- data ----------------------------------------------------------------------

@pytest.mark.parametrize("task", ["mrpc", "sts-b"])
def test_glue_examples_and_features_equal_jax(files, task):
    ours_tok, jax_tok = _tokenizers(files)
    ours_p, jax_p = glue.PROCESSORS[task](), jax_glue.PROCESSORS[task]()
    for split in ("get_train_examples", "get_dev_examples"):
        ours = getattr(ours_p, split)(files[task])
        theirs = getattr(jax_p, split)(files[task])
        assert [vars(e) for e in ours] == [vars(e) for e in theirs]
        _assert_equal_arrays(
            glue.features_to_arrays(glue.convert_examples_to_features(
                ours, ours_tok, SEQ, ours_p.labels, ours_p.regression),
                ours_p.regression),
            jax_glue.features_to_arrays(jax_glue.convert_examples_to_features(
                theirs, jax_tok, SEQ, jax_p.labels, jax_p.regression),
                jax_p.regression))


def test_ner_examples_and_features_equal_jax(files):
    ours_tok, jax_tok = _tokenizers(files)
    ours = NERDataset(files["conll"], ours_tok, LABELS, SEQ)
    theirs = JaxNERDataset(files["conll"], jax_tok, LABELS, SEQ)
    assert len(ours) == len(theirs) == 30
    for i in range(len(ours)):
        assert vars(ours.samples[i]) == vars(theirs.samples[i])
        for a, b in zip(ours[i], theirs[i]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_swag_examples_and_features_equal_jax(files):
    ours_tok, jax_tok = _tokenizers(files)
    ours = swag.read_swag_examples(files["swag"])
    theirs = jax_swag.read_swag_examples(files["swag"])
    assert [vars(e) for e in ours] == [vars(e) for e in theirs]
    _assert_equal_arrays(
        swag.convert_examples_to_arrays(ours, ours_tok, SEQ),
        jax_swag.convert_examples_to_arrays(theirs, jax_tok, SEQ))


def test_batches_equal_jax(files):
    ours_tok, _ = _tokenizers(files)
    p = glue.PROCESSORS["mrpc"]()
    arrays = glue.features_to_arrays(glue.convert_examples_to_features(
        p.get_train_examples(files["mrpc"]), ours_tok, SEQ, p.labels), False)
    ours = list(finetune.batches(arrays, 16, True, np.random.default_rng(3)))
    theirs = list(jax_run_glue.batches(arrays, 16, True,
                                       np.random.default_rng(3)))
    assert len(ours) == len(theirs) == 3
    for (a, va), (b, vb) in zip(ours, theirs):
        _assert_equal_arrays(a, b)
        np.testing.assert_array_equal(va, vb)
    assert not ours[-1][1][8:].any()


# -- heads -----------------------------------------------------------------------

HEADS = {
    # name: (JAX class, port class, port head name, extra kwarg)
    "classify": (jax_models.BertForSequenceClassification,
                 bert.BertForSequenceClassification, "classify",
                 {"num_labels": 2}),
    "regression": (jax_models.BertForSequenceClassification,
                   bert.BertForSequenceClassification, "classify",
                   {"num_labels": 1}),
    "token": (jax_models.BertForTokenClassification,
              bert.BertForTokenClassification, "ner",
              {"num_labels": len(LABELS) + 1}),
    "multiple_choice": (jax_models.BertForMultipleChoice,
                        bert.BertForMultipleChoice, "multiple_choice",
                        {"num_choices": 4}),
}


def _head_pair(name: str, seed: int = 0):
    """(JAX model, its params, port model with the same weights)."""
    jax_cls, port_cls, head, kwargs = HEADS[name]
    jmodel = jax_cls(JaxConfig(**CONFIG), dtype=jnp.float32, **kwargs)
    shape = (1, 4, 16) if name == "multiple_choice" else (1, 16)
    ids = jnp.zeros(shape, jnp.int32)
    params = nn.unbox(jmodel.init(jax.random.PRNGKey(seed), ids, ids, ids))[
        "params"]
    cfg = BertConfig(**CONFIG)
    port_kwargs = ({"num_choices": 4} if name == "multiple_choice"
                   else {"num_labels": kwargs["num_labels"]})
    model = port_cls(cfg, **port_kwargs)
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), cfg, head))
    return jmodel, params, model


def _inputs(name: str, seed: int = 1):
    rng = np.random.default_rng(seed)
    shape = (3, 4, SEQ) if name == "multiple_choice" else (3, SEQ)
    ids = rng.integers(5, 37, shape).astype(np.int32)
    seg = np.zeros(shape, np.int32)
    seg[..., SEQ // 2:] = 1
    mask = np.ones(shape, np.int32)
    mask[1, ..., 30:] = 0
    return ids, seg, mask


@pytest.mark.parametrize("name", sorted(HEADS))
def test_head_logits_match_jax(name):
    jmodel, params, model = _head_pair(name)
    ids, seg, mask = _inputs(name)
    ref = jmodel.apply({"params": params}, ids, seg, mask)
    with torch.no_grad():
        out = model(*(torch.from_numpy(a).long() for a in (ids, seg, mask)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


# -- train steps -------------------------------------------------------------------

def _jax_step(jmodel, tx, loss_of, clip):
    """The JAX runners' train_step (run_glue.py / run_ner.py /
    run_swag.py): loss, grads, global-norm clip, the optimizer update."""

    def step(params, opt_state, batch, scale=None):
        def loss_fn(p):
            return loss_of(lambda *a: jmodel.apply({"params": p}, *a),
                           batch)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        grads, _ = clip_by_global_norm(grads, clip)
        updates, opt_state = tx.update(grads, opt_state, params)
        if scale is not None:  # run_ner's per-epoch lr
            updates = jax.tree_util.tree_map(lambda u: u * scale, updates)
        return optax.apply_updates(params, updates), opt_state, loss

    return jax.jit(step)


def _glue_case(files, task):
    ours_tok, _ = _tokenizers(files)
    p = glue.PROCESSORS[task]()
    arrays = glue.features_to_arrays(glue.convert_examples_to_features(
        p.get_train_examples(files[task]), ours_tok, SEQ, p.labels,
        p.regression), p.regression)
    name = "regression" if p.regression else "classify"
    jmodel, params, model = _head_pair(name, seed=4)
    total = 3
    tx = jax_optim.adamw(
        jax_optim.warmup_linear_schedule(LR, 0.1, total),
        weight_decay=0.01, bias_correction=False,
        weight_decay_mask=jax_optim.no_decay_mask)
    opt = finetune.adamw(model, warmup_linear_schedule(LR, 0.1, total),
                         0.01)
    regression = p.regression

    def loss_of(apply, bv):
        batch, valid = bv
        logits = apply(batch["input_ids"], batch["segment_ids"],
                       batch["input_mask"])
        weights = valid.astype(jnp.float32)
        if regression:
            err = (logits.squeeze(-1).astype(jnp.float32)
                   - batch["labels"]) ** 2
            return jnp.sum(err * weights) / jnp.maximum(weights.sum(), 1.0)
        return jax_xent(logits.astype(jnp.float32),
                        jnp.where(valid, batch["labels"], -1), -1)

    steps = list(finetune.batches(arrays, 16, True,
                                  np.random.default_rng(0)))[:3]
    port_step = finetune.make_train_step(
        model, opt, run_glue.loss_fn(model, regression), 1.0,
        torch.Generator().manual_seed(0))
    port_inputs = [(finetune.to_device(b, "cpu"), torch.from_numpy(v))
                   for b, v in steps]
    return (jmodel, params, tx, loss_of, 1.0, steps, model, port_step,
            port_inputs, [None] * 3, "classify")


def _ner_case(files):
    ours_tok, _ = _tokenizers(files)
    data = NERDataset(files["conll"], ours_tok, LABELS, SEQ)
    jmodel, params, model = _head_pair("token", seed=5)
    tx = jax_optim.adamw(1.0, bias_correction=False, weight_decay=0.0)
    opt = finetune.adamw(model, LR, 0.0)

    def loss_of(apply, batch):
        seqs, labels, masks = batch
        return jax_token_loss(apply(seqs, None, masks), labels)

    steps = list(jax_run_ner.batches(data, 8, True,
                                     np.random.default_rng(0)))[:3]
    ours = list(run_ner.batches(data, 8, True, np.random.default_rng(0)))[:3]
    for a, b in zip(ours, steps):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    inner = finetune.make_train_step(model, opt, run_ner.loss_fn(model), 5.0,
                                     torch.Generator().manual_seed(0))

    def port_step(seqs, labels, masks, epoch):
        lr = LR / (1.0 + 0.05 * epoch)
        opt.schedule = lambda count: lr
        return inner(seqs, labels, masks)

    port_inputs = [tuple(torch.from_numpy(a).long() for a in b) + (e,)
                   for e, b in enumerate(steps)]
    scales = [LR / (1.0 + 0.05 * e) for e in range(3)]
    return (jmodel, params, tx, loss_of, 5.0, steps, model, port_step,
            port_inputs, scales, "ner")


def _swag_case(files):
    ours_tok, _ = _tokenizers(files)
    arrays = swag.convert_examples_to_arrays(
        swag.read_swag_examples(files["swag"]), ours_tok, SEQ)
    jmodel, params, model = _head_pair("multiple_choice", seed=6)
    tx = jax_optim.adamw(jax_optim.warmup_linear_schedule(LR, 0.1, 3),
                         weight_decay=0.01, bias_correction=False,
                         weight_decay_mask=jax_optim.no_decay_mask)
    opt = finetune.adamw(model, warmup_linear_schedule(LR, 0.1, 3), 0.01)

    def loss_of(apply, bv):
        batch, valid = bv
        scores = apply(batch["input_ids"], batch["segment_ids"],
                       batch["input_mask"])
        per_ex = optax.softmax_cross_entropy_with_integer_labels(
            scores.astype(jnp.float32), batch["labels"])
        weights = valid.astype(jnp.float32)
        return jnp.sum(per_ex * weights) / jnp.maximum(weights.sum(), 1.0)

    steps = list(finetune.batches(arrays, 8, True,
                                  np.random.default_rng(0)))[:3]
    port_step = finetune.make_train_step(
        model, opt, run_swag.loss_fn(model), 1.0,
        torch.Generator().manual_seed(0))
    port_inputs = [(finetune.to_device(b, "cpu"), torch.from_numpy(v))
                   for b, v in steps]
    return (jmodel, params, tx, loss_of, 1.0, steps, model, port_step,
            port_inputs, [None] * 3, "multiple_choice")


@pytest.mark.parametrize("runner", ["glue-mrpc", "glue-sts-b", "ner",
                                    "swag"])
def test_finetune_steps_match_jax(files, runner):
    """Three steps of each runner's train step (its loss, the clip, its
    optimizer and lr rule) from the same weights on the same batches:
    losses and parameters within 1e-6 of the JAX runner's step."""
    if runner.startswith("glue"):
        case = _glue_case(files, runner[5:])
    else:
        case = {"ner": _ner_case, "swag": _swag_case}[runner](files)
    (jmodel, params, tx, loss_of, clip, steps, model, port_step, port_inputs,
     scales, head) = case
    j_step = _jax_step(jmodel, tx, loss_of, clip)
    opt_state = tx.init(params)
    for batch, inputs, scale in zip(steps, port_inputs, scales):
        params, opt_state, j_loss = j_step(params, opt_state, batch, scale)
        loss = port_step(*inputs)["loss"]
        np.testing.assert_allclose(float(loss), float(j_loss),
                                   rtol=STEP_ATOL, atol=0)
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                          BertConfig(**CONFIG), head)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   atol=STEP_ATOL, rtol=0, err_msg=name)


# -- metrics -------------------------------------------------------------------------

@pytest.mark.parametrize("task", ["mrpc", "cola", "sts-b", "sst-2",
                                  "macro_f1"])
def test_metrics_equal_jax(task):
    rng = np.random.default_rng(7)
    if task == "macro_f1":
        logits = rng.standard_normal((5, 12, 6)).astype(np.float32)
        labels = rng.integers(-100, 6, (5, 12))
        labels[labels < 0] = -100
        assert run_ner.macro_f1(logits, labels) == jax_run_ner.macro_f1(
            logits, labels)
        return
    if task == "sts-b":
        preds, labels = rng.random(30) * 5, rng.random(30) * 5
        labels[:5] = labels[5:10]  # ties for the spearman ranks
    else:
        preds, labels = rng.integers(0, 2, 30), rng.integers(0, 2, 30)
    assert glue.compute_metrics(task, preds, labels) == (
        jax_glue.compute_metrics(task, preds, labels))


# -- the runners ---------------------------------------------------------------------

def _runner_argv(runner, files, out, *extra):
    common = ["--model_config_file", files["config"], "--output_dir",
              str(out), "--device", "cpu", "--dtype", "float32",
              "--max_seq_len", str(SEQ), "--epochs", "1", *extra]
    if runner == "glue":
        return ["--task", "mrpc", "--data_dir", files["mrpc"],
                "--batch_size", "16", *common]
    if runner == "ner":
        return ["--train_file", files["conll"], "--val_file", files["conll"],
                "--test_file", files["conll"], "--labels", *LABELS,
                "--batch_size", "8", *common]
    return ["--train_file", files["swag"], "--val_file", files["swag"],
            "--batch_size", "8", *common]


MODULES = {"glue": run_glue, "ner": run_ner, "swag": run_swag}
JAX_HEADS = {"glue": (jax_models.BertForSequenceClassification,
                      {"num_labels": 2}, (1, 16), "classify"),
             "ner": (jax_models.BertForTokenClassification,
                     {"num_labels": len(LABELS) + 1}, (1, 16), "ner"),
             "swag": (jax_models.BertForMultipleChoice, {"num_choices": 4},
                      (1, 4, 16), "multiple_choice")}


@pytest.mark.parametrize("runner", ["glue", "ner", "swag"])
def test_runner_command_line_exits_zero(files, runner, tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", f"bert_pytorch_tpu_torch.run_{runner}",
         *_runner_argv(runner, files, tmp_path / "out")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert ckpt.find_resume_step(str(tmp_path / "out")) is not None


@pytest.mark.parametrize("runner", ["glue", "ner", "swag"])
def test_runner_checkpoints_load_in_jax(files, runner, tmp_path):
    """From a port pretraining checkpoint (--init_checkpoint, NER's
    --model_checkpoint): the encoder starts from it; --save_steps 1 saves
    every step and the final save lands last; the metrics are reported;
    each saved model verifies in the JAX package and its load_params_only
    gives the runner's final params exactly."""
    pre = tmp_path / "pre"
    run_pretraining.main(run_pretraining.parse_arguments([
        "--model_config_file", files["config"], "--output_dir", str(pre),
        "--global_batch_size", "8", "--local_batch_size", "8",
        "--max_steps", "1", "--device", "cpu", "--dtype", "float32",
        "--max_predictions_per_seq", "5"]),
        synth.SyntheticPretrainingDataset(0, 8, 32, 40, 5))
    init = ckpt.latest_checkpoint(str(pre / "pretrain_ckpts"))
    flag = "--model_checkpoint" if runner == "ner" else "--init_checkpoint"
    module = MODULES[runner]
    args = module.parse_arguments(_runner_argv(
        runner, files, tmp_path / "out", flag, init, "--save_steps", "1"))
    results, model, config = module.run(args)
    metric = {"glue": "accuracy", "ner": "test_f1", "swag": "accuracy"}
    assert 0.0 <= results[metric[runner]] <= 1.0
    steps = results["global_step"]
    path = ckpt.checkpoint_path(str(tmp_path / "out"), steps)
    assert ckpt.find_resume_step(str(tmp_path / "out")) == steps >= 2
    assert jax_integrity.verify_checkpoint(path)[0] == "verified"
    jax_cls, kwargs, shape, head = JAX_HEADS[runner]
    jmodel = jax_cls(JaxConfig(**CONFIG), dtype=jnp.float32, **kwargs)
    ids = jnp.zeros(shape, jnp.int32)
    target = nn.unbox(jmodel.init(jax.random.PRNGKey(0), ids, ids, ids))[
        "params"]
    loaded = jax_ckpt.load_params_only(path, target)
    mine = to_jax_params(model.state_dict(), config, head)
    for (kp, a), b in zip(jax.tree_util.tree_flatten_with_path(loaded)[0],
                          jax.tree_util.tree_leaves(mine)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=jax.tree_util.keystr(kp))
    # The port's reader gives the same, and the run started from the
    # pretraining encoder: its position embeddings were not trained far.
    back = ckpt.load_params_only(path, model.state_dict())
    for key, value in model.state_dict().items():
        assert torch.equal(back[key], value), key
    encoder = ckpt.load_params_only(init, {
        k: v for k, v in model.state_dict().items() if k.startswith("bert.")})
    key = "bert.embeddings.token_type_embeddings.weight"
    assert (model.state_dict()[key] - encoder[key]).abs().max() < 0.05


@pytest.mark.parametrize("runner", ["glue", "ner", "swag"])
def test_runner_writes_schema_clean_telemetry(files, runner, tmp_path):
    """Each finetune runner's JSONL (``<output_dir>/<runner>_telemetry
    .jsonl``) passes both packages' schemas and holds step windows (the
    checkpoint steps among them), a grad-health record per step (sync
    every 1) and the run summary; the heartbeat reaches the last step."""
    from bert_pytorch_tpu.telemetry import schema as jax_schema
    from bert_pytorch_tpu_torch.telemetry import Heartbeat
    from bert_pytorch_tpu_torch.telemetry import schema

    out = tmp_path / "out"
    results, _, _ = MODULES[runner].run(MODULES[runner].parse_arguments(
        _runner_argv(runner, files, out, "--telemetry_window", "2",
                     "--save_steps", "1")))
    steps = results["global_step"]
    path = str(out / f"{runner}_telemetry.jsonl")
    assert schema.validate_file(path) == []
    assert jax_schema.validate_file(path) == []
    kinds = {}
    for line in open(path):
        rec = json.loads(line)
        kinds.setdefault(rec["kind"], []).append(rec)
    windows = kinds["step_window"]
    assert sum(w["window_steps"] for w in windows) == steps
    assert all(w["synced_steps"] == w["window_steps"] and w["mfu"] == 0.0
               for w in windows)
    assert sum(w.get("ckpt_steps", 0) for w in windows) == steps
    health = kinds["grad_health"]
    assert [r["step"] for r in health] == list(range(1, steps + 1))
    assert all(len(r["per_layer_grad_norm"]) == CONFIG["num_hidden_layers"]
               and "bert/encoder" in r["groups"] for r in health)
    assert kinds["run_summary"][0]["steps"] == steps
    assert Heartbeat.read(str(out / "heartbeat.json"))["step"] == steps


class _DeviceReached(Exception):
    pass


@pytest.mark.parametrize("runner", ["glue", "ner", "swag"])
def test_runner_routes_the_build_directory(files, runner, tmp_path,
                                           monkeypatch):
    """--compile_cache_dir (the JAX runner's flag, default "") names the
    directory the kernel libraries and the tokenizer core are built into:
    the run sets it first, before its device and anything that loads a
    library; a run without it is back on the package's build/."""
    from bert_pytorch_tpu_torch.ops.kernels import build

    module = MODULES[runner]
    base = _runner_argv(runner, files, tmp_path / "out")
    assert module.parse_arguments(base).compile_cache_dir == ""
    seen = []

    def reached(device):
        seen.append(build.build_dir())
        raise _DeviceReached

    monkeypatch.setattr(finetune, "setup_device", reached)
    cache = tmp_path / "kernels"
    try:
        for argv in (base + ["--compile_cache_dir", str(cache)], base):
            with pytest.raises(_DeviceReached):
                module.run(module.parse_arguments(argv))
    finally:
        build.set_build_dir(None)
    assert seen == [cache.resolve(), build.BUILD_DIR]


@pytest.mark.parametrize("runner", ["glue", "ner", "swag"])
def test_runner_refuses_what_it_cannot_do(files, runner, tmp_path):
    module = MODULES[runner]
    base = _runner_argv(runner, files, tmp_path / "out")
    for flags in (["--dtype", "float16"],):
        with pytest.raises(SystemExit):
            module.parse_arguments(base + flags)
    # BPE is taken: a vocab.json with its merges.txt beside it parses; a
    # WordPiece vocab.txt or a vocab.json without its merges.txt is refused
    # by name at parsing, before any weights load.
    bpe = tmp_path / "bpe"
    bpe.mkdir()
    (bpe / "vocab.json").write_text(json.dumps({"[PAD]": 0, "a": 1}))
    with pytest.raises(FileNotFoundError, match="merges.txt"):
        module.parse_arguments(base + ["--tokenizer", "bpe", "--vocab_file",
                                       str(bpe / "vocab.json")])
    (bpe / "merges.txt").write_text("#version: 0.2\n")
    args = module.parse_arguments(base + ["--tokenizer", "bpe",
                                          "--vocab_file",
                                          str(bpe / "vocab.json")])
    assert (args.tokenizer, args.vocab_file) == ("bpe",
                                                 str(bpe / "vocab.json"))
    with pytest.raises(ValueError, match="not a vocab.json"):
        module.parse_arguments(base + ["--tokenizer", "bpe"])
    # TF checkpoints are taken (tests/test_torch_tf_checkpoint.py loads
    # one); an .index that is no checkpoint index, and a missing
    # checkpoint, are refused by name at parsing.
    flag = "--model_checkpoint" if runner == "ner" else "--init_checkpoint"
    tf_prefix = tmp_path / "bert_model.ckpt"
    (tmp_path / "bert_model.ckpt.index").write_text("")
    for path in (tf_prefix, tmp_path):
        with pytest.raises(ValueError, match="not a TF checkpoint index"):
            module.run(module.parse_arguments(base + [flag, str(path)]))
    with pytest.raises(FileNotFoundError, match="missing.msgpack"):
        module.run(module.parse_arguments(
            base + [flag, str(tmp_path / "missing.msgpack")]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            module.run(module.parse_arguments(base + ["--device", "cuda"]))


def test_squad_runner_writes_checkpoints(tmp_path):
    """run_squad without --skip_checkpoint: --save_steps 1 async saves
    keep the newest one, the final save is {model, config} at the last
    step, JAX verifies it and reads the model back equal."""
    vocab = synth.write_trace_vocab(str(tmp_path / "vocab.txt"))
    data = synth.write_squad_json(str(tmp_path / "squad.json"), 0, 1)
    cfg = tmp_path / "model.json"
    cfg.write_text(json.dumps(dict(CONFIG, vocab_size=37, vocab_file=vocab,
                                   tokenizer="wordpiece",
                                   max_position_embeddings=128)))
    out = tmp_path / "out"
    summary = run_squad.main(run_squad.parse_args([
        "--output_dir", str(out), "--config_file", str(cfg),
        "--do_lower_case", "--device", "cpu", "--dtype", "float32",
        "--max_seq_length", "128", "--doc_stride", "64", "--train_file",
        data, "--do_train", "--train_batch_size", "2", "--max_steps", "3",
        "--save_steps", "1", "--skip_cache"]))
    assert summary["global_step"] == 3
    path = ckpt.checkpoint_path(str(out), 3)
    assert ckpt.find_resume_step(str(out)) == 3
    assert sorted(p.name for p in out.glob("ckpt_*.msgpack")) == [
        "ckpt_3.msgpack"]
    assert jax_integrity.verify_checkpoint(path)[0] == "verified"
    state = jax_ckpt.load_checkpoint(path)
    assert state["config"]["hidden_size"] == 64
    wide = dict(CONFIG, max_position_embeddings=128)
    jmodel = jax_models.BertForQuestionAnswering(JaxConfig(**wide),
                                                 dtype=jnp.float32)
    ids = jnp.zeros((1, 16), jnp.int32)
    target = nn.unbox(jmodel.init(jax.random.PRNGKey(0), ids, ids, ids))[
        "params"]
    back = from_jax_params(jax.tree_util.tree_map(
        np.asarray, jax_ckpt.load_params_only(path, target)),
        BertConfig(**wide), "squad")
    assert set(back) == set(ckpt.load_params_only(path, back))


@pytest.mark.parametrize("runner", ["glue", "ner", "swag"])
def test_device_prefetch_trains_the_same_steps(files, runner, tmp_path):
    """--device_prefetch 2 (a staging thread) against 0 (inline): the same
    steps, so the same final weights bit for bit, and the windows carry
    the h2d_wait sub-phase under data_wait."""
    module = MODULES[runner]
    models = {}
    for depth in ("0", "2"):
        out = tmp_path / depth
        _, model, _ = module.run(module.parse_arguments(_runner_argv(
            runner, files, out, "--device_prefetch", depth,
            "--telemetry_window", "2")))
        models[depth] = model.state_dict()
        windows = [json.loads(line) for line in open(
            out / f"{runner}_telemetry.jsonl")
            if '"step_window"' in line]
        assert windows and all(
            w["h2d_wait_max_s"] <= w["data_wait_max_s"] for w in windows)
    assert models["0"].keys() == models["2"].keys()
    for key, value in models["0"].items():
        assert torch.equal(value, models["2"][key]), key
