"""The port's SQuAD finetuning slice held against the JAX package on the
CPU: featurization, the QA head, ``span_loss``, the finetuning optimizers
and train step, n-best decoding, torch-archive import, and the runner end
to end on a seeded synthetic SQuAD file.

Weights cross with ``from_jax_params(..., head="squad")``; inputs are numpy
arrays or files from a seed. Tolerances: features, examples and decoded
answers exactly (the same pure-Python logic); QA logits and span loss fp32
1e-5 (the serving heads' bar); optimizers and the finetune steps 1e-6 in
params (the ROADMAP gate for one optimizer step); converted state dicts
exactly. Dropout is off wherever the JAX package is compared (its masks
cannot be reproduced).
"""

import dataclasses
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

from bert_pytorch_tpu import models as jax_models
from bert_pytorch_tpu import optim as jax_optim
from bert_pytorch_tpu import squad as jax_squad
from bert_pytorch_tpu.config import BertConfig as JaxConfig
from bert_pytorch_tpu.data.tokenization import BertTokenizer as JaxTokenizer
from bert_pytorch_tpu.models import convert as jax_convert
from bert_pytorch_tpu.models import losses as jax_losses
from bert_pytorch_tpu_torch import run_squad, squad
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.data.tokenization import BertTokenizer
from bert_pytorch_tpu_torch.models import bert, losses
from bert_pytorch_tpu_torch.models.convert import (from_jax_params,
                                                   from_torch_state_dict,
                                                   load_pretrained_encoder)
from bert_pytorch_tpu_torch.optim import schedules, transforms
from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
    write_squad_json, write_trace_vocab)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
STEP_ATOL = 1e-6
CONFIG = dict(vocab_size=48, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=64,
              max_position_embeddings=128, type_vocab_size=2,
              next_sentence=True, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
S = 64


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("squad")
    vocab = write_trace_vocab(str(root / "vocab.txt"))
    return {"root": root, "vocab": vocab,
            "v1": write_squad_json(str(root / "v1.json"), 0, 2),
            "v2": write_squad_json(str(root / "v2.json"), 1, 2,
                                   version_2=True)}


def _features(module, tokenizer, path, version_2, is_training,
              max_seq_length=384, doc_stride=128):
    examples = module.read_squad_examples(path, is_training, version_2)
    return examples, module.convert_examples_to_features(
        examples, tokenizer, max_seq_length, doc_stride, 64, is_training)


@pytest.mark.parametrize("is_training", [True, False], ids=["train", "predict"])
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_examples_and_features_equal_jax(files, version, is_training):
    """Every example and every feature (tokens, maps, max-context flags,
    ids, positions) field by field, on a synthetic file whose contexts
    cut into 2-4 windows at max_seq_length 384 / doc_stride 128."""
    v2 = version == "v2"
    ours = _features(squad, BertTokenizer(files["vocab"]), files[version], v2,
                     is_training)
    ref = _features(jax_squad, JaxTokenizer(files["vocab"]), files[version],
                    v2, is_training)
    for got, want in zip(ours, ref):
        assert [dataclasses.asdict(x) for x in got] == [
            dataclasses.asdict(x) for x in want]
    examples, features = ours
    windows = np.bincount([f.example_index for f in features])
    assert windows.min() >= 2 and windows.max() <= 4
    if is_training:
        outside = [f for f in features if f.start_position == 0]
        inside = [f for f in features if f.start_position > 0]
        assert outside and inside  # windows without and with the answer
        assert all(f.tokens[f.start_position] != "[CLS]" for f in inside)
    if v2 and is_training:
        assert any(e.is_impossible for e in examples)


def test_synthetic_answers_are_real_spans(files):
    for version in ("v1", "v2"):
        with open(files[version], encoding="utf-8") as f:
            data = json.load(f)
        assert data["version"] == ("v2.0" if version == "v2" else "1.1")
        for article in data["data"]:
            for p in article["paragraphs"]:
                assert 400 <= len(p["context"].split()) <= 700
                for qa in p["qas"]:
                    for ans in qa["answers"]:
                        start = ans["answer_start"]
                        assert p["context"][start:start + len(
                            ans["text"])] == ans["text"]
                    assert bool(qa["answers"]) != qa.get("is_impossible",
                                                         False)


@pytest.fixture(scope="module")
def jax_qa_params():
    ids = jnp.zeros((1, S), jnp.int32)
    params = jax_models.BertForQuestionAnswering(
        JaxConfig(**CONFIG), dtype=jnp.float32).init(
            jax.random.PRNGKey(0), ids, ids, ids)["params"]
    return jax.tree_util.tree_map(np.asarray, nn.unbox(params))


def _qa_batch(seed=0, batch=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, CONFIG["vocab_size"], (batch, S)).astype(np.int32)
    seg = np.zeros((batch, S), np.int32)
    seg[:, 20:] = 1
    mask = np.ones((batch, S), np.int32)
    mask[1, 40:], mask[2, 25:] = 0, 0
    start = np.array([30, 0, S + 7], np.int32)[:batch]  # in, outside, clamped
    end = np.array([33, 0, 70], np.int32)[:batch]
    return {"input_ids": ids, "segment_ids": seg, "input_mask": mask,
            "start_positions": start, "end_positions": end}


def _torch_qa(params, layer_norm_backend="plain"):
    cfg = BertConfig(**CONFIG)
    model = bert.BertForQuestionAnswering(
        cfg, layer_norm_backend=layer_norm_backend)
    model.load_state_dict(from_jax_params(params, cfg, "squad"))
    return model


def _jax_logits(params, batch, dtype=jnp.float32):
    model = jax_models.BertForQuestionAnswering(JaxConfig(**CONFIG),
                                                dtype=dtype)
    return model.apply({"params": params}, *(jnp.asarray(batch[k]) for k in (
        "input_ids", "segment_ids", "input_mask")))


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v, np.int64))
            for k, v in batch.items()}


@pytest.mark.parametrize("layer_norm_backend", ["plain", "kernel"])
def test_qa_logits_match_jax(jax_qa_params, layer_norm_backend):
    batch = _qa_batch()
    j_start, j_end = _jax_logits(jax_qa_params, batch)
    t = _t(batch)
    with torch.no_grad():
        start, end = _torch_qa(jax_qa_params, layer_norm_backend)(
            t["input_ids"], t["segment_ids"], t["input_mask"])
    assert start.shape == (3, S) and start.dtype == torch.float32
    np.testing.assert_allclose(start.numpy(), np.asarray(j_start), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(end.numpy(), np.asarray(j_end), atol=ATOL,
                               rtol=0)


def test_qa_head_computes_in_fp32_on_a_bf16_encoder(jax_qa_params):
    """A bf16 model's span logits are fp32 and equal the fp32 Dense applied
    to the bf16 encoder output widened to fp32 (JAX's ``dtype=float32``
    head), not a bf16 product."""
    cfg = BertConfig(**CONFIG)
    model = bert.BertForQuestionAnswering(cfg, torch.bfloat16)
    model.load_state_dict(from_jax_params(jax_qa_params, cfg, "squad"))
    t = _t(_qa_batch())
    with torch.no_grad():
        start, end = model(t["input_ids"], t["segment_ids"], t["input_mask"])
        hidden, _ = model.bert(t["input_ids"], t["segment_ids"],
                               t["input_mask"])
    assert hidden.dtype == torch.bfloat16 and start.dtype == torch.float32
    want = torch.nn.functional.linear(hidden.float(), model.qa_outputs.weight,
                                      model.qa_outputs.bias)
    torch.testing.assert_close(torch.stack([start, end], -1), want, atol=0,
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_span_loss_matches_jax(dtype):
    """Positions inside, at 0 (a window without the answer) and past S
    (clamped to the ignored index S), on fp32 and bf16 logits."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((4, 2, S)).astype(np.float32) * 3
    start = np.array([3, 0, S + 4, S], np.int32)
    end = np.array([9, 0, S, -3], np.int32)
    j_loss = jax_losses.span_loss(
        jnp.asarray(logits[:, 0]).astype(dtype),
        jnp.asarray(logits[:, 1]).astype(dtype), jnp.asarray(start),
        jnp.asarray(end))
    t_loss = losses.span_loss(
        torch.from_numpy(logits[:, 0]).to(getattr(torch, dtype)),
        torch.from_numpy(logits[:, 1]).to(getattr(torch, dtype)),
        torch.from_numpy(start).long(), torch.from_numpy(end).long())
    assert t_loss.dtype == torch.float32
    np.testing.assert_allclose(float(t_loss), float(j_loss), atol=ATOL,
                               rtol=0)


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "dense": {"weight": rng.standard_normal((6, 5)).astype(np.float32),
                  "bias": rng.standard_normal(5).astype(np.float32)},
        "layer_norm": {"scale": rng.standard_normal(5).astype(np.float32),
                       "bias": rng.standard_normal(5).astype(np.float32)},
    }


def _flat(tree):
    return {f"{a}.{b}": v for a, sub in tree.items() for b, v in sub.items()}


@pytest.mark.parametrize("name", ["adamw_no_bias_correction", "bert_adam"])
def test_finetuning_optimizers_match_jax_after_three_steps(name):
    """AdamW without bias correction on warmup_linear (offset 0) and
    BertAdam (its schedule inside, per-tensor clipping of gradients larger
    than max_grad_norm) against the JAX transforms."""
    if name == "bert_adam":
        tx = jax_optim.bert_adam(1e-2, warmup=0.3, t_total=10,
                                 weight_decay_mask=jax_optim.no_decay_mask)
    else:
        tx = jax_optim.adamw(
            jax_optim.warmup_linear_schedule(1e-2, 0.3, 10, offset=0),
            bias_correction=False, weight_decay_mask=jax_optim.no_decay_mask)
    params = jax.tree_util.tree_map(jnp.asarray, _opt_tree(0))
    state = tx.init(params)
    t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                for k, v in _flat(_opt_tree(0)).items()}
    mask = transforms.no_decay_mask(t_params.items())
    groups = [{"params": [p for k, p in t_params.items() if mask[k]],
               "weight_decay": 0.01},
              {"params": [p for k, p in t_params.items() if not mask[k]],
               "weight_decay": 0.0}]
    opt = (transforms.BertAdam(groups, 1e-2, warmup=0.3, t_total=10)
           if name == "bert_adam" else transforms.AdamW(
               groups, schedules.warmup_linear_schedule(1e-2, 0.3, 10,
                                                        offset=0),
               bias_correction=False))
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


def test_bert_adam_schedules_and_refusals():
    p = torch.nn.Parameter(torch.ones(3))
    with pytest.raises(ValueError, match="Invalid schedule"):
        transforms.BertAdam([p], 1e-3, schedule="step")
    opt = transforms.BertAdam([p], 1e-3)  # t_total -1: a constant lr
    p.grad = torch.ones(3)
    opt.step()
    assert opt.param_groups[0]["lr"] == 1e-3
    assert opt.param_groups[0]["count"] == 1


def _run_args(tmp, files, *extra):
    return ["--output_dir", str(tmp / "out"), "--config_file",
            str(files["config"]), "--vocab_file", files["vocab"],
            "--do_lower_case", "--skip_checkpoint", "--device", "cpu",
            "--dtype", "float32", "--max_seq_length", str(S),
            "--doc_stride", "32", "--max_query_length", "16", *extra]


@pytest.fixture(scope="module")
def tiny_config(files):
    path = files["root"] / "tiny.json"
    path.write_text(json.dumps(dict(CONFIG, tokenizer="wordpiece")))
    files["config"] = path
    return files


@pytest.mark.parametrize("optimizer", ["adamw", "bert_adam"])
def test_finetune_steps_match_jax(jax_qa_params, tiny_config, tmp_path,
                                  optimizer):
    """Two fp32 steps of the runner's optimizer and train step against the
    JAX runner's step (its loss_fn, global-norm clipping on the adamw path,
    the same transform) on the same weights and batches: loss and every
    parameter within 1e-6. The first step is warmup's lr 0 (moments only),
    the second past warmup. lr 1e-4 keeps the update of the QA bias, whose
    true gradient is 0 (the span softmax sums to 1), under 1e-6: Adam
    scales its rounding noise up to the update of a real gradient's
    size."""
    lr, warmup = 1e-4, 0.1
    args = run_squad.parse_args(_run_args(
        tmp_path, tiny_config, "--train_file", tiny_config["v1"], "--do_train",
        "--optimizer", optimizer, "--learning_rate", str(lr),
        "--warmup_proportion", str(warmup)))
    total = 8
    if optimizer == "adamw":
        tx = jax_optim.adamw(
            jax_optim.warmup_linear_schedule(lr, warmup, total, offset=0),
            bias_correction=False, weight_decay_mask=jax_optim.no_decay_mask)
    else:
        tx = jax_optim.bert_adam(lr, schedule="warmup_linear", warmup=warmup,
                                 t_total=total,
                                 weight_decay_mask=jax_optim.no_decay_mask)
    model_j = jax_models.BertForQuestionAnswering(JaxConfig(**CONFIG),
                                                  dtype=jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, jax_qa_params)
    state = tx.init(params)
    model = _torch_qa(jax_qa_params)
    step = run_squad.make_train_step(
        model, run_squad.make_optimizer(args, model, total),
        args.max_grad_norm if optimizer == "adamw" else 0.0,
        torch.Generator().manual_seed(0))
    for i in range(2):
        batch = _qa_batch(seed=i)

        def loss_fn(p):
            start, end = model_j.apply({"params": p}, *(
                jnp.asarray(batch[k]) for k in ("input_ids", "segment_ids",
                                                "input_mask")))
            return jax_losses.span_loss(start, end,
                                        jnp.asarray(batch["start_positions"]),
                                        jnp.asarray(batch["end_positions"]))

        j_loss, grads = jax.value_and_grad(loss_fn)(params)
        if optimizer == "adamw":
            gnorm = optax.global_norm(grads)
            scale = jnp.minimum(1.0, args.max_grad_norm / (gnorm + 1e-6))
            grads = jax.tree_util.tree_map(lambda g: g * scale, grads)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        t_loss = step(_t(batch))["loss"]
        np.testing.assert_allclose(float(t_loss), float(j_loss), atol=ATOL,
                                   rtol=0)
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                          BertConfig(**CONFIG), "squad")
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.detach().numpy(), ref[name].numpy(),
                                   atol=STEP_ATOL, rtol=0, err_msg=name)


def _decode_args(version_2):
    class Args:
        n_best_size = 5
        max_answer_length = 10
        version_2_with_negative = version_2
        null_score_diff_threshold = 0.0
        do_lower_case = True

    return Args()


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_get_answers_equal_jax_on_the_same_logits(files, version):
    """n-best decoding with text realignment (capitalised contexts, lower
    cased tokens) from the same seeded logits: answers, n-best lists and
    null odds equal."""
    v2 = version == "v2"
    examples, features = _features(squad, BertTokenizer(files["vocab"]),
                                   files[version], v2, False)
    rng = np.random.default_rng(9)
    outs = []
    for module in (squad, jax_squad):
        results = [module.RawResult(
            f.unique_id, *rng.standard_normal((2, 384)).tolist())
            for f in features]
        rng = np.random.default_rng(9)
        outs.append(module.get_answers(examples, features, results,
                                       _decode_args(v2)))
    assert json.dumps(outs[0]) == json.dumps(outs[1])
    answers, _, null_odds = outs[0]
    assert len(answers) == len({e.qas_id for e in examples})
    assert bool(null_odds) == v2
    # realignment restores the context's capitals in some answer
    assert any(a != a.lower() for a in answers.values())


@pytest.fixture(scope="module")
def jax_pretraining_params():
    ids = jnp.zeros((1, S), jnp.int32)
    cfg = JaxConfig(**dict(CONFIG, vocab_size=45))
    params = jax_models.BertForPreTraining(cfg).init(
        jax.random.PRNGKey(1), ids, ids, ids)["params"]
    return jax.tree_util.tree_map(np.asarray, nn.unbox(params))


def test_from_torch_state_dict_equals_from_jax_params(jax_pretraining_params):
    """The JAX export (HF naming) read back under the port's names equals
    the direct conversion, with the vocab (45) zero-padded to the config's
    48; the reference naming (``dense_act``, gamma/beta LayerNorms,
    ``module.`` prefix) reads the same."""
    cfg = BertConfig(**CONFIG)
    exported = jax_convert.export_torch_state_dict(
        jax_pretraining_params, JaxConfig(**dict(CONFIG, vocab_size=45)))
    got = from_torch_state_dict(exported, cfg, "pretraining")
    padded = jax.tree_util.tree_map(lambda x: x, jax_pretraining_params)
    emb = padded["bert"]["embeddings"]["word_embeddings"]
    emb["embedding"] = np.pad(emb["embedding"], ((0, 3), (0, 0)))
    padded["predictions"]["bias"] = np.pad(padded["predictions"]["bias"],
                                           (0, 3))
    want = from_jax_params(padded, cfg, "pretraining")
    assert set(got) == set(want) == set(
        bert.BertForPreTraining(cfg).state_dict())
    for key, value in want.items():
        torch.testing.assert_close(got[key], value, atol=0, rtol=0, msg=key)
    reference = {}
    for key, value in exported.items():
        key = key.replace("intermediate.dense.", "intermediate.dense_act.")
        key = key.replace("LayerNorm.weight", "LayerNorm.gamma").replace(
            "LayerNorm.bias", "LayerNorm.beta")
        reference["module." + key] = torch.from_numpy(np.array(value))
    again = from_torch_state_dict(reference, cfg, "pretraining")
    for key, value in want.items():
        torch.testing.assert_close(again[key], value, atol=0, rtol=0, msg=key)
    qa = from_torch_state_dict(exported, cfg, "squad")
    assert set(qa) == {k for k in want if k.startswith("bert.")}
    with pytest.raises(KeyError, match="not a BERT checkpoint"):
        from_torch_state_dict({"x": torch.zeros(1)}, cfg, "squad")


def test_load_pretrained_encoder_reads_torch_archives(jax_pretraining_params,
                                                      tmp_path):
    """A .bin file and a directory with pytorch_model.bin (under the
    reference's ``{"model": ...}`` layout) put the encoder under a QA model
    and leave its head alone; TF checkpoints (a directory without
    pytorch_model.bin, a prefix with its .index file) are read when the
    .index is a checkpoint index (tests/test_torch_tf_checkpoint.py) and
    refused by name when it is not. The JAX package's msgpack checkpoints
    load: tests/test_torch_checkpoint.py."""
    cfg = BertConfig(**CONFIG)
    exported = {k: torch.from_numpy(np.array(v)) for k, v in
                jax_convert.export_torch_state_dict(
                    jax_pretraining_params,
                    JaxConfig(**dict(CONFIG, vocab_size=45))).items()}
    want = from_torch_state_dict(exported, cfg, "squad")
    (tmp_path / "archive").mkdir()
    torch.save({"model": exported}, tmp_path / "archive" / "pytorch_model.bin")
    torch.save(exported, tmp_path / "weights.bin")
    for path in (tmp_path / "weights.bin", tmp_path / "archive"):
        model = bert.init_weights(bert.BertForQuestionAnswering(cfg), 0.02,
                                  torch.Generator().manual_seed(0))
        head = model.qa_outputs.weight.detach().clone()
        load_pretrained_encoder(str(path), cfg, model)
        state = model.state_dict()
        for key, value in want.items():
            torch.testing.assert_close(state[key], value, atol=0, rtol=0)
        torch.testing.assert_close(model.qa_outputs.weight.detach(), head)
    (tmp_path / "bert_model.ckpt.index").write_bytes(b"")
    for bad in (str(tmp_path / "bert_model.ckpt"), str(tmp_path)):
        with pytest.raises(ValueError, match="bert_model.ckpt.index is not "
                                             "a TF checkpoint index"):
            load_pretrained_encoder(bad, cfg, model)
    (tmp_path / "bert_model.ckpt.index").unlink()
    with pytest.raises(FileNotFoundError, match="no pytorch_model.bin and "
                                                "no bert_model.ckpt.index"):
        load_pretrained_encoder(str(tmp_path), cfg, model)


@pytest.mark.parametrize("optimizer,version,layer_norm_backend", [
    ("adamw", "v1", "pallas"), ("bert_adam", "v2", "plain")])
def test_runner_end_to_end_on_cpu(tiny_config, tmp_path, optimizer, version,
                                  layer_norm_backend):
    """``run_squad.main`` as the CLI drives it: 2 train steps, prediction
    in full padded batches, the output files and the official eval script
    as a subprocess (v1.1 or v2.0 with its null odds); the featurization
    cache is written and read back by a second run."""
    v2 = version == "v2"
    script = "squad_evaluate_v20.py" if v2 else "squad_evaluate_v11.py"
    extra = ["--train_file", tiny_config[version], "--predict_file",
             tiny_config[version], "--do_train", "--do_predict", "--do_eval",
             "--eval_script", os.path.join(REPO, "scripts", script),
             "--train_batch_size", "4", "--predict_batch_size", "8",
             "--max_steps", "2", "--optimizer", optimizer,
             "--layer_norm_backend", layer_norm_backend,
             "--cache_dir", str(tmp_path)]
    if v2:
        extra.append("--version_2_with_negative")
    args = run_squad.parse_args(_run_args(tmp_path, tiny_config, *extra))
    summary = run_squad.main(args)
    assert summary["global_step"] == 2 and len(summary["step_losses"]) == 2
    assert all(np.isfinite(summary["step_losses"]))
    assert summary["training_sequences_per_second"] > 0
    assert 0.0 <= summary["exact_match"] <= 100.0
    assert 0.0 <= summary["F1"] <= 100.0
    out = tmp_path / "out"
    answers = json.loads((out / "predictions.json").read_text())
    examples = squad.read_squad_examples(tiny_config[version], False, v2)
    assert set(answers) == {e.qas_id for e in examples}
    assert (out / "nbest_predictions.json").exists()
    assert (out / "null_odds.json").exists() == v2
    assert json.loads((out / "squad_log.json").read_text())["F1"] == (
        summary["F1"])
    caches = sorted(p.name for p in tmp_path.glob("*.feat"))
    assert len(caches) == 2
    again = run_squad.main(run_squad.parse_args(_run_args(
        tmp_path, tiny_config, *extra)))
    assert again["predict_batches"] == summary["predict_batches"]
    # The telemetry JSONL of both runs: schema-clean in both packages, a
    # step window, a grad-health record and a train record per step.
    from bert_pytorch_tpu.telemetry import schema as jax_schema
    from bert_pytorch_tpu_torch.telemetry import schema as tschema

    path = str(out / "squad_telemetry.jsonl")
    assert tschema.validate_file(path) == jax_schema.validate_file(path) == []
    records = [json.loads(line) for line in open(path)]
    kinds = [r.get("kind", r.get("tag")) for r in records]
    assert kinds.count("grad_health") == kinds.count("run_summary") * 2 == 4
    assert kinds.count("step_window") >= 2
    assert [r["step"] for r in records if r.get("kind") == "grad_health"
            ] == [1, 2, 1, 2]


def test_runner_command_line_exits_zero(tiny_config, tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "bert_pytorch_tpu_torch.run_squad",
         *_run_args(tmp_path, tiny_config, "--train_file", tiny_config["v1"],
                    "--predict_file", tiny_config["v1"], "--do_train",
                    "--do_predict", "--train_batch_size", "4",
                    "--max_steps", "1", "--skip_cache")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert any(line.startswith("event summary")
               for line in out.stdout.splitlines())


def test_runner_refuses_what_it_cannot_do(tiny_config, tmp_path):
    base = _run_args(tmp_path, tiny_config, "--train_file",
                     tiny_config["v1"], "--do_train")
    with pytest.raises(SystemExit):
        run_squad.parse_args(base + ["--mesh_data", "1"])
    # --tokenizer bpe is taken; on the WordPiece vocab.txt it is refused by
    # name at parsing (a BPE vocab is a vocab.json with merges.txt beside).
    with pytest.raises(ValueError, match="not a vocab.json"):
        run_squad.parse_args(base + ["--tokenizer", "bpe"])
    # fp16 and its loss scale are ported (tests/test_torch_fp16.py).
    args = run_squad.parse_args(base + ["--dtype", "float16",
                                        "--init_loss_scale", "2"])
    assert (args.dtype, args.init_loss_scale) == ("float16", 2.0)
    # Checkpoints are written now: neither --skip_checkpoint nor
    # --save_steps is refused (test_torch_finetune.py checks the files).
    args = run_squad.parse_args(
        [a for a in base if a != "--skip_checkpoint"] + ["--save_steps", "10"])
    assert args.save_steps == 10 and not args.skip_checkpoint
    with pytest.raises(ValueError, match="do_train or do_predict"):
        run_squad.parse_args([a for a in base if a != "--do_train"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            run_squad.main(run_squad.parse_args(base + ["--device", "cuda"]))


def test_runner_device_prefetch_trains_the_same_steps(tiny_config, tmp_path):
    """--device_prefetch 2 against 0: the same step losses bit for bit."""
    losses = {}
    for depth in ("0", "2"):
        args = run_squad.parse_args(_run_args(
            tmp_path / depth, tiny_config, "--train_file", tiny_config["v1"],
            "--do_train", "--train_batch_size", "4", "--max_steps", "3",
            "--skip_cache", "--device_prefetch", depth))
        losses[depth] = run_squad.main(args)["step_losses"]
    assert len(losses["0"]) == 3 and losses["0"] == losses["2"]
