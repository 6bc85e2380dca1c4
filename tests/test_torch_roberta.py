"""The RoBERTa shape (no NSP: no token-type table, no pooler in
pretraining, the MLM loss alone) held against the JAX package on the CPU,
on a byte-level BPE vocab the port's ``build_vocab`` trains on seeded
synthetic text; and the pretraining runner's mask id against the JAX
runner's.

Weights cross with ``from_jax_params``. Tolerances: MLM logits and loss
fp32 1e-5; one LAMB step 1e-6 (params, loss, grad_norm); GLUE classify
logits 1e-5; the serving engine's fill_mask top-k equal (ids and tokens;
scores 1e-5). The JAX package builds no classifier on a config without
NSP (its head reads the pooled vector that config lacks), while the port
gives such a classifier its own fresh pooler: the JAX oracle for it is the
same model on an NSP config whose token-type table is zero (adding a zero
row changes nothing).
"""

import json
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import run_pretraining as jax_run_pretraining
from bert_pytorch_tpu import models as jax_models
from bert_pytorch_tpu import optim as jax_optim
from bert_pytorch_tpu import pretrain as jax_pretrain
from bert_pytorch_tpu.config import BertConfig as JaxConfig
from bert_pytorch_tpu.data import glue as jax_glue
from bert_pytorch_tpu.data.tokenization import \
    get_bpe_tokenizer as jax_bpe_tokenizer
from bert_pytorch_tpu.models import losses as jax_losses
from bert_pytorch_tpu.serve import InferenceEngine as JaxEngine
from bert_pytorch_tpu_torch import pretrain, run_pretraining, run_server
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.data import glue
from bert_pytorch_tpu_torch.data.tokenization import get_bpe_tokenizer
from bert_pytorch_tpu_torch.models import bert, losses
from bert_pytorch_tpu_torch.models.convert import from_jax_params
from bert_pytorch_tpu_torch.optim import schedules, transforms
from bert_pytorch_tpu_torch.serve import InferenceEngine
from bert_pytorch_tpu_torch.tools import build_vocab, make_synthetic_text
from bert_pytorch_tpu_torch.tools import make_synthetic_data as synth

ATOL = 1e-5
STEP_ATOL = 1e-6
B, S, P = 3, 32, 6
SHAPE = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=64, max_position_embeddings=64,
             type_vocab_size=2, next_sentence=False, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0)
FILL_MASK = [{"text": "the capital of [MASK] is arveth."},
             {"text": "sailors tell [MASK] about the storms", "top_k": 3},
             {"text": "[MASK] founded the city of [MASK] long ago."}]


@pytest.fixture(scope="module")
def bpe(tmp_path_factory):
    """(vocab.json, config dict): a cased byte-level BPE trained by the
    port's build_vocab on seeded synthetic text, and the RoBERTa-shaped
    config over it (vocab padded to a multiple of 8)."""
    root = tmp_path_factory.mktemp("roberta")
    corpus = make_synthetic_text.write_corpus(str(root / "text"), 2, 30, 0)
    vocab_json = build_vocab.main([
        "--input_glob", str(root / "text" / "*.txt"), "--tokenizer", "bpe",
        "--output", str(root / "vocab"), "--vocab_size", "400",
        "--uppercase"])
    size = len(json.load(open(vocab_json)))
    config = dict(SHAPE, vocab_size=size + (8 - size % 8) % 8,
                  tokenizer="bpe", lowercase=False, vocab_file=vocab_json)
    return {"vocab": vocab_json, "config": config, "corpus": corpus}


@pytest.fixture(scope="module")
def jax_params(bpe):
    ids = jnp.zeros((1, S), jnp.int32)
    # jit: one compile of the init, 5x faster than flax's op-by-op init.
    params = jax.jit(jax_models.BertForPreTraining(
        JaxConfig.from_dict(bpe["config"])).init)(
        jax.random.PRNGKey(4), ids, ids, ids)["params"]
    return jax.tree_util.tree_map(np.asarray, nn.unbox(params))


def _batch(bpe, seed=0):
    """B rows of BPE-encoded corpus sentences, [CLS] x [SEP], padded to
    S, a quarter of the real tokens labelled."""
    tok = get_bpe_tokenizer(bpe["vocab"], uppercase=True)
    lines = [line for line in open(bpe["corpus"][0]).read().splitlines()
             if line]
    rng = np.random.default_rng(seed)
    ids = np.zeros((B, S), np.int32)
    mask = np.zeros((B, S), np.int32)
    for row in range(B):
        enc = tok.encode(" ".join(lines[rng.integers(len(lines))]
                                  for _ in range(2))).ids[:S - 2 - row * 5]
        seq = [tok.token_to_id("[CLS]")] + enc + [tok.token_to_id("[SEP]")]
        ids[row, :len(seq)], mask[row, :len(seq)] = seq, 1
    labels = np.where((rng.random((B, S)) < 0.25) & (mask == 1), ids,
                      -1).astype(np.int32)
    return {"input_ids": ids, "segment_ids": np.zeros((B, S), np.int32),
            "input_mask": mask, "masked_lm_labels": labels,
            "next_sentence_labels": np.zeros((B,), np.int32)}


def _positions(labels):
    _, pos = jax.lax.top_k(jnp.asarray((labels != -1).astype(np.int32)), P)
    return np.asarray(pos)


def _port_model(bpe, params):
    cfg = BertConfig.from_dict(bpe["config"])
    model = bert.BertForPreTraining(cfg)
    model.load_state_dict(from_jax_params(params, cfg, "pretraining"))
    return model


def test_no_nsp_model_has_no_token_type_table_and_no_pooler(bpe, jax_params):
    assert "token_type_embeddings" not in jax_params["bert"]["embeddings"]
    assert "pooler" not in jax_params["bert"]
    state = _port_model(bpe, jax_params).state_dict()
    assert not any("token_type" in k or "pooler" in k
                   or "seq_relationship" in k for k in state)


def test_mlm_logits_and_loss_match_jax(bpe, jax_params):
    batch = _batch(bpe)
    positions = _positions(batch["masked_lm_labels"])
    labels = np.take_along_axis(batch["masked_lm_labels"], positions, 1)
    model = jax_models.BertForPreTraining(
        JaxConfig.from_dict(bpe["config"]), dtype=jnp.float32)
    j_mlm, j_nsp = jax.jit(lambda p, *a: model.apply({"params": p}, *a[:3],
                                                     True, a[3]))(
        jax_params, *(jnp.asarray(batch[k]) for k in
                      ("input_ids", "segment_ids", "input_mask")),
        jnp.asarray(positions))
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        t_mlm, t_nsp = _port_model(bpe, jax_params)(
            t["input_ids"], t["segment_ids"], t["input_mask"],
            torch.from_numpy(positions))
    assert j_nsp is None and t_nsp is None
    np.testing.assert_allclose(t_mlm.numpy(), np.asarray(j_mlm), atol=ATOL,
                               rtol=0)
    j_loss = jax_losses.pretraining_loss(j_mlm, None, jnp.asarray(labels))
    t_loss = losses.pretraining_loss(t_mlm, None, torch.from_numpy(labels))
    np.testing.assert_allclose(float(t_loss), float(j_loss), atol=ATOL,
                               rtol=0)


def test_one_lamb_step_matches_jax(bpe, jax_params):
    """A=2 microbatches, MLM loss only: params, loss and grad_norm within
    1e-6 of the JAX make_train_step with next_sentence=False."""
    cfg = JaxConfig.from_dict(bpe["config"])
    model = jax_models.BertForPreTraining(cfg, dtype=jnp.float32)
    schedule = jax_optim.warmup_poly_schedule(4e-3, 0.128, 100)
    tx = jax_optim.lamb(schedule, weight_decay_mask=jax_optim.no_decay_mask)
    state = jax_pretrain.TrainState(params=jax_params,
                                    opt_state=tx.init(jax_params),
                                    rng=jax.random.PRNGKey(2))
    rows = [_batch(bpe, seed) for seed in (1, 2)]
    host = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
    j_batch = jax_pretrain.stack_microbatches(host, 2)
    step = jax_pretrain.make_train_step(model, tx, schedule=schedule,
                                        next_sentence=False,
                                        max_pred_per_seq=P)
    t_model = _port_model(bpe, jax_params)
    state, j_metrics = step(state, j_batch)
    t_schedule = schedules.warmup_poly_schedule(4e-3, 0.128, 100)
    opt = transforms.Lamb(transforms.param_groups(t_model, 0.01), t_schedule)
    t_step = pretrain.make_train_step(t_model, opt, t_schedule, False, P)
    metrics = t_step(pretrain.to_device(j_batch, "cpu"))
    for key in ("loss", "grad_norm", "learning_rate"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(j_metrics[key]), rtol=STEP_ATOL,
                                   atol=0, err_msg=key)
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, state.params),
                          BertConfig.from_dict(bpe["config"]), "pretraining")
    for name, param in t_model.named_parameters():
        np.testing.assert_allclose(param.detach().numpy(), ref[name].numpy(),
                                   atol=STEP_ATOL, rtol=0, err_msg=name)


def test_glue_classify_logits_match_jax(bpe, tmp_path):
    """MRPC rows featurized by both packages on the BPE vocab (equal
    arrays), then the port's no-NSP classifier against the JAX one on the
    NSP config with a zero token-type table, within 1e-5."""
    mrpc = synth.write_mrpc_tsvs(str(tmp_path / "MRPC"), 3, 8, 4)
    ours_p, jax_p = glue.PROCESSORS["mrpc"](), jax_glue.PROCESSORS["mrpc"]()
    arrays = glue.features_to_arrays(glue.convert_examples_to_features(
        ours_p.get_dev_examples(mrpc),
        get_bpe_tokenizer(bpe["vocab"], uppercase=True), S, ours_p.labels,
        False), False)
    theirs = jax_glue.features_to_arrays(jax_glue.convert_examples_to_features(
        jax_p.get_dev_examples(mrpc),
        jax_bpe_tokenizer(bpe["vocab"], uppercase=True), S, jax_p.labels,
        False), False)
    assert sorted(arrays) == sorted(theirs)
    for key in theirs:
        np.testing.assert_array_equal(arrays[key], theirs[key], err_msg=key)
    nsp = JaxConfig.from_dict(dict(bpe["config"], next_sentence=True))
    jax_model = jax_models.BertForSequenceClassification(
        nsp, num_labels=2, dtype=jnp.float32)
    ids = jnp.zeros((1, S), jnp.int32)
    params = jax.tree_util.tree_map(np.asarray, nn.unbox(jax.jit(
        jax_model.init)(jax.random.PRNGKey(5), ids, ids, ids)["params"]))
    table = params["bert"]["embeddings"]["token_type_embeddings"]
    table["embedding"] = np.zeros_like(table["embedding"])
    want = jax.jit(jax_model.apply)(
        {"params": params}, *(jnp.asarray(arrays[k]) for k in
                              ("input_ids", "segment_ids", "input_mask")))
    cfg = BertConfig.from_dict(bpe["config"])
    state = from_jax_params(params, cfg, "classify")
    del state["bert.embeddings.token_type_embeddings.weight"]
    model = bert.BertForSequenceClassification(cfg, 2)
    model.load_state_dict(state)
    t = {k: torch.from_numpy(v).long() for k, v in arrays.items()}
    with torch.no_grad():
        got = model(t["input_ids"], t["segment_ids"], t["input_mask"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_fill_mask_top_k_matches_the_jax_engine(bpe):
    """The JAX engine and the port's on the RoBERTa shape and the BPE
    vocab, the same fill_mask weights: equal top-k ids and BPE tokens,
    scores within 1e-5. The [MASK] literal is split out of the text and
    the tokenizer's [MASK] id inserted (byte-level BPE would shred it)."""
    jax_cfg = JaxConfig.from_dict(bpe["config"])
    jax_engine = JaxEngine(jax_cfg, jax_bpe_tokenizer(bpe["vocab"],
                                                      uppercase=True),
                           {"fill_mask": {}}, buckets=(32,),
                           max_batch_size=2, dtype=jnp.float32, seed=7,
                           attention_backend="xla")
    cfg = BertConfig.from_dict(bpe["config"])
    weights = from_jax_params(jax.tree_util.tree_map(
        np.asarray, jax_engine.tasks["fill_mask"].params), cfg, "fill_mask")
    engine = InferenceEngine(cfg, get_bpe_tokenizer(bpe["vocab"],
                                                    uppercase=True),
                             {"fill_mask": {"weights": weights}},
                             buckets=(32,), max_batch_size=2,
                             dtype=torch.float32,
                             attention_backend="flash_infer", device="cpu")
    mask_id = engine.tasks["fill_mask"].handler.tokenizer.token_to_id(
        "[MASK]")
    for payload in FILL_MASK:
        ours = engine.run_direct("fill_mask", payload)
        ref = jax_engine.run_direct("fill_mask", payload)
        features = engine.tasks["fill_mask"].handler.prepare(payload, 64)
        assert features["input_ids"].count(mask_id) == payload[
            "text"].count("[MASK]")
        assert len(ours["masks"]) == len(ref["masks"])
        for a, b in zip(ours["masks"], ref["masks"]):
            assert [s["id"] for s in a] == [s["id"] for s in b]
            assert [s["token"] for s in a] == [s["token"] for s in b]
            np.testing.assert_allclose([s["score"] for s in a],
                                       [s["score"] for s in b], atol=ATOL)


def test_run_server_serves_the_bpe_config(bpe, tmp_path):
    """run_server on the RoBERTa-shaped BPE config: fill_mask answers in
    BPE tokens and classify answers through the head's own pooler."""
    cfg_path = tmp_path / "roberta.json"
    cfg_path.write_text(json.dumps(bpe["config"]))
    service = run_server.build_service(run_server.parse_arguments([
        "--model_config_file", str(cfg_path), "--device", "cpu",
        "--dtype", "float32", "--tasks", "fill_mask,classify",
        "--buckets", "32", "--uppercase"]))
    engine = service.engine
    assert service.engine.tasks["fill_mask"].handler.tokenizer \
        .get_vocab_size() == len(json.load(open(bpe["vocab"])))
    out = engine.run_direct("fill_mask", FILL_MASK[0])
    vocab = json.load(open(bpe["vocab"]))
    assert all(s["token"] in vocab for s in out["masks"][0])
    label = engine.run_direct("classify", {"text": "the river runs",
                                           "text_pair": "to the sea"})
    assert label["label"] in ("0", "1")
    assert engine.tasks["classify"].model.bert.has_pooler


def _jax_mask_id(config: dict, tmp_path) -> int:
    """The mask id the JAX runner's prepare_dataset hands its dataset."""
    seen = {}

    class Stop(Exception):
        pass

    def capture(files, mask_id, *args, **kwargs):
        seen["mask"] = mask_id
        raise Stop

    (tmp_path / "shards").mkdir(exist_ok=True)
    args = types.SimpleNamespace(
        input_dir=str(tmp_path / "shards"), data_read_retries=0,
        data_retry_base_s=0.0, shard_error_policy="skip",
        telemetry_sink=types.SimpleNamespace(write_record=None),
        max_predictions_per_seq=P, masked_token_fraction=0.15, seed=0)
    real = jax_run_pretraining.ShardedPretrainingDataset
    jax_run_pretraining.ShardedPretrainingDataset = capture
    try:
        with pytest.raises(Stop):
            jax_run_pretraining.prepare_dataset(
                args, JaxConfig.from_dict(config), None)
    finally:
        jax_run_pretraining.ShardedPretrainingDataset = real
    return seen["mask"]


@pytest.mark.parametrize("case", ["wordpiece", "bpe_mask_at_6", "no_vocab"])
def test_mask_token_id_matches_the_jax_runner(tmp_path, case):
    """A WordPiece vocab.txt; a BPE vocab.json whose ``<mask>`` is id 6
    (before the repair the port read it as lines and gave 4); no vocab
    file, which gives 4."""
    config = dict(SHAPE, vocab_size=16)
    if case == "wordpiece":
        vocab = synth.write_trace_vocab(str(tmp_path / "vocab.txt"))
        config.update(vocab_file=vocab, tokenizer="wordpiece")
        want = 4
    elif case == "bpe_mask_at_6":
        tokens = ["<s>", "<pad>", "</s>", "<unk>", "a", "b", "<mask>"]
        (tmp_path / "vocab.json").write_text(json.dumps(
            {t: i for i, t in enumerate(tokens)}))
        (tmp_path / "merges.txt").write_text("#version: 0.2\n")
        config.update(vocab_file=str(tmp_path / "vocab.json"),
                      tokenizer="bpe", lowercase=False)
        want = 6
    else:
        config.update(vocab_file=str(tmp_path / "missing.json"),
                      tokenizer="bpe")
        want = 4
    got = run_pretraining.mask_token_id(BertConfig.from_dict(config))
    assert got == _jax_mask_id(config, tmp_path) == want


def test_squad_features_on_bpe_equal_jax(bpe, tmp_path):
    """run_squad's BPE path: ``build_tokenizer`` takes the C++ BPE, and the
    port's featurization of a synthetic SQuAD file on it (sub-tokens
    encoded without specials, the [CLS]/[SEP] ids looked up) equals the
    JAX package's on its own C++ BPE, field by field."""
    import dataclasses

    from bert_pytorch_tpu import squad as jax_squad
    from bert_pytorch_tpu_torch import run_squad, squad
    from bert_pytorch_tpu_torch.tools.tokenizer_cpp import \
        CppByteLevelBPETokenizer

    cfg_path = tmp_path / "roberta.json"
    cfg_path.write_text(json.dumps(bpe["config"]))
    path = make_synthetic_text.write_squad(str(tmp_path / "squad.json"), 4,
                                           3, 1, 0)
    args = run_squad.parse_args([
        "--config_file", str(cfg_path), "--output_dir", str(tmp_path / "o"),
        "--train_file", path, "--do_train", "--device", "cpu"])
    assert (args.tokenizer, args.vocab_file) == ("bpe", bpe["vocab"])
    tok = run_squad.build_tokenizer(args)
    assert isinstance(tok, CppByteLevelBPETokenizer) and not tok.lowercase
    for is_training in (True, False):
        got = squad.convert_examples_to_features(
            squad.read_squad_examples(path, is_training, False), tok, 64,
            32, 16, is_training)
        want = jax_squad.convert_examples_to_features(
            jax_squad.read_squad_examples(path, is_training, False),
            jax_bpe_tokenizer(bpe["vocab"], uppercase=True), 64, 32, 16,
            is_training)
        assert len(got) > 4
        assert [dataclasses.asdict(f) for f in got] == [
            dataclasses.asdict(f) for f in want]
