"""The port's offline text chain and ``batch_infer`` held against the JAX
package on the CPU.

For one seed, ``make_synthetic_text`` -> ``shard`` -> ``build_vocab`` ->
``encode_data`` give the same files from both packages (text and vocab
byte for byte, HDF5 arrays equal); the port's dataset reads the encoded
BPE shards as the JAX one does; two LAMB steps on them (RoBERTa shape)
give losses within 1e-5 of JAX's; the port's runner takes two steps on
them with the BPE ``[MASK]`` id. ``batch_infer`` equals the JAX
``batch_infer`` on the same file (fill_mask scores within fp32 1e-5, ids
and tokens exactly) and the port's own server's answers.
"""

import glob
import hashlib
import json
import os
import random
import threading
import urllib.request

import flax.linen as nn
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert_pytorch_tpu import models as jax_models
from bert_pytorch_tpu import optim as jax_optim
from bert_pytorch_tpu import pretrain as jax_pretrain
from bert_pytorch_tpu.config import BertConfig as JaxConfig
from bert_pytorch_tpu.data.dataset import \
    ShardedPretrainingDataset as JaxDataset
from bert_pytorch_tpu.serve import InferenceEngine as JaxEngine
from bert_pytorch_tpu.data.tokenization import \
    get_bpe_tokenizer as jax_bpe_tokenizer
from bert_pytorch_tpu.tools import batch_infer as jax_batch_infer
from bert_pytorch_tpu.tools import build_vocab as jax_build_vocab
from bert_pytorch_tpu.tools import encode_data as jax_encode_data
from bert_pytorch_tpu.tools import make_synthetic_text as jax_text
from bert_pytorch_tpu.tools import shard as jax_shard
from bert_pytorch_tpu.utils import checkpoint as jax_ckpt
from bert_pytorch_tpu_torch import pretrain, run_pretraining, run_server
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.data import dataset, loader, sampler
from bert_pytorch_tpu_torch.data.tokenization import get_bpe_tokenizer
from bert_pytorch_tpu_torch.models import bert
from bert_pytorch_tpu_torch.models.convert import from_jax_params
from bert_pytorch_tpu_torch.optim import schedules, transforms
from bert_pytorch_tpu_torch.serve import make_server
from bert_pytorch_tpu_torch.tools import (batch_infer, build_vocab,
                                          encode_data, make_synthetic_text,
                                          shard)

ATOL = 1e-5
SEQ, P, B = 64, 10, 4
SHAPE = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=64, max_position_embeddings=SEQ,
             type_vocab_size=2, next_sentence=False, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0)


def _digest(path) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def _tree(root) -> dict:
    """relative path -> sha256 of every file under ``root``."""
    return {os.path.relpath(p, root): _digest(p)
            for p in sorted(glob.glob(os.path.join(root, "**", "*"),
                                      recursive=True))
            if os.path.isfile(p)}


def _chain(text, shard_mod, vocab_mod, encode_mod, root, kind):
    """The offline chain of one package into ``root``; returns the paths.
    The BPE vocab is the C++ trainer's in both (the JAX default prefers
    HF's trainer when it is installed)."""
    corpus = text.write_corpus(os.path.join(root, "text"), 2, 40, 0)
    text.write_squad(os.path.join(root, "squad.json"), 6, 3, 1, 0, 0.3)
    shards = shard_mod.shard(corpus, os.path.join(root, "shards"), 20000)
    if kind == "wordpiece":
        vocab = vocab_mod.build_wordpiece_vocab(
            shards, os.path.join(root, "vocab", "vocab.txt"), 300)
        flags = ["--next_seq_prob", "0.5"]
    else:
        extra = {"backend": "cpp"} if vocab_mod is jax_build_vocab else {}
        vocab = vocab_mod.build_bpe_vocab(
            shards, os.path.join(root, "vocab"), 400, lowercase=False,
            **extra)
        flags = ["--tokenizer", "bpe", "--uppercase"]
    random.seed(11)
    encode_mod.main(["--input_dir", os.path.join(root, "shards"),
                     "--output_dir", os.path.join(root, "hdf5"),
                     "--vocab_file", vocab, "--max_seq_len", str(SEQ),
                     "--processes", "1", *flags])
    return {"vocab": vocab,
            "hdf5": sorted(glob.glob(os.path.join(root, "hdf5", "*",
                                                  "*.hdf5")))}


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    out = {}
    for kind in ("wordpiece", "bpe"):
        for name, mods in (("ours", (make_synthetic_text, shard, build_vocab,
                                     encode_data)),
                           ("jax", (jax_text, jax_shard, jax_build_vocab,
                                    jax_encode_data))):
            root = str(tmp_path_factory.mktemp(f"{kind}_{name}"))
            out[kind, name] = dict(_chain(*mods, root, kind), root=root)
    return out


@pytest.mark.parametrize("kind", ["wordpiece", "bpe"])
def test_text_chain_equals_jax(chains, kind):
    ours, theirs = chains[kind, "ours"], chains[kind, "jax"]
    for part in ("text", "shards", "vocab"):
        got = _tree(os.path.join(ours["root"], part))
        assert got and got == _tree(os.path.join(theirs["root"], part)), part
    assert _digest(os.path.join(ours["root"], "squad.json")) == _digest(
        os.path.join(theirs["root"], "squad.json"))
    assert [os.path.relpath(p, ours["root"]) for p in ours["hdf5"]] == [
        os.path.relpath(p, theirs["root"]) for p in theirs["hdf5"]]
    assert ours["hdf5"]
    for a, b in zip(ours["hdf5"], theirs["hdf5"]):
        with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
            assert sorted(fa) == sorted(fb)
            for key in fb:
                got, want = fa[key][()], fb[key][()]
                if got.dtype == object:  # ragged special positions
                    assert [list(x) for x in got] == [list(x) for x in want]
                else:
                    assert got.dtype == want.dtype
                    np.testing.assert_array_equal(got, want, err_msg=key)


def _bpe_config(chains) -> dict:
    vocab = chains["bpe", "ours"]["vocab"]
    size = len(json.load(open(vocab)))
    return dict(SHAPE, vocab_size=size + (8 - size % 8) % 8,
                tokenizer="bpe", lowercase=False, vocab_file=vocab)


def test_two_steps_on_the_encoded_shards_match_jax(chains):
    """The port's dataset yields the JAX dataset's rows from the BPE
    shards (mask id: the tokenizer's [MASK]); two LAMB steps of 2 x B
    rows from JAX-equal weights give losses within 1e-5 of JAX's."""
    config = _bpe_config(chains)
    files = chains["bpe", "ours"]["hdf5"]
    mask_id = run_pretraining.mask_token_id(BertConfig.from_dict(config))
    assert mask_id == get_bpe_tokenizer(config["vocab_file"]).token_to_id(
        "[MASK]")
    ours = dataset.ShardedPretrainingDataset(
        files, mask_id, P, 0.15, config["vocab_size"], seed=0)
    ref = JaxDataset(files, mask_id, P, 0.15, config["vocab_size"], seed=0)
    assert len(ours) == len(ref) >= 4 * B
    for i in range(4 * B):
        for x, y in zip(ours[i], ref[i]):
            np.testing.assert_array_equal(x, y)
    batches = list(loader.DataLoader(ours, sampler.DistributedSampler(ours),
                                     batch_size=2 * B))[:2]
    cfg = JaxConfig.from_dict(config)
    model = jax_models.BertForPreTraining(cfg, dtype=jnp.float32)
    ids = jnp.zeros((1, SEQ), jnp.int32)
    params = jax.tree_util.tree_map(np.asarray, nn.unbox(jax.jit(model.init)(
        jax.random.PRNGKey(6), ids, ids, ids)["params"]))
    schedule = jax_optim.warmup_poly_schedule(4e-3, 0.128, 100)
    tx = jax_optim.lamb(schedule, weight_decay_mask=jax_optim.no_decay_mask)
    state = jax_pretrain.TrainState(params=params, opt_state=tx.init(params),
                                    rng=jax.random.PRNGKey(2))
    j_step = jax_pretrain.make_train_step(model, tx, schedule=schedule,
                                          next_sentence=False,
                                          max_pred_per_seq=P)
    t_model = bert.BertForPreTraining(BertConfig.from_dict(config))
    t_model.load_state_dict(from_jax_params(
        params, BertConfig.from_dict(config), "pretraining"))
    t_schedule = schedules.warmup_poly_schedule(4e-3, 0.128, 100)
    opt = transforms.Lamb(transforms.param_groups(t_model, 0.01), t_schedule)
    t_step = pretrain.make_train_step(t_model, opt, t_schedule, False, P)
    for batch in batches:
        stacked = jax_pretrain.stack_microbatches(
            {k: np.asarray(v) for k, v in batch.items()}, 2)
        state, j_metrics = j_step(state, stacked)
        metrics = t_step(pretrain.to_device(stacked, "cpu"))
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(j_metrics["loss"]), atol=ATOL,
                                   rtol=0)


def test_runner_takes_two_steps_on_the_encoded_shards(chains, tmp_path):
    config = _bpe_config(chains)
    cfg_path = tmp_path / "roberta.json"
    cfg_path.write_text(json.dumps(config))
    shards = os.path.dirname(chains["bpe", "ours"]["hdf5"][0])
    summary = run_pretraining.main(run_pretraining.parse_arguments([
        "--model_config_file", str(cfg_path), "--input_dir", shards,
        "--output_dir", str(tmp_path / "out"), "--global_batch_size", "8",
        "--local_batch_size", "4", "--max_predictions_per_seq", str(P),
        "--steps", "2", "--max_steps", "50", "--device", "cpu", "--dtype",
        "float32", "--skip_final_checkpoint"]))
    assert summary["step"] == 2 and summary["finite"] == 1.0
    assert summary["mask_token_id"] == get_bpe_tokenizer(
        config["vocab_file"]).token_to_id("[MASK]")
    assert "nsp_loss" not in summary


REQUESTS = [
    {"id": 0, "task": "fill_mask",
     "payload": {"text": "the capital of [MASK] is caldus."}},
    {"id": 1, "task": "fill_mask",
     "payload": {"text": "[MASK] ruled over [MASK] during the old age.",
                 "top_k": 3}},
    {"id": 2, "task": "classify",
     "payload": {"text": "winter in the north", "text_pair": "lasts long"}},
    {"id": 3, "task": "fill_mask", "payload": {"text": "no mask here"}},
    {"id": 4, "task": "nope", "payload": {"text": "x"}},
    {"id": 5, "task": "classify", "payload": {"text": "the old roads"}},
    {"id": 6, "task": "fill_mask",
     "payload": {"text": "farmers in the [MASK] grow wheat."}},
]


def _close(ours: dict, ref: dict) -> None:
    assert ours.keys() == ref.keys()
    if "error" in ref:
        assert ours["error"] == ref["error"]
        return
    ours, ref = ours["result"], ref["result"]
    if "masks" in ref:
        assert len(ours["masks"]) == len(ref["masks"])
        for a, b in zip(ours["masks"], ref["masks"]):
            assert [(s["id"], s["token"]) for s in a] == [
                (s["id"], s["token"]) for s in b]
            np.testing.assert_allclose([s["score"] for s in a],
                                       [s["score"] for s in b], atol=ATOL)
    else:
        assert ours["label"] == ref["label"]
        for key in ref["scores"]:
            assert abs(ours["scores"][key] - ref["scores"][key]) <= ATOL


def test_batch_infer_equals_jax_and_the_server(chains, tmp_path):
    """The RoBERTa-shaped config on the BPE vocab, fill_mask from a JAX
    checkpoint: the port's batch_infer equals the JAX one's lines (the JAX
    package serves no classifier on a config without NSP, so JAX scores
    the fill_mask requests alone), and every line, classify included,
    equals the port's server's answer over HTTP."""
    config = _bpe_config(chains)
    cfg_path = tmp_path / "roberta.json"
    cfg_path.write_text(json.dumps(config))
    jax_engine = JaxEngine(JaxConfig.from_dict(config),
                           jax_bpe_tokenizer(config["vocab_file"],
                                             uppercase=True),
                           {"fill_mask": {}}, buckets=(32,),
                           dtype=jnp.float32, seed=3, attention_backend="xla")
    jax_ckpt.save_checkpoint(str(tmp_path / "fill_mask"), 0, {
        "model": jax_engine.tasks["fill_mask"].params, "epoch": 0})
    requests = tmp_path / "requests.jsonl"
    requests.write_text("".join(json.dumps(r) + "\n" for r in REQUESTS))
    jax_requests = tmp_path / "jax_requests.jsonl"
    jax_requests.write_text("".join(
        json.dumps(r) + "\n" for r in REQUESTS if r["task"] != "classify"))
    common = ["--model_config_file", str(cfg_path), "--uppercase",
              "--dtype", "float32", "--buckets", "32",
              "--max_batch_size", "2", "--fill_mask_checkpoint",
              str(tmp_path / "fill_mask")]
    port_args = common + ["--device", "cpu", "--tasks",
                          "fill_mask,classify", "--pack_requests"]
    stats = batch_infer.main(["--input", str(requests), "--output",
                              str(tmp_path / "ours.jsonl"), *port_args])
    assert stats["requests"] == len(REQUESTS) and stats["errors"] == 2
    jax_batch_infer.main(["--input", str(jax_requests), "--output",
                          str(tmp_path / "jax.jsonl"), *common, "--tasks",
                          "fill_mask", "--pack_requests",
                          "--attention_backend", "xla"])
    ours = [json.loads(line) for line in open(tmp_path / "ours.jsonl")]
    theirs = {r["id"]: r for r in map(json.loads, open(tmp_path /
                                                         "jax.jsonl"))}
    assert [r["id"] for r in ours] == [r["id"] for r in REQUESTS]
    assert "error" in ours[3] and "error" in ours[4]
    for line in ours:
        if line["task"] != "classify":
            _close(line, theirs[line["id"]])
    service = run_server.build_service(run_server.parse_arguments(port_args))
    service.start()
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        for request, line in zip(REQUESTS, ours):
            if "error" in line:
                continue
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/{request['task']}",
                data=json.dumps(request["payload"]).encode())
            with urllib.request.urlopen(req, timeout=60) as resp:
                _close({"result": json.loads(resp.read())},
                       {"result": line["result"]})
    finally:
        server.shutdown()
        server.server_close()
        service.stop()
        run_server.close_planes(service)
        thread.join(timeout=30)
