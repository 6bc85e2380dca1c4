"""The PyTorch port's serving engine held against the JAX package's on the
CPU: both take the pure-Python ``BertTokenizer`` on the same vocab file and
the same fp32 weights (the JAX engine's seeded params, carried across with
``from_jax_params``), so ``run_direct`` results and demultiplexed outputs
agree within fp32 1e-5. The port serves through ``"flash_infer"`` (its
kernel's plain version on CPU tensors), the JAX engine through ``"xla"``.

The four heads (fill_mask, classify, squad, ner) are also built in both
packages from one JAX checkpoint each (the port reads it with its own
params-only loader), the JAX engine on ``"pallas_infer"`` (its kernel in
interpret mode): squad answers and ner tags equal, logits and scores
within fp32 1e-5. Hot-swap (``swap_params``, ``POST /swapz``) is held to
the JAX engine's contract.
"""

import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert_pytorch_tpu.config import BertConfig as JaxConfig
from bert_pytorch_tpu.data.tokenization import BertTokenizer as JaxTokenizer
from bert_pytorch_tpu.serve import InferenceEngine as JaxEngine
from bert_pytorch_tpu.serve.batcher import Request as JaxRequest
from bert_pytorch_tpu.utils import checkpoint as jax_ckpt
from bert_pytorch_tpu_torch import run_server
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.data.tokenization import BertTokenizer
from bert_pytorch_tpu_torch.models.convert import from_jax_params
from bert_pytorch_tpu_torch.ops.kernels import build as kernel_build
from bert_pytorch_tpu_torch.serve import InferenceEngine, make_server
from bert_pytorch_tpu_torch.serve.batcher import Request
from bert_pytorch_tpu_torch.serve.engine import SwapBusy
from bert_pytorch_tpu_torch.testing import faults
from bert_pytorch_tpu_torch.utils import checkpoint as ckpt_util
from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
    TRACE_WORDS, write_trace_vocab)

ATOL = 1e-5
BUCKETS = (16, 32)
LABELS = ["neg", "pos"]
TASKS = {"fill_mask": {}, "classify": {"labels": LABELS}}
PAYLOADS = {
    "fill_mask": [{"text": "the capital of [MASK] is paris"},
                  {"text": "who wrote [MASK]", "top_k": 3},
                  {"text": "a big [MASK] runs through the old city of "
                           "london in england where [MASK] was"}],
    "classify": [{"text": "paris is big"},
                 {"text": "the river runs", "text_pair": "through london"},
                 {"text": "william shakespeare wrote hamlet"}],
}


def _config_dict():
    vocab = 5 + len(TRACE_WORDS)
    vocab += (8 - vocab % 8) % 8
    return dict(vocab_size=vocab, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=64, type_vocab_size=2,
                next_sentence=True, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    return write_trace_vocab(str(tmp_path_factory.mktemp("vocab") / "vocab.txt"))


@pytest.fixture(scope="module")
def jax_engine(vocab_file):
    return JaxEngine(JaxConfig(**_config_dict()),
                     JaxTokenizer(vocab_file, do_lower_case=True), TASKS,
                     buckets=BUCKETS, max_batch_size=2, max_requests_per_pack=3,
                     dtype=jnp.float32, seed=7, attention_backend="xla")


@pytest.fixture(scope="module")
def weights(jax_engine):
    cfg = BertConfig(**_config_dict())
    return {name: from_jax_params(
        jax.tree_util.tree_map(np.asarray, spec.params), cfg, name)
        for name, spec in jax_engine.tasks.items()}


@pytest.fixture(scope="module")
def engine(vocab_file, weights):
    tasks = {name: dict(opts, weights=weights[name])
             for name, opts in TASKS.items()}
    eng = InferenceEngine(BertConfig(**_config_dict()),
                          BertTokenizer(vocab_file, do_lower_case=True),
                          tasks, buckets=BUCKETS, max_batch_size=2,
                          max_requests_per_pack=3, dtype=torch.float32,
                          attention_backend="flash_infer", device="cpu")
    eng.warmup()
    return eng


def _assert_result_close(ours, ref):
    if "masks" in ours:
        assert len(ours["masks"]) == len(ref["masks"])
        for a_slot, b_slot in zip(ours["masks"], ref["masks"]):
            assert [s["id"] for s in a_slot] == [s["id"] for s in b_slot]
            assert [s["token"] for s in a_slot] == [s["token"] for s in b_slot]
            np.testing.assert_allclose([s["score"] for s in a_slot],
                                       [s["score"] for s in b_slot], atol=ATOL)
    else:
        assert ours["label"] == ref["label"]
        assert ours["scores"].keys() == ref["scores"].keys()
        for key in ours["scores"]:
            assert abs(ours["scores"][key] - ref["scores"][key]) <= ATOL


@pytest.mark.parametrize("task", ["fill_mask", "classify"])
def test_run_direct_matches_jax_engine(engine, jax_engine, task):
    for payload in PAYLOADS[task]:
        _assert_result_close(engine.run_direct(task, payload),
                             jax_engine.run_direct(task, payload))


@pytest.mark.parametrize("task", ["fill_mask", "classify"])
def test_packed_demux_matches_unpacked_and_jax(engine, jax_engine, task):
    """One packed plan (several requests per row) demultiplexes to the
    same per-request outputs as the unpacked plan, and as the JAX engine's
    packed plan."""
    handler = engine.tasks[task].handler
    feats = [handler.prepare(p, engine.max_len()) for p in PAYLOADS[task]]
    reqs = [Request(task, f, p) for f, p in zip(feats, PAYLOADS[task])]
    packed_plan = engine.plan_batch(reqs, packed=True)
    assert max(len(row) for row in packed_plan.rows) > 1
    packed, _ = engine.execute(task, packed_plan)
    unpacked = []
    for i in range(0, len(reqs), engine.max_batch_size):
        outs, _ = engine.execute(task, engine.plan_batch(
            reqs[i:i + engine.max_batch_size], packed=False))
        unpacked += outs
    by_id = dict(zip((r.id for r in packed_plan.requests), packed))
    for req, out in zip(reqs, unpacked):
        np.testing.assert_allclose(by_id[req.id], out, atol=ATOL, rtol=0)
    jreqs = [JaxRequest(task, f, p) for f, p in zip(feats, PAYLOADS[task])]
    jplan = jax_engine.plan_batch(jreqs, packed=True)
    jouts, _ = jax_engine.execute(task, jplan)
    assert [len(row) for row in jplan.rows] == [
        len(row) for row in packed_plan.rows]
    for ours, ref in zip(packed, jouts):
        np.testing.assert_allclose(ours, np.asarray(ref), atol=ATOL, rtol=0)


def test_http_smoke_two_posts(vocab_file, weights, tmp_path, engine):
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(_config_dict()))
    args = run_server.parse_arguments([
        "--model_config_file", str(cfg_path), "--vocab_file", vocab_file,
        "--device", "cpu", "--dtype", "float32", "--buckets", "16,32",
        "--max_batch_size", "2", "--pack_requests", "--classify_labels",
        ",".join(LABELS), "--port", "0"])
    service = run_server.build_service(args, weights=weights)
    service.start()
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        for task in ("fill_mask", "classify"):
            payload = PAYLOADS[task][0]
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/{task}",
                data=json.dumps(payload).encode())
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.status == 200
                _assert_result_close(json.loads(resp.read()),
                                     engine.run_direct(task, payload))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as resp:
            assert json.loads(resp.read())["status"] == "ok"
    finally:
        server.shutdown()
        server.server_close()
        service.stop()
        thread.join(timeout=30)
    assert not thread.is_alive()
    assert service.telemetry.snapshot()["requests"] == 2


class _EngineWithoutSwap:
    """A stand-in engine: the real one minus the hot-swap methods."""

    def __init__(self, engine):
        self._engine = engine

    def __getattr__(self, name):
        if name in ("swap_params", "version", "swap_stats"):
            raise AttributeError(name)
        return getattr(self._engine, name)


def test_swapz_refuses_cleanly_until_hot_swap_is_ported(vocab_file, weights,
                                                         tmp_path):
    """A well-formed POST /swapz to a server whose engine has no
    ``swap_params`` answers 404 naming it, never a 500 with the engine's
    AttributeError (the port's engine swaps: test_swapz_swaps_...)."""
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(_config_dict()))
    args = run_server.parse_arguments([
        "--model_config_file", str(cfg_path), "--vocab_file", vocab_file,
        "--device", "cpu", "--dtype", "float32", "--tasks", "fill_mask",
        "--buckets", "16", "--port", "0"])
    service = run_server.build_service(
        args, weights={"fill_mask": weights["fill_mask"]})
    service.engine = _EngineWithoutSwap(service.engine)
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        body = {"task": "fill_mask", "checkpoint": str(tmp_path / "ckpt"),
                "version": "v2"}
        status, reply = _post(server.server_address[1], "/swapz", body)
        assert status == 404
        assert "hot-swap unsupported" in reply["error"]
        assert "AttributeError" not in reply["error"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_run_server_defaults_to_cuda_and_raises_without_it(vocab_file,
                                                           tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid")
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(_config_dict()))
    args = run_server.parse_arguments([
        "--model_config_file", str(cfg_path), "--vocab_file", vocab_file])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        run_server.build_service(args)


def test_build_service_pads_vocab_to_multiple_of_8(vocab_file, tmp_path):
    cfg = dict(_config_dict(), vocab_size=61)
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    service = run_server.build_service(run_server.parse_arguments([
        "--model_config_file", str(cfg_path), "--vocab_file", vocab_file,
        "--device", "cpu", "--tasks", "fill_mask", "--buckets", "16"]))
    engine = service.engine
    assert engine.config.vocab_size == 64
    assert engine.dtype == torch.bfloat16  # the serving default
    assert engine.attention_backend == "flash_infer"
    out = engine.run_direct("fill_mask", PAYLOADS["fill_mask"][0])
    assert len(out["masks"][0]) == 5


def test_run_server_refuses_bpe_by_name_before_loading(tmp_path):
    """A BPE model config (the repo's RoBERTa-large) is taken, its vocab
    refused by name at argument parsing when the file is missing, before
    any weight is read: the config's own ``data/vocab/bpe-vocab.json`` is
    not in the repo. A ``vocab.json`` with its ``merges.txt`` parses as
    ``bpe``; ``--tokenizer bpe`` on a WordPiece ``.txt`` is refused."""
    with pytest.raises(FileNotFoundError, match="bpe-vocab.json"):
        run_server.parse_arguments([
            "--model_config_file", "configs/roberta_large_cased_config.json",
            "--device", "cpu"])
    bpe = tmp_path / "bpe"
    bpe.mkdir()
    (bpe / "vocab.json").write_text(json.dumps({"[PAD]": 0, "a": 1}))
    (bpe / "merges.txt").write_text("#version: 0.2\n")
    args = run_server.parse_arguments([
        "--model_config_file", "configs/roberta_large_cased_config.json",
        "--vocab_file", str(bpe / "vocab.json"), "--device", "cpu"])
    assert args.tokenizer == "bpe"
    (bpe / "merges.txt").unlink()
    with pytest.raises(FileNotFoundError, match="merges.txt"):
        run_server.parse_arguments([
            "--model_config_file", "configs/roberta_large_cased_config.json",
            "--vocab_file", str(bpe / "vocab.json"), "--device", "cpu"])
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(dict(_config_dict(),
                                        tokenizer="wordpiece")))
    with pytest.raises(ValueError, match="not a vocab.json"):
        run_server.parse_arguments([
            "--model_config_file", str(cfg_path), "--vocab_file",
            str(tmp_path / "missing.txt"), "--tokenizer", "bpe"])


@pytest.mark.parametrize("uppercase", [False, True])
def test_run_server_case_follows_the_jax_rule(vocab_file, tmp_path,
                                              uppercase):
    """The JAX server lower-cases unless ``--uppercase`` and ignores the
    config's ``"lowercase"``: on a ``"lowercase": false`` config the
    port's served tokens equal the JAX tokenizer's under that rule."""
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(dict(_config_dict(), lowercase=False)))
    argv = ["--model_config_file", str(cfg_path), "--vocab_file", vocab_file,
            "--device", "cpu", "--tasks", "fill_mask,squad", "--buckets",
            "16"] + (["--uppercase"] if uppercase else [])
    args = run_server.parse_arguments(argv)
    assert (args.tokenizer, args.uppercase) == ("wordpiece", uppercase)
    handlers = run_server.build_service(args).engine.tasks
    served = handlers["fill_mask"].handler.tokenizer
    text = "Paris IS the Capital of London"
    jax_tok = JaxTokenizer(vocab_file, do_lower_case=not uppercase)
    assert served.encode(text).tokens == jax_tok.tokenize(text)
    assert ("paris" in served.encode(text).tokens) != uppercase
    assert handlers["squad"].handler.do_lower_case == (not uppercase)


def test_engine_rejects_unknown_task_and_backend(vocab_file):
    tok = BertTokenizer(vocab_file)
    cfg = BertConfig(**_config_dict())
    with pytest.raises(ValueError, match="unknown serve task"):
        InferenceEngine(cfg, tok, {"summarize": {}}, buckets=BUCKETS,
                        device="cpu")
    with pytest.raises(ValueError, match="attention_backend"):
        InferenceEngine(cfg, tok, TASKS, buckets=BUCKETS, device="cpu",
                        attention_backend="pallas_infer")


# -- the four heads from JAX checkpoints; hot-swap -------------------------

NER_LABELS = ["O", "B-LOC", "I-LOC", "B-PER", "I-PER"]
HEAD_TASKS = {"fill_mask": {}, "classify": {"labels": LABELS},
              "squad": {}, "ner": {"labels": NER_LABELS}}
HEAD_PAYLOADS = dict(PAYLOADS, squad=[
    {"question": "who wrote hamlet",
     "context": "william shakespeare wrote hamlet in london"},
    {"question": "what is the capital of france", "n_best": 3,
     "context": "paris is the capital of france and london is the capital "
                "of england where the river runs"},
    {"question": "where", "context": "the old house"},
], ner=[
    {"text": "paris is big"},
    {"text": "william shakespeare wrote hamlet in london england"},
    {"text": "the river runs through the old city"},
])


def _post(port: int, path: str, body: dict):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return json.loads(resp.read())


@pytest.fixture(scope="module")
def head_checkpoints(vocab_file, tmp_path_factory):
    """One JAX checkpoint per head ({model, optimizer, epoch}) from a seeded
    JAX engine's params."""
    source = JaxEngine(JaxConfig(**_config_dict()),
                       JaxTokenizer(vocab_file, do_lower_case=True),
                       HEAD_TASKS, buckets=BUCKETS, max_batch_size=2,
                       dtype=jnp.float32, seed=11, attention_backend="xla")
    root = tmp_path_factory.mktemp("heads")
    return {name: jax_ckpt.save_checkpoint(
        str(root / name), 0, {"model": spec.params,
                              "optimizer": {"mu": spec.params}, "epoch": 0})
        for name, spec in source.tasks.items()}


@pytest.fixture(scope="module")
def jax_head_engine(vocab_file, head_checkpoints):
    return JaxEngine(JaxConfig(**_config_dict()),
                     JaxTokenizer(vocab_file, do_lower_case=True),
                     {k: dict(v, checkpoint=head_checkpoints[k])
                      for k, v in HEAD_TASKS.items()},
                     buckets=BUCKETS, max_batch_size=2,
                     max_requests_per_pack=3, dtype=jnp.float32, seed=7,
                     attention_backend="pallas_infer")


def _port_head_engine(vocab_file, checkpoints, **kwargs):
    eng = InferenceEngine(BertConfig(**_config_dict()),
                          BertTokenizer(vocab_file, do_lower_case=True),
                          {k: dict(v, checkpoint=checkpoints[k])
                           for k, v in HEAD_TASKS.items()},
                          buckets=BUCKETS, max_batch_size=2,
                          max_requests_per_pack=3, dtype=torch.float32,
                          attention_backend="flash_infer", device="cpu",
                          **kwargs)
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def head_engine(vocab_file, head_checkpoints):
    return _port_head_engine(vocab_file, head_checkpoints)


def _assert_head_close(task, ours, ref):
    if task == "squad":
        assert ours["answer"] == ref["answer"]
        assert ([e["text"] for e in ours["n_best"]]
                == [e["text"] for e in ref["n_best"]])
        for a, b in zip(ours["n_best"], ref["n_best"]):
            for key in ("start_logit", "end_logit", "probability"):
                assert abs(a[key] - b[key]) <= ATOL, (key, a, b)
    elif task == "ner":
        assert ([(e["word"], e["tag"]) for e in ours["entities"]]
                == [(e["word"], e["tag"]) for e in ref["entities"]])
        for a, b in zip(ours["entities"], ref["entities"]):
            assert abs(a["score"] - b["score"]) <= ATOL, (a, b)
    else:
        _assert_result_close(ours, ref)


@pytest.mark.parametrize("task", list(HEAD_TASKS))
def test_heads_from_checkpoints_match_jax(head_engine, jax_head_engine,
                                          task):
    """Each head, built from one JAX checkpoint in both packages: run_direct
    and one packed batch (decoded per request) agree with JAX's
    pallas_infer engine."""
    for payload in HEAD_PAYLOADS[task]:
        _assert_head_close(task, head_engine.run_direct(task, payload),
                           jax_head_engine.run_direct(task, payload))
    handler = head_engine.tasks[task].handler
    jax_handler = jax_head_engine.tasks[task].handler
    payloads = HEAD_PAYLOADS[task]
    reqs = [Request(task, handler.prepare(p, head_engine.max_len()), p)
            for p in payloads]
    jreqs = [JaxRequest(task, jax_handler.prepare(
        p, jax_head_engine.max_len()), p) for p in payloads]
    plan = head_engine.plan_batch(reqs, packed=True)
    jplan = jax_head_engine.plan_batch(jreqs, packed=True)
    assert max(len(row) for row in plan.rows) > 1
    assert [len(r) for r in plan.rows] == [len(r) for r in jplan.rows]
    outs, _ = head_engine.execute(task, plan)
    jouts, _ = jax_head_engine.execute(task, jplan)
    for req, out, jreq, jout in zip(plan.requests, outs, jplan.requests,
                                    jouts):
        _assert_head_close(
            task, handler.postprocess(req.features, out, req.payload),
            jax_handler.postprocess(jreq.features, jout, jreq.payload))


@pytest.mark.parametrize("task", ["squad", "ner"])
def test_packed_span_and_token_demux_matches_unpacked(head_engine, task):
    handler = head_engine.tasks[task].handler
    reqs = [Request(task, handler.prepare(p, head_engine.max_len()), p)
            for p in HEAD_PAYLOADS[task]]
    plan = head_engine.plan_batch(reqs, packed=True)
    assert max(len(row) for row in plan.rows) > 1
    packed, _ = head_engine.execute(task, plan)
    by_id = dict(zip((r.id for r in plan.requests), packed))
    for i in range(0, len(reqs), head_engine.max_batch_size):
        chunk = reqs[i:i + head_engine.max_batch_size]
        outs, _ = head_engine.execute(
            task, head_engine.plan_batch(chunk, packed=False))
        for req, out in zip(chunk, outs):
            got = by_id[req.id]
            for a, b in zip(*((got, out) if task == "squad"
                              else ((got,), (out,)))):
                assert a.shape == b.shape == (req.length,) + a.shape[1:]
                np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_fused_stack_span_equals_unfused(vocab_file, head_checkpoints,
                                         head_engine):
    """squad's fused epilogue stacks (start, end) into one [B, 2, S] output;
    demultiplexed, it is the unfused batch's output bit for bit."""
    fused_engine = _port_head_engine(vocab_file, head_checkpoints,
                                     fuse_epilogues=True)
    handler = head_engine.tasks["squad"].handler
    reqs = [Request("squad", handler.prepare(p, head_engine.max_len()), p)
            for p in HEAD_PAYLOADS["squad"]]
    for packed in (False, True):
        plan = head_engine.plan_batch(reqs, packed=packed)
        staged = fused_engine.stage("squad", plan)
        out, info = fused_engine.execute_staged(staged)
        assert info["fused"] and tuple(out.shape) == (
            fused_engine.max_batch_size, 2, plan.bucket)
        fused = fused_engine.demux(staged, out)
        unfused, uinfo = head_engine.execute("squad", plan)
        assert not uinfo["fused"]
        for (fs, fe), (us, ue) in zip(fused, unfused):
            np.testing.assert_array_equal(fs, us)
            np.testing.assert_array_equal(fe, ue)
    payload = HEAD_PAYLOADS["squad"][1]
    assert (fused_engine.run_direct("squad", payload)
            == head_engine.run_direct("squad", payload))


def _nudged_checkpoint(path: str, out_dir: str, delta: float = 0.5) -> str:
    """A JAX checkpoint of ``path``'s params + ``delta`` (the new version
    a swap loads)."""
    state = jax_ckpt.load_checkpoint(path)
    nudged = jax.tree_util.tree_map(lambda x: np.asarray(x) + delta,
                                    state["model"])
    return jax_ckpt.save_checkpoint(out_dir, 1, {"model": nudged,
                                                 "epoch": 1})


def _classify_engine(vocab_file, checkpoint, version="v1"):
    eng = InferenceEngine(BertConfig(**_config_dict()),
                          BertTokenizer(vocab_file, do_lower_case=True),
                          {"classify": {"labels": LABELS,
                                        "checkpoint": checkpoint}},
                          buckets=(16,), max_batch_size=2,
                          dtype=torch.float32, device="cpu",
                          version=version)
    eng.warmup()
    return eng


SWAP_INFO_KEYS = {"task", "version", "from_version", "checkpoint", "load_s",
                  "compiles", "compiles_cold", "compiles_warm"}


def test_swap_params_flips_version_and_weights_atomically(
        vocab_file, head_checkpoints, tmp_path, monkeypatch):
    eng = _classify_engine(vocab_file, head_checkpoints["classify"])
    new_ckpt = _nudged_checkpoint(head_checkpoints["classify"],
                                  str(tmp_path / "v2"))
    spec = eng.tasks["classify"]
    old = spec.model.head.classifier.weight.detach().clone()
    epoch = eng._swap_epoch

    def refuse(*args, **kwargs):
        raise AssertionError("a hot-swap must build and load no kernel")

    # The kernels were built and loaded once, at startup (none on the CPU).
    with monkeypatch.context() as patch:
        patch.setattr(kernel_build, "build", refuse)
        patch.setattr(kernel_build, "load", refuse)
        info = eng.swap_params("classify", new_ckpt, "v2")
    assert set(info) == SWAP_INFO_KEYS
    assert info["version"] == "v2" and info["from_version"] == "v1"
    assert info["compiles"] == info["compiles_cold"] == 0
    assert info["compiles_warm"] == 0 and info["load_s"] >= 0
    assert eng.version() == "v2" and eng._swap_epoch == epoch + 1
    assert eng.swap_stats() == {"version": "v2", "swaps": 1,
                                "torn_serves": 0}
    torch.testing.assert_close(spec.model.head.classifier.weight, old + 0.5,
                               atol=1e-6, rtol=0)
    fresh = _classify_engine(vocab_file, new_ckpt)
    for payload in PAYLOADS["classify"]:
        assert (eng.run_direct("classify", payload)
                == fresh.run_direct("classify", payload))
    plan = eng.plan_batch([Request("classify", spec.handler.prepare(
        PAYLOADS["classify"][0], eng.max_len()), PAYLOADS["classify"][0])])
    _, info = eng.execute_staged(eng.stage("classify", plan))
    assert info["version"] == "v2"
    # A model replaced without the flip while a batch runs is a torn serve.
    forward = spec.model.forward

    def tearing(*args, **kwargs):
        spec.model = fresh.tasks["classify"].model
        return forward(*args, **kwargs)

    monkeypatch.setattr(spec.model, "forward", tearing)
    eng.execute_staged(eng.stage("classify", plan))
    assert eng.swap_stats()["torn_serves"] == 1


def test_swap_params_rejects_bad_inputs(vocab_file, head_checkpoints,
                                        tmp_path):
    eng = _classify_engine(vocab_file, head_checkpoints["classify"])
    with pytest.raises(ValueError, match="unknown task"):
        eng.swap_params("fill_mask", head_checkpoints["fill_mask"], "v9")
    with pytest.raises(FileNotFoundError):
        eng.swap_params("classify", str(tmp_path / "missing.msgpack"), "v9")
    with eng._swap_lock:
        eng._swap_inflight = True
    try:
        with pytest.raises(SwapBusy):
            eng.swap_params("classify", head_checkpoints["classify"], "v9")
    finally:
        with eng._swap_lock:
            eng._swap_inflight = False
    # A failed load leaves the old version serving.
    model = eng.tasks["classify"].model
    with pytest.raises(ckpt_util.CheckpointShapeError):
        eng.swap_params("classify", head_checkpoints["squad"], "v9")
    assert eng.version() == "v1" and eng.tasks["classify"].model is model
    assert eng.swap_stats()["swaps"] == 0 and not eng._swap_inflight


def _classify_args(vocab_file, cfg_path, *extra):
    return run_server.parse_arguments([
        "--model_config_file", str(cfg_path), "--vocab_file", vocab_file,
        "--device", "cpu", "--dtype", "float32", "--tasks", "classify",
        "--classify_labels", ",".join(LABELS), "--buckets", "16",
        "--max_batch_size", "2", "--max_wait_ms", "1", "--port", "0",
        *extra])


def test_swapz_swaps_the_served_head(vocab_file, head_checkpoints,
                                     tmp_path):
    """POST /swapz over HTTP: 200 with the swap info, the version flipped
    on /healthz and /statsz, answers from the new weights; requests in
    flight while the swap is held open (swap_hold) all answer, on the old
    version; a second swap meanwhile is 409; unknown task 404, missing
    checkpoint 400."""
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(_config_dict()))
    ckpt_dir = tmp_path / "classify"
    ckpt_dir.mkdir()
    shutil.copy(head_checkpoints["classify"], ckpt_dir / "ckpt_0.msgpack")
    shutil.copy(head_checkpoints["classify"] + ".manifest.json",
                ckpt_dir / "ckpt_0.msgpack.manifest.json")
    new_ckpt = _nudged_checkpoint(head_checkpoints["classify"],
                                  str(tmp_path / "v2"))
    service = run_server.build_service(_classify_args(
        vocab_file, cfg_path, "--classify_checkpoint", str(ckpt_dir),
        "--serving_version", "v1"))
    engine = service.engine
    engine.warmup()
    payloads = PAYLOADS["classify"] * 4
    before = [engine.run_direct("classify", p) for p in payloads]
    after = [_classify_engine(vocab_file, new_ckpt).run_direct(
        "classify", p) for p in payloads]
    assert before != after
    service.start()
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    faults.arm("swap_hold@1x2")
    try:
        port = server.server_address[1]
        assert _get(port, "/healthz")["version"] == "v1"
        body = {"task": "classify", "checkpoint": new_ckpt, "version": "v2"}
        with ThreadPoolExecutor(max_workers=len(payloads) + 1) as pool:
            swap = pool.submit(_post, port, "/swapz", body)
            deadline = time.monotonic() + 30
            while not engine._swap_inflight and time.monotonic() < deadline:
                time.sleep(0.01)
            assert engine._swap_inflight
            inflight = list(pool.map(
                lambda p: _post(port, "/v1/classify", p), payloads))
            assert _post(port, "/swapz", body)[0] == 409
            status, info = swap.result(timeout=60)
        assert [s for s, _ in inflight] == [200] * len(payloads)
        for (_, got), want in zip(inflight, before):
            _assert_result_close(got, want)
        assert status == 200 and info["ok"] and info["version"] == "v2"
        assert SWAP_INFO_KEYS <= set(info) and info["compiles"] == 0
        health = _get(port, "/healthz")
        stats = _get(port, "/statsz")
        assert health["version"] == stats["version"] == "v2"
        assert stats["swaps"] == 1 and stats["torn_serves"] == 0
        for payload, want in zip(payloads, after):
            status, got = _post(port, "/v1/classify", payload)
            assert status == 200
            _assert_result_close(got, want)
        assert _post(port, "/swapz", dict(body, task="squad"))[0] == 404
        assert _post(port, "/swapz", dict(
            body, checkpoint=str(tmp_path / "nope.msgpack")))[0] == 400
    finally:
        faults.arm("")
        server.shutdown()
        server.server_close()
        service.stop()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_slow_forward_fault_holds_every_forward(vocab_file,
                                                head_checkpoints):
    """``slow_forwardxMS`` sleeps MS milliseconds after each forward,
    inside its timed span, and leaves every answer as it was."""
    engine = _classify_engine(vocab_file, head_checkpoints["classify"])
    payloads = PAYLOADS["classify"][:2]
    want = [engine.run_direct("classify", p) for p in payloads]
    faults.arm("slow_forwardx150")
    try:
        t0 = time.perf_counter()
        got = [engine.run_direct("classify", p) for p in payloads]
        held = time.perf_counter() - t0
    finally:
        faults.arm("")
    assert got == want
    assert held >= 2 * 0.15
    with pytest.raises(faults.FaultSpecError, match="slow_forward"):
        faults.FaultPlan("slow_walk")


def test_run_server_checkpoint_flags(vocab_file, head_checkpoints,
                                     tmp_path):
    """A directory resolves to its newest ckpt_*.msgpack, an empty one
    raises, and --save_init_checkpoint writes a checkpoint that a second
    server reads back to identical answers."""
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(_config_dict()))
    runs = tmp_path / "runs"
    runs.mkdir()
    for step in (1, 12, 5):
        shutil.copy(head_checkpoints["classify"],
                    runs / f"ckpt_{step}.msgpack")
    assert run_server.resolve_ckpt(str(runs)) == str(runs / "ckpt_12.msgpack")
    assert run_server.resolve_ckpt(head_checkpoints["ner"]) == \
        head_checkpoints["ner"]
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no ckpt_"):
        run_server.build_service(_classify_args(
            vocab_file, cfg_path, "--classify_checkpoint",
            str(tmp_path / "empty")))
    args = run_server.parse_arguments([
        "--model_config_file", str(cfg_path), "--vocab_file", vocab_file,
        "--device", "cpu", "--dtype", "float32", "--buckets", "16,32",
        "--classify_labels", ",".join(LABELS),
        "--ner_labels", ",".join(NER_LABELS),
        *[a for task in HEAD_TASKS for a in (
            f"--{task}_checkpoint", head_checkpoints[task])]])
    assert args.tasks == "fill_mask,classify,squad,ner"
    first = run_server.build_service(args).engine
    saved = run_server.save_init_checkpoint(first, str(tmp_path / "init"))
    assert saved == str(tmp_path / "init" / "ckpt_0.msgpack")
    assert ckpt_util.integrity.verify_checkpoint(saved)[0] == "verified"
    args.tasks = "classify"
    args.classify_checkpoint = str(tmp_path / "init")
    second = run_server.build_service(args).engine
    for payload in PAYLOADS["classify"]:
        assert (second.run_direct("classify", payload)
                == first.run_direct("classify", payload))
    for task in ("squad", "ner"):
        for payload in HEAD_PAYLOADS[task]:
            assert first.run_direct(task, payload)
    assert os.path.isfile(saved)
