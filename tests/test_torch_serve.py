"""The PyTorch port's serving engine held against the JAX package's on the
CPU: both take the pure-Python ``BertTokenizer`` on the same vocab file and
the same fp32 weights (the JAX engine's seeded params, carried across with
``from_jax_params``), so ``run_direct`` results and demultiplexed outputs
agree within fp32 1e-5. The port serves through ``"flash_infer"`` (its
kernel's plain version on CPU tensors), the JAX engine through ``"xla"``.
"""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert_pytorch_tpu.config import BertConfig as JaxConfig
from bert_pytorch_tpu.data.tokenization import BertTokenizer as JaxTokenizer
from bert_pytorch_tpu.serve import InferenceEngine as JaxEngine
from bert_pytorch_tpu.serve.batcher import Request as JaxRequest
from bert_pytorch_tpu_torch import run_server
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.data.tokenization import BertTokenizer
from bert_pytorch_tpu_torch.models.convert import from_jax_params
from bert_pytorch_tpu_torch.serve import InferenceEngine, make_server
from bert_pytorch_tpu_torch.serve.batcher import Request
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


def test_engine_rejects_unknown_task_and_backend(vocab_file):
    tok = BertTokenizer(vocab_file)
    cfg = BertConfig(**_config_dict())
    with pytest.raises(ValueError, match="unknown serve task"):
        InferenceEngine(cfg, tok, {"squad": {}}, buckets=BUCKETS,
                        device="cpu")
    with pytest.raises(ValueError, match="attention_backend"):
        InferenceEngine(cfg, tok, TASKS, buckets=BUCKETS, device="cpu",
                        attention_backend="pallas_infer")
