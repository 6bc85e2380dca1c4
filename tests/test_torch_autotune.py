"""The port's measured attention geometry (ops/kernels/autotune.py, the
geometry argument of kernels #4 and #5, the engine's ``autotune`` modes
and ``run_server --autotune``) held against the JAX package's
``ops/pallas/autotune.py`` on the CPU.

The registry rules are compared directly: the same winner gives the same
digest in both packages, a winners file written by the port passes (and
loads in) the JAX module, and the JAX module's good and bad payloads get
the same verdicts from both validators. The kernels' outputs at a forced
geometry are the plain versions here (the geometry is validated, then the
plain version runs); they are held against the JAX Pallas kernels run in
interpret mode at that same geometry, within fp32 1e-5 (one full softmax
against the tiled online one). The engine's measure/load cycle runs on a
1-layer config of head dim 64, the width whose whole tile grid the
library instantiates.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert_pytorch_tpu.ops.pallas import autotune as jax_autotune
from bert_pytorch_tpu.ops.pallas.attention import (
    flash_attention_infer as jax_flash_infer,
    flash_attention_infer_int8 as jax_flash_int8)
from bert_pytorch_tpu.telemetry import schema as jax_schema
from bert_pytorch_tpu_torch import run_server
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.data.tokenization import BertTokenizer
from bert_pytorch_tpu_torch.ops import attention
from bert_pytorch_tpu_torch.ops.kernels import attention as kattn
from bert_pytorch_tpu_torch.ops.kernels import autotune
from bert_pytorch_tpu_torch.serve import InferenceEngine
from bert_pytorch_tpu_torch.telemetry import schema
from bert_pytorch_tpu_torch.telemetry.compile_events import CompileMonitor
from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
    TRACE_WORDS, write_trace_vocab)

ATOL = 1e-5
# Forced geometries of the kernel parity test: a 128-key stage, two
# warpgroups, both with slices walked in turn (S=128, B*H=4, D=64).
GEOMETRIES = [(64, 128, 2), (128, 64, 1), (128, 128, 4)]
B, S, H, D = 2, 128, 2, 64
GOOD = {"version": 1, "platform": "cpu", "interpret": True,
        "winners": {"infer:s32:bh8": {"block_q": 16, "block_k": 16,
                                      "bh_block": 2}}}


@pytest.fixture(autouse=True)
def clean_registries():
    autotune.clear_winners()
    jax_autotune.clear_winners()
    yield
    autotune.clear_winners()
    jax_autotune.clear_winners()


# -- the registry and its file -------------------------------------------------

def test_name_digest_is_the_jax_digest():
    for kernel, seq, bh, geom in (("infer", 128, 128, (128, 64, 4)),
                                  ("infer_int8", 512, 128, (64, 128, 1)),
                                  ("infer", 32, 8, (16, 16, 2))):
        assert autotune.name_digest(kernel, seq, bh) == ""
        autotune.record_winner(kernel, seq, bh, *geom, measured_ms=0.01)
        jax_autotune.record_winner(kernel, seq, bh, *geom)
        digest = autotune.name_digest(kernel, seq, bh)
        assert len(digest) == 6
        assert digest == jax_autotune.name_digest(kernel, seq, bh)
        assert autotune.lookup(kernel, seq, bh) == geom


def test_port_winners_file_passes_and_loads_in_the_jax_module(tmp_path):
    autotune.record_winner("infer", 128, 4, 128, 128, 2, measured_ms=0.25,
                           spread_ms=0.01)
    autotune.record_winner("infer_int8", 512, 4, 64, 128, 4)
    path = str(tmp_path / "winners.json")
    assert autotune.save_winners(path, "cpu") == 2
    with open(path) as f:
        payload = json.load(f)
    assert (payload["platform"], payload["interpret"]) == ("cpu", True)
    assert jax_autotune.validate_winners(payload) == []
    assert jax_autotune.validate_winners_file(path) == []
    assert autotune.validate_winners_file(path) == []
    # The JAX package on the CPU runs interpret mode: the same stamp.
    assert jax_autotune.load_winners(path) == 2
    assert jax_autotune.lookup("infer", 128, 4) == (128, 128, 2)
    assert jax_autotune.name_digest("infer_int8", 512, 4) == \
        autotune.name_digest("infer_int8", 512, 4)


def _payload_cases():
    bad_divide = json.loads(json.dumps(GOOD))
    bad_divide["winners"]["infer:s32:bh8"]["block_q"] = 12
    bad_kernel = {"version": 1, "platform": "cpu", "interpret": True,
                  "winners": {"bogus:s32:bh8": {"block_q": 16,
                                                "block_k": 16,
                                                "bh_block": 2}}}
    bad_bh = json.loads(json.dumps(GOOD))
    bad_bh["winners"]["infer:s32:bh8"]["bh_block"] = 3
    bad_key = {"version": 1, "platform": "cpu", "interpret": True,
               "winners": {"infer-32-8": {"block_q": 16, "block_k": 16,
                                          "bh_block": 2}}}
    bad_ms = json.loads(json.dumps(GOOD))
    bad_ms["winners"]["infer:s32:bh8"]["measured_ms"] = -1.0
    bad_top = dict(GOOD, version=2, platform="", interpret="yes")
    return {"good": GOOD, "bad_divide": bad_divide, "bad_kernel": bad_kernel,
            "bad_bh_block": bad_bh, "bad_key": bad_key,
            "bad_measured_ms": bad_ms, "bad_header": bad_top,
            "not_an_object": [GOOD], "no_winners": dict(GOOD, winners=[])}


@pytest.mark.parametrize("case", sorted(_payload_cases()))
def test_validator_verdicts_match_the_jax_module(case):
    payload = _payload_cases()[case]
    ours = autotune.validate_winners(payload)
    assert ours == jax_autotune.validate_winners(payload)
    assert (ours == []) == (case == "good")


def test_load_rules_missing_other_platform_malformed(tmp_path):
    assert autotune.load_winners(str(tmp_path / "absent.json"), "cpu") == 0
    card = dict(GOOD, platform="cuda:NVIDIA H100 80GB HBM3",
                interpret=False)
    path = tmp_path / "card.json"
    path.write_text(json.dumps(card))
    assert autotune.load_winners(str(path), "cpu") == 0
    assert autotune.lookup("infer", 32, 8) is None
    path.write_text(json.dumps(GOOD))
    assert autotune.load_winners(str(path), "cpu") == 1
    assert autotune.lookup("infer", 32, 8) == (16, 16, 2)
    bad = json.loads(json.dumps(GOOD))
    bad["winners"]["infer:s32:bh8"]["block_k"] = 5
    path.write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="malformed"):
        autotune.load_winners(str(path), "cpu")
    path.write_text("{not json")
    with pytest.raises(ValueError):
        autotune.load_winners(str(path), "cpu")
    assert autotune.validate_winners_file(str(path))[0].startswith(
        "not valid JSON")


def test_candidates_tile_the_shape_and_hold_the_default():
    for seq, bh, depth in ((128, 128, 64), (512, 128, 64), (128, 12, 64),
                           (256, 6, 32), (384, 64, 128)):
        grid = autotune.candidates(seq, bh, depth)
        assert grid[0] == autotune.DEFAULT_GEOMETRY
        assert len(set(grid)) == len(grid)
        for geom in grid:
            assert autotune.tiles(geom, seq, bh)
            assert geom[:2] in autotune.TILES[depth]
            assert geom[2] <= autotune.MAX_BH_BLOCK
    assert len(autotune.candidates(512, 128, 64)) == 16
    # A ragged length keeps the default alone, which runs it as before.
    assert autotune.candidates(200, 128, 64) == [autotune.DEFAULT_GEOMETRY]
    assert autotune.candidates(128, 128, 48) == [autotune.DEFAULT_GEOMETRY]
    with pytest.raises(ValueError, match="kernel"):
        autotune.candidates(128, 8, 64, "bogus")


@pytest.mark.parametrize("kernel", ["infer", "infer_int8"])
def test_measure_on_the_cpu_runs_the_mechanism(kernel, tmp_path):
    result = autotune.measure(kernel, 128, 4, 64, heads=2, device="cpu")
    assert (result["platform"], result["interpret"]) == ("cpu", True)
    assert result["candidates"] == len(autotune.candidates(128, 4, 64))
    assert result["failed"] == 0 and result["recorded"]
    winner = tuple(result["winner"][k]
                   for k in ("block_q", "block_k", "bh_block"))
    assert autotune.lookup(kernel, 128, 4) == winner
    assert len(result["times_ms"]) == result["candidates"]
    assert result["measured_ms"] == min(result["times_ms"].values()) \
        or abs(result["measured_ms"] - min(result["times_ms"].values())) \
        < 1e-3
    path = str(tmp_path / "w.json")
    autotune.save_winners(path, "cpu")
    assert json.load(open(path))["platform"] == "cpu"


def test_measure_counts_failures_and_raises_when_all_fail(monkeypatch):
    calls = []

    def failing(kernel, seq, bh, depth, heads, dtype, device):
        def call(geom):
            calls.append(geom)
            if geom != autotune.DEFAULT_GEOMETRY:
                raise RuntimeError("refused")
        return call

    monkeypatch.setattr(autotune, "_inputs", failing)
    result = autotune.measure("infer", 128, 4, 64, device="cpu")
    assert result["failed"] == len(autotune.candidates(128, 4, 64)) - 1
    assert result["candidates"] == 1
    assert result["winner"] == {"block_q": 64, "block_k": 64, "bh_block": 1}

    def all_fail(*args):
        def call(geom):
            raise RuntimeError("refused")
        return call

    monkeypatch.setattr(autotune, "_inputs", all_fail)
    with pytest.raises(RuntimeError, match="no candidate"):
        autotune.measure("infer", 128, 4, 64, device="cpu")


# -- the kernels at a forced geometry -------------------------------------------

def _inputs(seed, packed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    if packed:
        sids = np.zeros((B, S), np.int32)
        sids[0, :40], sids[0, 40:100] = 1, 2
        sids[1, :70], sids[1, 70:120], sids[1, 120:] = 1, 2, 3
        return q, k, v, {"sequence_ids": torch.from_numpy(sids)}, \
            {"sequence_ids": jnp.asarray(sids)}
    mask = np.ones((B, S), np.int32)
    mask[1, 77:] = 0
    bias = attention.make_attention_bias(torch.from_numpy(mask))
    return q, k, v, {"bias": bias}, {"bias": jnp.asarray(bias.numpy())}


@pytest.mark.parametrize("geometry", GEOMETRIES,
                         ids=["%dx%dg%d" % g for g in GEOMETRIES])
@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
@pytest.mark.parametrize("kernel", ["infer", "infer_int8"])
def test_kernel_at_a_forced_geometry_matches_jax(kernel, packed, geometry):
    q, k, v, kw, jkw = _inputs(19 + packed, packed)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    ours_fn, jax_fn = ((kattn.flash_attention_infer, jax_flash_infer)
                       if kernel == "infer" else
                       (kattn.flash_attention_infer_int8, jax_flash_int8))
    ours = ours_fn(tq, tk, tv, geometry=geometry, **kw).numpy()
    ref = np.asarray(jax_fn(*map(jnp.asarray, (q, k, v)),
                            geometry=geometry, **jkw))
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(
        ours, ref, atol=ATOL, rtol=0,
        err_msg=f"{kernel} at {geometry} vs the JAX kernel in interpret mode")


@pytest.mark.parametrize("kernel", ["infer", "infer_int8"])
def test_a_geometry_that_does_not_tile_raises(kernel):
    q = torch.zeros(B, S, H, D)
    fn = (kattn.flash_attention_infer if kernel == "infer"
          else kattn.flash_attention_infer_int8)
    for geometry in ((128, 128, 3), (96, 64, 1), (64, 256, 1)):
        with pytest.raises(ValueError, match="does not tile"):
            fn(q, q, q, geometry=geometry)
    # A tile the library does not instantiate for the head dim.
    with pytest.raises(ValueError, match="not instantiated"):
        fn(q, q, q, geometry=(32, 32, 1))
    narrow = torch.zeros(B, S, H, 32)
    with pytest.raises(ValueError, match="not instantiated"):
        fn(narrow, narrow, narrow, geometry=(128, 64, 1))
    # A loaded winner is validated like a forced one; the default takes a
    # ragged length.
    autotune.record_winner(kernel, S, B * H, 128, 128, 3)
    with pytest.raises(ValueError, match="does not tile"):
        fn(q, q, q)
    ragged = torch.zeros(B, 100, H, D)
    assert fn(ragged, ragged, ragged).shape == ragged.shape
    with pytest.raises(ValueError, match="does not tile"):
        fn(ragged, ragged, ragged, geometry=(64, 64, 2))
    assert kattn.infer_geometry(kernel, 100, B * H, D) == \
        autotune.DEFAULT_GEOMETRY


def test_cuda_core_route_takes_only_the_default():
    with pytest.raises(ValueError, match="tensor-core route"):
        kattn._route_geometry("flash_attention_infer", "cuda_cores",
                              (128, 64, 1))
    kattn._route_geometry("flash_attention_infer", "cuda_cores",
                          autotune.DEFAULT_GEOMETRY)
    kattn._route_geometry("flash_attention_infer", "tensor_cores",
                          (128, 64, 1))


# -- the engine and run_server -----------------------------------------------------

CONFIG = dict(hidden_size=128, num_hidden_layers=1, num_attention_heads=2,
              intermediate_size=128, max_position_embeddings=128,
              type_vocab_size=2, next_sentence=True, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0,
              vocab_size=5 + len(TRACE_WORDS) + (8 - (5 + len(TRACE_WORDS))
                                                 % 8) % 8)
TASKS = {"fill_mask": {}, "classify": {"labels": ["neg", "pos"]}}
PAYLOADS = [("fill_mask", {"text": "the cat sat on the [MASK]"}),
            ("classify", {"text": "the dog ran home"})]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return write_trace_vocab(str(tmp_path_factory.mktemp("tune") / "v.txt"))


def _engine(vocab, backend="flash_infer", **kw):
    records = []
    engine = InferenceEngine(
        BertConfig(**CONFIG), BertTokenizer(vocab, do_lower_case=True),
        TASKS, buckets=(48, 128), max_batch_size=2, dtype=torch.float32,
        attention_backend=backend, device="cpu",
        monitor=CompileMonitor(emit=records.append), **kw)
    return engine, records


def test_engine_misconfiguration_fails_with_the_jax_messages(vocab,
                                                            tmp_path):
    with pytest.raises(ValueError, match="requires autotune_cache"):
        _engine(vocab, autotune="measure")
    with pytest.raises(ValueError, match="no geometry to tune"):
        _engine(vocab, backend="dense", autotune="load",
                autotune_cache=str(tmp_path / "w.json"))
    with pytest.raises(ValueError, match="off|load|measure"):
        _engine(vocab, autotune="sometimes",
                autotune_cache=str(tmp_path / "w.json"))
    engine, records = _engine(vocab)
    assert engine.autotune == "off" and records == []


def _server_args(vocab, tmp_path, *extra):
    config = tmp_path / "config.json"
    config.write_text(json.dumps(CONFIG))
    return run_server.parse_arguments([
        "--model_config_file", str(config), "--vocab_file", vocab,
        "--device", "cpu", "--dtype", "float32", "--tasks", "classify",
        "--buckets", "64", *extra])


def test_run_server_flags_reach_the_engine(vocab, tmp_path):
    args = _server_args(vocab, tmp_path)
    assert (args.autotune, args.autotune_cache) == ("off", "")
    with pytest.raises(ValueError, match="requires autotune_cache"):
        run_server.build_service(_server_args(vocab, tmp_path,
                                              "--autotune", "measure"))
    with pytest.raises(ValueError, match="no geometry to tune"):
        run_server.build_service(_server_args(
            vocab, tmp_path, "--autotune", "load", "--autotune_cache",
            str(tmp_path / "w.json"), "--attention_backend", "dense"))
    with pytest.raises(SystemExit):
        _server_args(vocab, tmp_path, "--autotune", "sometimes")
    cache = str(tmp_path / "w.json")
    service = run_server.build_service(_server_args(
        vocab, tmp_path, "--autotune", "load", "--autotune_cache", cache))
    run_server.close_planes(service)
    assert (service.engine.autotune, service.engine.autotune_cache) == (
        "load", cache)
    assert [r["source"] for r in service.engine.autotune_records] == [
        "heuristic"]


def _answers(engine):
    return [engine.run_direct(task, payload) for task, payload in PAYLOADS]


def test_engine_measure_then_load(vocab, tmp_path):
    """measure: one measured record for the bucket with a tile grid (128)
    and a heuristic one for the bucket without (64 does not divide 48, so
    the default is its only candidate), the winners file written and valid in both packages; a restart
    with load: cached, the same digest in the forward names, nothing
    measured, and the same answers."""
    cache = str(tmp_path / "winners.json")
    first, records1 = _engine(vocab, autotune="measure",
                              autotune_cache=cache)
    tuned = [r for r in records1 if r.get("kind") == "autotune"]
    assert [(r["seq"], r["source"]) for r in tuned] == [
        (48, "heuristic"), (128, "measured")]
    for rec in tuned:
        assert rec["kernel"] == "infer" and rec["bh"] == 4
        assert schema.validate_record(rec) == []
        assert jax_schema.validate_record(rec) == []
    measured = tuned[1]
    assert measured["candidates"] == 12 and measured["failed"] == 0
    digest = measured["digest"]
    assert len(digest) == 6 and tuned[0]["digest"] == ""
    with open(cache) as f:
        assert jax_autotune.validate_winners(json.load(f)) == []
    first.warmup()
    assert first.startup["autotune"] == "measure"
    assert f"serve_classify_b128_fp32_g{digest}" in first.startup["forwards"]
    assert "serve_classify_b48_fp32" in first.startup["forwards"]
    answers = _answers(first)

    autotune.clear_winners()
    second, records2 = _engine(vocab, autotune="load", autotune_cache=cache)
    again = [r for r in records2 if r.get("kind") == "autotune"]
    assert [(r["seq"], r["source"]) for r in again] == [
        (48, "heuristic"), (128, "cached")]
    assert again[1]["winner"] == measured["winner"]
    assert again[1]["digest"] == digest
    assert all(schema.validate_record(r) == [] for r in again)
    second.warmup()
    assert second.startup["forwards"] == first.startup["forwards"]
    assert second.forward_name("fill_mask", 128) == \
        f"serve_fill_mask_b128_fp32_g{digest}"
    assert _answers(second) == answers
    # A hot-swap keeps the geometry: the registry is the process's, not
    # the head's.
    ckpt = run_server.save_init_checkpoint(second, str(tmp_path / "ck"))
    second.swap_params("classify", ckpt, "v2")
    assert autotune.name_digest("infer", 128, 4) == digest
    assert second.forward_name("classify", 128) == \
        f"serve_classify_b128_fp32_g{digest}"

    # A measure start over the written file measures nothing new.
    autotune.clear_winners()
    third, records3 = _engine(vocab, autotune="measure",
                              autotune_cache=cache)
    assert [r["source"] for r in records3 if r.get("kind") == "autotune"
            ] == ["heuristic", "cached"]
