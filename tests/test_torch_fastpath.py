"""The port's serving fast path held against the JAX package's on the CPU:
the int8-score attention (TPU kernel #5, through its plain version here),
int8 and bf16 weights in the serving heads, and the fused fill_mask gather
epilogue, in the heads and through the engine.

Tiny config (2 layers, hidden 64, 4 heads). The JAX side runs the Pallas
kernels in interpret mode, as its own tests do. Tolerances:

* the int8 attention's plain version vs the JAX kernel, fp32: q8/k8 and
  scales equal, out within 1e-5 (the same int32 scores; one full softmax
  against the tiled online one);
* heads at ``quant="int8"`` + ``flash_infer_int8`` vs the JAX heads at
  ``quant="int8"`` + ``pallas_infer_int8``, fp32 logits: 2e-2, the JAX
  package's ``INT8_ATTN_MODEL_ATOL`` (the same int8 weights; activations
  quantized per token and per head from fp32 values that differ in their
  last bits can land on the other side of a rounding boundary);
* heads at ``quant="bf16"``, the fused gather and every engine comparison
  without int8: fp32 1e-5.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert_pytorch_tpu import models as jax_models
from bert_pytorch_tpu.config import BertConfig as JaxConfig
from bert_pytorch_tpu.data.tokenization import BertTokenizer as JaxTokenizer
from bert_pytorch_tpu.ops import quant as jax_quant
from bert_pytorch_tpu.ops.pallas.attention import (
    flash_attention_infer_int8 as jax_flash_int8)
from bert_pytorch_tpu.serve import InferenceEngine as JaxEngine
from bert_pytorch_tpu.serve.batcher import Request as JaxRequest
from bert_pytorch_tpu_torch import run_server
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.data.tokenization import BertTokenizer
from bert_pytorch_tpu_torch.models import bert
from bert_pytorch_tpu_torch.models.convert import (from_jax_params,
                                                   quantize_state_dict)
from bert_pytorch_tpu_torch.ops import attention
from bert_pytorch_tpu_torch.ops.kernels import attention as kattn
from bert_pytorch_tpu_torch.serve import InferenceEngine
from bert_pytorch_tpu_torch.serve.batcher import Request
from bert_pytorch_tpu_torch.serve.tasks import GatheredTokens
from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
    TRACE_WORDS, write_trace_vocab)

ATOL = 1e-5
INT8_ATTN_MODEL_ATOL = 2e-2
NUM_LABELS = 3
LABELS = ["neg", "pos"]
TASKS = {"fill_mask": {}, "classify": {"labels": LABELS}}
BUCKET = 16
B, S = 3, 24


def _config_dict(vocab_size=128):
    return dict(vocab_size=vocab_size, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128,
                max_position_embeddings=64, type_vocab_size=2,
                next_sentence=True, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)


def _engine_config():
    vocab = 5 + len(TRACE_WORDS)
    return _config_dict(vocab + (8 - vocab % 8) % 8)


# -- the int8-score attention ------------------------------------------------

def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _packed_ids(batch, seq):
    sids = np.zeros((batch, seq), np.int32)
    sids[0, :9], sids[0, 9:20], sids[0, 20:] = 1, 2, 3
    sids[1, :5], sids[1, 5:14] = 1, 2
    return sids


# The JAX kernel's tile geometry for the parity test's shape (S=32,
# B*H=12), pinned to its heuristic's (block_q, block_k, bh_block): left
# to itself the kernel reads the process-global autotune registry and the
# PALLAS_ATTN_BH_BLOCK variable at trace time, which other tests of the
# same worker process may have set.
JAX_INT8_GEOMETRY = (32, 32, 4)


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_int8_attention_plain_matches_jax_kernel(packed):
    """The wrapper on CPU tensors (its plain version) vs the JAX Pallas
    int8 kernel in interpret mode at a pinned geometry: the same int8 q/k
    and per-head scales, and outputs within 1e-5. Each comparison names
    itself and its gap when it fails."""
    b, s, h, d = 3, 32, 4, 8
    q, k, v = _qkv(11, (b, s, h, d))
    if packed:
        sids = _packed_ids(b, s)
        kw = {"sequence_ids": torch.from_numpy(sids)}
        jkw = {"sequence_ids": jnp.asarray(sids)}
    else:
        mask = np.ones((b, s), np.int32)
        mask[1, 20:], mask[2, 5:] = 0, 0
        kw = {"bias": attention.make_attention_bias(torch.from_numpy(mask))}
        jkw = {"bias": jnp.asarray(kw["bias"].numpy())}
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = kattn.flash_attention_infer_int8.launches
    ours = kattn.flash_attention_infer_int8(tq, tk, tv, **kw)
    assert kattn.flash_attention_infer_int8.launches == before == 0, (
        "a CPU call counted a launch", before,
        kattn.flash_attention_infer_int8.launches)
    torch.testing.assert_close(
        ours, kattn.flash_attention_infer_int8_reference(tq, tk, tv, **kw),
        atol=0, rtol=0, msg=lambda m: f"wrapper vs plain version: {m}")
    q8, q_scale, k8, k_scale = kattn.quantize_qk(tq, tk)
    for label, t8, scale, x in (("q", q8, q_scale, q), ("k", k8, k_scale, k)):
        x3 = x.transpose(0, 2, 1, 3).reshape(b * h, s, d)
        j8, jscale = jax_quant.quantize_symmetric(jnp.asarray(x3), (1, 2))
        np.testing.assert_array_equal(
            t8.numpy(),
            np.asarray(j8).reshape(b, h, s, d).transpose(0, 2, 1, 3),
            err_msg=f"{label}8 vs the JAX quantization")
        np.testing.assert_array_equal(scale.numpy(),
                                      np.asarray(jscale).reshape(b, h),
                                      err_msg=f"{label} scale vs JAX's")
    ref = np.asarray(jax_flash_int8(*map(jnp.asarray, (q, k, v)),
                                    geometry=JAX_INT8_GEOMETRY, **jkw))
    assert np.isfinite(ours.numpy()).all()
    np.testing.assert_allclose(
        ours.numpy(), ref, atol=ATOL, rtol=0,
        err_msg=f"plain version vs the JAX kernel at {JAX_INT8_GEOMETRY}")


def test_int8_backend_rejects_training_dropout():
    x = torch.zeros(1, 16, 2, 8)
    with pytest.raises(ValueError, match="forward-only"):
        attention.dot_product_attention(x, x, x, dropout_rate=0.1,
                                        deterministic=False,
                                        backend="flash_infer_int8")
    out = attention.dot_product_attention(x, x, x,
                                          backend="flash_infer_int8")
    assert out.shape == x.shape


# -- the serving heads ---------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    cfg = JaxConfig(**_config_dict())
    ids = jnp.zeros((1, S), jnp.int32)
    out = {}
    for seed, head in enumerate(("fill_mask", "classify")):
        params = _jax_model(head, "xla", None).init(
            jax.random.PRNGKey(seed), ids, ids, ids)["params"]
        out[head] = jax.tree_util.tree_map(np.asarray, nn.unbox(params))
    return out


def _jax_model(head, backend, quant):
    cfg = JaxConfig(**_config_dict())
    if head == "fill_mask":
        return jax_models.BertForMaskedLM(cfg, dtype=jnp.float32,
                                          attention_backend=backend,
                                          quant=quant)
    return jax_models.BertForSequenceClassification(
        cfg, num_labels=NUM_LABELS, dtype=jnp.float32,
        attention_backend=backend, quant=quant)


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 128, (B, S)).astype(np.int32)
    seg = np.zeros((B, S), np.int32)
    seg[:, S // 2:] = 1
    mask = np.ones((B, S), np.int32)
    mask[1, 15:], mask[2, 4:] = 0, 0
    sids = np.zeros((B, S), np.int32)
    sids[0, :7], sids[0, 7:16], sids[0, 16:] = 1, 2, 3
    sids[1, :10], sids[1, 10:20] = 1, 2
    sids[2, :6] = 1
    cpos = np.array([[0, 7, 16], [0, 10, 0], [0, 0, 0]], np.int32)
    pos = np.array([[1, 5, 20], [0, 3, 3], [2, 0, 0]], np.int32)
    return ids, seg, mask, sids, cpos, pos


def _head_pair(params, head, quant, backend, jax_backend, packed,
               gather=False):
    """(port logits, JAX logits) of one head on the same inputs; the port
    quantizes the fp32 weights itself, JAX through ``quantize_params``."""
    ids, seg, mask, sids, cpos, pos = _inputs()
    cfg = BertConfig(**_config_dict())
    state = from_jax_params(params, cfg, head)
    jparams = params
    if quant:
        state = quantize_state_dict(state, quant)
        jparams = jax_quant.quantize_params(params, quant)
    model = (bert.BertForMaskedLM(cfg, attention_backend=backend, quant=quant)
             if head == "fill_mask" else
             bert.BertForSequenceClassification(
                 cfg, NUM_LABELS, attention_backend=backend, quant=quant))
    model.load_state_dict(state, strict=True)
    j_args = [jnp.asarray(a) for a in (ids, seg, mask)]
    t_args = [torch.from_numpy(a) for a in (ids, seg, mask)]
    kwargs = {}
    if packed:
        extra = (sids, cpos) if head == "classify" else (sids,)
        j_args += [True] + [jnp.asarray(a) for a in extra]
        t_args += [torch.from_numpy(a) for a in extra]
    if gather:
        j_args = j_args + ([] if packed else [True, None]) + [
            jnp.asarray(pos)]
        kwargs["output_positions"] = torch.from_numpy(pos)
    ref = np.asarray(_jax_model(head, jax_backend, quant).apply(
        {"params": jparams}, *j_args))
    with torch.inference_mode():
        ours = model(*t_args, **kwargs).float().numpy()
    return ours, ref


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("head", ["fill_mask", "classify"])
def test_int8_heads_match_jax(jax_params, head, packed, record_property):
    ours, ref = _head_pair(jax_params[head], head, "int8", "flash_infer_int8",
                           "pallas_infer_int8", packed)
    diff = float(np.abs(ours - ref).max())
    record_property("max_abs_diff", diff)
    print(f"int8 {head} {'packed' if packed else 'unpacked'}: max |port - "
          f"jax| {diff:.3e} (atol {INT8_ATTN_MODEL_ATOL:g})")
    assert ours.shape == ref.shape
    assert diff <= INT8_ATTN_MODEL_ATOL, diff


@pytest.mark.parametrize("head", ["fill_mask", "classify"])
def test_bf16_heads_match_jax(jax_params, head):
    """bf16-stored weights computed in fp32 on both sides: the same values,
    so the fp32 bar holds."""
    ours, ref = _head_pair(jax_params[head], head, "bf16", "flash_infer",
                           "pallas_infer", packed=True)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_fused_gather_head_matches_jax(jax_params, packed):
    """``output_positions`` gathers the hidden rows before the vocab
    projection: [B, P, V] equal to the JAX head's and to the unfused
    head's rows at those positions."""
    ours, ref = _head_pair(jax_params["fill_mask"], "fill_mask", None,
                           "flash_infer", "pallas_infer", packed, gather=True)
    pos = _inputs()[-1]
    assert ours.shape == (B, pos.shape[1], 128)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    full, _ = _head_pair(jax_params["fill_mask"], "fill_mask", None,
                         "flash_infer", "xla", packed)
    np.testing.assert_allclose(
        ours, full[np.arange(B)[:, None], pos], atol=ATOL, rtol=0)


# -- the engine -------------------------------------------------------------

@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    return write_trace_vocab(str(tmp_path_factory.mktemp("vocab")
                                 / "vocab.txt"))


def _jax_engine(vocab_file, **kw):
    return JaxEngine(JaxConfig(**_engine_config()),
                     JaxTokenizer(vocab_file, do_lower_case=True), TASKS,
                     buckets=(BUCKET,), max_batch_size=2,
                     max_requests_per_pack=2, dtype=jnp.float32, seed=7,
                     fuse_epilogues=True, **kw)


@pytest.fixture(scope="module")
def jax_fused(vocab_file):
    eng = _jax_engine(vocab_file, attention_backend="xla")
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def jax_int8(vocab_file):
    eng = _jax_engine(vocab_file, attention_backend="pallas_infer_int8",
                      quantize="int8")
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def weights(jax_fused):
    cfg = BertConfig(**_engine_config())
    return {name: from_jax_params(
        jax.tree_util.tree_map(np.asarray, spec.params), cfg, name)
        for name, spec in jax_fused.tasks.items()}


def _engine(vocab_file, weights, **kw):
    tasks = {name: dict(opts, weights=weights[name])
             for name, opts in TASKS.items()}
    options = dict(buckets=(BUCKET,), max_batch_size=2,
                   max_requests_per_pack=2, dtype=torch.float32,
                   device="cpu", fuse_epilogues=True)
    options.update(kw)
    eng = InferenceEngine(BertConfig(**_engine_config()),
                          BertTokenizer(vocab_file, do_lower_case=True),
                          tasks, **options)
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def port_fused(vocab_file, weights):
    return _engine(vocab_file, weights, attention_backend="flash_infer")


@pytest.fixture(scope="module")
def port_int8(vocab_file, weights):
    return _engine(vocab_file, weights, attention_backend="flash_infer_int8",
                   quantize="int8")


PAYLOADS = {
    "fill_mask": [{"text": "the capital of [MASK] is paris"},
                  {"text": "[MASK] wrote [MASK]", "top_k": 3},
                  {"text": "paris is [MASK]"}],
    "classify": [{"text": "paris is big"},
                 {"text": "the river runs", "text_pair": "through london"},
                 {"text": "william shakespeare wrote hamlet"}],
}


def _assert_results_close(ours, ref, atol):
    if "masks" in ours:
        assert len(ours["masks"]) == len(ref["masks"])
        for a, b in zip(ours["masks"], ref["masks"]):
            np.testing.assert_allclose([s["score"] for s in a],
                                       [s["score"] for s in b], atol=atol)
            if atol <= ATOL:
                assert [s["id"] for s in a] == [s["id"] for s in b]
    else:
        assert ours["scores"].keys() == ref["scores"].keys()
        for key in ours["scores"]:
            assert abs(ours["scores"][key] - ref["scores"][key]) <= atol
        if atol <= ATOL:
            assert ours["label"] == ref["label"]


def _execute_packed(engine, task, request_cls):
    """One packed plan of the task's payloads: (plan, outputs, info)."""
    handler = engine.tasks[task].handler
    reqs = [request_cls(task, handler.prepare(p, engine.max_len()), p)
            for p in PAYLOADS[task]]
    plan = engine.plan_batch(reqs, packed=True)
    outputs, info = engine.execute(task, plan)
    return plan, outputs, info


def _raw(out):
    return np.asarray(out.logits if hasattr(out, "logits") else out,
                      np.float32)


@pytest.mark.parametrize("task", ["fill_mask", "classify"])
def test_fused_engine_matches_jax(port_fused, jax_fused, task):
    """run_direct and a packed plan through fused-epilogue engines: the
    port's (fp32, flash_infer) against the JAX package's (fp32, xla), the
    gathered rows within 1e-5; classify is unchanged by the flag."""
    for payload in PAYLOADS[task]:
        _assert_results_close(port_fused.run_direct(task, payload),
                              jax_fused.run_direct(task, payload), ATOL)
    plan, outs, info = _execute_packed(port_fused, task, Request)
    jplan, jouts, jinfo = _execute_packed(jax_fused, task, JaxRequest)
    assert [len(r) for r in plan.rows] == [len(r) for r in jplan.rows]
    assert info["fused"] == jinfo["fused"] == (task == "fill_mask")
    assert max(len(r) for r in plan.rows) > 1
    for ours, ref in zip(outs, jouts):
        assert isinstance(ours, GatheredTokens) == (task == "fill_mask")
        np.testing.assert_allclose(_raw(ours), _raw(ref), atol=ATOL, rtol=0)


def test_fused_gather_equals_unfused_rows(port_fused):
    """The fused batch's gathered rows are the unfused batch's [MASK] rows
    (the same engine staged without the epilogue), packed and unpacked, and
    the JSON results agree."""
    for packed in (False, True):
        handler = port_fused.tasks["fill_mask"].handler
        reqs = [Request("fill_mask", handler.prepare(p, BUCKET), p)
                for p in PAYLOADS["fill_mask"]]
        plan = port_fused.plan_batch(reqs, packed=packed)
        fused, info = port_fused.execute("fill_mask", plan)
        port_fused.fuse_epilogues = False
        try:
            unfused, info_u = port_fused.execute("fill_mask", plan)
            direct = port_fused.run_direct("fill_mask",
                                           PAYLOADS["fill_mask"][1])
        finally:
            port_fused.fuse_epilogues = True
        assert info["fused"] and not info_u["fused"]
        for req, got, full in zip(plan.requests, fused, unfused):
            assert isinstance(got, GatheredTokens)
            np.testing.assert_allclose(
                got.logits, full[req.features["mask_positions"]], atol=ATOL,
                rtol=0)
    _assert_results_close(
        port_fused.run_direct("fill_mask", PAYLOADS["fill_mask"][1]), direct,
        ATOL)


@pytest.mark.parametrize("task", ["fill_mask", "classify"])
def test_int8_engine_matches_jax(port_int8, jax_int8, task, record_property):
    """int8 weights + int8-score attention + fused gather on both sides:
    the port quantizes the same fp32 weights the JAX engine quantizes."""
    worst = 0.0
    plan, outs, info = _execute_packed(port_int8, task, Request)
    _, jouts, jinfo = _execute_packed(jax_int8, task, JaxRequest)
    assert info["fused"] == jinfo["fused"] == (task == "fill_mask")
    for ours, ref in zip(outs, jouts):
        worst = max(worst, float(np.abs(_raw(ours) - _raw(ref)).max()))
    for payload in PAYLOADS[task]:
        _assert_results_close(port_int8.run_direct(task, payload),
                              jax_int8.run_direct(task, payload),
                              INT8_ATTN_MODEL_ATOL)
    record_property("max_abs_diff", worst)
    print(f"int8 engine {task}: max |port - jax| {worst:.3e}")
    assert worst <= INT8_ATTN_MODEL_ATOL, worst


def test_int8_engine_loads_a_jax_quantized_tree(vocab_file, port_int8,
                                                jax_int8):
    """Weights already quantized by the JAX engine (``quantize_params``),
    carried across by ``from_jax_params``, serve the same logits as the
    port's own quantization of the fp32 weights."""
    cfg = BertConfig(**_engine_config())
    quantized = {name: from_jax_params(spec.params, cfg, name)
                 for name, spec in jax_int8.tasks.items()}
    assert quantized["fill_mask"][
        "bert.encoder.layers.0.attention.query.weight_q"].dtype == torch.int8
    eng = _engine(vocab_file, quantized,
                  attention_backend="flash_infer_int8", quantize="int8")
    for task in TASKS:
        _, ours, _ = _execute_packed(eng, task, Request)
        _, ref, _ = _execute_packed(port_int8, task, Request)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(_raw(a), _raw(b))


def test_slot_overflow_falls_back(vocab_file, weights):
    """A batch whose [MASK]s exceed the gather quota runs the unfused
    forward (the whole token plane), with the same result."""
    eng = _engine(vocab_file, weights, attention_backend="flash_infer",
                  epilogue_slots=1)
    assert eng.startup["warmup_forwards"] == 6  # fill_mask x2 + classify
    handler = eng.tasks["fill_mask"].handler
    for payload, fused in (({"text": "[MASK] is [MASK]"}, False),
                           ({"text": "paris is [MASK]"}, True)):
        feats = handler.prepare(payload, BUCKET)
        plan = eng.plan_batch([Request("fill_mask", feats, payload)],
                              packed=False)
        (out,), info = eng.execute("fill_mask", plan)
        assert info["fused"] is fused
        assert isinstance(out, GatheredTokens) is fused
        if not fused:
            assert out.shape[0] == len(feats["input_ids"])
    eng.fuse_epilogues = False
    unfused = eng.run_direct("fill_mask", {"text": "[MASK] is [MASK]"})
    eng.fuse_epilogues = True
    _assert_results_close(
        eng.run_direct("fill_mask", {"text": "[MASK] is [MASK]"}), unfused,
        ATOL)


def test_startup_reports_quantize_and_weight_bytes(port_fused, port_int8,
                                                   jax_fused, jax_int8):
    """``weight_bytes`` counts parameters AND buffers (the int8 weights and
    their scales are buffers): byte for byte the JAX engines' numbers."""
    for ours, ref, mode in ((port_fused, jax_fused, "none"),
                            (port_int8, jax_int8, "int8")):
        assert ours.startup["quantize"] == ref.startup["quantize"] == mode
        assert ours.startup["fuse_epilogues"] is True
        assert ours.startup["weight_bytes"] == ref.startup["weight_bytes"]
        assert ours.startup["weight_bytes"] == sum(
            ours.startup["weight_bytes_by_task"].values())
    assert (port_int8.startup["weight_bytes"]
            < port_fused.startup["weight_bytes"] / 2)


def test_fast_path_cli_flags(vocab_file, tmp_path):
    import json

    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(_engine_config()))
    base = ["--model_config_file", str(cfg_path), "--vocab_file", vocab_file,
            "--device", "cpu", "--dtype", "float32", "--buckets", "16",
            "--tasks", "fill_mask"]
    args = run_server.parse_arguments(base)
    assert (args.quantize, args.fuse_epilogues, args.epilogue_slots) == (
        "none", False, 8)
    args = run_server.parse_arguments(base + [
        "--quantize", "int8", "--attention_backend", "flash_infer_int8",
        "--fuse_epilogues", "--epilogue_slots", "4"])
    assert (args.quantize, args.attention_backend, args.fuse_epilogues,
            args.epilogue_slots) == ("int8", "flash_infer_int8", True, 4)
    engine = run_server.build_service(args).engine
    assert (engine.quantize, engine.fuse_epilogues,
            engine.epilogue_slots) == ("int8", True, 4)
    out = engine.run_direct("fill_mask", {"text": "paris is [MASK]"})
    assert len(out["masks"][0]) == 5
    for bad in (["--quantize", "int4"], ["--attention_backend",
                                         "pallas_infer_int8"]):
        with pytest.raises(SystemExit):
            run_server.parse_arguments(base + bad)
    with pytest.raises(ValueError, match="epilogue_slots"):
        run_server.build_service(run_server.parse_arguments(
            base + ["--fuse_epilogues", "--epilogue_slots", "0"]))
