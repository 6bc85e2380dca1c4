"""The port's weight quantization (ops/quant.py, models/convert.py
``quantize_state_dict``) held against the JAX package's ``ops/quant.py`` on
the CPU. Inputs come from a numpy seed and go to both packages.

Tolerances: the int8 values and the fp32 scales are EQUAL (the same
host-side numpy transform, and for activations the same fp32 division and
round-half-to-even); ``int8_matmul``'s fp32 output within 1e-6 (the same
int32 sums, rescaled in the same order).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert_pytorch_tpu import models as jax_models
from bert_pytorch_tpu.config import BertConfig as JaxConfig
from bert_pytorch_tpu.ops import quant as jax_quant
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.models import bert
from bert_pytorch_tpu_torch.models.convert import (from_jax_params,
                                                   quantize_state_dict)
from bert_pytorch_tpu_torch.ops import quant

MATMUL_ATOL = 1e-6
CONFIG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=128,
              max_position_embeddings=64, type_vocab_size=2,
              next_sentence=True)
NUM_LABELS = 3
HEADS = ("fill_mask", "classify")


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.fixture(scope="module")
def jax_params():
    """fp32 params of both JAX serving heads (tiny config)."""
    cfg = JaxConfig(**CONFIG)
    ids = jnp.zeros((1, 16), jnp.int32)
    out = {}
    for seed, head in enumerate(HEADS):
        model = (jax_models.BertForMaskedLM(cfg, dtype=jnp.float32)
                 if head == "fill_mask" else
                 jax_models.BertForSequenceClassification(
                     cfg, num_labels=NUM_LABELS, dtype=jnp.float32))
        params = model.init(jax.random.PRNGKey(seed), ids, ids, ids)["params"]
        out[head] = jax.tree_util.tree_map(np.asarray, nn.unbox(params))
    return out


@pytest.mark.parametrize("per_axis0", [False, True])
def test_quantize_array_is_the_jax_transform(per_axis0):
    w = (_rng(0).standard_normal((3, 16, 24)) * 0.05).astype(np.float32)
    q, scale = quant.quantize_array(w, per_axis0=per_axis0)
    jq, jscale = jax_quant.quantize_array(w, per_axis0=per_axis0)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(scale, jscale)
    assert q.dtype == np.int8 and scale.dtype == np.float32
    np.testing.assert_array_equal(quant.dequantize_array(q, scale),
                                  jax_quant.dequantize_array(jq, jscale))


@pytest.mark.parametrize("grain", ["per_token", "per_head"])
def test_quantize_symmetric_matches_jax(grain):
    """Per token (``int8_matmul``'s activations, last axis) and per (batch,
    head) over (S, D) (the int8 attention's q/k; JAX reduces the [B*H, S,
    D] layout over axes (1, 2)): equal ints and scales. Values on exact .5
    boundaries are planted to exercise round-half-to-even."""
    x = _rng(1).standard_normal((2, 12, 4, 8)).astype(np.float32) * 3
    # Scale 1.0 on this token and this head: 2.5 -> 2, 3.5 -> 4, -2.5 -> -2.
    x[0, 0, 0, :4] = [127.0, 2.5, 3.5, -2.5]
    if grain == "per_token":
        q, scale = quant.quantize_symmetric(torch.from_numpy(x), -1)
        jq, jscale = jax_quant.quantize_symmetric(jnp.asarray(x), -1)
    else:
        q, scale = quant.quantize_symmetric(torch.from_numpy(x), (1, 3))
        x3 = x.transpose(0, 2, 1, 3).reshape(8, 12, 8)
        jq, jscale = jax_quant.quantize_symmetric(jnp.asarray(x3), (1, 2))
        jq = np.asarray(jq).reshape(2, 4, 12, 8).transpose(0, 2, 1, 3)
        jscale = np.asarray(jscale).reshape(2, 1, 4, 1)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


@pytest.mark.parametrize("rows", [8, 40])
def test_int8_matmul_matches_jax(rows):
    """[rows, K] activations against an int8 [K, N] kernel (the port takes
    its [N, K] transpose), per-token activation scales, fp32 out."""
    rng = _rng(2)
    x = rng.standard_normal((rows, 64)).astype(np.float32)
    kq, kscale = jax_quant.quantize_array(
        rng.standard_normal((64, 48)).astype(np.float32) * 0.02)
    ref = np.asarray(jax_quant.int8_matmul(jnp.asarray(x), jnp.asarray(kq),
                                           jnp.asarray(kscale)))
    ours = quant.int8_matmul(torch.from_numpy(x),
                             torch.from_numpy(np.ascontiguousarray(kq.T)),
                             torch.from_numpy(kscale))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=MATMUL_ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("head", HEADS)
def test_quantized_state_dict_matches_jax_quantize_params(jax_params, head,
                                                          mode):
    """The port's ``quantize_state_dict`` of the fp32 state equals JAX's
    ``quantize_params`` carried across by ``from_jax_params``: the same
    keys, int8 weights equal (the JAX kernel transposed), one scale per
    encoder layer equal to JAX's per-layer scale, excluded output layers
    bf16, embeddings and LayerNorm fp32."""
    cfg = BertConfig(**CONFIG)
    ours = quantize_state_dict(from_jax_params(jax_params[head], cfg, head),
                               mode)
    jtree = jax_quant.quantize_params(jax_params[head], mode)
    theirs = from_jax_params(jtree, cfg, head)
    assert set(ours) == set(theirs)
    for key in ours:
        assert ours[key].dtype == theirs[key].dtype, key
        assert torch.equal(ours[key], theirs[key]), key
    model = (bert.BertForMaskedLM(cfg, quant=mode) if head == "fill_mask"
             else bert.BertForSequenceClassification(cfg, NUM_LABELS,
                                                     quant=mode))
    model.load_state_dict(ours, strict=True)
    query = jtree["bert"]["encoder"]["layers"]["attention"]["query"]
    if mode == "int8":
        for i in range(cfg.num_hidden_layers):
            prefix = f"bert.encoder.layers.{i}.attention.query"
            np.testing.assert_array_equal(
                ours[f"{prefix}.weight_q"].numpy(),
                query["kernel_q"][i].reshape(cfg.hidden_size, -1).T)
            assert ours[f"{prefix}.weight_scale"].item() == float(
                query["kernel_scale"][i])
            assert ours[f"{prefix}.bias"].dtype == torch.bfloat16
    assert ours["bert.embeddings.word_embeddings.weight"].dtype == (
        torch.float32)
    assert ours["bert.embeddings.layer_norm.scale"].dtype == torch.float32
    if head == "classify":
        assert ours["head.classifier.weight"].dtype == torch.bfloat16
        assert ours["head.classifier.bias"].dtype == torch.bfloat16
    else:
        assert ours["predictions.bias"].dtype == torch.float32


def test_make_dense_modes():
    for mode, kind, dtype in ((None, bert.Dense, torch.float32),
                              ("bf16", bert.Dense, torch.bfloat16),
                              ("int8", quant.Int8Dense, torch.int8)):
        layer = bert.make_dense(mode, 16, 8, torch.float32)
        assert type(layer) is kind
        weight = layer.weight_q if mode == "int8" else layer.weight
        assert weight.dtype == dtype and weight.shape == (8, 16)
    with pytest.raises(ValueError, match="quantize mode"):
        bert.make_dense("int4", 16, 8, torch.float32)
    assert quant.exclude("int8") == "bf16"
    assert quant.exclude("bf16") == "bf16" and quant.exclude(None) is None


def test_weight_bytes_counts_buffers():
    layer = quant.Int8Dense(64, 32, torch.float32)
    assert [name for name, _ in layer.named_buffers()] == [
        "weight_q", "weight_scale"]
    assert quant.weight_bytes(layer) == 64 * 32 + 4 + 32 * 2
    dense = bert.Dense(64, 32, torch.float32)
    assert quant.weight_bytes(dense) == (64 * 32 + 32) * 4


def test_int8_dense_matches_jax_int8_dense():
    """One Int8Dense forward against the JAX module with the same int8
    kernel, scale and bf16 bias: ``y.to(dtype) + bias.to(dtype)``."""
    rng = _rng(3)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    kq, kscale = jax_quant.quantize_array(
        rng.standard_normal((32, 16)).astype(np.float32) * 0.1)
    bias = rng.standard_normal(16).astype(np.float32)
    jparams = {"kernel_q": kq, "kernel_scale": kscale,
               "bias": jnp.asarray(bias, jnp.bfloat16)}
    ref = jax_quant.Int8Dense(16, dtype=jnp.float32).apply(
        {"params": jparams}, jnp.asarray(x))
    layer = quant.Int8Dense(32, 16, torch.float32)
    layer.load_state_dict({
        "weight_q": torch.from_numpy(np.ascontiguousarray(kq.T)),
        "weight_scale": torch.from_numpy(kscale),
        "bias": torch.from_numpy(bias).to(torch.bfloat16)})
    with torch.inference_mode():
        ours = layer(torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               atol=MATMUL_ATOL, rtol=0)
