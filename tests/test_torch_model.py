"""The PyTorch port's serving heads held against the JAX package's models
on the CPU: JAX weights carried across with ``from_jax_params``, the same
numpy inputs through both, fp32 logits within 1e-5.

Tiny config (vocab 128, hidden 32, 2 layers, 4 heads). The JAX side runs
``attention_backend="pallas_infer"`` (the Pallas kernel in interpret mode)
against the port's ``"flash_infer"`` (the kernel's plain version on CPU
tensors), and ``"xla"`` against ``"dense"``.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert_pytorch_tpu import models as jax_models
from bert_pytorch_tpu.config import BertConfig as JaxConfig
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.models import bert
from bert_pytorch_tpu_torch.models.convert import from_jax_params

ATOL = 1e-5
CONFIG = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=64,
              max_position_embeddings=64, type_vocab_size=2,
              next_sentence=True)
NUM_LABELS = 3
B, S = 3, 24
BACKENDS = {"flash_infer": "pallas_infer", "dense": "xla"}


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, CONFIG["vocab_size"], (B, S)).astype(np.int32)
    seg = np.zeros((B, S), np.int32)
    seg[:, S // 2:] = 1
    mask = np.ones((B, S), np.int32)
    mask[1, 15:], mask[2, 4:] = 0, 0
    # Packed rows: three sequences, two then pad, one short then pad.
    sids = np.zeros((B, S), np.int32)
    sids[0, :7], sids[0, 7:16], sids[0, 16:] = 1, 2, 3
    sids[1, :10], sids[1, 10:20] = 1, 2
    sids[2, :6] = 1
    cpos = np.array([[0, 7, 16], [0, 10, 0], [0, 0, 0]], np.int32)
    return ids, seg, mask, sids, cpos


def _jax_model(head, backend):
    cfg = JaxConfig(**CONFIG)
    if head == "fill_mask":
        return jax_models.BertForMaskedLM(cfg, dtype=jnp.float32,
                                          attention_backend=backend)
    return jax_models.BertForSequenceClassification(
        cfg, num_labels=NUM_LABELS, dtype=jnp.float32,
        attention_backend=backend)


def _torch_model(head, backend):
    cfg = BertConfig(**CONFIG)
    if head == "fill_mask":
        return bert.BertForMaskedLM(cfg, attention_backend=backend)
    return bert.BertForSequenceClassification(cfg, NUM_LABELS,
                                              attention_backend=backend)


@pytest.fixture(scope="module")
def jax_params():
    ids = jnp.zeros((1, S), jnp.int32)
    out = {}
    for seed, head in enumerate(("fill_mask", "classify")):
        params = _jax_model(head, "xla").init(
            jax.random.PRNGKey(seed), ids, ids, ids)["params"]
        out[head] = jax.tree_util.tree_map(np.asarray, nn.unbox(params))
    return out


def _forward_pair(head, backend, params, packed):
    ids, seg, mask, sids, cpos = _inputs()
    jmodel = _jax_model(head, BACKENDS[backend])
    tmodel = _torch_model(head, backend)
    tmodel.load_state_dict(from_jax_params(params, BertConfig(**CONFIG), head))
    j_args = [jnp.asarray(a) for a in (ids, seg, mask)]
    t_args = [torch.from_numpy(a) for a in (ids, seg, mask)]
    if packed:
        extra = (sids, cpos) if head == "classify" else (sids,)
        j_args += [True] + [jnp.asarray(a) for a in extra]
        t_args += [torch.from_numpy(a) for a in extra]
    ref = np.asarray(jmodel.apply({"params": params}, *j_args))
    with torch.no_grad():
        ours = tmodel(*t_args).numpy()
    return ours, ref


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("head", ["fill_mask", "classify"])
def test_head_logits_match_jax_flash(jax_params, head, packed):
    ours, ref = _forward_pair(head, "flash_infer", jax_params[head], packed)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("head", ["fill_mask", "classify"])
def test_head_logits_match_jax_dense(jax_params, head):
    ours, ref = _forward_pair(head, "dense", jax_params[head], packed=True)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


def test_from_jax_params_maps_every_parameter(jax_params):
    cfg = BertConfig(**CONFIG)
    for head in ("fill_mask", "classify"):
        state = from_jax_params(jax_params[head], cfg, head)
        model = _torch_model(head, "dense")
        assert set(state) == set(model.state_dict())
        q = jax_params[head]["bert"]["encoder"]["layers"]["attention"][
            "query"]["kernel"]
        np.testing.assert_array_equal(
            state["bert.encoder.layers.1.attention.query.weight"].numpy(),
            q[1].reshape(cfg.hidden_size, -1).T)
    with pytest.raises(KeyError, match="head"):
        from_jax_params(jax_params["fill_mask"], cfg, "classify")
    with pytest.raises(ValueError, match="unknown head"):
        from_jax_params(jax_params["fill_mask"], cfg, "summarize")


def test_packed_positions_restart_per_sequence():
    cfg = BertConfig(**CONFIG)
    emb = bert.init_weights(bert.BertEmbeddings(cfg, torch.float32), 1.0,
                            torch.Generator().manual_seed(0))
    ids = torch.tensor([[5, 6, 7, 8, 9, 0]])
    sids = torch.tensor([[1, 1, 2, 2, 2, 0]])
    with torch.no_grad():
        packed = emb(ids, sequence_ids=sids)
        solo = emb(ids[:, 2:5])
    torch.testing.assert_close(packed[:, 2:5], solo)


def test_bf16_weight_copy_follows_parameter_updates():
    """A bf16 forward computes from a cached bf16 copy of the fp32
    weights; an in-place update of the fp32 weights refreshes it."""
    cfg = BertConfig(**CONFIG)
    g = torch.Generator().manual_seed(0)
    model = bert.init_weights(
        bert.BertForSequenceClassification(cfg, NUM_LABELS, torch.bfloat16),
        0.2, g)
    ids = torch.randint(1, 128, (2, 8), generator=g)
    with torch.inference_mode():
        first = model(ids)
        assert first.dtype == torch.bfloat16
        assert model.head.classifier.weight.dtype == torch.float32
        again = model(ids)
    torch.testing.assert_close(first, again, atol=0, rtol=0)
    state = {k: v * 2 if k.endswith("classifier.weight") else v
             for k, v in model.state_dict().items()}
    model.load_state_dict(state)
    with torch.inference_mode():
        assert not torch.equal(model(ids), first)
