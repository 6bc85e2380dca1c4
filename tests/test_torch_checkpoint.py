"""The port's checkpoint code held against the JAX package's on the CPU.

* the msgpack codec (``utils/flax_msgpack.py``) against flax and msgpack:
  it decodes ``msgpack_serialize``'s bytes to equal values, encodes the
  same trees to byte-identical bytes that ``msgpack_restore`` reads back
  equal, and skips to the offsets ``msgpack.Unpacker.skip`` reaches;
* ``utils/checkpoint.py load_params_only`` on JAX ``save_checkpoint``
  files: exact against ``from_jax_params`` of the same params, no leaf
  outside ``model`` decoded, and exact against ``quantize_state_dict`` and
  JAX's own streamed quantization;
* the other direction: a checkpoint the port writes verifies and loads in
  the JAX package;
* ``load_pretrained_encoder`` on a JAX checkpoint against JAX's, on the
  encoder output at fp32 1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from bert_pytorch_tpu import models as jax_models
from bert_pytorch_tpu.config import BertConfig as JaxConfig
from bert_pytorch_tpu.models import convert as jax_convert
from bert_pytorch_tpu.ops import quant as jax_quant
from bert_pytorch_tpu.utils import checkpoint as jax_ckpt
from bert_pytorch_tpu.utils import integrity as jax_integrity
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.models import bert
from bert_pytorch_tpu_torch.models.convert import (from_jax_params,
                                                   load_pretrained_encoder,
                                                   quantize_state_dict,
                                                   to_jax_params)
from bert_pytorch_tpu_torch.utils import checkpoint as ckpt
from bert_pytorch_tpu_torch.utils import flax_msgpack, integrity

CONFIG = dict(vocab_size=48, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=64,
              max_position_embeddings=64, type_vocab_size=2,
              next_sentence=True, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
ATOL = 1e-5


def _to_torch(tree):
    """A flax-style tree with its numpy leaves as torch tensors."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    if isinstance(tree, np.ndarray):
        if tree.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(tree.astype(np.float32)).to(
                torch.bfloat16)
        return torch.from_numpy(tree.copy())
    return tree


def _assert_same(ours, ref, where="root"):
    """``ours`` (port decode) equals ``ref`` (flax decode) exactly."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and list(ours) == list(ref), where
        for key in ref:
            _assert_same(ours[key], ref[key], f"{where}/{key}")
    elif isinstance(ref, list):
        assert len(ours) == len(ref), where
        for i, (a, b) in enumerate(zip(ours, ref)):
            _assert_same(a, b, f"{where}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert isinstance(ours, torch.Tensor), where
        assert tuple(ours.shape) == ref.shape, where
        if ref.dtype == ml_dtypes.bfloat16:
            assert ours.dtype == torch.bfloat16, where
            np.testing.assert_array_equal(ours.float().numpy(),
                                          ref.astype(np.float32))
        else:
            assert ours.numpy().dtype == ref.dtype, where
            np.testing.assert_array_equal(ours.numpy(), ref)
    else:
        assert type(ours) is type(ref) and ours == ref, where


def _trees():
    rng = np.random.default_rng(0)
    return {
        "mixed_leaves": {
            "model": {
                "dense": {"kernel": rng.standard_normal(
                              (3, 4)).astype(np.float32),
                          "bias": np.zeros(4, np.float32)},
                "emb": {"embedding": rng.standard_normal(
                    (5, 2)).astype(ml_dtypes.bfloat16)},
                "q": {"kernel_q": rng.integers(
                          -127, 128, (7, 3)).astype(np.int8),
                      "kernel_scale": np.float32(0.25) * np.ones(
                          (), np.float32)},
                "ids": np.arange(6, dtype=np.int32).reshape(2, 3),
            },
            "epoch": 3, "step": 70000, "loss_scale": -200, "lr": 1.5e-4,
            "name": "x" * 40, "none": None, "flag": True,
            "npscalar": np.float32(2.5), "count": np.int32(-7),
            "history": [1, {"z": 2, "y": np.float64(1.0)}],
            "empty": np.zeros((0, 3), np.float32),
            "zero_d": np.asarray(3.0, np.float32),
        },
        "wide_headers": {
            f"k{i:03d}": rng.standard_normal((i % 5 + 1,)).astype(np.float32)
            for i in range(40)} | {"long": "y" * 300,
                                   "big": np.zeros(20000, np.int8)},
    }


@pytest.mark.parametrize("name", ["mixed_leaves", "wide_headers"])
def test_codec_matches_flax(name):
    tree = _trees()[name]
    ref = serialization.msgpack_serialize(tree)
    decoded, end = flax_msgpack.decode(ref)
    assert end == len(ref)
    _assert_same(decoded, serialization.msgpack_restore(ref))
    # Byte-identical from torch leaves and from numpy leaves; flax reads it.
    assert flax_msgpack.encode(_to_torch(tree)) == ref
    assert flax_msgpack.encode(tree) == ref
    # skip lands where msgpack.Unpacker.skip lands, key by key.
    unpacker = msgpack.Unpacker(raw=False)
    unpacker.feed(ref)
    n, pos = flax_msgpack.map_header(ref, 0)
    assert n == unpacker.read_map_header()
    for _ in range(2 * n):
        unpacker.skip()
        pos = flax_msgpack.skip(ref, pos)
        assert pos == unpacker.tell()


def test_codec_chunked_leaf(monkeypatch):
    """Leaves above flax's chunk size are written as chunked maps (12
    chunks here, so the chunk keys are not in sorted order)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 16)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 16)
    rng = np.random.default_rng(1)
    tree = {"model": {"w": {"kernel": rng.standard_normal(
                (3, 15)).astype(np.float32)},
                      "b": {"bias": np.arange(10, dtype=np.int8)}},
            "small": rng.standard_normal(2).astype(np.float32)}
    ref = serialization.msgpack_serialize(tree)
    assert flax_msgpack.encode(_to_torch(tree)) == ref
    decoded, _ = flax_msgpack.decode(ref)
    np.testing.assert_array_equal(decoded["model"]["w"]["kernel"].numpy(),
                                  tree["model"]["w"]["kernel"])
    back = serialization.msgpack_restore(
        flax_msgpack.encode(_to_torch(tree)))
    np.testing.assert_array_equal(back["model"]["w"]["kernel"],
                                  tree["model"]["w"]["kernel"])


def test_codec_refuses_truncated_bytes():
    ref = serialization.msgpack_serialize(_trees()["mixed_leaves"])
    with pytest.raises(flax_msgpack.MsgpackError):
        flax_msgpack.decode(ref[: len(ref) // 2])
    with pytest.raises(flax_msgpack.MsgpackError):
        flax_msgpack.skip(ref[: len(ref) // 2])


# -- params-only load -------------------------------------------------------

def _jax_params(head: str, seed: int = 0):
    cfg = JaxConfig(**CONFIG)
    model = {"fill_mask": jax_models.BertForMaskedLM,
             "squad": jax_models.BertForQuestionAnswering}[head](
        cfg, dtype=jnp.float32)
    import flax.linen as nn

    params = nn.unbox(model.init(
        jax.random.PRNGKey(seed),
        *(jnp.zeros((1, 16), jnp.int32),) * 3))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(head: str, quant=None, device=None):
    cfg = BertConfig(**CONFIG)
    if head == "fill_mask":
        return bert.BertForMaskedLM(cfg, quant=quant, device=device)
    return bert.BertForQuestionAnswering(cfg, quant=quant, device=device)


def _target(head: str):
    return _port_model(head, device="meta").state_dict()


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX training-style checkpoint of the squad head:
    {model, optimizer (twice the params), epoch}."""
    params = _jax_params("squad")
    optimizer = {"mu": jax.tree_util.tree_map(lambda x: x + 1, params),
                 "nu": jax.tree_util.tree_map(lambda x: x * 2, params)}
    path = jax_ckpt.save_checkpoint(
        str(tmp_path_factory.mktemp("jax_ckpt")), 3,
        {"model": params, "optimizer": optimizer, "epoch": 1})
    return path, params


def test_load_params_only_restores_model_exactly(jax_checkpoint,
                                                 monkeypatch):
    path, params = jax_checkpoint
    decoded = []
    array = flax_msgpack._array

    def counting(buf, pos, end):
        decoded.append(pos)
        return array(buf, pos, end)

    monkeypatch.setattr(flax_msgpack, "_array", counting)
    state = ckpt.load_params_only(path, _target("squad"))
    want = from_jax_params(params, BertConfig(**CONFIG), "squad")
    assert set(state) == set(want)
    for key, value in want.items():
        torch.testing.assert_close(state[key], value, atol=0, rtol=0,
                                   msg=key)
    # One decoded array per model leaf: no optimizer leaf was decoded.
    assert len(decoded) == len(jax.tree_util.tree_leaves(params))
    model = _port_model("squad")
    model.load_state_dict(state, strict=True)


def test_load_params_only_refuses_bad_checkpoints(jax_checkpoint, tmp_path):
    path, params = jax_checkpoint
    wrong = dict(CONFIG, hidden_size=64, intermediate_size=128)
    with pytest.raises(ckpt.CheckpointShapeError, match="shape"):
        ckpt.load_params_only(path, bert.BertForQuestionAnswering(
            BertConfig(**wrong), device="meta").state_dict())
    deeper = dict(CONFIG, num_hidden_layers=3)
    with pytest.raises(ckpt.CheckpointShapeError, match="stacked layers"):
        ckpt.load_params_only(path, bert.BertForQuestionAnswering(
            BertConfig(**deeper), device="meta").state_dict())
    with pytest.raises(KeyError, match="no top-level"):
        ckpt.load_params_only(path, _target("squad"), key="params")
    # One byte flipped in the middle: the manifest's sha256 catches it.
    corrupt = tmp_path / "ckpt_3.msgpack"
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    corrupt.write_bytes(bytes(blob))
    with open(path + integrity.MANIFEST_SUFFIX) as f:
        (tmp_path / ("ckpt_3.msgpack" + integrity.MANIFEST_SUFFIX)
         ).write_text(f.read())
    with pytest.raises(ckpt.CheckpointCorruptError, match="sha256"):
        ckpt.load_params_only(str(corrupt), _target("squad"))


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_streamed_quantization_is_exact(jax_checkpoint, mode):
    """Quantized while streaming, module by module: equal bit for bit to
    quantize_state_dict of the fp32 load, and to from_jax_params of the
    JAX package's own streamed quantized tree."""
    path, params = jax_checkpoint
    streamed = ckpt.load_params_only(path, _target("squad"), quantize=mode)
    fp32 = ckpt.load_params_only(path, _target("squad"))
    want = quantize_state_dict(fp32, mode)
    jax_tree = jax_ckpt.load_params_only(path, params, quantize=mode)
    jax_state = from_jax_params(jax_tree, BertConfig(**CONFIG), "squad")
    assert set(streamed) == set(want) == set(jax_state)
    for key in want:
        assert streamed[key].dtype == want[key].dtype == jax_state[key].dtype
        assert torch.equal(streamed[key], want[key]), key
        assert torch.equal(streamed[key], jax_state[key]), key
    model = _port_model("squad", quant=mode)
    model.load_state_dict(streamed, strict=True)


def test_sharded_checkpoint_loads_equal_to_gathered(devices, tmp_path):
    """A JAX sharded-layout checkpoint written on the 8-device CPU mesh
    (each leaf's last axis sharded where it divides, replicated where not)
    loads equal to its gathered twin, reading only the model slices."""
    params = _jax_params("fill_mask", seed=3)
    mesh = Mesh(np.array(devices), ("x",))

    def put(x):
        spec = (PartitionSpec(*([None] * (x.ndim - 1) + ["x"]))
                if x.ndim and x.shape[-1] % 8 == 0 else PartitionSpec())
        return jax.device_put(x, NamedSharding(mesh, spec))

    sharded = jax.tree_util.tree_map(put, params)
    optimizer = jax.tree_util.tree_map(lambda x: put(x * 2), params)
    jax_ckpt.save_checkpoint(str(tmp_path / "sharded"), 5,
                             {"model": sharded, "optimizer": optimizer},
                             layout="sharded", mesh_spec={"x": 8})
    gathered = jax_ckpt.save_checkpoint(str(tmp_path / "gathered"), 5,
                                        {"model": params})
    index = ckpt.checkpoint_path(str(tmp_path / "sharded"), 5)
    assert integrity.read_manifest(index)["layout"] == "sharded"
    got = ckpt.load_params_only(index, _target("fill_mask"))
    want = ckpt.load_params_only(gathered, _target("fill_mask"))
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    got8 = ckpt.load_params_only(index, _target("fill_mask"),
                                 quantize="int8")
    want8 = quantize_state_dict(want, "int8")
    for key in want8:
        assert torch.equal(got8[key], want8[key]), key


def test_port_checkpoint_verifies_and_loads_in_jax(tmp_path):
    """The port's save_checkpoint of to_jax_params: JAX's integrity check
    says verified, and JAX's load_params_only restores the same params
    (fp32 exactly; a quantized state dict round-trips too)."""
    params = _jax_params("squad", seed=4)
    cfg = BertConfig(**CONFIG)
    state = from_jax_params(params, cfg, "squad")
    back = to_jax_params(state, cfg, "squad")
    path = ckpt.save_checkpoint(str(tmp_path), 0,
                                {"model": back, "epoch": 0})
    assert jax_integrity.verify_checkpoint(path)[0] == "verified"
    assert integrity.verify_checkpoint(path)[0] == "verified"
    manifest = json.loads(open(path + integrity.MANIFEST_SUFFIX).read())
    assert manifest["keys"] == ["epoch", "model"]
    restored = jax_ckpt.load_params_only(path, params)
    for (kp, a), b in zip(jax.tree_util.tree_flatten_with_path(restored)[0],
                          jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b,
                                      err_msg=jax.tree_util.keystr(kp))
    # The bytes are flax's own for the same tree.
    assert open(path, "rb").read() == serialization.msgpack_serialize(
        {"model": params, "epoch": 0})
    quantized = quantize_state_dict(state, "int8")
    qpath = ckpt.save_checkpoint(str(tmp_path / "q"), 0, {
        "model": to_jax_params(quantized, cfg, "squad")})
    jax_q = jax_quant.quantize_params(params, "int8")
    qback = serialization.msgpack_restore(open(qpath, "rb").read())["model"]
    for (kp, a), b in zip(jax.tree_util.tree_flatten_with_path(qback)[0],
                          jax.tree_util.tree_leaves(jax_q)):
        np.testing.assert_array_equal(np.asarray(a).astype(np.float32),
                                      np.asarray(b).astype(np.float32),
                                      err_msg=jax.tree_util.keystr(kp))


def test_checkpoint_discovery(tmp_path):
    assert ckpt.latest_checkpoint(str(tmp_path / "missing")) is None
    for step in (2, 10, 7):
        ckpt.save_checkpoint(str(tmp_path), step, {"epoch": step})
    (tmp_path / "ckpt_11.msgpack.tmp").write_bytes(b"")
    assert ckpt.find_resume_step(str(tmp_path)) == 10
    assert ckpt.latest_checkpoint(str(tmp_path)) == ckpt.checkpoint_path(
        str(tmp_path), 10)
    # A truncated file fails its manifest.
    path = ckpt.checkpoint_path(str(tmp_path), 10)
    assert integrity.verify_checkpoint(path)[0] == integrity.VERIFIED
    with open(path, "r+b") as f:
        f.truncate(3)
    assert integrity.verify_checkpoint(path)[0] == integrity.CORRUPT


def test_load_pretrained_encoder_reads_jax_checkpoints(tmp_path):
    """run_squad --init_checkpoint ckpt_N.msgpack: the encoder of a JAX
    pretraining-style checkpoint under a fresh QA model, against the JAX
    load_pretrained_encoder on the same file (encoder output, fp32 1e-5);
    the QA head keeps its own init."""
    params = _jax_params("fill_mask", seed=5)
    path = jax_ckpt.save_checkpoint(
        str(tmp_path), 100,
        {"model": params, "optimizer": {"mu": params}, "epoch": 2})
    cfg = BertConfig(**CONFIG)
    model = bert.init_weights(bert.BertForQuestionAnswering(cfg), 0.02,
                              torch.Generator().manual_seed(0))
    head = model.qa_outputs.weight.detach().clone()
    load_pretrained_encoder(path, cfg, model)
    torch.testing.assert_close(model.qa_outputs.weight.detach(), head)

    jcfg = JaxConfig(**CONFIG)
    jmodel = jax_models.BertForQuestionAnswering(jcfg, dtype=jnp.float32)
    import flax.linen as nn

    target = nn.unbox(jmodel.init(jax.random.PRNGKey(9),
                                  *(jnp.zeros((1, 16), jnp.int32),) * 3)
                      )["params"]
    loaded = jax_convert.load_pretrained_encoder(path, jcfg, target)
    rng = np.random.default_rng(2)
    ids = rng.integers(5, 48, (2, 16)).astype(np.int32)
    seg = np.zeros((2, 16), np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 11:] = 0
    encoder = jax_models.BertModel(jcfg, dtype=jnp.float32)
    ref, _ = encoder.apply({"params": loaded["bert"]}, ids, seg, mask)
    with torch.no_grad():
        out, _ = model.bert(torch.from_numpy(ids), torch.from_numpy(seg),
                            torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    with pytest.raises(ckpt.CheckpointShapeError, match="lacks"):
        empty = ckpt.save_checkpoint(str(tmp_path / "e"), 0,
                                     {"model": {"other": {"b": np.zeros(2)}}})
        load_pretrained_encoder(empty, cfg, model)
    assert os.path.exists(path)
