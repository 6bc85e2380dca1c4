"""Google TF checkpoints in the port, held against TensorFlow and the JAX
package on the CPU.

``tensorflow`` appears here only, as the writer of the checkpoints and as
the oracle that reads them back (``tf.train.load_checkpoint``); the port
reads the bundle with numpy alone (``models/tf_bundle.py``). Tolerances:
the raw tensors are equal exactly; the converted state dict equals the
JAX ``load_tf_checkpoint`` -> ``convert_torch_state_dict`` result within
rtol 1e-6 (it is the same arithmetic, a transpose and a pad).
"""

import json
import os
import re
import struct
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert_pytorch_tpu import models as jax_models
from bert_pytorch_tpu.config import BertConfig as JaxConfig
from bert_pytorch_tpu.models import convert as jax_convert
from bert_pytorch_tpu_torch import finetune, run_glue, run_squad
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.models import bert
from bert_pytorch_tpu_torch.models.convert import (from_jax_params,
                                                   from_torch_state_dict,
                                                   load_tf_checkpoint)
from bert_pytorch_tpu_torch.models.tf_bundle import (FOOTER_BYTES,
                                                     TFCheckpointReader)
from bert_pytorch_tpu_torch.tools import make_synthetic_data as synth

tf = pytest.importorskip("tensorflow")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-6
VOCAB = 37  # the demo vocab's tokens, padded to 40 by the runners
CONFIG = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=64,
              max_position_embeddings=64, type_vocab_size=2,
              next_sentence=True, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)


def _tf_variables(params) -> dict:
    """The JAX pretraining params under Google's TF names (the mapping of
    tests/test_convert.py), plus the optimizer slots and the step counter
    a released checkpoint carries."""
    sd = jax_convert.export_torch_state_dict(params, JaxConfig(**CONFIG))
    out = {}
    for name, arr in sd.items():
        if name == "cls.predictions.decoder.weight":
            continue
        tf_name = name.replace(".", "/")
        tf_name = tf_name.replace("LayerNorm/weight", "LayerNorm/gamma")
        tf_name = tf_name.replace("LayerNorm/bias", "LayerNorm/beta")
        tf_name = re.sub(r"layer/(\d+)", r"layer_\1", tf_name)
        if tf_name == "cls/seq_relationship/weight":
            tf_name = "cls/seq_relationship/output_weights"
        elif tf_name == "cls/seq_relationship/bias":
            tf_name = "cls/seq_relationship/output_bias"
        elif tf_name == "cls/predictions/bias":
            tf_name = "cls/predictions/output_bias"
        elif tf_name.endswith("/weight") and "embeddings" not in tf_name:
            tf_name, arr = tf_name[:-len("/weight")] + "/kernel", arr.T
        out[tf_name] = np.ascontiguousarray(arr, np.float32)
    out["bert/pooler/dense/kernel/adam_m"] = np.ones((32, 32), np.float32)
    out["global_step"] = np.array(7, np.int64)
    return out


def _save(variables: dict, prefix: str, shards: int) -> None:
    """A TF checkpoint at ``prefix``: TensorFlow's Saver for one data
    file; for two, each half saved on its own and merged the way the
    sharded Saver does (``MergeV2Checkpoints``)."""
    names = sorted(variables)
    if shards == 1:
        with tf.compat.v1.Graph().as_default():
            saved = [tf.compat.v1.get_variable(
                n, initializer=tf.constant(variables[n])) for n in names]
            saver = tf.compat.v1.train.Saver(saved)
            with tf.compat.v1.Session() as sess:
                sess.run(tf.compat.v1.global_variables_initializer())
                saver.save(sess, prefix, write_meta_graph=False)
        return
    parts = []
    for i, half in enumerate((names[::2], names[1::2])):
        part = f"{prefix}_temp/part-{i:05d}-of-00002"
        tf.raw_ops.SaveV2(prefix=part, tensor_names=half,
                          shape_and_slices=[""] * len(half),
                          tensors=[tf.constant(variables[n]) for n in half])
        parts.append(part)
    tf.raw_ops.MergeV2Checkpoints(checkpoint_prefixes=parts,
                                  destination_prefix=prefix)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    ids = jnp.zeros((1, 16), jnp.int32)
    params = nn.unbox(jax.jit(jax_models.BertForPreTraining(
        JaxConfig(**CONFIG)).init)(jax.random.PRNGKey(3), ids, ids,
                                   ids)["params"])
    params = jax.tree_util.tree_map(np.asarray, params)
    variables = _tf_variables(params)
    out = {"params": params, "variables": variables}
    for shards in (1, 2):
        root = tmp_path_factory.mktemp(f"tf{shards}")
        _save(variables, str(root / "bert_model.ckpt"), shards)
        out[shards] = str(root / "bert_model.ckpt")
    return out


@pytest.mark.parametrize("shards", [1, 2])
def test_bundle_reads_equal_to_tensorflow(checkpoints, shards):
    prefix = checkpoints[shards]
    reader = TFCheckpointReader(prefix)
    assert reader.num_shards == shards
    assert len({e["shard_id"] for e in reader.entries.values()}) == shards
    oracle = tf.train.load_checkpoint(prefix)
    want = oracle.get_variable_to_shape_map()
    assert reader.shapes() == want
    assert set(want) == set(checkpoints["variables"])
    for name in want:
        got, ref = reader.get_tensor(name), oracle.get_tensor(name)
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref, err_msg=name)


@pytest.mark.parametrize("shards", [1, 2])
def test_conversion_equals_jax(checkpoints, shards):
    """Port: load_tf_checkpoint -> from_torch_state_dict; JAX:
    load_tf_checkpoint -> convert_torch_state_dict -> from_jax_params
    (the JAX reader needs TensorFlow; the port's does not)."""
    prefix = checkpoints[shards]
    cfg = BertConfig(**dict(CONFIG, vocab_size=40))
    got = from_torch_state_dict(load_tf_checkpoint(prefix), cfg,
                                "pretraining")
    jax_params = jax_convert.convert_torch_state_dict(
        jax_convert.load_tf_checkpoint(prefix),
        JaxConfig(**dict(CONFIG, vocab_size=40)))
    want = from_jax_params(jax_params, cfg, "pretraining")
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   rtol=RTOL, atol=0, err_msg=key)
    direct = from_jax_params(checkpoints["params"], BertConfig(**CONFIG),
                             "pretraining")
    np.testing.assert_array_equal(
        got["bert.encoder.layers.1.attention.query.weight"].numpy(),
        direct["bert.encoder.layers.1.attention.query.weight"].numpy())


@pytest.fixture(scope="module")
def runner_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("runners")
    vocab = synth.write_trace_vocab(str(root / "vocab.txt"))
    config = root / "model.json"
    config.write_text(json.dumps(dict(CONFIG, vocab_file=vocab,
                                      tokenizer="wordpiece")))
    return {"vocab": vocab, "config": str(config),
            "mrpc": synth.write_mrpc_tsvs(str(root / "MRPC"), 0, 8, 4),
            "squad": synth.write_squad_json(str(root / "s.json"), 0, 1)}


def _assert_encoder_loaded(model, prefix):
    cfg = BertConfig(**dict(CONFIG, vocab_size=40))
    want = from_torch_state_dict(load_tf_checkpoint(prefix), cfg,
                                 "pretraining")
    state = model.state_dict()
    keys = [k for k in want if k.startswith("bert.")]
    assert keys and all(k in state for k in keys)
    for key in keys:
        torch.testing.assert_close(state[key], want[key], atol=0, rtol=0)


@pytest.mark.parametrize("form", ["prefix", "directory"])
def test_runners_load_a_tf_checkpoint(checkpoints, runner_files, tmp_path,
                                      form):
    """``run_squad`` and ``run_glue`` ``--init_checkpoint`` take the
    prefix and the ``bert_model.ckpt*`` directory alike."""
    prefix = checkpoints[2]
    path = prefix if form == "prefix" else os.path.dirname(prefix)
    args = run_squad.parse_args([
        "--config_file", runner_files["config"], "--output_dir",
        str(tmp_path / "squad"), "--train_file", runner_files["squad"],
        "--do_train", "--do_lower_case", "--device", "cpu", "--dtype",
        "float32", "--init_checkpoint", path])
    model, _ = run_squad.build_model(args, torch.device("cpu"))
    _assert_encoder_loaded(model, prefix)
    args = run_glue.parse_arguments([
        "--task", "mrpc", "--data_dir", runner_files["mrpc"],
        "--model_config_file", runner_files["config"], "--device", "cpu",
        "--dtype", "float32", "--init_checkpoint", path])
    config = finetune.load_config(args.model_config_file)
    model = finetune.init_model(
        bert.BertForSequenceClassification(config, 2), config, args.seed,
        args.init_checkpoint)
    _assert_encoder_loaded(model, prefix)


def test_a_compressed_index_block_is_refused_by_name(checkpoints,
                                                          tmp_path):
    """A data block of the index stored with snappy (byte 1 in its
    trailer) is refused by name, before any tensor is read."""
    data = bytearray(open(checkpoints[1] + ".index", "rb").read())
    footer = bytes(data[-FOOTER_BYTES:])

    def varint(buf, pos):
        value = shift = 0
        while True:
            byte = buf[pos]
            pos += 1
            value |= (byte & 0x7F) << shift
            if not byte & 0x80:
                return value, pos
            shift += 7

    _, pos = varint(footer, 0)
    _, pos = varint(footer, pos)
    index_offset, pos = varint(footer, pos)
    index_size, _ = varint(footer, pos)
    # The index block's first entry: its value is the first data block's
    # handle (shared 0, unshared, value size, key, value).
    block = bytes(data[index_offset:index_offset + index_size])
    _, p = varint(block, 0)
    unshared, p = varint(block, p)
    _, p = varint(block, p)
    offset, p = varint(block, p + unshared)
    size, _ = varint(block, p)
    data[offset + size] = 1
    bad = tmp_path / "bert_model.ckpt"
    (tmp_path / "bert_model.ckpt.index").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="compressed with snappy"):
        TFCheckpointReader(str(bad))
    assert struct.unpack("<Q", bytes(data[-8:]))[0] == 0xDB4775248B80FB57


def test_reads_without_tensorflow(checkpoints, tmp_path):
    """In a fresh interpreter where tensorflow cannot be imported, the
    port reads the two-shard checkpoint equal to TensorFlow's reading."""
    want = {k: v for k, v in checkpoints["variables"].items()}
    np.savez(tmp_path / "want.npz", **{k.replace("/", "|"): v
                                       for k, v in want.items()})
    code = (
        "import sys\n"
        "sys.modules['tensorflow'] = None\n"
        "import numpy as np\n"
        "from bert_pytorch_tpu_torch.models.tf_bundle import "
        "TFCheckpointReader\n"
        f"reader = TFCheckpointReader({checkpoints[2]!r})\n"
        f"want = np.load({str(tmp_path / 'want.npz')!r})\n"
        "assert sorted(reader.shapes()) == sorted(k.replace('|', '/') "
        "for k in want.files)\n"
        "for key in want.files:\n"
        "    got = reader.get_tensor(key.replace('|', '/'))\n"
        "    assert got.dtype == want[key].dtype\n"
        "    assert np.array_equal(got, want[key]), key\n"
        "print('ok', len(want.files))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
