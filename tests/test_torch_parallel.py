"""The port's data-parallel and fully-sharded pretraining held against the
JAX package on the CPU, over real gloo process groups.

The JAX references run here, on the conftest's virtual 8-device CPU mesh
(``dp=2``, ``dp=1,fsdp=2`` and ``dp=2,fsdp=2`` meshes over its first
devices); the port's ranks run in processes of their own
(tests/_torch_parallel_worker.py, torch and numpy only), which rendezvous
through a ``file://`` in the test's directory and take their inputs as
numpy files. One process group carries every case of a world size, so
torch starts once per rank.

Tiny config: 2 layers, hidden 64, fp32, dropout 0 unless a case says
otherwise. Every batch puts UNEQUAL masked counts on the ranks, so a step
that averaged per-rank means would miss the JAX step's global mean.
Bars: the loss at rtol 1e-6 and every parameter after one optimizer step
at atol 1e-6 (the JAX package's own composed-strategy bar); the overlap
against the plain reduction at 1e-6; the grad-health norms at rtol 1e-5
(the single-process bar of tests/test_torch_pretraining.py).
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert_pytorch_tpu import optim as jax_optim
from bert_pytorch_tpu import pretrain as jax_pretrain
from bert_pytorch_tpu.config import BertConfig as JaxConfig
from bert_pytorch_tpu.models import BertForPreTraining as JaxPreTraining
from bert_pytorch_tpu.parallel import (MeshSpec as JaxMeshSpec,
                                       create_mesh as jax_create_mesh,
                                       logical_axis_rules)
from bert_pytorch_tpu.utils import checkpoint as jax_ckpt
from bert_pytorch_tpu.utils import integrity as jax_integrity
from bert_pytorch_tpu_torch import pretrain
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.models import bert
from bert_pytorch_tpu_torch.models.convert import from_jax_params
from bert_pytorch_tpu_torch.optim import schedules, transforms
from bert_pytorch_tpu_torch.parallel import launcher, mesh, overlap
from bert_pytorch_tpu_torch.utils import checkpoint as ckpt
from bert_pytorch_tpu_torch.utils import integrity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_parallel_worker.py")
CONFIG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=128,
              max_position_embeddings=32, type_vocab_size=2,
              next_sentence=True, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
A, B, S, P = 2, 8, 32, 8
SCHEDULE = (4e-3, 0.128, 100)
RTOL = ATOL = 1e-6
HEALTH_RTOL = 1e-5
# Each quarter of every microbatch masks at its own rate: ranks of dp=2
# (halves) and of dp=2,fsdp=2 (quarters) hold different masked counts.
MASK_RATES = (0.45, 0.3, 0.15, 0.06)


def _batch(rng, packed=False):
    """One [B, S] microbatch (the JAX package's composed-strategy
    layouts), its label rate varying by quarter of the rows."""
    rate = np.repeat(MASK_RATES, B // len(MASK_RATES))[:, None]
    ids = rng.integers(5, CONFIG["vocab_size"], (B, S)).astype(np.int32)
    batch = {"input_ids": ids,
             "segment_ids": rng.integers(0, 2, (B, S)).astype(np.int32),
             "input_mask": np.ones((B, S), np.int32),
             "masked_lm_labels": np.where(rng.random((B, S)) < rate, ids,
                                          -1).astype(np.int32),
             "next_sentence_labels": rng.integers(0, 2, B).astype(np.int32)}
    if not packed:
        batch["input_mask"][1, 20:] = 0
        batch["masked_lm_labels"][1, 20:] = -1
        return batch
    batch.update(sequence_ids=np.zeros((B, S), np.int32),
                 cls_positions=np.zeros((B, 2), np.int32),
                 next_sentence_labels=np.full((B, 2), -1, np.int32))
    for i in range(B):
        n1, n2 = (int(x) for x in rng.integers(S // 4, S // 2, 2))
        batch["input_mask"][i] = 0
        batch["input_mask"][i, :n1 + n2] = 1
        batch["sequence_ids"][i, :n1] = 1
        batch["sequence_ids"][i, n1:n1 + n2] = 2
        batch["cls_positions"][i] = [0, n1]
        batch["next_sentence_labels"][i] = rng.integers(0, 2, 2)
        batch["masked_lm_labels"][i, n1 + n2:] = -1
    return batch


def _stacked(seed, packed=False):
    rng = np.random.default_rng(seed)
    mbs = [_batch(rng, packed) for _ in range(A)]
    return {k: np.stack([mb[k] for mb in mbs]) for k in mbs[0]}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v)})
    return out


def _jax_config(**over):
    return JaxConfig(**dict(CONFIG, **over))


def _jax_params(seed=5):
    model = JaxPreTraining(_jax_config(), dtype=jnp.float32)
    ids = jnp.zeros((1, S), jnp.int32)
    return jax.tree_util.tree_map(np.asarray, nn.unbox(
        model.init(jax.random.PRNGKey(seed), ids, ids, ids))["params"])


def _jax_tx(name, clip=None):
    if name == "lamb":
        return jax_optim.lamb(jax_optim.warmup_poly_schedule(*SCHEDULE),
                              weight_decay_mask=jax_optim.no_decay_mask)
    return jax_optim.bert_adam(1e-3, warmup=0.1, t_total=100,
                               weight_decay_mask=jax_optim.no_decay_mask,
                               max_grad_norm=clip)


def _jax_mesh(spec_text):
    spec = JaxMeshSpec.parse(spec_text)
    n = spec.data * spec.fsdp
    return spec, jax_create_mesh(spec.mesh_config(),
                                 devices=jax.devices()[:n])


def _jax_state(spec_text, params, tx_name="lamb", clip=None, packed=False):
    """(mesh, step, state on it, batch shardings) of the JAX step on the
    ``spec_text`` mesh, from ``params``."""
    spec, jmesh = _jax_mesh(spec_text)
    model = JaxPreTraining(_jax_config(), dtype=jnp.float32)
    schedule = jax_optim.warmup_poly_schedule(*SCHEDULE)
    tx = _jax_tx(tx_name, clip)
    sample = (jnp.zeros((1, S), jnp.int32),) * 3
    dims = {"input_ids": 3, "segment_ids": 3, "input_mask": 3,
            "masked_lm_labels": 3, "next_sentence_labels": 3 if packed else 2}
    if packed:
        dims.update(sequence_ids=3, cls_positions=3)
    with jmesh:
        shardings = jax_pretrain.state_shardings(
            jmesh, model, logical_axis_rules(spec), sample)
        b_shardings = jax_pretrain.batch_shardings(jmesh, dims)
        state = jax_pretrain.make_init_fn(model, tx, sample, shardings)(
            jax.random.PRNGKey(5))
        state = dataclasses.replace(
            state, params=jax.device_put(params, shardings.params))
        step = jax_pretrain.make_train_step(
            model, tx, schedule=schedule, next_sentence=True,
            shardings=shardings, batch_shardings_=b_shardings,
            max_pred_per_seq=P, stats_every=1)
    return jmesh, step, state, b_shardings


def _jax_step(spec_text, params, batch, **kw):
    jmesh, step, state, b_shardings = _jax_state(spec_text, params, **kw)
    with jmesh:
        state, metrics = step(state, jax_pretrain.put_batch(
            batch, b_shardings))
        from bert_pytorch_tpu.telemetry import model_stats as jax_stats

        health = jax_stats.health_record(1, metrics["grad_health"])
        out = {k: float(metrics[k]) for k in
               ("loss", "grad_norm", "mlm_accuracy", "real_tokens")}
        out["health_grad_norm"] = health["grad_norm"]
        out["health_update_ratio"] = health["update_ratio"]
    return out, jax.device_get(state)


def _port_names(jax_tree):
    return {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, jax_tree), BertConfig(**CONFIG),
        "pretraining").items()}


class Group:
    """The ranks of one world size, running a plan of cases in the
    background; :meth:`result` waits for them and reads a case's output."""

    def __init__(self, root, world, cases):
        self.root, self.world = str(root), world
        self.out = os.path.join(self.root, "out")
        os.makedirs(self.out, exist_ok=True)
        plan = {"world": world, "init": os.path.join(self.root, "rdzv"),
                "out": self.out, "cases": cases}
        path = os.path.join(self.root, "plan.json")
        with open(path, "w") as f:
            json.dump(plan, f)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, path, str(r)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        self.logs = None

    def wait(self):
        if self.logs is None:
            self.logs = [p.communicate(timeout=240)[0] for p in self.procs]
            for r, p in enumerate(self.procs):
                assert p.returncode == 0, f"rank {r}:\n{self.logs[r][-3000:]}"
        return self

    def json(self, name, rank=0):
        self.wait()
        with open(os.path.join(self.out, f"{name}.rank{rank}.json")) as f:
            return json.load(f)

    def npz(self, name, rank=0):
        self.wait()
        return dict(np.load(os.path.join(self.out,
                                         f"{name}.rank{rank}.npz")))


def _case(name, kind, root, mesh_text, batch="unpacked", **extra):
    return dict(name=name, kind=kind, config=CONFIG, mesh=mesh_text,
                params=str(root / "params.npz"),
                batch=str(root / f"batch_{batch}.npz"), max_pred=P,
                schedule=list(SCHEDULE), **extra)


AGREE = [[7, 7], [5, 7], [None, None], [None, 7]]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The shared inputs and the JAX 2-way sharded checkpoint (one JAX
    step on a dp=1,fsdp=2 mesh, saved sharded) the port resumes."""
    root = tmp_path_factory.mktemp("parallel")
    params = _jax_params()
    np.savez(root / "params.npz", **_flat(params))
    batches = {"unpacked": _stacked(1), "packed": _stacked(2, packed=True),
               "next": _stacked(3)}
    for name, batch in batches.items():
        np.savez(root / f"batch_{name}.npz", **batch)
    jmesh, step, state, b_shardings = _jax_state("dp=1,fsdp=2", params)
    with jmesh:
        state, _ = step(state, jax_pretrain.put_batch(batches["unpacked"],
                                                      b_shardings))
        jax_ckpt.save_checkpoint(
            str(root / "jax_sharded"), 1,
            {"model": state.params, "optimizer": state.opt_state,
             "sampler": {"index": 0}, "epoch": 0}, layout="sharded",
            mesh_spec=JaxMeshSpec.parse("dp=1,fsdp=2").as_dict())
        jax_ckpt.save_checkpoint(
            str(root / "jax_gathered"), 1,
            {"model": state.params, "optimizer": state.opt_state,
             "sampler": {"index": 0}, "epoch": 0})
    return root, params, batches


@pytest.fixture(scope="module")
def world2(inputs):
    root, _, _ = inputs
    dropout = dict(CONFIG, hidden_dropout_prob=0.1,
                   attention_probs_dropout_prob=0.1)
    cases = [
        _case("dp_unpacked", "step", root, "dp=2"),
        _case("dp_packed", "step", root, "dp=2", batch="packed"),
        _case("dp_overlap", "step", root, "dp=2", overlap=True),
        _case("fsdp_lamb", "step", root, "fsdp=2"),
        _case("fsdp_bertadam", "step", root, "fsdp=2",
              optimizer="bertadam", clip=0.05),
        _case("fsdp_remat", "step", root, "fsdp=2", remat="dots"),
        _case("fp16_inf", "fp16_inf", root, "fsdp=2", fp16=True),
        dict(_case("dropout", "dropout", root, "dp=2"), config=dropout),
        dict(name="agree", kind="agree", proposals=AGREE),
        _case("save_sharded", "save", root, "fsdp=2", layout="sharded",
              dir=str(root / "port_sharded")),
        _case("save_async", "save", root, "fsdp=2", layout="sharded",
              dir=str(root / "port_async"), **{"async": True}),
        _case("save_gathered", "save", root, "fsdp=2", layout="gathered",
              dir=str(root / "port_gathered")),
        _case("resume_jax_w2", "resume", root, "fsdp=2", batch="next",
              dir=str(root / "jax_sharded")),
        _case("resume_port_w2", "resume", root, "dp=2", batch="next",
              dir=str(root / "port_sharded")),
    ]
    return Group(root / "w2", 2, cases)


@pytest.fixture(scope="module")
def world4(inputs):
    root, _, _ = inputs
    return Group(root / "w4", 4, [
        _case("hsdp_lamb", "step", root, "dp=2,fsdp=2"),
        _case("hsdp_fp16_inf", "fp16_inf", root, "dp=2,fsdp=2", fp16=True)])


@pytest.fixture(scope="module")
def jax_refs(inputs):
    """The JAX package's step on each mesh the port's cases run."""
    _, params, batches = inputs
    refs = {}
    for name, spec, kw in (
            ("dp_unpacked", "dp=2", {}),
            ("dp_packed", "dp=2", {"packed": True}),
            ("fsdp_lamb", "dp=1,fsdp=2", {}),
            ("fsdp_bertadam", "dp=1,fsdp=2",
             {"tx_name": "bert_adam", "clip": 0.05}),
            ("hsdp_lamb", "dp=2,fsdp=2", {})):
        batch = batches["packed" if kw.get("packed") else "unpacked"]
        metrics, state = _jax_step(spec, params, batch, **kw)
        refs[name] = (metrics, _port_names(state.params))
    return refs


def _check_step(result, params, ref, name):
    metrics, want = ref
    for key in ("loss", "grad_norm", "mlm_accuracy", "real_tokens"):
        np.testing.assert_allclose(result[key], metrics[key], rtol=RTOL,
                                   err_msg=f"{name} {key}")
    for key in ("health_grad_norm", "health_update_ratio"):
        np.testing.assert_allclose(result[key], metrics[key],
                                   rtol=HEALTH_RTOL, err_msg=f"{name} {key}")
    assert result["finite"] == 1.0
    assert set(params) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(params[key], value, atol=ATOL, rtol=0,
                                   err_msg=f"{name} {key}")


# -- the mesh grammar (JAX tests/test_one_mesh.py:44-90, case by case) ----

@pytest.mark.parametrize("text, data, fsdp, canonical", [
    ("dp=4,fsdp=2,pipe=1,seq=1", 4, 2, "dp=4,fsdp=2"),
    ("dp=-1,fsdp=2", -1, 2, "dp=-1,fsdp=2"),
    ("data=2", 2, 1, "dp=2"),
    ("dp=8", 8, 1, "dp=8"),
    ("fsdp=2", -1, 2, "dp=-1,fsdp=2"),
])
def test_mesh_spec_parse_and_canonical(text, data, fsdp, canonical):
    spec = mesh.MeshSpec.parse(text)
    assert (spec.data, spec.fsdp) == (data, fsdp)
    assert spec.canonical() == canonical
    assert mesh.MeshSpec.parse(spec.canonical()) == spec
    jax_spec = JaxMeshSpec.parse(text)
    assert spec.as_dict() == jax_spec.as_dict()
    assert spec.canonical() == jax_spec.canonical()


@pytest.mark.parametrize("text, want", [
    ("data=2,pp=2,tp=2", dict(data=2, pipe=2, model=2)),
    ("dp=2,ring=4", dict(data=2, seq=4)),
    ("dp=2,sp=2", dict(data=2, seq=2)),
    ("dp=2,dcn=2", dict(data=2, dcn_data=2)),
])
def test_mesh_spec_aliases(text, want):
    assert mesh.MeshSpec.parse(text) == mesh.MeshSpec(**want)


def test_mesh_spec_dict_round_trip_and_active_axes():
    d = mesh.MeshSpec.parse("dp=2,fsdp=2,seq=2").as_dict()
    assert all(isinstance(v, int) for v in d.values())
    assert d == JaxMeshSpec.parse("dp=2,fsdp=2,seq=2").as_dict()
    assert mesh.MeshSpec.from_dict(d) == mesh.MeshSpec.parse(
        "dp=2,fsdp=2,seq=2")
    assert mesh.parse_mesh_spec("dp=8") == mesh.MeshSpec(data=8)
    for text in ("dp=1", "dp=-1,fsdp=2", "dp=2,fsdp=2,pipe=2,tp=2"):
        assert (mesh.MeshSpec.parse(text).active_axes()
                == JaxMeshSpec.parse(text).active_axes()), text
    assert mesh.MeshSpec.from_strategy("fsdp", data=2, fsdp=2) == \
        mesh.MeshSpec(data=2, fsdp=2)
    with pytest.raises(mesh.MeshSpecError, match="unknown strategy"):
        mesh.MeshSpec.from_strategy("zero3")


@pytest.mark.parametrize("text, match", [
    ("dp=4,bogus=2", "unknown mesh-spec key"),
    ("dp=4,dp=2", "given twice"),
    ("dp=two", "integer"),
    ("dp", "KEY=SIZE"),
    ("dp=4,fsdp=0", ">= 1"),
    ("dp=0", "'data' must be >= 1 or -1"),
])
def test_mesh_spec_parse_rejections(text, match):
    with pytest.raises(mesh.MeshSpecError, match=match):
        mesh.MeshSpec.parse(text)


@pytest.mark.parametrize("text, kwargs, match", [
    ("dp=2,seq=2", {"packed": True}, "packed"),
    ("dp=3,fsdp=3", {"n_devices": 8}, "devices"),
    ("dp=-1,fsdp=3", {"n_devices": 8}, "not divisible"),
])
def test_mesh_spec_validate_rejections(text, kwargs, match):
    with pytest.raises(mesh.MeshSpecError, match=match):
        mesh.MeshSpec.parse(text).validate(**kwargs)
    mesh.MeshSpec.parse("dp=4,fsdp=2").validate(n_devices=8, packed=True)
    mesh.MeshSpec.parse("dp=2,pipe=2,seq=2").validate(n_devices=8)


@pytest.mark.parametrize("text", ["dp=2,pipe=2", "dp=2,seq=2", "tp=2",
                                  "dp=2,dcn=2"])
def test_model_parallel_axes_resolve_as_jax(text):
    """The axes beyond dp and fsdp resolve as JAX MeshConfig.resolve does:
    the same sizes on the product of the spec, the same refusal of a world
    that is not it (data per dcn granule)."""
    spec = mesh.MeshSpec.parse(text)
    jax_config = JaxMeshSpec.parse(text).mesh_config()
    world = max(spec.data, 1) * spec.fsdp * spec.pipe * spec.seq * (
        spec.model * spec.dcn_data)
    got = mesh.resolved(spec, world)
    assert (got.data, got.fsdp, got.pipe, got.seq, got.model) == \
        jax_config.resolve(world)
    assert got.canonical() == dataclasses.replace(
        JaxMeshSpec.parse(text), data=got.data).canonical()
    with pytest.raises(mesh.MeshSpecError, match="devices"):
        mesh.resolved(spec, world + 1)
    with pytest.raises(ValueError, match="devices"):
        jax_config.resolve(world + 1)


def test_resolved_fills_data_from_the_world():
    assert mesh.resolved(mesh.MeshSpec.parse("fsdp=2"), 8) == \
        mesh.MeshSpec(data=4, fsdp=2)
    with pytest.raises(mesh.MeshSpecError, match="devices"):
        mesh.resolved(mesh.MeshSpec.parse("dp=3"), 2)
    with pytest.raises(RuntimeError, match="launcher.initialize"):
        mesh.create_mesh(mesh.MeshSpec.parse("dp=1"), "cpu")


# -- the launcher ------------------------------------------------------------

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
        "MASTER_ADDR", "MASTER_PORT", "JAX_COORDINATOR_ADDRESS",
        "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "SLURM_NODELIST",
        "SLURM_NTASKS", "SLURM_NNODES", "SLURM_PROCID", "SLURM_LOCALID")


@pytest.fixture
def clean_env(monkeypatch):
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.mark.parametrize("env, want", [
    ({}, None),
    ({"RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "1",
      "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "h", "MASTER_PORT": "9"},
     dict(rank=1, world_size=4, local_rank=1, local_world_size=2,
          init_method="env://", source="torchrun")),
    ({"JAX_COORDINATOR_ADDRESS": "h:9", "JAX_NUM_PROCESSES": "2",
      "JAX_PROCESS_ID": "1"},
     dict(rank=1, world_size=2, local_rank=0, local_world_size=1,
          init_method="tcp://h:9", source="jax")),
    # torchrun's names win over the JAX launcher's.
    ({"RANK": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "h",
      "MASTER_PORT": "9", "JAX_COORDINATOR_ADDRESS": "x:1",
      "JAX_NUM_PROCESSES": "8", "JAX_PROCESS_ID": "5"},
     dict(rank=0, world_size=2, source="torchrun")),
    # a single SLURM task is a single process.
    ({"SLURM_NODELIST": "n1", "SLURM_NTASKS": "1"}, None),
], ids=["single", "torchrun", "jax", "torchrun-first", "slurm-one-task"])
def test_launcher_environment_precedence(clean_env, env, want):
    for k, v in env.items():
        clean_env.setenv(k, v)
    found = launcher.discover()
    if want is None:
        assert found is None
        assert launcher.initialize("cpu") == launcher.Topology()
        return
    for key, value in want.items():
        assert found[key] == value, key


@pytest.mark.parametrize("env, match", [
    ({"RANK": "1"}, "torchrun"),
    ({"RANK": "1", "WORLD_SIZE": "2", "MASTER_ADDR": "h"}, "MASTER_PORT"),
    ({"JAX_PROCESS_ID": "1", "JAX_NUM_PROCESSES": "2"},
     "JAX_COORDINATOR_ADDRESS"),
])
def test_launcher_refuses_a_partly_configured_rank(clean_env, env, match):
    for k, v in env.items():
        clean_env.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        launcher.initialize("cpu")


def test_launcher_rendezvous_that_fails_raises(clean_env, tmp_path):
    """Rank 0 of 2 whose peer never comes: the rendezvous times out and
    raises (never trains solo). A file:// init_method stands in for
    MASTER_ADDR/PORT."""
    clean_env.setenv("RANK", "0")
    clean_env.setenv("WORLD_SIZE", "2")
    t0 = time.monotonic()
    with pytest.raises(Exception):
        launcher.initialize("cpu", init_method=f"file://{tmp_path}/rdzv",
                            timeout_s=2)
    assert time.monotonic() - t0 < 60
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("device, ranks, cards, want", [
    ("cpu", 2, 0, "gloo"), ("cuda", 1, 1, "nccl"), ("cuda", 8, 8, "nccl"),
    ("cuda", 2, 1, "gloo")])
def test_launcher_backend_follows_the_topology(device, ranks, cards, want):
    assert launcher.choose_backend(device, ranks, cards) == want


# -- bucket order, dropout fold --------------------------------------------

def test_overlap_buckets_in_availability_order():
    model = bert.BertForPreTraining(BertConfig(**CONFIG))
    buckets = {n: overlap.BUCKET_NAMES[overlap.bucket_of(n)]
               for n, _ in model.named_parameters()}
    assert buckets["predictions.bias"] == "heads"
    assert buckets["seq_relationship.weight"] == "heads"
    assert buckets["bert.pooler.dense_act.dense.weight"] == "heads"
    assert buckets["bert.encoder.layers.1.output_layer_norm.scale"] == \
        "encoder"
    assert buckets["bert.embeddings.word_embeddings.weight"] == "embeddings"
    assert set(buckets.values()) == set(overlap.BUCKET_NAMES)


def test_overlap_hooks_from_many_threads_launch_each_bucket_once(
        monkeypatch):
    """The bucketed reducer's hooks run on autograd's thread while arm()
    and finish() run on the loop's: its bucket state is under one lock.
    Many threads fire the hooks at once (a short switch interval): every
    bucket's count still reaches its size, so each bucket is launched by
    its last hook exactly once, before finish()."""
    import threading

    class Work:
        def wait(self):
            pass

    monkeypatch.setattr(overlap.dist, "all_reduce",
                        lambda flat, group=None, async_op=False: Work())
    named = [(f"{prefix}.{i}", torch.nn.Parameter(torch.ones(2)))
             for prefix in ("predictions", "bert.encoder.layers.0",
                            "bert.embeddings") for i in range(400)]
    for _, p in named:
        p.grad = torch.ones(2)
    reducer = overlap.GradReducer(named, overlap=True)
    reducer.arm()
    params = [p for _, p in named]
    threads = [threading.Thread(target=lambda part=params[t::16]: [
        reducer._on_grad(p) for p in part]) for t in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(reducer.launches) == sorted(overlap.BUCKET_NAMES)
    assert reducer._seen == {b: 400 for b in range(overlap.N_BUCKETS)}
    reducer.finish()
    assert sorted(reducer.launches) == sorted(overlap.BUCKET_NAMES)
    assert all(torch.equal(p.grad, torch.ones(2)) for p in params)


def test_dropout_fold_keeps_rank_zero():
    seeds = bert.draw_dropout_seeds(torch.Generator().manual_seed(3), 2)
    assert bert.fold_dropout_seeds(seeds, 0) == seeds
    for rank in (1, 2, 3):
        folded = bert.fold_dropout_seeds(seeds, rank)
        assert all(0 <= s < 2 ** 61 for s in folded)
        assert all(a != b for a, b in zip(folded, seeds))
    assert len({tuple(bert.fold_dropout_seeds(seeds, r))
                for r in range(8)}) == 8


# -- the steps against the JAX package --------------------------------------

@pytest.mark.parametrize("name", ["dp_unpacked", "dp_packed"])
def test_dp_step_matches_jax(world2, jax_refs, name):
    """dp=2, A=2, unequal masked counts per rank: the global-mean step."""
    for rank in range(2):
        _check_step(world2.json(name, rank), world2.npz(name, rank),
                    jax_refs[name], f"{name} rank {rank}")


def test_overlap_matches_the_plain_reduction(world2):
    plain, bucketed = world2.npz("dp_unpacked"), world2.npz("dp_overlap")
    for key, value in plain.items():
        np.testing.assert_allclose(bucketed[key], value, atol=ATOL, rtol=0,
                                   err_msg=key)
    for rank in range(2):
        assert world2.json("dp_overlap", rank)["launches"] == [
            "heads", "encoder", "embeddings"]
        assert world2.json("dp_unpacked", rank)["launches"] == ["all"]
    np.testing.assert_allclose(world2.json("dp_overlap")["loss"],
                               world2.json("dp_unpacked")["loss"], rtol=RTOL)


def test_dropout_masks_differ_across_ranks(world2):
    """Dropout 0.1: rank 0's seeds are the single-process draw (so its
    Philox masks are the single-process masks), rank 1's are folded and
    its masks differ."""
    from bert_pytorch_tpu_torch.testing.dropout_masks import philox_mask

    r0, r1 = world2.npz("dropout", 0), world2.npz("dropout", 1)
    gen = torch.Generator().manual_seed(0)
    single = [bert.draw_dropout_seeds(gen, CONFIG["num_hidden_layers"])
              for _ in range(A)]
    np.testing.assert_array_equal(r0["seeds"], np.asarray(single))
    assert (r1["seeds"] != r0["seeds"]).all()
    want = philox_mask(2, 16, CONFIG["num_attention_heads"],
                       bert._sub_seed(single[0][1], bert._ATTENTION_PROBS),
                       0.1).numpy()
    np.testing.assert_array_equal(r0["mask"], want)
    assert not np.array_equal(r1["mask"], r0["mask"])
    assert float(r0["loss"]) == float(r1["loss"])  # global metrics
    assert np.isfinite(float(r0["loss"]))


@pytest.mark.parametrize("name", ["fsdp_lamb", "fsdp_bertadam"])
def test_fsdp_step_matches_jax(world2, jax_refs, name):
    """fsdp=2 against JAX dp=1,fsdp=2: LAMB's trust ratios and BertAdam's
    clip per JAX leaf (all layers of a stacked leaf together) from one
    all-reduce of local sums of squares."""
    for rank in range(2):
        _check_step(world2.json(name, rank), world2.npz(name, rank),
                    jax_refs[name], f"{name} rank {rank}")


def test_fsdp_remat_regathers_the_parameters(world2, jax_refs):
    """remat dots under FSDP2: the recomputed forward re-gathers each
    layer's shards, and the step is the same."""
    _check_step(world2.json("fsdp_remat"), world2.npz("fsdp_remat"),
                jax_refs["fsdp_lamb"], "fsdp_remat")


def test_hsdp_step_matches_jax(world4, jax_refs):
    for rank in range(4):
        _check_step(world4.json("hsdp_lamb", rank),
                    world4.npz("hsdp_lamb", rank), jax_refs["hsdp_lamb"],
                    f"dp=2,fsdp=2 rank {rank}")


@pytest.mark.parametrize("group, name", [("world2", "fp16_inf"),
                                         ("world4", "hsdp_fp16_inf")])
def test_fp16_inf_in_one_shard_skips_every_rank(request, group, name):
    g = request.getfixturevalue(group)
    for rank in range(g.world):
        got = g.json(name, rank)
        assert got == {"stepped": False, "scale": 8.0, "unchanged": True}, \
            f"rank {rank}: {got}"


def test_agree_on_resume_step_across_two_ranks(world2):
    """The JAX policy (tests/test_checkpoint.py:106) over real ranks:
    equal -> that step; differing -> the minimum; some None -> raise."""
    for rank in range(2):
        got = world2.json("agree", rank)
        assert got[0] == ["ok", 7]
        assert got[1] == ["ok", 5]
        assert got[2] == ["ok", None]
        assert got[3][0] == "error" and "inconsistent" in got[3][1]


# -- sharded checkpoints across the packages --------------------------------

def _jax_restore(directory, step, template):
    path = jax_ckpt.checkpoint_path(directory, step)
    loaded = jax_ckpt.load_checkpoint(path)
    return (jax_ckpt.restore_tree(template, loaded["model"]),
            jax_ckpt.restore_tree(template, loaded["optimizer"]["mu"]),
            jax_ckpt.load_params_only(path, template))


@pytest.mark.parametrize("name", ["save_sharded", "save_async"])
def test_port_sharded_checkpoint_loads_in_jax(world2, inputs, name):
    root, params, _ = inputs
    directory = str(root / ("port_sharded" if name == "save_sharded"
                            else "port_async"))
    want = world2.npz(name)
    files = sorted(os.listdir(directory))
    assert "ckpt_3.shard0of2.msgpack" in files
    assert "ckpt_3.shard1of2.msgpack" in files
    path = jax_ckpt.checkpoint_path(directory, 3)
    manifest = jax_integrity.read_manifest(path)
    assert manifest["layout"] == "sharded"
    assert manifest["mesh_spec"]["fsdp"] == 2
    assert manifest["mesh_spec"]["data"] == 1
    status, detail = jax_integrity.verify_checkpoint(path)
    assert status == jax_integrity.VERIFIED, detail
    restored, mu, params_only = _jax_restore(directory, 3, params)
    got = _port_names(restored)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert np.abs(np.concatenate([np.ravel(x) for x in
                                  jax.tree_util.tree_leaves(mu)])).max() > 0
    only = _port_names(params_only)
    for key, value in want.items():
        np.testing.assert_array_equal(only[key], value, err_msg=key)


def test_gathered_save_under_fsdp_is_rank_zeros(world2, inputs):
    root, params, _ = inputs
    directory = str(root / "port_gathered")
    assert not any("shard" in f for f in os.listdir(directory))
    restored, _, _ = _jax_restore(directory, 3, params)
    got, want = _port_names(restored), world2.npz("save_gathered")
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def _world1_resume(directory, batch):
    """The port at world size 1 (no process group) resumed from
    ``directory``, then one step: (step, loss, parameters)."""
    cfg = BertConfig(**CONFIG)
    model = bert.BertForPreTraining(cfg)
    schedule = schedules.warmup_poly_schedule(*SCHEDULE)
    opt = transforms.Lamb(transforms.param_groups(model, 0.01), schedule)
    found = ckpt.load_latest_checkpoint(directory, model, opt)
    step = pretrain.make_train_step(model, opt, schedule, True, P,
                                    torch.Generator().manual_seed(0))
    metrics = step(pretrain.to_device(batch, "cpu"))
    return found[0], float(metrics["loss"]), {
        k: v.detach().numpy() for k, v in model.state_dict().items()}


def test_jax_sharded_checkpoint_resumes_at_two_and_one(world2, inputs):
    """A JAX 2-way sharded checkpoint resumes in the port at world size 2
    (fsdp=2) and 1, and the resumed step equals an unsharded resume of
    the same state: bit for bit at world 1, within the step bars at 2."""
    root, _, batches = inputs
    step_s, loss_s, params_s = _world1_resume(str(root / "jax_sharded"),
                                              batches["next"])
    step_g, loss_g, params_g = _world1_resume(str(root / "jax_gathered"),
                                              batches["next"])
    assert step_s == step_g == 1
    assert loss_s == loss_g
    for key, value in params_g.items():
        np.testing.assert_array_equal(params_s[key], value, err_msg=key)
    for rank in range(2):
        got = world2.json("resume_jax_w2", rank)
        assert (got["step"], got["count"]) == (1, 1)
        np.testing.assert_allclose(got["loss"], loss_g, rtol=RTOL)
        after = world2.npz("resume_jax_w2", rank)
        for key, value in params_g.items():
            np.testing.assert_allclose(after[key], value, atol=ATOL, rtol=0,
                                       err_msg=key)


def test_port_sharded_save_resumes_at_another_layout(world2, inputs):
    """Saved under fsdp=2, resumed under dp=2 and at world size 1: the
    same next step."""
    root, _, batches = inputs
    step1, loss1, params1 = _world1_resume(str(root / "port_sharded"),
                                           batches["next"])
    assert step1 == 3
    got = world2.json("resume_port_w2")
    assert got["step"] == 3
    np.testing.assert_allclose(got["loss"], loss1, rtol=RTOL)
    after = world2.npz("resume_port_w2")
    for key, value in params1.items():
        np.testing.assert_allclose(after[key], value, atol=ATOL, rtol=0,
                                   err_msg=key)


def test_sharded_load_detects_missing_shard(world2, inputs, tmp_path):
    """A sharded index whose shard file is gone fails loudly (CORRUPT by
    the manifest chase; the load raises), never restores zeros."""
    import shutil

    root, _, _ = inputs
    world2.wait()
    directory = str(tmp_path / "copy")
    shutil.copytree(str(root / "port_sharded"), directory)
    os.unlink(os.path.join(directory, "ckpt_3.shard1of2.msgpack"))
    path = ckpt.checkpoint_path(directory, 3)
    status, detail = integrity.verify_checkpoint(path)
    assert status == integrity.CORRUPT and "shard" in detail
    with pytest.raises(Exception):
        ckpt.load_checkpoint(path)
    model = bert.BertForPreTraining(BertConfig(**CONFIG))
    with pytest.warns(UserWarning, match="Skipping unreadable"):
        assert ckpt.load_latest_checkpoint(directory, model) is None


def test_sharded_index_waits_for_this_saves_shards(tmp_path, monkeypatch):
    """A stale shard0of2/1of2 pair of an earlier, torn save of the same
    step is already there: rank 0 publishes the index only once rank 1's
    shard of THIS save has landed (a timeout otherwise, and no index),
    and a restore refuses an index one of whose shards a later save
    rewrote."""
    import threading

    directory = str(tmp_path)
    weights = torch.arange(6.0).reshape(2, 3)
    records: dict = {}
    index = ckpt._build_sharded({"model": {"w": weights}, "epoch": 0},
                                records, 0)

    def write(rank, save_id):
        ckpt._write_sharded(index, records if rank == 0 else {}, directory,
                            4, 3, {"fsdp": 2}, rank, 2, False, save_id)

    path = ckpt.checkpoint_path(directory, 4)
    write(1, "torn")
    write(0, "torn")
    os.unlink(path)
    os.unlink(integrity.manifest_path(path))
    monkeypatch.setattr(ckpt, "SHARD_WAIT_S", 0.3)
    with pytest.raises(TimeoutError, match="this save's shard"):
        write(0, "new")
    assert not os.path.exists(path)
    monkeypatch.setattr(ckpt, "SHARD_WAIT_S", 60.0)
    late = threading.Timer(0.3, write, (1, "new"))
    late.start()
    write(0, "new")
    late.join()
    status, detail = integrity.verify_checkpoint(path)
    assert status == integrity.VERIFIED, detail
    np.testing.assert_array_equal(
        np.asarray(ckpt.load_checkpoint(path)["model"]["w"]), weights)
    write(1, "later")
    status, detail = integrity.verify_checkpoint(path)
    assert status == integrity.CORRUPT and "another save" in detail
    with pytest.raises(ckpt.CheckpointCorruptError, match="another save"):
        ckpt.load_checkpoint(path)


# -- the telemetry's multi-process settings ---------------------------------

def test_telemetry_of_a_non_primary_rank_writes_nothing(tmp_path):
    """The JAX facade's is_primary: a rank other than 0 keeps a disabled
    sink, heartbeat, profiler window and watchdog, and its sentinel still
    sees the (global) metrics, so a non-finite step ends every rank."""
    from bert_pytorch_tpu_torch.telemetry.runner import TrainTelemetry
    from bert_pytorch_tpu_torch.telemetry.sentinels import NonFiniteError

    tele = TrainTelemetry(
        jsonl_path=str(tmp_path / "t.jsonl"), is_primary=False,
        heartbeat_path=str(tmp_path / "hb.json"), profile_steps="1:2",
        profile_dir=str(tmp_path / "profile"), watchdog_timeout_s=5.0,
        sentinel_policy="abort", sentinel_patience=1)
    assert tele.profiler.range is None and tele.watchdog is None
    tele.emit({"kind": "fault", "tag": "telemetry", "fault": "x",
               "injected": True, "step": 1})
    tele.heartbeat.beat(1, last_loss=1.0)
    with pytest.raises(NonFiniteError):
        tele.sentinel.observe(1, 0.0, float("nan"))
    tele.close()
    assert sorted(os.listdir(tmp_path)) == []


@pytest.mark.parametrize("devices_n", [1, 2, 8])
def test_mfu_is_per_card(devices_n):
    """n_devices (the world size) divides the step's sequences among the
    cards before MFU, on both bases, as the JAX StepTimer does."""
    from bert_pytorch_tpu.telemetry.step_timer import StepTimer as JaxTimer
    from bert_pytorch_tpu_torch.telemetry.step_timer import StepTimer

    kind = "NVIDIA H100 80GB HBM3"
    port = StepTimer(seq_per_step=64, flops_per_seq=1e12, device_kind=kind,
                     n_devices=devices_n)
    one = StepTimer(seq_per_step=64, flops_per_seq=1e12, device_kind=kind)
    got, basis = port._window_mfu(2.0, 4)
    assert basis == "wall" and got > 0
    np.testing.assert_allclose(got, round(one._window_mfu(2.0, 4)[0]
                                          / devices_n, 4), atol=1e-4)
    jax_timer = JaxTimer(seq_per_step=64, flops_per_seq=1e12,
                         device_kind=kind, n_devices=devices_n)
    assert jax_timer.n_devices == port.n_devices == devices_n
