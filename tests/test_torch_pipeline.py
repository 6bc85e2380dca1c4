"""The port's GPipe pipeline (parallel/pipeline.py, pretrain.py
``make_pp_train_step``) over real gloo ranks, held against the JAX
package's single-device step on the CPU, and its checkpoints against the
JAX package's.

The ranks run in processes of their own (tests/_torch_layout_worker.py),
4 for pp (dp=2,pipe=2), pp_tp (pipe=2,model=2), pp_sp (pipe=2,seq=2) and
fsdp_pp (fsdp=2,pipe=2: each stage's layers FSDP2 units on the stage's
fsdp group) and 8 for pp_sp_tp (pipe=2,seq=2,model=2), from the JAX weights
(``from_jax_params``) on the same [2, 8, 32] batch: one LAMB step each
against the JAX single-device ``make_train_step``, the loss at rtol 1e-5
and every parameter at atol 2e-5 (the JAX package's own pipeline bars,
tests/test_pipeline.py:318-327); pp also on packed rows
(tests/test_one_mesh.py:262), and fsdp_pp too. K-FAC under pp, pp_tp,
pp_sp and fsdp_pp (the stats pass on a whole-model twin that takes the
weights gathered from the ranks' parts, the preconditioner on the
gathered gradients) against the JAX K-FAC step of tests/test_kfac.py:450's cells:
factors from microbatch 0, fp32 inverses, then the preconditioned step:
the factors, the inverses and the whole preconditioned gradients (LAMB's
first moment) at the bars of tests/layout_common.py. The step cells hold
the whole gradients too.

Checkpoints: pp_tp and fsdp_pp sharded saves (a shard file a rank, the
JAX slice records) read by the JAX package's ``load_checkpoint`` and
resumed by the port at world size 1 bit for bit, pp_tp's at world size 2
too; and a JAX pp_tp sharded
checkpoint resumed by the port's pp_tp ranks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import layout_common as common
from bert_pytorch_tpu import optim as jax_optim
from bert_pytorch_tpu import pretrain as jax_pretrain
from bert_pytorch_tpu.config import BertConfig as JaxConfig
from bert_pytorch_tpu.models import BertForPreTraining as JaxPreTraining
from bert_pytorch_tpu.parallel import (MeshSpec as JaxMeshSpec,
                                       create_mesh as jax_create_mesh,
                                       logical_axis_rules)
from bert_pytorch_tpu.utils import checkpoint as jax_ckpt
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.models import bert
from bert_pytorch_tpu_torch.optim import schedules, transforms
from bert_pytorch_tpu_torch.utils import checkpoint as ckpt

STEP_CELLS = {"pp": "dp=2,pipe=2", "pp_tp": "pipe=2,model=2",
              "pp_sp": "pipe=2,seq=2", "fsdp_pp": "fsdp=2,pipe=2"}
PACKED_CELLS = {"pp_packed": "dp=2,pipe=2",
                "fsdp_pp_packed": "fsdp=2,pipe=2"}
KFAC_CELLS = {"kfac_pp": "dp=2,pipe=2", "kfac_pp_tp": "pipe=2,model=2",
              "kfac_pp_sp": "pipe=2,seq=2", "kfac_fsdp_pp": "fsdp=2,pipe=2"}
# Sharded saves: one shard file a rank, the JAX slice records.
SAVE_CELLS = {"pp_tp": "pipe=2,model=2", "fsdp_pp": "fsdp=2,pipe=2"}


def _jax_pp_tp_checkpoint(root, params, host):
    """One JAX step, its state put on a pipe=2,model=2 mesh of the
    virtual devices and saved sharded (the JAX ``_write_sharded``)."""
    cfg = JaxConfig(**common.CONFIG)
    model = JaxPreTraining(cfg, dtype=jnp.float32)
    schedule = jax_optim.warmup_poly_schedule(*common.SCHEDULE)
    tx = jax_optim.lamb(schedule, weight_decay_mask=jax_optim.no_decay_mask)
    state = jax_pretrain.TrainState(
        params=jax.tree_util.tree_map(jnp.array, params),
        opt_state=tx.init(params), rng=jax.random.PRNGKey(2))
    state, _ = jax_pretrain.make_train_step(
        model, tx, schedule=schedule, next_sentence=True,
        max_pred_per_seq=common.P)(state, host)
    spec = JaxMeshSpec.parse("dp=1,pipe=2,model=2")
    mesh = jax_create_mesh(spec.mesh_config(), devices=jax.devices()[:4])
    sample = (jnp.zeros((1, common.S), jnp.int32),) * 3
    with mesh:
        shardings = jax_pretrain.state_shardings(
            mesh, model, logical_axis_rules(spec), sample)
        state = dataclasses.replace(
            state, params=jax.device_put(state.params, shardings.params),
            opt_state=jax.device_put(state.opt_state, shardings.opt_state))
        jax_ckpt.save_checkpoint(
            str(root / "jax_pp_tp"), 1,
            {"model": state.params, "optimizer": state.opt_state,
             "sampler": {"index": 0}, "epoch": 0}, layout="sharded",
            mesh_spec=spec.as_dict())
    return jax.device_get(state)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    params, batches = common.write_inputs(root)
    return root, params, batches


@pytest.fixture(scope="module")
def world4(inputs):
    root, params, batches = inputs
    jax_state = _jax_pp_tp_checkpoint(root, params, batches["unpacked"])
    cases = [common.case(name, "step", root, mesh)
             for name, mesh in STEP_CELLS.items()]
    cases += [common.case(name, "step", root, mesh, "packed")
              for name, mesh in PACKED_CELLS.items()]
    cases += [common.case(name, "kfac", root, mesh)
              for name, mesh in KFAC_CELLS.items()]
    cases += [common.case(f"save_{name}", "save", root, mesh,
                          dir=str(root / f"port_{name}"))
              for name, mesh in SAVE_CELLS.items()]
    cases.append(common.case("resume_jax_pp_tp", "resume", root,
                             "pipe=2,model=2", dir=str(root / "jax_pp_tp")))
    return common.Group(root / "w4", 4, cases), jax_state


@pytest.fixture(scope="module")
def world8(inputs):
    root, _, _ = inputs
    return common.Group(root / "w8", 8, [common.case(
        "pp_sp_tp", "step", root, "pipe=2,seq=2,model=2")])


@pytest.fixture(scope="module")
def world2(inputs, world4):
    """model=2 ranks resuming the port's pp_tp sharded save (after the
    world-4 ranks wrote it)."""
    root, _, _ = inputs
    world4[0].wait()
    return common.Group(root / "w2", 2, [common.case(
        "resume_port_w2", "resume", root, "model=2",
        dir=str(root / "port_pp_tp"))])


@pytest.fixture(scope="module")
def refs(inputs):
    _, params, batches = inputs
    return {"unpacked": common.jax_step(params, batches["unpacked"]),
            "packed": common.jax_step(params, batches["packed"]),
            "kfac": common.jax_step(params, batches["unpacked"],
                                    kfac="stats")}


@pytest.mark.parametrize("name", sorted(STEP_CELLS))
def test_pipeline_step_matches_jax(world4, refs, name):
    group, _ = world4
    common.check_step(group.json(name), group.npz(name), refs["unpacked"],
                      name)


def test_fsdp_pipeline_reduces_once_a_step(world4):
    """Each FSDP2 unit of a stage reduce-scatters once in a step of two
    microbatches: the sync is held until the last microbatch's
    backward."""
    group, _ = world4
    for rank in range(4):
        result = group.json("fsdp_pp", rank)
        # A stage's 1 layer, the MLM transform, the pooler, the NSP head
        # and the root; on stage 0 (even ranks: pipe is the fastest axis
        # here) the heads take no gradient, so its layer and the root
        # reduce.
        assert result["fsdp_units"] == 5, result
        assert result["fsdp_reductions"] == (5 if rank % 2 else 2), result


def test_pipeline_step_on_packed_rows_matches_jax(world4, refs):
    group, _ = world4
    common.check_step(group.json("pp_packed"), group.npz("pp_packed"),
                      refs["packed"], "pp_packed")


def test_fsdp_pipeline_step_on_packed_rows_matches_jax(world4, refs):
    group, _ = world4
    common.check_step(group.json("fsdp_pp_packed"),
                      group.npz("fsdp_pp_packed"), refs["packed"],
                      "fsdp_pp_packed")


def test_pp_sp_tp_on_eight_ranks_matches_jax(world8, refs):
    common.check_step(world8.json("pp_sp_tp"), world8.npz("pp_sp_tp"),
                      refs["unpacked"], "pp_sp_tp")


@pytest.mark.parametrize("name", sorted(KFAC_CELLS))
def test_kfac_under_the_pipeline_matches_jax(world4, refs, name):
    group, _ = world4
    metrics, want = refs["kfac"]
    result = group.json(name)
    np.testing.assert_allclose(result["loss"], metrics["loss"],
                               rtol=common.LOSS_RTOL)
    # The factors, the inverses and the preconditioned gradients.
    common.check_state(group.npz(name), want, name)
    # Every rank holds the same whole K-FAC state.
    sums = {group.json(name, r)["state_sum"] for r in range(4)}
    assert len(sums) == 1, sums


def _saved(group, name="pp_tp"):
    return group.npz(f"save_{name}")


def _jax_reads(group, root, name):
    saved = _saved(group, name)
    tree = jax_ckpt.load_checkpoint(str(root / f"port_{name}" /
                                        "ckpt_3.msgpack"))
    got = common.port_names(tree["model"])
    assert set(got) == {k[len("param/"):] for k in saved
                        if k.startswith("param/")}
    for key, value in got.items():
        np.testing.assert_array_equal(value, saved[f"param/{key}"], key)
    mu = common.port_names(tree["optimizer"]["mu"])
    for key, value in mu.items():
        np.testing.assert_array_equal(value, saved[f"mu/{key}"], key)
    assert int(np.asarray(tree["optimizer"]["count"])) == 1


def test_jax_reads_the_ports_pp_tp_shards(world4, inputs):
    _jax_reads(world4[0], inputs[0], "pp_tp")


def test_jax_reads_the_ports_fsdp_pp_shards(world4, inputs):
    _jax_reads(world4[0], inputs[0], "fsdp_pp")


def _resumes_at_world_one(group, root, name):
    saved = _saved(group, name)
    cfg = BertConfig(**common.CONFIG)
    model = bert.BertForPreTraining(cfg, torch.float32)
    opt = transforms.Lamb(transforms.param_groups(model, 0.01),
                          schedules.warmup_poly_schedule(*common.SCHEDULE))
    step, extras = ckpt.load_latest_checkpoint(str(root / f"port_{name}"),
                                               model, opt)
    assert step == 3 and extras["count"] == 1
    mu, nu = transforms.moments(opt, dict(model.named_parameters()))
    for key, p in model.named_parameters():
        for prefix, t in (("param", p), ("mu", mu[key]), ("nu", nu[key])):
            np.testing.assert_array_equal(t.detach().numpy(),
                                          saved[f"{prefix}/{key}"],
                                          f"{prefix}/{key}")


def test_port_resumes_pp_tp_shards_at_world_one(world4, inputs):
    _resumes_at_world_one(world4[0], inputs[0], "pp_tp")


def test_port_resumes_fsdp_pp_shards_at_world_one(world4, inputs):
    _resumes_at_world_one(world4[0], inputs[0], "fsdp_pp")


def test_port_resumes_pp_tp_shards_at_world_two(world2, world4):
    saved = _saved(world4[0])
    got = world2.npz("resume_port_w2")
    assert world2.json("resume_port_w2")["step"] == 3
    assert set(got) == set(saved)
    for key, value in saved.items():
        np.testing.assert_array_equal(got[key], value, key)


def test_port_pp_tp_ranks_resume_the_jax_pp_tp_shards(world4):
    group, jax_state = world4
    got = group.npz("resume_jax_pp_tp")
    want = common.port_names(jax_state.params)
    for key, value in want.items():
        np.testing.assert_array_equal(got[f"param/{key}"], value, key)
    mu = common.port_names(jax_state.opt_state.mu)
    for key, value in mu.items():
        np.testing.assert_array_equal(got[f"mu/{key}"], value, key)
