"""The port's ``model``, ``seq`` and ``dcn`` mesh axes outside a pipeline,
and K-FAC across data ranks, over real gloo ranks held against the JAX
package's single-device step on the CPU; and the mesh layout itself
against the JAX package's.

The ranks run in processes of their own (tests/_torch_layout_worker.py):
2 for tp (model=2), sp (seq=2, the ring) and the fused K-FAC capture at
dp=2 (its statistics summed over the data ranks and its inverses split
by layer), fsdp=2, model=2 and seq=2; 4 for tp_fsdp (fsdp=2,model=2),
tp on packed rows (dp=2,model=2), dp x dcn (dp=2,dcn=2), fsdp_sp
(fsdp=2,seq=2: FSDP2 over the ring) and the fused K-FAC capture at
fsdp=2,model=2. One LAMB step each from the
JAX weights on the same batch, against the JAX single-device
``make_train_step`` (or its K-FAC step, fused capture, fp32 inverses):
the loss at rtol 1e-5 and every parameter at atol 2e-5 (the JAX package's
pipeline bars; dp x dcn, which splits no parameter, at 1e-6), the whole
gradients (LAMB's first moment) and K-FAC's factors and inverses at the
bars of tests/layout_common.py.
"""

import numpy as np
import pytest

import layout_common as common
from bert_pytorch_tpu.parallel import MeshConfig as JaxMeshConfig
from bert_pytorch_tpu.parallel import MeshSpec as JaxMeshSpec
from bert_pytorch_tpu.parallel import create_mesh as jax_create_mesh
from bert_pytorch_tpu_torch.parallel import mesh

W2_CELLS = {"tp": ("model=2", "unpacked"), "sp": ("seq=2", "unpacked")}
W4_CELLS = {"tp_fsdp": ("fsdp=2,model=2", "unpacked"),
            "tp_packed": ("dp=2,model=2", "packed"),
            "dp_dcn": ("dp=2,dcn=2", "unpacked"),
            "fsdp_sp": ("fsdp=2,seq=2", "unpacked")}
# The fused K-FAC capture on a split or ring model, by world size.
KFAC_W2 = {"kfac_dp": "dp=2", "kfac_fsdp": "fsdp=2", "kfac_tp": "model=2",
           "kfac_sp": "seq=2"}
KFAC_W4 = {"kfac_tp_fsdp": "fsdp=2,model=2"}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_axes")
    params, batches = common.write_inputs(root)
    return root, params, batches


@pytest.fixture(scope="module")
def world2(inputs):
    root, _, _ = inputs
    cases = [common.case(name, "step", root, spec, b)
             for name, (spec, b) in W2_CELLS.items()]
    cases += [common.case(name, "kfac", root, spec, fused=True)
              for name, spec in KFAC_W2.items()]
    return common.Group(root / "w2", 2, cases)


@pytest.fixture(scope="module")
def world4(inputs):
    root, _, _ = inputs
    cases = [common.case(name, "step", root, spec, b)
             for name, (spec, b) in W4_CELLS.items()]
    cases += [common.case(name, "kfac", root, spec, fused=True)
              for name, spec in KFAC_W4.items()]
    return common.Group(root / "w4", 4, cases)


@pytest.fixture(scope="module")
def refs(inputs):
    _, params, batches = inputs
    return {"unpacked": common.jax_step(params, batches["unpacked"]),
            "packed": common.jax_step(params, batches["packed"]),
            "kfac": common.jax_step(params, batches["unpacked"],
                                    kfac="fused")}


@pytest.mark.parametrize("name", sorted(W2_CELLS))
def test_two_rank_layouts_match_jax(world2, refs, name):
    common.check_step(world2.json(name), world2.npz(name),
                      refs[W2_CELLS[name][1]], name)


@pytest.mark.parametrize("name", sorted(W4_CELLS))
def test_four_rank_layouts_match_jax(world4, refs, name):
    tol = ({"loss_rtol": common.DP_TOL, "atol": common.DP_TOL}
           if name == "dp_dcn" else {})
    common.check_step(world4.json(name), world4.npz(name),
                      refs[W4_CELLS[name][1]], name, **tol)


def _check_kfac(group, name, ref, world):
    metrics, want = ref
    np.testing.assert_allclose(group.json(name)["loss"], metrics["loss"],
                               rtol=common.LOSS_RTOL)
    common.check_state(group.npz(name), want, name)
    # Every rank holds the same whole K-FAC state.
    sums = {group.json(name, r)["state_sum"] for r in range(world)}
    assert len(sums) == 1, sums


def test_kfac_dp2_fused_capture_matches_jax(world2, refs):
    """The factors summed over the two ranks, the inverses split between
    them and gathered, and the preconditioned gradients, against the JAX
    fused K-FAC step's."""
    _check_kfac(world2, "kfac_dp", refs["kfac"], 2)


@pytest.mark.parametrize("name", sorted(set(KFAC_W2) - {"kfac_dp"}))
def test_kfac_fused_capture_on_two_split_ranks_matches_jax(world2, refs,
                                                           name):
    """The fused capture under fsdp=2 (statistics summed over the shards'
    rows, the gradients gathered from the shards), model=2 (the split
    layers' taps gathered over the model group, nothing summed over it)
    and seq=2 (statistics and rows over the token shards), against the JAX
    single-device fused K-FAC step."""
    _check_kfac(world2, name, refs["kfac"], 2)


@pytest.mark.parametrize("name", sorted(KFAC_W4))
def test_kfac_fused_capture_on_four_split_ranks_matches_jax(world4, refs,
                                                            name):
    _check_kfac(world4, name, refs["kfac"], 4)


# Products of the mesh axes that the JAX runner takes (its MeshSpec
# validation refuses only packing with seq).
JAX_LAYOUTS = ("dp=2", "fsdp=2", "dp=2,fsdp=2", "model=2", "seq=2",
               "pipe=2", "fsdp=2,model=2", "fsdp=2,pipe=2", "fsdp=2,seq=2",
               "dp=2,fsdp=2,pipe=2", "fsdp=2,pipe=2,seq=2",
               "fsdp=2,pipe=2,model=2", "fsdp=2,seq=2,model=2",
               "pipe=2,seq=2,model=2", "dp=2,dcn=2")


@pytest.mark.parametrize("kfac", [False, True], ids=["first_order", "kfac"])
@pytest.mark.parametrize("text", JAX_LAYOUTS)
def test_runner_takes_every_layout_the_jax_runner_takes(text, kfac):
    """Each product the JAX runner accepts, with and without --kfac, passes
    the port's refusals; the JAX runner's own refusals stay."""
    from bert_pytorch_tpu_torch import run_pretraining

    JaxMeshSpec.parse(text).validate(packed=False)
    argv = ["--model_config_file", "c.json", "--output_dir", "out",
            "--global_batch_size", "8", "--local_batch_size", "2",
            "--max_steps", "1"] + (["--kfac"] if kfac else [])
    spec = mesh.MeshSpec.parse(text)
    run_pretraining.refuse_layout(run_pretraining.parse_arguments(argv),
                                  spec)
    if spec.active_axes() - {mesh.AXIS_DATA}:
        with pytest.raises(ValueError, match="overlap_grad_reduce"):
            run_pretraining.refuse_layout(run_pretraining.parse_arguments(
                argv + ["--overlap_grad_reduce"]), spec)


@pytest.mark.parametrize("text", [
    "dp=2,fsdp=2,pipe=2", "pipe=2,seq=2,model=2", "dp=-1,model=4",
    "fsdp=2,seq=2,model=2"])
def test_layout_coordinates_follow_the_jax_mesh(text, devices):
    """Each rank's coordinates are its device's place in the JAX
    create_mesh array (device i = rank i, model fastest), and every group
    holds the ranks that differ only along its axes."""
    spec = mesh.resolved(mesh.MeshSpec.parse(text), 8)
    shape = mesh.mesh_shape(spec)
    jspec = JaxMeshSpec.parse(text)
    grid = np.vectorize(lambda d: d.id)(
        jax_create_mesh(jspec.mesh_config(), devices=devices).devices)
    assert grid.shape == shape
    for rank in range(8):
        c = mesh.coordinates(rank, shape)
        assert grid[tuple(c[a] for a in mesh.MESH_AXES)] == rank
    for name, axes in mesh.GROUP_AXES.items():
        for ranks in mesh.axis_ranks(shape, axes):
            coords = [mesh.coordinates(r, shape) for r in ranks]
            for axis in mesh.MESH_AXES:
                if axis not in axes:
                    assert len({c[axis] for c in coords}) == 1, (name, axis)


def test_dcn_needs_whole_nodes_per_granule():
    spec = mesh.resolved(mesh.MeshSpec.parse("dp=2,dcn=2"), 4)
    # data per granule, as JAX MeshConfig.resolve gives it; dcn is the
    # outer factor of the mesh's data axis.
    assert (spec.data, spec.dcn_data) == (2, 2)
    assert JaxMeshConfig(data=2, dcn_data=2).resolve(4) == (2, 1, 1, 1, 1)
    assert mesh.mesh_shape(spec) == (4, 1, 1, 1, 1)
    mesh.check_dcn(spec, 4, 1)  # 4 nodes of 1 rank
    mesh.check_dcn(spec, 4, 2)  # 2 nodes of 2 ranks
    with pytest.raises(mesh.MeshSpecError, match="nodes"):
        mesh.check_dcn(spec, 4, 4)  # one node
    with pytest.raises(mesh.MeshSpecError, match="nodes"):
        mesh.check_dcn(mesh.resolved(mesh.MeshSpec.parse("dcn=4"), 8), 8, 4)
