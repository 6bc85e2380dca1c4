"""One rank of the port's model-parallel CPU tests (tests/test_torch_ring.py,
test_torch_pipeline.py, test_torch_mesh_axes.py): ``python
_torch_layout_worker.py PLAN RANK``. It imports torch, numpy and the port
only; the JAX references are computed in the pytest process and arrive
as numpy files.

The plan (JSON) names the world size, the rendezvous file, the output
directory and a list of cases; every rank runs every case in order and
writes its results as ``<out>/<case name>.rank<r>.npz`` or ``.json``.
Each case lays the ranks out as its mesh says (parallel/mesh.py
``make_layout``): the groups of a case are made when the case starts.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bert_pytorch_tpu_torch import pretrain  # noqa: E402
from bert_pytorch_tpu_torch.config import BertConfig  # noqa: E402
from bert_pytorch_tpu_torch.models import bert  # noqa: E402
from bert_pytorch_tpu_torch.models.convert import (  # noqa: E402
    from_jax_params)
from bert_pytorch_tpu_torch.optim import schedules, transforms  # noqa: E402
from bert_pytorch_tpu_torch.optim.kfac import KFAC  # noqa: E402
from bert_pytorch_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from bert_pytorch_tpu_torch.parallel import sharding  # noqa: E402
from bert_pytorch_tpu_torch.parallel import state as state_lib  # noqa: E402


def unflatten(flat) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(value)
    return tree


def layout_of(case, rank, world):
    spec = mesh_lib.resolved(mesh_lib.MeshSpec.parse(case["mesh"]), world)
    device_mesh = (mesh_lib.create_mesh(spec, "cpu") if spec.fsdp > 1
                   else None)
    return mesh_lib.make_layout(spec, rank, world, "gloo", device_mesh)


def whole_model(case, backend=None):
    cfg = BertConfig(**case["config"])
    model = bert.BertForPreTraining(
        cfg, torch.float32, backend or case.get("backend", "dense"),
        case.get("remat", "none"))
    if case.get("params"):  # else the seeded init, the same on every rank
        params = unflatten(np.load(case["params"]))
        model.load_state_dict(from_jax_params(params, cfg, "pretraining"))
    return model, cfg


def build(case, rank, world):
    """(model, optimizer, schedule, layout, DataParallel, config) of a
    case: the JAX weights of ``case["params"]``, laid out per
    ``case["mesh"]``."""
    layout = layout_of(case, rank, world)
    backend = "ring" if layout.spec.seq > 1 else None
    model, cfg = whole_model(case, backend)
    model = mesh_lib.place_model(model, layout)
    model = sharding.shard_model(model, layout.device_mesh)
    mesh_lib.mark_norms(model, layout)
    schedule = schedules.warmup_poly_schedule(*case["schedule"])
    groups = transforms.param_groups(model, 0.01)
    opt = transforms.Lamb(groups, schedule)
    dp = pretrain.DataParallel(rank=rank, world_size=world,
                               fsdp=sharding.is_fsdp(model), layout=layout)
    return model, opt, schedule, layout, dp, cfg


def rows_of(batch, layout):
    """The data coordinate's rows of every microbatch of [A, B, ...]."""
    n, i = layout.n_data, layout.data_index
    rows = next(iter(batch.values())).shape[1] // n
    return {k: torch.from_numpy(np.ascontiguousarray(
        v[:, i * rows:(i + 1) * rows])).long() for k, v in batch.items()}


def whole_params(model, layout) -> dict:
    """Every parameter whole (a collective over the layout's groups)."""
    state = sharding.full_state_dict(model)
    named = {n: state[n] for n, _ in model.named_parameters()}
    full = state_lib.gather_full(named, layout.axis("model"),
                                 layout.axis("pipe"),
                                 model.config.num_hidden_layers)
    return {k: v.detach().numpy().copy() for k, v in full.items()}


def make_step(model, opt, schedule, cfg, case, dp, kfac=None):
    kwargs = dict(next_sentence=bool(cfg.next_sentence),
                  max_pred_per_seq=case["max_pred"],
                  generator=torch.Generator().manual_seed(0), kfac=kfac,
                  data_parallel=dp, stats_every=0 if kfac else 1)
    if dp.layout.spec.pipe > 1:
        return pretrain.make_pp_train_step(model, opt, schedule, **kwargs)
    return pretrain.make_train_step(model, opt, schedule, **kwargs)


def counting_fsdp_reductions():
    """(calls, restore): FSDP2's gradient reductions (one a unit that
    reduces) append to ``calls`` until ``restore()``."""
    from torch.distributed.fsdp._fully_shard import _fsdp_param_group

    calls, original = [], _fsdp_param_group.foreach_reduce

    def counted(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)

    _fsdp_param_group.foreach_reduce = counted
    return calls, lambda: setattr(_fsdp_param_group, "foreach_reduce",
                                  original)


def case_step(case, rank, world, out):
    """One optimizer step; rank 0 writes the metrics and the whole state
    after it (:func:`whole_state`). Under FSDP2 each rank also writes its
    units and the reductions the step made."""
    model, opt, schedule, layout, dp, cfg = build(case, rank, world)
    step = make_step(model, opt, schedule, cfg, case, dp)
    calls, restore = counting_fsdp_reductions() if dp.fsdp else (None, None)
    try:
        metrics = step(rows_of(dict(np.load(case["batch"])), layout))
    finally:
        if restore is not None:
            restore()
    result = {k: float(metrics[k]) for k in
              ("loss", "grad_norm", "mlm_accuracy", "real_tokens", "finite")}
    if calls is not None:
        from torch.distributed.fsdp import FSDPModule

        result.update(fsdp_reductions=len(calls), fsdp_units=sum(
            isinstance(m, FSDPModule) for m in model.modules()))
    from bert_pytorch_tpu_torch.telemetry import model_stats

    health = model_stats.health_record(1, metrics["grad_health"])
    result.update(health_grad_norm=health["grad_norm"],
                  health_update_ratio=health["update_ratio"],
                  health_layers=health["per_layer_grad_norm"])
    state = whole_state(model, opt, layout)
    if rank == 0:
        np.savez(f"{out}/{case['name']}.rank0.npz", **state)
    with open(f"{out}/{case['name']}.rank{rank}.json", "w") as f:
        json.dump(result, f)


def case_kfac(case, rank, world, out):
    """One K-FAC step: the factors from a stats pass over the whole
    microbatch 0, the inverses, then the preconditioned step; or with
    ``fused`` the capture in the step, its statistics summed over the
    ``grad`` group. The stats pass of a split or ring model runs on a
    twin of the whole model that takes the weights gathered whole from
    the ranks' parts, as the runner's. Rank 0 writes the whole state after
    the step and K-FAC's ``a``, ``g``, ``qa`` and ``qg``."""
    from bert_pytorch_tpu_torch import run_pretraining

    model, opt, schedule, layout, dp, cfg = build(case, rank, world)
    batch = rows_of(dict(np.load(case["batch"])), layout)
    group = layout.groups["grad" if case.get("fused") else "batch"]
    tapped = model
    if not case.get("fused") and layout.spec.active_axes() - {"data"}:
        tapped, _ = whole_model(case, "dense")
        tapped.load_state_dict(run_pretraining.whole_parts(model)(
            sharding.full_state_dict(model)))
    kfac = KFAC(tapped, damping=case["damping"], group=group,
                replicas=layout.n_data, inv_dtype=torch.float32)
    state = kfac.init()
    kfac.apply_loss = pretrain.make_kfac_loss(kfac.model, True,
                                              case["max_pred"], group)
    if case.get("fused"):
        step = pretrain.make_train_step(
            model, opt, schedule, True, case["max_pred"],
            torch.Generator().manual_seed(0), kfac=kfac, kfac_fused=True,
            kfac_inv_interval=1, data_parallel=dp)
    else:
        kfac.update_factors(state, {k: v[0] for k, v in batch.items()})
        kfac.update_inverses(state)
        step = make_step(model, opt, schedule, cfg, case, dp, kfac)
    metrics = step(batch, state)
    whole = whole_state(model, opt, layout)
    whole.update({f"{field}/{k}": v.float().numpy()
                  for field in ("a", "g", "qa", "qg")
                  for k, v in getattr(state, field).items()})
    if rank == 0:
        np.savez(f"{out}/{case['name']}.rank0.npz", **whole)
    digest = float(sum(v.float().sum() for field in ("a", "g", "qa", "qg")
                       for v in getattr(state, field).values()))
    with open(f"{out}/{case['name']}.rank{rank}.json", "w") as f:
        json.dump({"loss": float(metrics["loss"]), "state_sum": digest}, f)


def case_ring(case, rank, world, out):
    """Ring attention over the world as one seq group: the output and the
    gradients of this rank's slice of q, k, v (dropout from the case)."""
    from bert_pytorch_tpu_torch.ops.ring import ring_attention

    layout = layout_of(case, rank, world)
    seq = layout.axis("seq")
    data = dict(np.load(case["inputs"]))
    width = data["q"].shape[1] // seq.size
    sl = slice(seq.index * width, (seq.index + 1) * width)
    q, k, v = (torch.from_numpy(np.ascontiguousarray(data[n][:, sl]))
               .requires_grad_(True) for n in ("q", "k", "v"))
    bias = torch.from_numpy(np.ascontiguousarray(data["bias"][:, sl]))
    rate = case.get("rate", 0.0)
    out_t = ring_attention(q, k, v, bias, seq, rate,
                           case.get("seed") if rate else None)
    d_out = torch.from_numpy(np.ascontiguousarray(data["d_out"][:, sl]))
    (out_t * d_out).sum().backward()
    np.savez(f"{out}/{case['name']}.rank{rank}.npz", out=out_t.detach(),
             dq=q.grad, dk=k.grad, dv=v.grad)


def case_refuse(case, rank, world, out):
    """Each refusal the case lists, as (kind, message)."""
    from bert_pytorch_tpu_torch.ops.ring import ring_attention

    layout = layout_of(case, rank, world)
    seq = layout.axis("seq")
    found = []
    x = torch.zeros((1, 4, 2, 8))
    try:
        ring_attention(x, x, x, None, seq,
                       sequence_ids=torch.ones((1, 4), dtype=torch.long))
    except ValueError as e:
        found.append(str(e))
    length = seq.size * 2 + 1  # not a multiple of the group's size
    mb = {k: torch.zeros((1, length), dtype=torch.long) for k in (
        "input_ids", "segment_ids", "input_mask")}
    mb.update(masked_lm_labels=torch.full((1, length), -1),
              next_sentence_labels=torch.zeros(1, dtype=torch.long))
    try:
        pretrain.local_inputs(mb, None, seq)
    except ValueError as e:
        found.append(str(e))
    with open(f"{out}/{case['name']}.rank{rank}.json", "w") as f:
        json.dump(found, f)


def whole_state(model, opt, layout) -> dict:
    """``param/``, ``mu/`` and ``nu/`` of every parameter, whole."""
    from bert_pytorch_tpu_torch import run_pretraining

    regroup = run_pretraining.whole_parts(model)
    params = dict(model.named_parameters())
    out = {f"param/{k}": v for k, v in whole_params(model, layout).items()}
    for prefix, moments in zip(("mu", "nu"), transforms.moments(opt,
                                                                 params)):
        whole = regroup({n: sharding.gather_like(t, params[n])
                         for n, t in moments.items()})
        out.update({f"{prefix}/{k}": v.detach().numpy().copy()
                    for k, v in whole.items()})
    return out


def case_save(case, rank, world, out):
    """One step, then a sharded checkpoint of the state (the runner's
    write_checkpoint) at step 3; rank 0 writes the whole state."""
    from bert_pytorch_tpu_torch import run_pretraining

    model, opt, schedule, layout, dp, cfg = build(case, rank, world)
    step = make_step(model, opt, schedule, cfg, case, dp)
    step(rows_of(dict(np.load(case["batch"])), layout))
    run_pretraining.write_checkpoint(
        case["dir"], 3, model, opt, cfg, {"index": 0}, 1, layout="sharded",
        mesh_spec=layout.spec.as_dict())
    state = whole_state(model, opt, layout)
    if rank == 0:
        np.savez(f"{out}/{case['name']}.rank0.npz", **state)


def case_resume(case, rank, world, out):
    """Resume the newest checkpoint of ``case["dir"]`` into this layout;
    rank 0 writes the whole state."""
    from bert_pytorch_tpu_torch.utils import checkpoint as ckpt
    from bert_pytorch_tpu_torch.utils import dist as dist_utils

    model, opt, schedule, layout, dp, cfg = build(case, rank, world)
    found = ckpt.load_latest_checkpoint(case["dir"], model, opt,
                                        agree=dist_utils.agree_on_resume_step)
    state = whole_state(model, opt, layout)
    if rank == 0:
        np.savez(f"{out}/{case['name']}.rank0.npz", **state)
    with open(f"{out}/{case['name']}.rank{rank}.json", "w") as f:
        json.dump({"step": found[0], "count": found[1]["count"]}, f)


def case_cost(case, rank, world, out):
    """One step through the compile monitor with the cost counter on
    (telemetry/compile_events.py); each rank writes its records."""
    from bert_pytorch_tpu_torch.telemetry.compile_events import CompileMonitor

    model, opt, schedule, layout, dp, cfg = build(case, rank, world)
    monitor = CompileMonitor(cost_analysis="auto")
    step = monitor.instrument(
        make_step(model, opt, schedule, cfg, case, dp), "train_step")
    step(rows_of(dict(np.load(case["batch"])), layout))
    with open(f"{out}/{case['name']}.rank{rank}.json", "w") as f:
        json.dump(monitor.events, f)


CASES = {"step": case_step, "kfac": case_kfac, "ring": case_ring,
         "refuse": case_refuse, "save": case_save, "resume": case_resume,
         "cost": case_cost}


def main():
    plan_path, rank = sys.argv[1], int(sys.argv[2])
    with open(plan_path) as f:
        plan = json.load(f)
    world = plan["world"]
    torch.manual_seed(0)
    dist.init_process_group("gloo", init_method=f"file://{plan['init']}",
                            rank=rank, world_size=world)
    try:
        for case in plan["cases"]:
            CASES[case["kind"]](case, rank, world, plan["out"])
            dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
