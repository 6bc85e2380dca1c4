"""One rank of the port's data-parallel / fully-sharded CPU tests
(tests/test_torch_parallel.py): ``python _torch_parallel_worker.py PLAN
RANK``. It imports torch, numpy and the port only; the JAX references
are computed in the pytest process and arrive as numpy files.

The plan (JSON) names the world size, the rendezvous file, the output
directory and a list of cases; every rank runs every case in order and
rank 0 (or each rank, where the case says so) writes its results as
``<out>/<case name>.rank<r>.npz`` or ``.json``. One process group carries
all the cases, so the cost of starting torch is paid once.
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
from bert_pytorch_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from bert_pytorch_tpu_torch.parallel import sharding  # noqa: E402
from bert_pytorch_tpu_torch.utils import dist as dist_utils  # noqa: E402


def unflatten(flat) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(value)
    return tree


def build(case, rank, world):
    """(model, optimizer, schedule, mesh, DataParallel) of a case: the
    JAX weights of ``case["params"]``, sharded per ``case["mesh"]``."""
    cfg = BertConfig(**case["config"])
    model = bert.BertForPreTraining(cfg, torch.float32,
                                    case.get("backend", "dense"),
                                    case.get("remat", "none"))
    params = unflatten(np.load(case["params"]))
    model.load_state_dict(from_jax_params(params, cfg, "pretraining"))
    spec = mesh_lib.MeshSpec.parse(case["mesh"])
    mesh = mesh_lib.create_mesh(spec, "cpu")
    model = sharding.shard_model(model, mesh)
    schedule = schedules.warmup_poly_schedule(*case["schedule"])
    groups = transforms.param_groups(model, 0.01)
    if case.get("optimizer", "lamb") == "lamb":
        opt = transforms.Lamb(groups, schedule)
    else:
        opt = transforms.BertAdam(groups, 1e-3, warmup=0.1, t_total=100,
                                  max_grad_norm=case["clip"])
    if case.get("fp16"):
        opt = transforms.DynamicLossScale(opt, init_scale=2.0 ** 4)
    dp = pretrain.DataParallel(rank=rank, world_size=world,
                               fsdp=sharding.is_fsdp(model),
                               overlap=case.get("overlap", False))
    return model, opt, schedule, mesh, dp, cfg


def rank_rows(batch, rank, world):
    """This rank's rows of every microbatch of a [A, B, ...] batch."""
    rows = next(iter(batch.values())).shape[1] // world
    return {k: torch.from_numpy(np.ascontiguousarray(
        v[:, rank * rows:(rank + 1) * rows])).long()
        for k, v in batch.items()}


def full_params(model) -> dict:
    return {k: v.detach().numpy().copy()
            for k, v in sharding.full_state_dict(model).items()}


def case_step(case, rank, world, out):
    """One optimizer step of the port's data-parallel step; every rank
    writes its metrics and the whole parameters after the step."""
    model, opt, schedule, _, dp, cfg = build(case, rank, world)
    step = pretrain.make_train_step(
        model, opt, schedule, bool(cfg.next_sentence), case["max_pred"],
        torch.Generator().manual_seed(0), stats_every=1,
        loss_scale=bool(case.get("fp16")), data_parallel=dp)
    batch = rank_rows(dict(np.load(case["batch"])), rank, world)
    metrics = step(batch)
    result = {k: float(metrics[k]) for k in
              ("loss", "grad_norm", "mlm_accuracy", "real_tokens", "finite")}
    from bert_pytorch_tpu_torch.telemetry import model_stats

    health = model_stats.health_record(1, metrics["grad_health"])
    result["health_grad_norm"] = health["grad_norm"]
    result["health_update_ratio"] = health["update_ratio"]
    reducer = getattr(step, "reducer", None)
    result["launches"] = reducer.launches if reducer is not None else []
    np.savez(f"{out}/{case['name']}.rank{rank}.npz", **full_params(model))
    with open(f"{out}/{case['name']}.rank{rank}.json", "w") as f:
        json.dump(result, f)


def case_fp16_inf(case, rank, world, out):
    """fp16 under FSDP: an inf planted in rank 1's gradient shard only;
    every rank must skip the step and halve the scale."""
    model, opt, schedule, _, dp, cfg = build(case, rank, world)
    batch = rank_rows(dict(np.load(case["batch"])), rank, world)
    before = {k: v.copy() for k, v in full_params(model).items()}
    mb = {k: v[0] for k, v in batch.items()}
    loss, _ = pretrain.pretraining_loss_and_accuracy(
        model, mb, True, case["max_pred"])
    (loss * opt.scale).backward()
    if rank == 1:
        p = model.bert.encoder.layers[0].attention.query.weight
        sharding.local(p.grad).view(-1)[0] = float("inf")
    stepped = opt.step()
    after = full_params(model)
    unchanged = all(np.array_equal(before[k], after[k]) for k in before)
    with open(f"{out}/{case['name']}.rank{rank}.json", "w") as f:
        json.dump({"stepped": bool(stepped), "scale": opt.scale,
                   "unchanged": unchanged}, f)


def case_dropout(case, rank, world, out):
    """The dropout seeds each rank's step hands its model, and the first
    layer's attention keep mask drawn from them."""
    from bert_pytorch_tpu_torch.testing.dropout_masks import philox_mask

    model, opt, schedule, _, dp, cfg = build(case, rank, world)
    seen = []
    forward = model.forward

    def recording(*args, **kwargs):
        seen.append(list(args[6]))
        return forward(*args, **kwargs)

    model.forward = recording
    step = pretrain.make_train_step(
        model, opt, schedule, True, case["max_pred"],
        torch.Generator().manual_seed(0), data_parallel=dp)
    metrics = step(rank_rows(dict(np.load(case["batch"])), rank, world))
    layer0 = bert._sub_seed(seen[0][1], bert._ATTENTION_PROBS)
    mask = philox_mask(2, 16, cfg.num_attention_heads, layer0, 0.1)
    np.savez(f"{out}/{case['name']}.rank{rank}.npz",
             seeds=np.asarray(seen, dtype=np.int64), mask=mask.numpy(),
             loss=float(metrics["loss"]))


def case_agree(case, rank, world, out):
    """agree_on_resume_step over real ranks, one proposal per rank per
    policy case."""
    results = []
    for proposals in case["proposals"]:
        try:
            results.append(["ok", dist_utils.agree_on_resume_step(
                proposals[rank])])
        except RuntimeError as e:
            results.append(["error", str(e)])
    with open(f"{out}/{case['name']}.rank{rank}.json", "w") as f:
        json.dump(results, f)


def case_save(case, rank, world, out):
    """One step, then a checkpoint of the state in ``case["layout"]``
    (the runner's checkpoint_contents), sync or async."""
    from bert_pytorch_tpu_torch import run_pretraining
    from bert_pytorch_tpu_torch.utils import checkpoint as ckpt

    model, opt, schedule, mesh, dp, cfg = build(case, rank, world)
    step = pretrain.make_train_step(
        model, opt, schedule, True, case["max_pred"],
        torch.Generator().manual_seed(0), data_parallel=dp)
    step(rank_rows(dict(np.load(case["batch"])), rank, world))
    spec = mesh_lib.resolved(mesh_lib.MeshSpec.parse(case["mesh"]), world)
    run_pretraining.write_checkpoint(
        case["dir"], 3, model, opt, cfg, {"index": 0}, 1,
        layout=case["layout"], async_write=case.get("async", False),
        mesh_spec=spec.as_dict())
    ckpt.wait_for_pending_save()
    dist_utils.barrier()
    params = full_params(model)
    if rank == 0:
        np.savez(f"{out}/{case['name']}.rank0.npz", **params)


def case_resume(case, rank, world, out):
    """Resume a checkpoint into this world's layout, then one step: every
    rank writes the step's loss and the whole parameters after it."""
    from bert_pytorch_tpu_torch.utils import checkpoint as ckpt

    model, opt, schedule, _, dp, cfg = build(case, rank, world)
    found = ckpt.load_latest_checkpoint(case["dir"], model, opt,
                                        agree=dist_utils.agree_on_resume_step)
    step = pretrain.make_train_step(
        model, opt, schedule, True, case["max_pred"],
        torch.Generator().manual_seed(0), data_parallel=dp)
    metrics = step(rank_rows(dict(np.load(case["batch"])), rank, world))
    np.savez(f"{out}/{case['name']}.rank{rank}.npz", **full_params(model))
    with open(f"{out}/{case['name']}.rank{rank}.json", "w") as f:
        json.dump({"step": found[0], "count": found[1]["count"],
                   "loss": float(metrics["loss"])}, f)


CASES = {"step": case_step, "fp16_inf": case_fp16_inf,
         "dropout": case_dropout, "agree": case_agree, "save": case_save,
         "resume": case_resume}


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
