"""The port's runners across ranks, end to end on the CPU: two processes of
``python -m bert_pytorch_tpu_torch.run_pretraining`` (and of
``run_squad``) launched with torchrun's environment over gloo, meeting
through a ``file://`` rendezvous in the test's directory.

* pretraining ``--mesh dp=2``: rank 0 alone prints, writes the JSONL, the
  heartbeat and the gathered checkpoint; a second run resumes it under
  ``--mesh fsdp=2`` (the ranks agree on the step) and writes a sharded
  checkpoint, one shard per rank; ``--kfac`` at dp=2 sums its factors
  over the ranks;
* pretraining ``--mesh pipe=2,model=2`` on 4 ranks and ``--mesh seq=2``:
  rank 0 alone prints, writes the JSONL and the checkpoint; the mesh line
  names every axis and each group's transport;
* ``--mesh fsdp=2,pipe=2`` on 4 ranks (FSDP2 units on each stage's
  fsdp group): a held-out pass, a sharded save, and a second run that
  resumes it; ``--mesh fsdp=2 --kfac`` (the fused capture on FSDP
  shards), whose saved K-FAC state one process resumes bit for bit;
* a refused layout (the JAX runner's rule: the bucketed overlap outside a
  plain data mesh) is refused before the rendezvous, so every rank of
  every run prints the refusal, also with several runs launched at once
  (a refusal raised after the rendezvous let a rank leave while its peer
  was still connecting: the peer died of gloo's "connectFullMesh failed"
  instead).
* SQuAD ``--mesh_data 2``: one step, equal to the single-process step on
  the same batch (dropout off) within 1e-6 in loss and parameters.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bert_pytorch_tpu_torch import run_squad
from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
    make_shard, write_squad_json, write_trace_vocab)
from bert_pytorch_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=128,
              max_position_embeddings=32, type_vocab_size=2,
              next_sentence=True, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
TOL = 1e-6


def _start(tmp, name, module, argv, world=2):
    """Start ``world`` ranks of ``python -m module argv`` with torchrun's
    environment and a file:// rendezvous; their processes."""
    rdzv = tmp / f"{name}.rdzv"
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                   OMP_NUM_THREADS="1")
        env.pop("MASTER_ADDR", None)
        env.pop("MASTER_PORT", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv, "--dist_init_method",
             f"file://{rdzv}"], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return procs


def _finish(procs):
    """(returncodes, stdouts, stderrs) of started ranks."""
    outs = [p.communicate(timeout=240) for p in procs]
    return ([p.returncode for p in procs], [o for o, _ in outs],
            [e for _, e in outs])


def _launch(tmp, name, module, argv, world=2):
    """``world`` ranks of ``python -m module argv`` with torchrun's
    environment and a file:// rendezvous; (returncodes, stdouts,
    stderrs)."""
    return _finish(_start(tmp, name, module, argv, world))


@pytest.fixture(scope="module")
def pretrain_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("runner_shards")
    for s in range(2):
        make_shard(str(root / f"shard_{s}.hdf5"), 32, 32, 125, seed=s)
    config = root / "tiny.json"
    config.write_text(json.dumps(dict(CONFIG, vocab_size=125)))
    return root, config


def _pretrain_args(data, out, *extra):
    root, config = data
    return ["--model_config_file", str(config), "--input_dir", str(root),
            "--output_dir", str(out), "--global_batch_size", "8",
            "--local_batch_size", "2", "--max_steps", "50", "--device",
            "cpu", "--dtype", "float32", "--checkpoint_write", "sync",
            "--skip_final_checkpoint", *extra]


@pytest.fixture(scope="module")
def dp_then_fsdp(pretrain_data, tmp_path_factory):
    """Run A: dp=2, 2 steps, a gathered checkpoint at step 2. Run B: the
    same directory under fsdp=2, resumed, 1 step, saved sharded."""
    tmp = tmp_path_factory.mktemp("runner")
    out = tmp / "out"
    a = _launch(tmp, "a", "bert_pytorch_tpu_torch.run_pretraining",
                _pretrain_args(pretrain_data, out, "--mesh", "dp=2",
                               "--steps", "2", "--num_steps_per_checkpoint",
                               "2"))
    b = _launch(tmp, "b", "bert_pytorch_tpu_torch.run_pretraining",
                _pretrain_args(pretrain_data, out, "--mesh", "fsdp=2",
                               "--steps", "1", "--num_steps_per_checkpoint",
                               "1", "--checkpoint_layout", "sharded"))
    return tmp, out, a, b


def test_dp_runner_rank_zero_writes(dp_then_fsdp):
    _, out, (rcs, stdouts, stderrs), _ = dp_then_fsdp
    assert rcs == [0, 0], stderrs[0][-3000:] + stderrs[1][-3000:]
    lines = stdouts[0].splitlines()
    mesh_line = next(line for line in lines if line.startswith("event mesh"))
    assert "data 2 fsdp 1 world_size 2 backend gloo" in mesh_line
    steps = [line for line in lines if line.startswith("step ")]
    assert [s.split()[1] for s in steps] == ["1", "2"]
    assert all(" finite 1 " in s for s in steps)
    assert stdouts[1] == ""  # rank 1 prints nothing
    records = [json.loads(line) for line in
               (out / "pretraining_telemetry.jsonl").read_text().splitlines()]
    train = [r for r in records if r.get("tag") == "train"]
    assert [r["step"] for r in train[:2]] == [1, 2]  # once, not per rank
    assert json.loads((out / "heartbeat.json").read_text())["step"] >= 2
    files = sorted(os.listdir(out / "pretrain_ckpts"))
    assert "ckpt_2.msgpack" in files
    assert not any("shard" in f for f in files if "ckpt_2." in f)


def test_fsdp_runner_resumes_the_agreed_step_and_saves_sharded(dp_then_fsdp):
    _, out, _, (rcs, stdouts, stderrs) = dp_then_fsdp
    assert rcs == [0, 0], stderrs[0][-3000:] + stderrs[1][-3000:]
    lines = stdouts[0].splitlines()
    resume = next(line for line in lines if line.startswith("event resume"))
    assert resume.split()[3] == "2"
    assert "fsdp 2" in next(line for line in lines
                            if line.startswith("event mesh"))
    steps = [line for line in lines if line.startswith("step ")]
    assert [s.split()[1] for s in steps] == ["3"]
    files = os.listdir(out / "pretrain_ckpts")
    assert {"ckpt_3.msgpack", "ckpt_3.shard0of2.msgpack",
            "ckpt_3.shard1of2.msgpack"} <= set(files)
    state = ckpt.load_checkpoint(str(out / "pretrain_ckpts" /
                                     "ckpt_3.msgpack"))
    assert int(np.asarray(state["optimizer"]["count"])) == 3
    assert np.isfinite(float(state["model"]["predictions"]["bias"].sum()))


def test_kfac_dp2_runner_sums_factors_over_the_ranks(pretrain_data,
                                                    tmp_path):
    rcs, stdouts, stderrs = _launch(
        tmp_path, "kfac", "bert_pytorch_tpu_torch.run_pretraining",
        _pretrain_args(pretrain_data, tmp_path / "out", "--mesh", "dp=2",
                       "--kfac", "--steps", "2", "--kfac_factor_interval",
                       "1", "--kfac_inv_interval", "1"))
    assert rcs == [0, 0], stderrs[0][-3000:] + stderrs[1][-3000:]
    lines = stdouts[0].splitlines()
    kfac = next(line for line in lines if line.startswith("event kfac"))
    assert "capture train (fused)" in kfac
    steps = [line for line in lines if line.startswith("step ")]
    assert [s.split()[1] for s in steps] == ["1", "2"]
    assert all(" finite 1 " in s for s in steps)
    assert stdouts[1] == ""


def test_pp_tp_runner_on_four_ranks(pretrain_data, tmp_path):
    out = tmp_path / "out"
    rcs, stdouts, stderrs = _launch(
        tmp_path, "pp_tp", "bert_pytorch_tpu_torch.run_pretraining",
        _pretrain_args(pretrain_data, out, "--mesh", "pipe=2,model=2",
                       "--steps", "2", "--num_steps_per_checkpoint", "2",
                       "--val_input_dir", str(pretrain_data[0]),
                       "--num_steps_per_eval", "2", "--eval_batches", "1"),
        world=4)
    assert rcs == [0] * 4, "".join(e[-2000:] for e in stderrs)
    lines = stdouts[0].splitlines()
    mesh_line = next(line for line in lines if line.startswith("event mesh"))
    assert ("dcn 1 data 1 fsdp 1 world_size 4 backend gloo pipe 2 seq 1 "
            "model 2 transport pipe=gloo+host,model=gloo") in mesh_line
    steps = [line for line in lines if line.startswith("step ")]
    assert [s.split()[1] for s in steps] == ["1", "2"]
    assert all(" finite 1 " in s for s in steps)
    # The held-out forward runs through the stages too.
    assert any(line.startswith("event val step 2 ") for line in lines)
    assert stdouts[1] == stdouts[2] == stdouts[3] == ""
    records = [json.loads(line) for line in
               (out / "pretraining_telemetry.jsonl").read_text().splitlines()]
    train = [r for r in records if r.get("tag") == "train"]
    assert [r["step"] for r in train[:2]] == [1, 2]
    state = ckpt.load_checkpoint(str(out / "pretrain_ckpts" /
                                     "ckpt_2.msgpack"))
    layers = state["model"]["bert"]["encoder"]["layers"]
    assert np.asarray(layers["attention"]["query"]["kernel"]).shape == (
        2, 64, 4, 16)  # every layer, every head: gathered whole
    assert int(np.asarray(state["optimizer"]["count"])) == 2


def test_seq2_runner_switches_to_the_ring(pretrain_data, tmp_path):
    rcs, stdouts, stderrs = _launch(
        tmp_path, "sp", "bert_pytorch_tpu_torch.run_pretraining",
        _pretrain_args(pretrain_data, tmp_path / "out", "--mesh", "seq=2",
                       "--steps", "1"))
    assert rcs == [0, 0], stderrs[0][-3000:] + stderrs[1][-3000:]
    lines = stdouts[0].splitlines()
    assert any(line.startswith("event attention_backend was auto now ring")
               for line in lines)
    start = next(line for line in lines if line.startswith("event start"))
    assert "attention_backend ring" in start
    steps = [line for line in lines if line.startswith("step ")]
    assert len(steps) == 1 and " finite 1 " in steps[0]
    assert stdouts[1] == ""


def test_refusals_reach_every_rank_under_load(pretrain_data, tmp_path):
    """Three refused runs of two ranks each, started at once: every rank
    of every run prints the refusal (it is raised before the rendezvous,
    so no rank waits on a peer that has left). The refusal is the JAX
    runner's: the bucketed overlap outside a plain data mesh."""
    runs = [_start(tmp_path, f"refused{i}",
                   "bert_pytorch_tpu_torch.run_pretraining",
                   _pretrain_args(pretrain_data, tmp_path / f"out{i}",
                                  "--mesh", "fsdp=2", "--overlap_grad_reduce",
                                  "--steps", "1"))
            for i in range(3)]
    for procs in runs:
        rcs, _, stderrs = _finish(procs)
        assert rcs[0] != 0 and rcs[1] != 0
        for err in stderrs:
            assert ("--overlap_grad_reduce requires a pure data-parallel "
                    "mesh") in err, err[-2000:]


@pytest.fixture(scope="module")
def fsdp_pp_runs(pretrain_data, tmp_path_factory):
    """Run A: fsdp=2,pipe=2 on 4 ranks, 2 steps, a held-out pass at step 2
    and a sharded checkpoint. Run B: the same directory and layout,
    resumed, 1 step."""
    tmp = tmp_path_factory.mktemp("fsdp_pp")
    out = tmp / "out"
    common = ("--mesh", "fsdp=2,pipe=2", "--checkpoint_layout", "sharded",
              "--val_input_dir", str(pretrain_data[0]),
              "--num_steps_per_eval", "2", "--eval_batches", "1")
    a = _launch(tmp, "a", "bert_pytorch_tpu_torch.run_pretraining",
                _pretrain_args(pretrain_data, out, *common, "--steps", "2",
                               "--num_steps_per_checkpoint", "2"), world=4)
    b = _launch(tmp, "b", "bert_pytorch_tpu_torch.run_pretraining",
                _pretrain_args(pretrain_data, out, *common, "--steps", "1",
                               "--num_steps_per_checkpoint", "1"), world=4)
    return out, a, b


def test_fsdp_pp_runner_on_four_ranks(fsdp_pp_runs):
    out, (rcs, stdouts, stderrs), _ = fsdp_pp_runs
    assert rcs == [0] * 4, "".join(e[-2000:] for e in stderrs)
    lines = stdouts[0].splitlines()
    mesh_line = next(line for line in lines if line.startswith("event mesh"))
    assert ("dcn 1 data 1 fsdp 2 world_size 4 backend gloo pipe 2 seq 1 "
            "model 1 transport batch=gloo,pipe=gloo+host") in mesh_line
    steps = [line for line in lines if line.startswith("step ")]
    assert [s.split()[1] for s in steps] == ["1", "2"]
    assert all(" finite 1 " in s for s in steps)
    # The held-out forward runs through the stages and the FSDP units.
    val = next(line for line in lines if line.startswith("event val step 2 "))
    assert np.isfinite(float(val.split("average_loss ")[1].split()[0]))
    assert stdouts[1] == stdouts[2] == stdouts[3] == ""
    files = set(os.listdir(out / "pretrain_ckpts"))
    assert {"ckpt_2.msgpack"} | {f"ckpt_2.shard{r}of4.msgpack"
                                 for r in range(4)} <= files


def test_fsdp_pp_runner_resumes_its_sharded_save(fsdp_pp_runs):
    out, _, (rcs, stdouts, stderrs) = fsdp_pp_runs
    assert rcs == [0] * 4, "".join(e[-2000:] for e in stderrs)
    lines = stdouts[0].splitlines()
    resume = next(line for line in lines if line.startswith("event resume"))
    assert resume.split()[3] == "2"
    steps = [line for line in lines if line.startswith("step ")]
    assert [s.split()[1] for s in steps] == ["3"]
    assert " finite 1 " in steps[0]
    state = ckpt.load_checkpoint(str(out / "pretrain_ckpts" /
                                     "ckpt_3.msgpack"))
    assert int(np.asarray(state["optimizer"]["count"])) == 3
    layers = state["model"]["bert"]["encoder"]["layers"]
    assert np.asarray(layers["attention"]["query"]["kernel"]).shape == (
        2, 64, 4, 16)  # every layer, every head, from the four shards


def test_kfac_fsdp2_runner_state_resumes_at_world_one(pretrain_data,
                                                      tmp_path):
    """--kfac under fsdp=2 (the fused capture): the factors and inverses
    it saves resume bit for bit in one process."""
    from bert_pytorch_tpu_torch.config import BertConfig
    from bert_pytorch_tpu_torch.models.bert import BertForPreTraining
    from bert_pytorch_tpu_torch.optim import KFAC, schedules, transforms

    out = tmp_path / "out"
    rcs, stdouts, stderrs = _launch(
        tmp_path, "kfac_fsdp", "bert_pytorch_tpu_torch.run_pretraining",
        _pretrain_args(pretrain_data, out, "--mesh", "fsdp=2", "--kfac",
                       "--steps", "2", "--kfac_factor_interval", "1",
                       "--kfac_inv_interval", "1",
                       "--num_steps_per_checkpoint", "2"))
    assert rcs == [0, 0], stderrs[0][-3000:] + stderrs[1][-3000:]
    lines = stdouts[0].splitlines()
    assert "capture train (fused)" in next(
        line for line in lines if line.startswith("event kfac"))
    steps = [line for line in lines if line.startswith("step ")]
    assert [s.split()[1] for s in steps] == ["1", "2"]
    assert all(" finite 1 " in s for s in steps)
    path = str(out / "pretrain_ckpts")
    saved = ckpt.load_checkpoint(os.path.join(path, "ckpt_2.msgpack"))[
        "preconditioner"]
    assert int(np.asarray(saved["count"])) == 2
    config = BertConfig(**dict(CONFIG, vocab_size=128))
    model = BertForPreTraining(config, torch.float32)
    opt = transforms.Lamb(transforms.param_groups(model, 0.01),
                          schedules.warmup_poly_schedule(1e-3, 0.1, 50))
    kfac = KFAC(model)
    state = kfac.init()
    step, extras = ckpt.load_latest_checkpoint(path, model, opt,
                                               preconditioner=state)
    assert step == 2 and extras["preconditioner"]
    assert int(state.count) == 2
    for field in ("a", "g", "qa", "la", "qg", "lg"):
        for key, value in getattr(state, field).items():
            want = saved[field][key]
            if not isinstance(want, torch.Tensor):
                want = torch.as_tensor(np.asarray(want))
            assert want.dtype == value.dtype, (field, key)
            assert torch.equal(value, want), (field, key)


@pytest.fixture(scope="module")
def squad_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("squad_dp")
    vocab = write_trace_vocab(str(root / "vocab.txt"))
    config = root / "tiny.json"
    config.write_text(json.dumps(dict(CONFIG, vocab_size=48,
                                      max_position_embeddings=128,
                                      tokenizer="wordpiece")))
    return root, vocab, config, write_squad_json(str(root / "v1.json"), 0, 2)


def _squad_args(files, out, *extra):
    root, vocab, config, train = files
    return ["--output_dir", str(out), "--config_file", str(config),
            "--vocab_file", vocab, "--do_lower_case", "--device", "cpu",
            "--dtype", "float32", "--max_seq_length", "64", "--doc_stride",
            "32", "--max_query_length", "16", "--train_file", train,
            "--do_train", "--train_batch_size", "4", "--max_steps", "1",
            "--skip_cache", "--learning_rate", "1e-3", *extra]


def test_squad_mesh_data_matches_one_process(squad_files, tmp_path):
    rcs, stdouts, stderrs = _launch(
        tmp_path, "squad", "bert_pytorch_tpu_torch.run_squad",
        _squad_args(squad_files, tmp_path / "dp", "--mesh_data", "2"))
    assert rcs == [0, 0], stderrs[0][-3000:] + stderrs[1][-3000:]
    assert stdouts[1] == ""
    dp = json.loads((tmp_path / "dp" / "squad_log.json").read_text())
    single = run_squad.main(run_squad.parse_args(
        _squad_args(squad_files, tmp_path / "one")))
    assert dp["global_step"] == single["global_step"] == 1
    np.testing.assert_allclose(dp["final_loss"], single["final_loss"],
                               rtol=TOL)
    got = ckpt.load_checkpoint(ckpt.checkpoint_path(str(tmp_path / "dp"),
                                                    1))["model"]
    want = ckpt.load_checkpoint(ckpt.checkpoint_path(str(tmp_path / "one"),
                                                     1))["model"]

    def leaves(tree, path=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{path}/{k}")
            else:
                yield f"{path}/{k}", v

    want = dict(leaves(want))
    for key, value in leaves(got):
        np.testing.assert_allclose(torch.as_tensor(value).numpy(),
                                   torch.as_tensor(want[key]).numpy(),
                                   atol=TOL, rtol=0, err_msg=key)
    with pytest.raises(ValueError, match="world size"):
        run_squad.main(run_squad.parse_args(
            _squad_args(squad_files, tmp_path / "bad", "--mesh_data", "2")))
