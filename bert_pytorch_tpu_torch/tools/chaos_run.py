#!/usr/bin/env python
"""Chaos harness of the port's pretraining runner: kill, corrupt, resume,
and prove the recovery exact. The port of the JAX package's
``tools/chaos_run.py``, phase for phase.

1. **reference**: an uninterrupted run of ``python -m
   bert_pytorch_tpu_torch.run_pretraining --device <--device>`` on
   synthetic HDF5 shards (a tiny fp32 model, dropout 0, every step synced and
   logged) records the per-step loss trajectory;
2. **chaos**: the same run armed with ``--fault_spec
   die@K,shard_errorxN`` is SIGKILLed after step K's checkpoint block,
   after N injected shard-read errors went through the read retries;
3. **corrupt**: the newest checkpoint the dead run left is damaged in
   place (``--corrupt_mode truncate|flip``; its manifest left stale, so
   only the integrity check can catch ``flip``);
4. **resume**: the same command with no fault armed walks back past the
   damaged checkpoint to the one before, writes a ``resume`` record
   naming the skip, finishes the steps, and matches the reference from
   the resume step on (``--loss_rtol``, default 1e-6: the masking derives
   from (seed, epoch, index) and the fp32 step is deterministic).

Both telemetry artifacts are then linted against the port's record
schema. The verdict is one JSON line on standard output; exit 0 means
every check held. The children run on the CUDA card unless ``--device
cpu`` is given; nothing here falls back to the CPU. ``--smoke`` is the
one-command gate::

    python bert_pytorch_tpu_torch/tools/chaos_run.py --smoke --device cpu

The parent imports no torch: it loads the port's ``testing/faults.py``,
``utils/integrity.py``, ``telemetry/schema.py`` and
``tools/make_synthetic_data.py`` by file path (``tools/_bootstrap.py``),
so a wedged child is killed at ``--child_timeout_s``, never the harness.
The shards need ``h5py``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile

if __package__:
    from bert_pytorch_tpu_torch.tools._bootstrap import (REPO_ROOT,
                                                         load_by_path)
else:
    from _bootstrap import REPO_ROOT, load_by_path

faults = load_by_path("_torchchaos_faults", "testing", "faults.py")
integrity = load_by_path("_torchchaos_integrity", "utils", "integrity.py")
schema = load_by_path("_torchchaos_schema", "telemetry", "schema.py")
synth = load_by_path("_torchchaos_synth", "tools", "make_synthetic_data.py")

# Tiny fp32 model with dropout 0: a resumed run draws its dropout seeds
# afresh (checkpoints hold no generator), so only without dropout is the
# resumed trajectory the reference's.
MODEL_CONFIG = {
    "vocab_size": 1000, "hidden_size": 16, "num_hidden_layers": 1,
    "num_attention_heads": 2, "intermediate_size": 32,
    "max_position_embeddings": 32, "type_vocab_size": 2,
    "next_sentence": True, "mask_token_id": 4,
    "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
}


class ChaosFailure(AssertionError):
    pass


def check(cond, what):
    if not cond:
        raise ChaosFailure(what)


def make_data(data_dir: str, seq_len: int, n_per_shard: int = 64) -> None:
    os.makedirs(data_dir, exist_ok=True)
    for i in range(2):
        synth.make_shard(os.path.join(data_dir, f"shard_{i}.hdf5"),
                         n_per_shard, seq_len, MODEL_CONFIG["vocab_size"],
                         seed=i)


def child_cmd(args, out_dir: str, fault_spec: str = "") -> list:
    # Synchronous saves: die@K fires right after step K's checkpoint block,
    # and an async write could still be in flight then, leaving a torn
    # newest file; this gate corrupts a durably written one itself.
    cmd = [
        sys.executable, "-m", "bert_pytorch_tpu_torch.run_pretraining",
        "--device", args.device, "--input_dir", args.data_dir,
        "--output_dir", out_dir, "--model_config_file", args.config_path,
        "--global_batch_size", "16", "--local_batch_size", "16",
        "--max_steps", str(args.steps), "--steps", str(args.steps),
        "--learning_rate", "1e-3", "--warmup_proportion", "0.25",
        "--num_steps_per_checkpoint", str(args.ckpt_every),
        "--keep_checkpoints", "3", "--dtype", "float32",
        "--seed", str(args.seed), "--log_steps", "1",
        "--telemetry_sync_every", "1", "--telemetry_window", "5",
        "--term_check_steps", "1", "--grad_stats_every", "0",
        "--checkpoint_write", "sync",
    ]
    if fault_spec:
        cmd += ["--fault_spec", fault_spec]
    return cmd


def run_child(args, out_dir: str, fault_spec: str = "") -> int:
    env = dict(os.environ)
    # A fault spec leaked from the caller's environment must not arm the
    # children.
    env.pop(faults.FAULTS_ENV, None)
    proc = subprocess.run(
        child_cmd(args, out_dir, fault_spec), env=env, cwd=REPO_ROOT,
        timeout=args.child_timeout_s, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    if args.verbose:
        sys.stderr.write(proc.stdout[-4000:] + "\n")
    return proc.returncode


def telemetry_records(out_dir: str) -> list:
    with open(os.path.join(out_dir, "pretraining_telemetry.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def train_losses(records) -> dict:
    return {int(r["step"]): float(r["loss"]) for r in records
            if r.get("tag") == "train" and r.get("loss") is not None}


def lint(out_dir: str) -> None:
    path = os.path.join(out_dir, "pretraining_telemetry.jsonl")
    errors = schema.validate_file(path)
    check(errors == [], f"schema lint failed for {path}: {errors[:3]}")


def compare_trajectories(ref: dict, new: dict, steps, rtol: float,
                         what: str) -> None:
    for step in steps:
        check(step in ref, f"{what}: reference has no step {step}")
        check(step in new, f"{what}: run has no step {step}")
        check(math.isclose(ref[step], new[step], rel_tol=rtol),
              f"{what}: loss diverged at step {step}: reference "
              f"{ref[step]!r} vs {new[step]!r} (rtol {rtol})")


def ckpt_steps(out_dir: str) -> list:
    names = os.listdir(os.path.join(out_dir, "pretrain_ckpts"))
    return sorted(int(n[len("ckpt_"):-len(".msgpack")]) for n in names
                  if n.startswith("ckpt_") and n.endswith(".msgpack"))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="kill -> corrupt -> resume chaos harness of the port's "
                    "pretraining runner")
    parser.add_argument("--smoke", action="store_true",
                        help="the one-command gate: small step counts")
    parser.add_argument("--steps", type=int, default=None,
                        help="total optimizer steps (default 20; 8 under "
                             "--smoke)")
    parser.add_argument("--die_at", type=int, default=None,
                        help="SIGKILL the chaos child at this step "
                             "(default: steps - 3)")
    parser.add_argument("--ckpt_every", type=int, default=2)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--seq_len", type=int, default=32)
    parser.add_argument("--shard_errors", type=int, default=2,
                        help="transient injected shard-read errors in the "
                             "chaos run (0 disables)")
    parser.add_argument("--corrupt_mode", type=str, default="truncate",
                        choices=["truncate", "flip"])
    parser.add_argument("--loss_rtol", type=float, default=1e-6)
    parser.add_argument("--child_timeout_s", type=float, default=300.0)
    parser.add_argument("--workdir", type=str, default="",
                        help="keep artifacts here (default: a fresh temp "
                             "dir, removed on success)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the children's torch device: cuda (default; "
                             "a child raises without a card) or cpu")
    parser.add_argument("--verbose", action="store_true",
                        help="echo the children's output")
    args = parser.parse_args(argv)

    args.steps = args.steps or (8 if args.smoke else 20)
    args.die_at = args.die_at or max(3, args.steps - 3)
    check(args.die_at < args.steps, "--die_at must be before --steps")

    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_run_")
    os.makedirs(workdir, exist_ok=True)
    args.data_dir = os.path.join(workdir, "data")
    args.config_path = os.path.join(workdir, "model.json")
    ref_dir = os.path.join(workdir, "reference")
    chaos_dir = os.path.join(workdir, "chaos")
    verdict = {"metric": "chaos_kill_corrupt_resume", "workdir": workdir,
               "device": args.device, "steps": args.steps,
               "die_at": args.die_at,
               "corrupt_mode": args.corrupt_mode}
    try:
        make_data(args.data_dir, args.seq_len)
        with open(args.config_path, "w") as f:
            json.dump(MODEL_CONFIG, f)

        # 1. the reference trajectory
        rc = run_child(args, ref_dir)
        check(rc == 0, f"reference run failed (rc {rc})")
        ref = train_losses(telemetry_records(ref_dir))
        check(len(ref) == args.steps,
              f"reference logged {len(ref)} steps, wanted {args.steps}")

        # 2. the chaos run: transient shard errors, then SIGKILL at die_at
        spec = f"die@{args.die_at}"
        if args.shard_errors:
            spec += f",shard_errorx{args.shard_errors}"
        rc = run_child(args, chaos_dir, fault_spec=spec)
        check(rc in (-9, 137),
              f"chaos child should die by SIGKILL, got rc {rc}")
        chaos_records = telemetry_records(chaos_dir)
        fault_kinds = {r.get("fault") for r in chaos_records
                       if r.get("kind") == "fault"}
        check("injected_die" in fault_kinds,
              f"no injected_die fault record (saw {sorted(fault_kinds)})")
        if args.shard_errors:
            check("injected_shard_error" in fault_kinds,
                  "no injected_shard_error fault record")
            check("shard_read_retry" in fault_kinds,
                  "the retries wrote no shard_read_retry record")
        compare_trajectories(
            ref, train_losses(chaos_records), range(1, args.die_at),
            args.loss_rtol,
            "pre-kill prefix (shard retries must not change the data)")

        # 3. corrupt the newest surviving checkpoint
        steps = ckpt_steps(chaos_dir)
        check(len(steps) >= 2, f"need >= 2 retained checkpoints to "
                               f"corrupt and walk back, have {steps}")
        newest, expect_resume = steps[-1], steps[-2]
        newest_path = os.path.join(chaos_dir, "pretrain_ckpts",
                                   f"ckpt_{newest}.msgpack")
        faults.corrupt_checkpoint(newest_path, args.corrupt_mode)
        status, detail = integrity.verify_checkpoint(newest_path)
        check(status == integrity.CORRUPT,
              f"corruption undetected: {status} ({detail})")
        verdict.update(corrupted_step=newest, resume_step=expect_resume)

        # 4. resume: walk back past the damage, finish, match
        rc = run_child(args, chaos_dir)
        check(rc == 0, f"resume run failed (rc {rc})")
        records = telemetry_records(chaos_dir)
        resumes = [r for r in records if r.get("kind") == "resume"]
        check(resumes, "the resume run wrote no resume record")
        resume = resumes[-1]
        check(int(resume["step"]) == expect_resume,
              f"resumed from step {resume['step']}, expected "
              f"{expect_resume} (walk-back past corrupt {newest})")
        skipped_steps = [int(e["step"]) for e in resume["skipped"]]
        check(newest in skipped_steps,
              f"the resume record does not name corrupt step {newest} "
              f"(skipped: {skipped_steps})")
        compare_trajectories(
            ref, train_losses(records[records.index(resume):]),
            range(expect_resume + 1, args.steps + 1), args.loss_rtol,
            "post-resume trajectory")

        # 5. both artifacts schema-clean
        lint(ref_dir)
        lint(chaos_dir)

        verdict.update(ok=True, skipped=resume["skipped"],
                       compared_steps=args.steps - expect_resume)
        print(json.dumps(verdict))
        if not args.workdir:
            shutil.rmtree(workdir, ignore_errors=True)
        return 0
    except (ChaosFailure, subprocess.TimeoutExpired, OSError, ValueError,
            KeyError) as exc:
        verdict.update(ok=False, error=f"{type(exc).__name__}: {exc}")
        print(json.dumps(verdict))
        print(f"chaos_run: FAILED; artifacts kept in {workdir}",
              file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
