"""Probe whether K-FAC pretraining's resumed step is deterministic on the
card, with PyTorch's deterministic algorithms on.

    python -m bert_pytorch_tpu_torch.tools.probe_determinism [--out FILE]

Runs, in this (fresh) process, the resume-then-one-step pair of
``chip_smoke.py`` phase 11 at its shape: BERT-large with the phase-2
recipe (S=512, flash, remat dots, LAMB, bf16, local batch 8 x 2,
seeded synthetic rows) and ``--kfac --kfac_factor_interval 1
--kfac_inv_interval 2`` (fused capture, Cholesky): 4 steps and a sync
save through the runner's own functions, then a fresh runner resumes the
save, and one more step from each (the in-memory runner and the resumed
one) on the same batch and dropout seeds. Before any CUDA work it sets
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (unless set) and
``torch.use_deterministic_algorithms(True, warn_only=True)``: every op
of the run that has no deterministic CUDA implementation warns (PyTorch
switches the others to their deterministic versions), so one run names
them all and still finishes the comparison.

Prints one JSON line (and writes it to ``--out``): the card's name and
power limit, the ops that warned, whether the two resumed steps agree
bit for bit (params, moments, K-FAC factors, loss), the largest
param/moment difference, and the seconds taken. The mode is a probe
only: nothing on the training path turns it on. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "configs", "bert_large_uncased_config.json")
PHASE2 = os.path.join(REPO, "configs", "bert_pretraining_phase2_config.json")
LOCAL_BATCH, ACCUMULATION, STEPS, SEQ = 8, 2, 4, 512
KFAC_FLAGS = ("--kfac", "--kfac_factor_interval", "1",
              "--kfac_inv_interval", "2")
DATA_SEED, BATCH_SEED = 11, 400


def runner(out: str) -> dict:
    """The pretraining runner's set-up as its ``main`` runs it up to the
    loop, resuming from ``out`` when it holds a checkpoint."""
    from bert_pytorch_tpu_torch import run_pretraining as rp

    args = rp.setup_training(rp.parse_arguments([
        "--config_file", PHASE2, "--model_config_file", CONFIG,
        "--output_dir", out, "--dtype", "bfloat16", "--device", "cuda",
        "--seed", "0", "--local_batch_size", str(LOCAL_BATCH),
        "--global_batch_size", str(LOCAL_BATCH * ACCUMULATION),
        "--steps", str(STEPS), "--attention_backend", "flash",
        "--num_steps_per_checkpoint", str(10 ** 6), "--keep_checkpoints",
        "1", "--previous_phase_end_step", "0", *KFAC_FLAGS]))
    model, config = rp.prepare_model(args)
    optimizer, schedule = rp.prepare_optimizer(args, model)
    kfac, kfac_state = rp.prepare_kfac(args, model, config)
    checkpoint, global_step = rp.restore_checkpoint(args, model, optimizer,
                                                    kfac, kfac_state)
    return dict(args=args, model=model, config=config, optimizer=optimizer,
                schedule=schedule, kfac=kfac, kfac_state=kfac_state,
                checkpoint=checkpoint, global_step=global_step)


def step_of(r: dict):
    from bert_pytorch_tpu_torch import run_pretraining as rp

    return rp.make_step(r["args"], r["model"], r["optimizer"],
                        r["schedule"], r["config"], r["kfac"],
                        r["kfac_state"])


def state_of(r: dict) -> dict:
    """name -> (param, exp_avg, exp_avg_sq), and the factors by key."""
    out = {n: (p, r["optimizer"].state[p]["exp_avg"],
               r["optimizer"].state[p]["exp_avg_sq"])
           for n, p in r["model"].named_parameters()}
    for field in ("a", "g"):
        for key, value in getattr(r["kfac_state"], field).items():
            out[f"kfac.{field}.{key}"] = (value,)
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def probe(root: str) -> dict:
    from bert_pytorch_tpu_torch import pretrain
    from bert_pytorch_tpu_torch import run_pretraining as rp
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
        SyntheticPretrainingDataset, synthetic_pretraining_batch)

    t0 = time.perf_counter()
    out = os.path.join(root, "kfac")
    r = runner(out)
    args = r["args"]
    loader, sampler = rp.prepare_dataset(
        args, r["config"], None, SyntheticPretrainingDataset(
            DATA_SEED, LOCAL_BATCH * ACCUMULATION * STEPS, SEQ,
            r["config"].vocab_size, args.max_predictions_per_seq))
    rp.train(args, r["model"], r["optimizer"], r["config"], step_of(r),
             loader, sampler, None, r["global_step"], r["kfac_state"])
    resumed = runner(out)
    if resumed["global_step"] != STEPS:
        raise AssertionError(f"resumed at {resumed['global_step']}")
    mine, theirs = state_of(r), state_of(resumed)
    before = [all(torch.equal(a, b) for a, b in zip(v, theirs[n]))
              for n, v in mine.items()]
    batch = pretrain.to_device(pretrain.stack_microbatches(
        synthetic_pretraining_batch(
            BATCH_SEED, args.global_batch_size, SEQ,
            r["config"].vocab_size, args.max_predictions_per_seq,
            args.masked_token_fraction), args.accumulation_steps),
        args.device)
    loss = {label: float(step_of(x)(batch)["loss"])
            for label, x in (("memory", r), ("resumed", resumed))}
    diffs = {n: max((a.float() - b.float()).abs().max().item()
                    for a, b in zip(mine[n], theirs[n])) for n in mine}
    differ = sorted(n for n, d in diffs.items() if d != 0.0)
    shutil.rmtree(out)
    return {"resumed_state_bit_equal": all(before),
            "bit_equal": not differ and loss["memory"] == loss["resumed"],
            "loss": loss, "max_diff": max(diffs.values()),
            "tensors_differ": differ[:20], "n_tensors_differ": len(differ),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=str, default="",
                        help="also write the JSON line to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_determinism needs a CUDA card", file=sys.stderr)
        return 2
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    root = tempfile.mkdtemp(prefix="probe_determinism_")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            result = probe(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ops = sorted({str(w.message).split("\n")[0] for w in caught
                  if "deterministic" in str(w.message)})
    result = {"card": card_line(), "torch": torch.__version__,
              "cublas_workspace_config":
                  os.environ["CUBLAS_WORKSPACE_CONFIG"],
              "nondeterministic_ops": ops, **result}
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a", encoding="utf-8") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
