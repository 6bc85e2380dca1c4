"""What the runner telemetry's defaults cost a finetuning run, on the card.

    python -m bert_pytorch_tpu_torch.tools.profile_finetune \\
        [--order on,off,sync,sync,off,on] [--steps 9]

Runs ``run_glue`` (MRPC at scripts/run_glue.sh's recipe: S=128, batch 32)
and ``run_squad`` (scripts/run_squad.sh's: S=384, doc stride 128, batch
32, AdamW, every LayerNorm through the kernel) through their own ``run``
at BERT-large width (configs/bert_large_uncased_config.json, seeded
random weights, bf16, seeded synthetic files, no checkpoints, no
evaluation), ``--steps`` optimizer steps each, after one untimed run
(``off``: it builds kernel #6 and warms the libraries), in the turns of
``--order``:

* ``on`` — the finetune runners' telemetry defaults: a device sync on
  every step (``--telemetry_sync_every 1``) and the grad-health block on
  every step (``--grad_stats_every -1`` follows the sync);
* ``sync`` — the sync on every step alone (``--grad_stats_every 0``);
* ``off`` — ``--telemetry_sync_every 0 --grad_stats_every 0``.

Every setting writes the JSONL (``--telemetry_jsonl``), so only these
flags differ. It prints one JSON line per runner: each turn's
``training_sequences_per_second`` (the runner's own figure: sequences
over the loop's host-clock time, which ends in a synchronize) and the
median per setting. Turns alternate in one process on one card, so the
settings are compared under the same clocks and neighbours. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "configs", "bert_large_uncased_config.json")
SETTINGS = {"on": [], "sync": ["--grad_stats_every", "0"],
            "off": ["--telemetry_sync_every", "0", "--grad_stats_every", "0"]}
GLUE_BATCH, SQUAD_BATCH = 32, 32


def glue_argv(tmp: str, vocab: str, steps: int) -> list:
    """run_glue's arguments: one epoch of synthetic MRPC is 3 steps."""
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
        write_mrpc_tsvs)

    data = write_mrpc_tsvs(os.path.join(tmp, "MRPC"), 21, 3 * GLUE_BATCH,
                           GLUE_BATCH)
    return ["--task", "mrpc", "--data_dir", data, "--model_config_file",
            CONFIG, "--vocab_file", vocab, "--device", "cuda", "--dtype",
            "bfloat16", "--max_seq_len", "128", "--batch_size",
            str(GLUE_BATCH), "--epochs", str(-(-steps // 3)), "--skip_eval"]


def squad_argv(tmp: str, vocab: str, steps: int) -> list:
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
        write_squad_json)

    train = write_squad_json(os.path.join(tmp, "squad_train.json"), 11, 8)
    return ["--config_file", CONFIG, "--vocab_file", vocab,
            "--do_lower_case", "--train_file", train, "--do_train",
            "--output_dir", os.path.join(tmp, "squad_out"),
            "--skip_checkpoint", "--skip_cache", "--max_seq_length", "384",
            "--doc_stride", "128", "--train_batch_size", str(SQUAD_BATCH),
            "--max_steps", str(steps), "--dtype", "bfloat16",
            "--layer_norm_backend", "kernel", "--device", "cuda", "--seed",
            "0", "--log_freq", str(steps)]


def turns(name: str, parse, run, argv: list, order: list,
          tmp: str) -> dict:
    """Each turn's seq/s and steps, and the median seq/s per setting,
    after one untimed ``off`` run."""
    seq_per_s = {setting: [] for setting in SETTINGS}
    steps = []
    for i, setting in enumerate(["off"] + order):
        jsonl = os.path.join(tmp, f"{name}_{i}.jsonl")
        results, model, _ = run(parse(argv + SETTINGS[setting] + [
            "--telemetry_jsonl", jsonl]))
        if i:
            seq_per_s[setting].append(
                results["training_sequences_per_second"])
            steps.append(results["global_step"])
        del model
        torch.cuda.empty_cache()
    return {"runner": name, "order": order, "steps": steps,
            "seq_per_s": seq_per_s,
            "median_seq_per_s": {k: statistics.median(v)
                                 for k, v in seq_per_s.items() if v}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--order", default="on,off,sync,sync,off,on",
                        help="comma-separated settings (on, sync, off), "
                             "run in this order for each runner")
    parser.add_argument("--steps", type=int, default=9,
                        help="optimizer steps per run (GLUE rounds up to "
                             "whole epochs of 3)")
    args = parser.parse_args(argv)
    order = args.order.split(",")
    if set(order) - set(SETTINGS):
        parser.error(f"--order takes {sorted(SETTINGS)}, got {order}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_finetune needs a CUDA card")
    from bert_pytorch_tpu_torch import run_glue, run_squad
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
        write_trace_vocab)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        vocab = write_trace_vocab(os.path.join(tmp, "vocab.txt"))
        print(json.dumps(turns(
            "glue", run_glue.parse_arguments, run_glue.run,
            glue_argv(tmp, vocab, args.steps), order, tmp)), flush=True)
        print(json.dumps(turns(
            "squad", run_squad.parse_args, run_squad.run,
            squad_argv(tmp, vocab, args.steps), order, tmp)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
