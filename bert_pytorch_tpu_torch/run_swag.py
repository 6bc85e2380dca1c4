"""SWAG multiple-choice finetuning on one GPU: the port of the JAX
package's ``run_swag.py``, with its flag names and defaults for what it
implements.

    python -m bert_pytorch_tpu_torch.run_swag --train_file train.csv \\
        --val_file val.csv --model_config_file <config.json> \\
        --init_checkpoint out/pretrain_ckpts/ckpt_8601.msgpack \\
        --output_dir swag/

The 4-way ``BertForMultipleChoice`` on SWAG-format CSVs (data/swag.py) in
the SWAG BERT recipe: AdamW without bias correction, weight decay 0.01 off
the no-decay groups, warmup-linear schedule, global-norm clipping to
``--clip_grad``, dropout from per-step seeds, the last partial batch
padded and masked (``finetune.batches``, the JAX runner's, which it
imports from its ``run_glue``); then the choice accuracy on
``--val_file``. Every ``--save_steps`` steps an async ``{"model"}``
checkpoint goes to ``--output_dir`` and at the end a synchronous one,
with ``eval_results_swag.json``. SIGTERM, SIGINT or SIGUSR1 stop at the
next step, save, skip the evaluation and exit with 75.

Telemetry (telemetry/, the JAX runner's flags; window 50, sync every 1):
step windows with CUDA-event device time and MFU (one example is 4
encoder passes, so 4 x a choice's FLOPs), allocator watermarks, grad
health, the loss sentinel, the heartbeat and ``--profile_steps`` traces
go to ``<output_dir>/swag_telemetry.jsonl`` (or ``--telemetry_jsonl``),
``<output_dir>/heartbeat.json`` and ``<output_dir>/profile``. No
TensorBoard files are written.

``--init_checkpoint`` reads the JAX package's msgpack checkpoints,
torch archives and TF checkpoints (a ``bert_model.ckpt`` prefix or its
directory; models/convert.py ``load_pretrained_encoder``). The
``--tokenizer`` (or the model config's ``tokenizer``) is ``wordpiece`` or
``bpe``, both on the C++ core. ``--device_prefetch`` (default 2) stages the
training batches on the card ahead of the step (data/device_prefetch.py).
``--compile_cache_dir`` names the directory the kernel libraries and the
tokenizer core are built into (ops/kernels/build.py ``set_build_dir``).
``train_step`` and ``eval_step`` emit their ``compile`` and
``compile_cost`` records (``--telemetry_cost_analysis``,
telemetry/memory.py). The telemetry debug planes (``--debug_port``, ``--postmortem_file``) are the
JAX runner's.

Runs on ``cuda`` unless ``--device cpu`` is given; asking for ``cuda``
where there is none raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from bert_pytorch_tpu_torch import finetune, telemetry
from bert_pytorch_tpu_torch.telemetry import memory as memory_util
from bert_pytorch_tpu_torch.data import device_prefetch as dp_cli
from bert_pytorch_tpu_torch.data import swag
from bert_pytorch_tpu_torch.models.bert import BertForMultipleChoice
from bert_pytorch_tpu_torch.ops.kernels import build
from bert_pytorch_tpu_torch.optim.schedules import warmup_linear_schedule
from bert_pytorch_tpu_torch.utils import checkpoint as ckpt
from bert_pytorch_tpu_torch.utils import flops as flops_util
from bert_pytorch_tpu_torch.utils import preemption

WEIGHT_DECAY = 0.01


def parse_arguments(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="BERT SWAG finetuning on one GPU (PyTorch / CUDA port)")
    parser.add_argument("--train_file", type=str, required=True)
    parser.add_argument("--val_file", type=str, default=None)
    parser.add_argument("--model_config_file", type=str, required=True)
    parser.add_argument("--init_checkpoint", type=str, default=None)
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--vocab_file", type=str, default=None)
    parser.add_argument("--uppercase", action="store_true")
    parser.add_argument("--tokenizer", type=str, default=None,
                        choices=["wordpiece", "bpe"])
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--lr", type=float, default=2e-5)
    parser.add_argument("--warmup_proportion", type=float, default=0.1)
    parser.add_argument("--clip_grad", type=float, default=1.0)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--max_seq_len", type=int, default=128)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=sorted(finetune.DTYPES))
    parser.add_argument("--save_steps", type=int, default=0,
                        help="async checkpoint every this many steps; the "
                             "final one is synchronous. 0 disables")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    dp_cli.add_cli_args(parser)
    telemetry.add_cli_args(parser, sync_every_default=1)
    build.add_cli_args(parser)
    return finetune.read_vocab_args(parser.parse_args(argv))


def loss_fn(model):
    """``loss(batch, valid, dropout_seeds)``: the choices' softmax CE
    averaged over the valid rows."""

    def loss(batch, valid, seeds):
        scores = model(batch["input_ids"], batch["segment_ids"],
                       batch["input_mask"], dropout_seeds=seeds)  # [B, C]
        per_ex = torch.nn.functional.cross_entropy(
            scores.float(), batch["labels"], reduction="none")
        weights = valid.float()
        return (per_ex * weights).sum() / weights.sum().clamp(min=1.0)

    return loss


def run(args):
    """(results, model, config): the whole run; ``main`` keeps the
    results."""
    build.set_build_dir(args.compile_cache_dir or None)
    device = finetune.setup_device(args.device)
    torch.manual_seed(args.seed)
    tokenizer = finetune.make_tokenizer(args)
    arrays = {"train": swag.convert_examples_to_arrays(
        swag.read_swag_examples(args.train_file), tokenizer,
        args.max_seq_len)}
    if args.val_file:
        arrays["val"] = swag.convert_examples_to_arrays(
            swag.read_swag_examples(args.val_file), tokenizer,
            args.max_seq_len)
    print("examples: " + " ".join(f"{k}={len(v['labels'])}"
                                  for k, v in arrays.items()), flush=True)
    config = finetune.load_config(args.model_config_file)
    model = finetune.init_model(
        BertForMultipleChoice(config, swag.NUM_CHOICES,
                              dtype=finetune.DTYPES[args.dtype],
                              device=device),
        config, args.seed, args.init_checkpoint)
    steps_per_epoch = max(
        1, -(-len(arrays["train"]["labels"]) // args.batch_size))
    total_steps = steps_per_epoch * args.epochs
    optimizer = finetune.adamw(
        model, warmup_linear_schedule(args.lr, args.warmup_proportion,
                                      total_steps), WEIGHT_DECAY)
    step = finetune.make_train_step(model, optimizer, loss_fn(model),
                                    args.clip_grad,
                                    torch.Generator().manual_seed(args.seed),
                                    telemetry.stats_every(args))
    tele = finetune.open_telemetry(
        args, "swag", device, args.batch_size,
        swag.NUM_CHOICES * flops_util.bert_finetune_flops_per_seq(
            config, args.max_seq_len, head_outputs=1, per_token_head=False,
            pooled=True))
    # Compile and cost attribution (JAX run_swag.py:187-189).
    step = tele.instrument(step, "train_step",
                           memory_util.training_state(model, optimizer))
    eval_step = tele.instrument(model, "eval_step")

    @torch.no_grad()
    def evaluate():
        correct = total = 0
        for batch, valid in finetune.batches(arrays["val"], args.batch_size,
                                             False,
                                             np.random.default_rng(0)):
            t = finetune.to_device(batch, device)
            scores = eval_step(t["input_ids"], t["segment_ids"],
                               t["input_mask"]).float().cpu().numpy()
            preds = scores.argmax(axis=-1)
            correct += int(((preds == batch["labels"]) & valid).sum())
            total += int(valid.sum())
        return correct / max(total, 1)

    rng = np.random.default_rng(args.seed)
    global_step, seen = 0, 0
    t0 = time.perf_counter()
    stop = preemption.GracefulStop().install()
    prefetcher = None
    try:
        for epoch in range(args.epochs):
            losses = []
            prefetcher = dp_cli.prefetch(
                finetune.batches(arrays["train"], args.batch_size, True,
                                 rng), device, args.device_prefetch,
                finetune.put_valid_batch)
            tele.attach_prefetcher(prefetcher)
            for batch, valid_t, valid in tele.timed(prefetcher):
                tele.profiler.maybe_start(global_step + 1)
                with tele.profiler.annotation(global_step + 1):
                    metrics = step(batch, valid_t)
                tele.dispatch_done()
                global_step += 1
                tele.step_done(global_step, metrics)
                losses.append(metrics["loss"])
                # valid is the host-side numpy padding mask (the prefetcher
                # stages only the batch and valid_t).
                seen += int(valid.sum())  # torchlint: disable=HS101
                if (args.save_steps and args.output_dir
                        and global_step % args.save_steps == 0):
                    with tele.checkpoint_stall():
                        finetune.save(args.output_dir, global_step, model,
                                      config, "multiple_choice",
                                      async_write=True)
                if stop.requested:
                    break
            if losses:
                print(f"epoch {epoch}: train_loss="
                      f"{float(torch.stack(losses).mean()):.4f}", flush=True)
            if stop.requested:
                print(f"termination signal ({stop.signal_name}) received; "
                      "checkpointing and exiting cleanly (exit code "
                      f"{preemption.EXIT_PREEMPTED})", flush=True)
                tele.emit(preemption.preemption_record(global_step, stop))
                break
        if device.type == "cuda":
            torch.cuda.synchronize()
        train_time = time.perf_counter() - t0
        tele.finish(global_step, summary={
            "training_seq_per_sec":
                round(seen / train_time, 2) if train_time else 0.0})
        results = {"e2e_train_time": train_time,
                   "training_sequences_per_second":
                       seen / train_time if train_time else 0,
                   "global_step": global_step,
                   "terminated_by_signal": stop.requested}
        if args.val_file and not stop.requested:
            results["accuracy"] = evaluate()
        print(json.dumps({"swag_summary": results}), flush=True)
        if args.output_dir:
            os.makedirs(args.output_dir, exist_ok=True)
            finetune.save(args.output_dir, global_step, model, config,
                          "multiple_choice", async_write=False)
            with open(os.path.join(args.output_dir,
                                   "eval_results_swag.json"), "w",
                      encoding="utf-8") as f:
                json.dump(results, f, indent=2)
        ckpt.wait_for_pending_save()
    finally:
        if prefetcher is not None:
            prefetcher.close()
        stop.restore()
        tele.close()
    return results, model, config


def main(args) -> dict:
    return run(args)[0]


if __name__ == "__main__":
    outcome = main(parse_arguments())
    if outcome.get("terminated_by_signal"):
        sys.exit(preemption.EXIT_PREEMPTED)
