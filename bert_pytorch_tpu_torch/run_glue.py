"""GLUE finetuning on one GPU: the port of the JAX package's
``run_glue.py``, with its flag names and defaults for what it implements.

    python -m bert_pytorch_tpu_torch.run_glue --task mrpc \\
        --data_dir <glue/MRPC> --model_config_file <config.json> \\
        --init_checkpoint out/pretrain_ckpts/ckpt_8601.msgpack \\
        --output_dir glue/

``BertForSequenceClassification`` (``num_labels == 1`` and a squared-error
loss for the STS-B regression) finetunes in the classic BERT GLUE recipe:
AdamW without bias correction, weight decay 0.01 off the no-decay groups,
warmup-linear schedule, global-norm clipping to ``--clip_grad``, dropout
from per-step seeds; the last partial batch is padded and masked. Then the
dev set's GLUE metric (data/glue.py ``compute_metrics``). Every
``--save_steps`` steps an async ``{"model"}`` checkpoint goes to
``--output_dir`` and at the end a synchronous one, with
``eval_results_<task>.json`` (the JAX package's layout: its server and
``load_params_only`` read it; ``run_server --classify_checkpoint``
serves it). SIGTERM, SIGINT or SIGUSR1 stop at the next step, save, skip
the evaluation and exit with 75.

Telemetry (telemetry/, the JAX runner's flags; window 50, sync every 1):
step windows with CUDA-event device time and MFU, allocator watermarks,
grad health, the loss sentinel, the heartbeat and ``--profile_steps``
traces go to ``<output_dir>/glue_telemetry.jsonl`` (or
``--telemetry_jsonl``), ``<output_dir>/heartbeat.json`` and
``<output_dir>/profile``. No TensorBoard files are written.

``--init_checkpoint`` reads the JAX package's msgpack checkpoints (a
pretraining run's ``ckpt_N.msgpack``), torch archives and TF checkpoints
(a ``bert_model.ckpt`` prefix or its directory; models/convert.py
``load_pretrained_encoder``). The
``--tokenizer`` (or the model config's ``tokenizer``) is ``wordpiece`` or
``bpe``, both on the C++ core. ``--device_prefetch``
(default 2) stages the training batches on the card ahead of the step
(data/device_prefetch.py). ``--compile_cache_dir`` names the directory
the kernel libraries and the tokenizer core are built into
(ops/kernels/build.py ``set_build_dir``). ``train_step`` and
``eval_step`` emit their ``compile`` and ``compile_cost`` records
(``--telemetry_cost_analysis``, telemetry/memory.py). The
telemetry debug planes (``--debug_port``, ``--postmortem_file``) are the
JAX runner's. Attention is dense
(the JAX runner's ``xla``), LayerNorm plain.

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
from bert_pytorch_tpu_torch.data import glue
from bert_pytorch_tpu_torch.models.bert import BertForSequenceClassification
from bert_pytorch_tpu_torch.models.losses import _xent_ignore
from bert_pytorch_tpu_torch.ops.kernels import build
from bert_pytorch_tpu_torch.optim.schedules import warmup_linear_schedule
from bert_pytorch_tpu_torch.utils import checkpoint as ckpt
from bert_pytorch_tpu_torch.utils import flops as flops_util
from bert_pytorch_tpu_torch.utils import preemption

WEIGHT_DECAY = 0.01


def parse_arguments(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="BERT GLUE finetuning on one GPU (PyTorch / CUDA port)")
    parser.add_argument("--task", type=str, required=True,
                        choices=sorted(glue.PROCESSORS))
    parser.add_argument("--data_dir", type=str, required=True,
                        help="Directory holding the task's train/dev TSVs")
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
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--max_seq_len", type=int, default=128)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=sorted(finetune.DTYPES))
    parser.add_argument("--skip_eval", action="store_true")
    parser.add_argument("--save_steps", type=int, default=0,
                        help="async checkpoint every this many steps; the "
                             "final one is synchronous. 0 disables")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    dp_cli.add_cli_args(parser)
    telemetry.add_cli_args(parser, sync_every_default=1)
    build.add_cli_args(parser)
    return finetune.read_vocab_args(parser.parse_args(argv))


def loss_fn(model, regression: bool):
    """``loss(batch, valid, dropout_seeds)``: mean CE over the valid rows,
    or their mean squared error for regression."""

    def loss(batch, valid, seeds):
        logits = model(batch["input_ids"], batch["segment_ids"],
                       batch["input_mask"], dropout_seeds=seeds)
        weights = valid.float()
        if regression:
            err = (logits.squeeze(-1).float() - batch["labels"]) ** 2
            return (err * weights).sum() / weights.sum().clamp(min=1.0)
        return _xent_ignore(logits.float(), torch.where(
            valid, batch["labels"], torch.full_like(batch["labels"], -1)),
            -1)

    return loss


def run(args):
    """(results, model, config): the whole run; ``main`` keeps the
    results."""
    build.set_build_dir(args.compile_cache_dir or None)
    device = finetune.setup_device(args.device)
    torch.manual_seed(args.seed)
    processor = glue.PROCESSORS[args.task]()
    regression = processor.regression
    num_labels = 1 if regression else len(processor.labels)
    tokenizer = finetune.make_tokenizer(args)
    splits = {"train": processor.get_train_examples(args.data_dir)}
    if not args.skip_eval:
        splits["dev"] = processor.get_dev_examples(args.data_dir)
    arrays = {
        name: glue.features_to_arrays(
            glue.convert_examples_to_features(
                examples, tokenizer, args.max_seq_len, processor.labels,
                regression), regression)
        for name, examples in splits.items()}
    print(f"task={args.task} train={len(arrays['train']['labels'])} "
          + (f"dev={len(arrays['dev']['labels'])}" if "dev" in arrays
             else ""), flush=True)

    config = finetune.load_config(args.model_config_file)
    model = finetune.init_model(
        BertForSequenceClassification(
            config, num_labels, dtype=finetune.DTYPES[args.dtype],
            device=device),
        config, args.seed, args.init_checkpoint)
    steps_per_epoch = max(
        1, -(-len(arrays["train"]["labels"]) // args.batch_size))
    total_steps = steps_per_epoch * args.epochs
    optimizer = finetune.adamw(
        model, warmup_linear_schedule(args.lr, args.warmup_proportion,
                                      total_steps), WEIGHT_DECAY)
    step = finetune.make_train_step(
        model, optimizer, loss_fn(model, regression), args.clip_grad,
        torch.Generator().manual_seed(args.seed),
        telemetry.stats_every(args))
    tele = finetune.open_telemetry(
        args, "glue", device, args.batch_size,
        flops_util.bert_finetune_flops_per_seq(
            config, args.max_seq_len, head_outputs=num_labels,
            per_token_head=False, pooled=True))
    # Compile and cost attribution (JAX run_glue.py:222-231).
    step = tele.instrument(step, "train_step",
                           memory_util.training_state(model, optimizer))
    eval_step = tele.instrument(model, "eval_step")

    @torch.no_grad()
    def evaluate():
        preds, labels = [], []
        for batch, valid in finetune.batches(arrays["dev"], args.batch_size,
                                             False,
                                             np.random.default_rng(0)):
            t = finetune.to_device(batch, device)
            logits = eval_step(t["input_ids"], t["segment_ids"],
                               t["input_mask"]).float().cpu().numpy()
            out = (logits.squeeze(-1) if regression
                   else logits.argmax(axis=-1))
            preds.append(out[valid])
            labels.append(batch["labels"][valid])
        return glue.compute_metrics(args.task, np.concatenate(preds),
                                    np.concatenate(labels))

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
                                      config, "classify", async_write=True)
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
        if not args.skip_eval and not stop.requested:
            results.update(evaluate())
        print(json.dumps({"glue_summary": {"task": args.task, **results}}),
              flush=True)
        if args.output_dir:
            os.makedirs(args.output_dir, exist_ok=True)
            # Numbered with the step reached; synchronous, joining a
            # pending write to the directory first.
            finetune.save(args.output_dir, global_step, model, config,
                          "classify", async_write=False)
            with open(os.path.join(args.output_dir,
                                   f"eval_results_{args.task}.json"),
                      "w", encoding="utf-8") as f:
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
