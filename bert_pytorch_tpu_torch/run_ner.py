"""NER finetuning on one GPU: the port of the JAX package's ``run_ner.py``,
with its flag names and defaults for what it implements.

    python -m bert_pytorch_tpu_torch.run_ner --train_file train.txt \\
        --val_file dev.txt --test_file test.txt --labels O B-PER I-PER \\
        --model_config_file <config.json> \\
        --model_checkpoint out/pretrain_ckpts/ckpt_8601.msgpack \\
        --output_dir ner/

CoNLL-style data (data/ner_dataset.py), ``BertForTokenClassification``
with ``len(labels) + 1`` classes (id 0 reserved), AdamW without bias
correction or weight decay at ``lr / (1 + 0.05 * epoch)``, global-norm
clipping to ``--clip_grad``, dropout from per-step seeds, incomplete
batches dropped; after each epoch the validation loss and macro-F1 over
the non-special tokens (:func:`macro_f1`), at the end the test split's.
Every ``--save_steps`` steps an async ``{"model"}`` checkpoint goes to
``--output_dir`` and at the end a synchronous one (the JAX package's
layout; ``run_server --ner_checkpoint`` serves it). SIGTERM, SIGINT or
SIGUSR1 stop at the next step, save, skip the test and exit with 75.

Telemetry (telemetry/, the JAX runner's flags; window 50, sync every 1):
step windows with CUDA-event device time and MFU, allocator watermarks,
grad health, the loss sentinel and ``--profile_steps`` traces go to the
JSONL of ``--telemetry_jsonl``, else ``<output_dir>/ner_telemetry.jsonl``
when there is an output dir, else nowhere; the heartbeat to
``<output_dir>/heartbeat.json`` (or ``--heartbeat_file``). No TensorBoard
files are written.

``--model_checkpoint`` reads the JAX package's msgpack checkpoints,
torch archives and TF checkpoints (a ``bert_model.ckpt`` prefix or its
directory; models/convert.py ``load_pretrained_encoder``). The
``--tokenizer`` (or the model config's ``tokenizer``) is ``wordpiece`` or
``bpe``, both on the C++ core. ``--device_prefetch`` (default 2) stages the
training batches on the card ahead of the step (data/device_prefetch.py).
Not ported, so argparse refuses their flags: ``--compile_cache_dir`` and
``--telemetry_cost_analysis``. The
telemetry debug planes (``--debug_port``, ``--postmortem_file``) are the
JAX runner's.

Runs on ``cuda`` unless ``--device cpu`` is given; asking for ``cuda``
where there is none raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from bert_pytorch_tpu_torch import finetune, telemetry
from bert_pytorch_tpu_torch.data import device_prefetch as dp_cli
from bert_pytorch_tpu_torch.data.ner_dataset import NERDataset
from bert_pytorch_tpu_torch.models.bert import BertForTokenClassification
from bert_pytorch_tpu_torch.models.losses import token_classification_loss
from bert_pytorch_tpu_torch.utils import checkpoint as ckpt
from bert_pytorch_tpu_torch.utils import flops as flops_util
from bert_pytorch_tpu_torch.utils import preemption


def parse_arguments(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="BERT NER finetuning on one GPU (PyTorch / CUDA port)")
    parser.add_argument("--train_file", type=str, required=True)
    parser.add_argument("--val_file", type=str, default=None)
    parser.add_argument("--test_file", type=str, default=None)
    parser.add_argument("--labels", type=str, nargs="+", required=True)
    parser.add_argument("--model_config_file", type=str, required=True)
    parser.add_argument("--model_checkpoint", type=str, default=None)
    parser.add_argument("--vocab_file", type=str, default=None)
    parser.add_argument("--uppercase", action="store_true")
    parser.add_argument("--tokenizer", type=str, default=None,
                        choices=["wordpiece", "bpe"])
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--lr", type=float, default=5e-6)
    parser.add_argument("--clip_grad", type=float, default=5.0)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--max_seq_len", type=int, default=128)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--output_dir", type=str, default=None,
                        help="where the finetuned model checkpoint lands "
                             "(end of run, and on graceful preemption)")
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=sorted(finetune.DTYPES))
    parser.add_argument("--save_steps", type=int, default=0,
                        help="async checkpoint every this many steps; the "
                             "final one is synchronous. 0 disables")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    dp_cli.add_cli_args(parser)
    telemetry.add_cli_args(parser, sync_every_default=1)
    return finetune.read_vocab_args(parser.parse_args(argv),
                                    "model_checkpoint")


def macro_f1(predictions: np.ndarray, labels: np.ndarray) -> float:
    """Macro-F1 over non-special positions (labels > 0) of [N, S, C]
    logits against [N, S] labels: the JAX runner's numpy version of the
    reference's sklearn call (run_ner.py:127-142)."""
    preds = predictions.argmax(axis=-1)
    keep = labels > 0
    y_true = labels[keep]
    y_pred = preds[keep]
    f1s = []
    for c in np.unique(y_true):
        tp = np.sum((y_pred == c) & (y_true == c))
        fp = np.sum((y_pred == c) & (y_true != c))
        fn = np.sum((y_pred != c) & (y_true == c))
        precision = tp / (tp + fp) if tp + fp else 0.0
        recall = tp / (tp + fn) if tp + fn else 0.0
        f1s.append(2 * precision * recall / (precision + recall)
                   if precision + recall else 0.0)
    return float(np.mean(f1s)) if f1s else 0.0


def batches(dataset, batch_size: int, shuffle: bool, rng):
    """Full batches (seqs, labels, masks) of the dataset; the last
    incomplete one is dropped (the JAX runner's)."""
    order = (rng.permutation(len(dataset)) if shuffle
             else np.arange(len(dataset)))
    for i in range(0, len(order) - batch_size + 1, batch_size):
        seqs, labels, masks = zip(*(dataset[j]
                                    for j in order[i:i + batch_size]))
        yield np.stack(seqs), np.stack(labels), np.stack(masks)


def loss_fn(model):
    def loss(seqs, labels, masks, seeds):
        logits = model(seqs, None, masks, dropout_seeds=seeds)
        return token_classification_loss(logits, labels)

    return loss


def run(args):
    """(results, model, config): the whole run; ``main`` keeps the
    results."""
    device = finetune.setup_device(args.device)
    torch.manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    tokenizer = finetune.make_tokenizer(args)
    datasets = {"train": NERDataset(args.train_file, tokenizer, args.labels,
                                    args.max_seq_len)}
    for split, path in (("val", args.val_file), ("test", args.test_file)):
        if path:
            datasets[split] = NERDataset(path, tokenizer, args.labels,
                                         args.max_seq_len)
    config = finetune.load_config(args.model_config_file)
    model = finetune.init_model(
        BertForTokenClassification(
            config, len(args.labels) + 1,
            dtype=finetune.DTYPES[args.dtype], device=device),
        config, args.seed, args.model_checkpoint)
    # The lr is set per epoch (reference run_ner.py:243-245).
    optimizer = finetune.adamw(model, args.lr, 0.0)
    step = finetune.make_train_step(model, optimizer, loss_fn(model),
                                    args.clip_grad,
                                    torch.Generator().manual_seed(args.seed),
                                    telemetry.stats_every(args))
    tele = finetune.open_telemetry(
        args, "ner", device, args.batch_size,
        flops_util.bert_finetune_flops_per_seq(
            config, args.max_seq_len, head_outputs=len(args.labels) + 1))

    def tensors(arrays):
        return [torch.from_numpy(a).to(device, torch.int64) for a in arrays]

    @torch.no_grad()
    def evaluate(split):
        all_logits, all_labels, losses = [], [], []
        for seqs, labels, masks in batches(datasets[split], args.batch_size,
                                           False, rng):
            t_seqs, t_labels, t_masks = tensors((seqs, labels, masks))
            logits = model(t_seqs, None, t_masks).float()
            losses.append(float(token_classification_loss(logits,
                                                          t_labels)))
            all_logits.append(logits.cpu().numpy())
            all_labels.append(labels)
        if not all_logits:
            return 0.0, 0.0
        return float(np.mean(losses)), macro_f1(
            np.concatenate(all_logits), np.concatenate(all_labels))

    results = {}
    global_step, seen, train_time = 0, 0, 0.0
    stop = preemption.GracefulStop().install()
    prefetcher = None
    try:
        for epoch in range(args.epochs):
            t0 = time.perf_counter()
            lr = args.lr / (1.0 + 0.05 * epoch)
            optimizer.schedule = lambda count, lr=lr: lr
            losses = []
            prefetcher = dp_cli.prefetch(
                batches(datasets["train"], args.batch_size, True, rng),
                device, args.device_prefetch,
                lambda arrays, put: [put(a) for a in arrays])
            tele.attach_prefetcher(prefetcher)
            for staged in tele.timed(prefetcher):
                tele.profiler.maybe_start(global_step + 1)
                with tele.profiler.annotation(global_step + 1):
                    metrics = step(*staged)
                tele.dispatch_done()
                global_step += 1
                tele.step_done(global_step, metrics)
                losses.append(metrics["loss"])
                seen += args.batch_size
                if (args.save_steps and args.output_dir
                        and global_step % args.save_steps == 0):
                    with tele.checkpoint_stall():
                        finetune.save(args.output_dir, global_step, model,
                                      config, "ner", async_write=True)
                if stop.requested:
                    break
            if device.type == "cuda":
                torch.cuda.synchronize()
            train_time += time.perf_counter() - t0
            if stop.requested:
                print(f"termination signal ({stop.signal_name}) received; "
                      "checkpointing and exiting cleanly (exit code "
                      f"{preemption.EXIT_PREEMPTED})", flush=True)
                tele.emit(preemption.preemption_record(global_step, stop))
                break
            mean = (float(torch.stack(losses).mean()) if losses
                    else float("nan"))
            msg = (f"epoch {epoch}: train_loss={mean:.4f} "
                   f"({time.perf_counter() - t0:.1f}s)")
            if "val" in datasets:
                val_loss, val_f1 = evaluate("val")
                results["val_f1"] = val_f1
                msg += f" val_loss={val_loss:.4f} val_f1={val_f1:.4f}"
            print(msg, flush=True)
        results.update(training_sequences_per_second=(
                           seen / train_time if train_time else 0.0),
                       global_step=global_step,
                       terminated_by_signal=stop.requested)
        tele.finish(global_step, summary={"training_seq_per_sec": round(
            results["training_sequences_per_second"], 2)})
        if "test" in datasets and not stop.requested:
            test_loss, test_f1 = evaluate("test")
            results["test_f1"] = test_f1
            print(f"test_loss={test_loss:.4f} test_f1={test_f1:.4f}",
                  flush=True)
        if args.output_dir:
            os.makedirs(args.output_dir, exist_ok=True)
            finetune.save(args.output_dir, global_step, model, config, "ner",
                          async_write=False)
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
