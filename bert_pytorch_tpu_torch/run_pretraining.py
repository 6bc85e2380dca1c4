"""BERT MLM+NSP pretraining on one GPU: the port of the JAX package's
``run_pretraining.py``, with its flag names for what it implements.

    python -m bert_pytorch_tpu_torch.run_pretraining \\
        --config_file configs/bert_pretraining_phase2_config.json \\
        --model_config_file configs/bert_large_uncased_config.json \\
        --input_dir <dir of HDF5 shards> --steps 10 --skip_final_checkpoint

A run streams the HDF5 shards (data/dataset.py; dynamic masking, optional
``--pack_sequences``), stacks each global batch into ``accumulation_steps
= global_batch_size / local_batch_size`` microbatches, and takes optimizer
steps with pretrain.make_train_step (LAMB or AdamW with a warmup schedule,
bf16 or fp32, ``--remat``, the ``flash`` attention kernels). Every
``--log_steps`` it prints the loss, learning rate and sequences per
second.

Not ported yet, so rejected rather than ignored: checkpoints (this runner
writes none, and raises at startup unless ``--skip_final_checkpoint`` is
given and the run ends before ``--num_steps_per_checkpoint``; ROADMAP.md
queue 1 "Checkpointing"), meshes and multi-GPU, K-FAC, fp16 loss scaling,
held-out evaluation, process-based loader workers, the telemetry planes
and the metrics files of ``--output_dir``; argparse refuses their flags.
On-the-fly packing packs up to 8 sequences per row (the JAX runner's
``--max_sequences_per_pack`` default), and LAMB clips to a global norm of
1.0 (its ``--max_grad_norm`` default). ``attention_backend "pallas"`` in a
config file (the JAX recipe's phase-2 setting) selects its counterpart,
``flash``. ``--layer_norm_backend kernel`` (or its JAX name ``pallas``)
runs every LayerNorm through the hand-written forward kernel; the default
``plain`` (JAX ``xla``) is the JAX runner's.

Runs on ``cuda`` unless ``--device cpu`` is given; asking for ``cuda``
where there is none raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from bert_pytorch_tpu_torch import pretrain
from bert_pytorch_tpu_torch.config import (BertConfig,
                                           parse_args_with_config_file,
                                           require_args)
from bert_pytorch_tpu_torch.data.dataset import (ShardedPretrainingDataset,
                                                 input_files)
from bert_pytorch_tpu_torch.data.loader import DataLoader
from bert_pytorch_tpu_torch.data.sampler import DistributedSampler
from bert_pytorch_tpu_torch.data.tokenization import load_vocab
from bert_pytorch_tpu_torch.models.bert import BertForPreTraining, init_weights
from bert_pytorch_tpu_torch.ops.layernorm import resolve_backend
from bert_pytorch_tpu_torch.optim.schedules import SCHEDULES, make_schedule
from bert_pytorch_tpu_torch.optim.transforms import AdamW, Lamb, param_groups

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# The JAX recipe's phase-2 config file names the fused kernels "pallas".
BACKEND_ALIASES = {"pallas": "flash"}
MAX_SEQUENCES_PER_PACK = 8
CHECKPOINT_ITEM = ("ROADMAP.md, queue 1 of the modules still to port: "
                   "\"Checkpointing (utils/checkpoint.py)\"")


def parse_arguments(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="BERT pretraining on one GPU (PyTorch / CUDA port)")
    # data / io
    parser.add_argument("--input_dir", type=str, default=None,
                        help="HDF5 shard file or directory of *.hdf5")
    parser.add_argument("--model_config_file", type=str, default=None)
    parser.add_argument("--config_file", type=str, default=None,
                        help="JSON overriding defaults; CLI overrides JSON")
    # schedule / steps
    parser.add_argument("--max_steps", type=int, default=None,
                        help="total optimizer steps of the phase (t_total)")
    parser.add_argument("--steps", type=int, default=None,
                        help="optimizer steps to run in this invocation")
    parser.add_argument("--previous_phase_end_step", type=int, default=0,
                        help="the phase's step offset on resume; with no "
                             "checkpoint to resume from it changes nothing, "
                             "as in the JAX runner")
    parser.add_argument("--learning_rate", type=float, default=6e-3)
    parser.add_argument("--lr_decay", type=str, default="poly",
                        choices=sorted(SCHEDULES))
    parser.add_argument("--warmup_proportion", type=float, default=0.2843)
    # batch
    parser.add_argument("--global_batch_size", type=int, default=None)
    parser.add_argument("--local_batch_size", type=int, default=None)
    # masking / packing
    parser.add_argument("--max_predictions_per_seq", type=int, default=20)
    parser.add_argument("--masked_token_fraction", type=float, default=0.15)
    parser.add_argument("--pack_sequences", action="store_true",
                        help="pack short samples into full rows on the fly "
                             "(data/packing.py, within each shard); "
                             "offline-packed shards are detected without it")
    # checkpoints (not written by this runner yet)
    parser.add_argument("--num_steps_per_checkpoint", type=int, default=200)
    parser.add_argument("--skip_final_checkpoint", action="store_true")
    parser.add_argument("--log_steps", type=int, default=1)
    # numerics / memory
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=sorted(DTYPES))
    parser.add_argument("--remat", type=str, default="none",
                        choices=["none", "dots", "full"])
    parser.add_argument("--attention_backend", type=str, default="auto",
                        choices=["auto", "dense", "flash"],
                        help="'auto': the flash kernels at seq >= 256 on a "
                             "CUDA device, dense otherwise")
    parser.add_argument("--layer_norm_backend", type=str, default="plain",
                        help="plain (the JAX 'xla'; default) or kernel "
                             "(the JAX 'pallas'): the LayerNorm forward "
                             "kernel")
    # optimizer
    parser.add_argument("--optimizer", type=str, default="lamb",
                        choices=["lamb", "adamw"])
    parser.add_argument("--weight_decay", type=float, default=0.01)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parse_args_with_config_file(parser, argv)


def log(record: dict) -> None:
    print(" ".join(f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                   for k, v in record.items()), flush=True)


def setup_training(args) -> argparse.Namespace:
    """Device, numerics, accumulation math and the checkpoint rule; the
    batches are unpacked until prepare_dataset finds packed data."""
    require_args(args, ["model_config_file", "global_batch_size",
                        "local_batch_size", "max_steps"])
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda but torch.cuda.is_available() is False; pass "
            "--device cpu to run on the CPU")
    args.device = device
    args.attention_backend = BACKEND_ALIASES.get(args.attention_backend,
                                                 args.attention_backend)
    if args.attention_backend not in ("auto", "dense", "flash"):
        raise ValueError(
            f"attention_backend {args.attention_backend!r} is not one of "
            "auto, dense, flash")
    args.layer_norm_backend = resolve_backend(args.layer_norm_backend)
    if args.dtype not in DTYPES:
        raise ValueError(f"dtype {args.dtype!r} is not one of {sorted(DTYPES)}")
    if args.global_batch_size % args.local_batch_size:
        raise ValueError(
            f"global_batch_size={args.global_batch_size} must be divisible "
            f"by local_batch_size={args.local_batch_size}")
    args.accumulation_steps = args.global_batch_size // args.local_batch_size
    args.packed, args.pack_k = False, 1
    args.steps = args.max_steps if args.steps is None else args.steps
    if not args.skip_final_checkpoint or (
            args.steps >= args.num_steps_per_checkpoint):
        raise ValueError(
            "this runner writes no checkpoint yet "
            f"({CHECKPOINT_ITEM}); pass --skip_final_checkpoint and run "
            f"fewer --steps ({args.steps}) than --num_steps_per_checkpoint "
            f"({args.num_steps_per_checkpoint})")
    if device.type == "cuda":
        # fp32 products in full fp32, as the JAX package's parity tests.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(args.seed)
    return args


def prepare_model(args):
    """(model with seeded random weights, config); vocab padded to a
    multiple of 8 as the reference does (run_pretraining.py:237)."""
    config = BertConfig.from_json_file(args.model_config_file)
    if config.vocab_size % 8 != 0:
        config.vocab_size += 8 - (config.vocab_size % 8)
    model = BertForPreTraining(
        config, dtype=DTYPES[args.dtype],
        attention_backend=args.attention_backend, remat=args.remat,
        device=args.device, layer_norm_backend=args.layer_norm_backend)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    init_weights(model, config.initializer_range, gen)
    return model, config


def prepare_optimizer(args, model):
    """(LAMB or AdamW over the no-decay param groups, schedule)."""
    schedule = make_schedule(args.lr_decay, args.learning_rate,
                             args.warmup_proportion, args.max_steps)
    groups = param_groups(model, args.weight_decay)
    if args.optimizer == "lamb":
        optimizer = Lamb(groups, schedule, weight_decay=args.weight_decay)
    else:
        optimizer = AdamW(groups, schedule, weight_decay=args.weight_decay)
    return optimizer, schedule


def mask_token_id(config) -> int:
    """``mask_token_id`` of the model config, else ``[MASK]``/``<mask>`` of
    its ``vocab_file``, else 4 (the synthetic-data default)."""
    found = getattr(config, "mask_token_id", None)
    vocab_file = getattr(config, "vocab_file", None)
    if found is None and vocab_file and os.path.exists(vocab_file):
        vocab = load_vocab(vocab_file)
        found = vocab.get("[MASK]", vocab.get("<mask>"))
    return 4 if found is None else int(found)


def prepare_dataset(args, config):
    """(loader of global batches, sampler); sets ``args.packed`` and
    ``args.pack_k`` (sequences per row) from the data."""
    require_args(args, ["input_dir"])
    dataset = ShardedPretrainingDataset(
        input_files(args.input_dir), mask_token_id(config),
        args.max_predictions_per_seq, args.masked_token_fraction,
        vocab_size=int(config.vocab_size), seed=args.seed)
    args.packed = bool(dataset.packed)
    args.pack_k = dataset.max_sequences_per_pack if dataset.packed else 1
    if not dataset.packed and args.pack_sequences:
        from bert_pytorch_tpu_torch.data.packing import (
            PackedPretrainingDataset)

        dataset = PackedPretrainingDataset(
            dataset, max_sequences_per_pack=MAX_SEQUENCES_PER_PACK)
        args.packed = True
        args.pack_k = MAX_SEQUENCES_PER_PACK
    sampler = DistributedSampler(dataset)
    loader = DataLoader(dataset, sampler, batch_size=args.global_batch_size,
                        drop_last=True)
    if len(loader) == 0:
        raise ValueError(
            f"{len(dataset)} samples do not fill one global batch of "
            f"{args.global_batch_size}")
    return loader, sampler


def make_step(args, model, optimizer, schedule, config):
    """The train step for this run: the per-row MLM gather cap is
    ``max_predictions_per_seq`` per packed sequence."""
    return pretrain.make_train_step(
        model, optimizer, schedule, next_sentence=config.next_sentence,
        max_pred_per_seq=args.max_predictions_per_seq * args.pack_k,
        generator=torch.Generator().manual_seed(args.seed))


def main(args) -> dict:
    args = setup_training(args)
    model, config = prepare_model(args)
    optimizer, schedule = prepare_optimizer(args, model)
    loader, sampler = prepare_dataset(args, config)
    step = make_step(args, model, optimizer, schedule, config)
    log({"event": "start", "device": str(args.device),
               "dtype": args.dtype, "attention_backend":
               args.attention_backend, "remat": args.remat,
               "layer_norm_backend": args.layer_norm_backend,
               "accumulation_steps": args.accumulation_steps,
               "samples": len(loader.dataset), "packed": int(args.packed)})
    global_step, epoch = 0, 0
    last = {}
    window_t0, window_steps = time.perf_counter(), 0
    while global_step < args.steps:
        sampler.set_epoch(epoch)
        for host_batch in loader:
            batch = pretrain.to_device(
                pretrain.stack_microbatches(host_batch,
                                            args.accumulation_steps),
                args.device)
            metrics = step(batch)
            global_step += 1
            window_steps += 1
            if global_step % args.log_steps == 0 or global_step == args.steps:
                values = {k: float(v) for k, v in metrics.items()}
                elapsed = time.perf_counter() - window_t0
                last = dict(step=global_step, **values,
                            seq_per_s=window_steps * args.global_batch_size
                            / elapsed)
                log(last)
                window_t0, window_steps = time.perf_counter(), 0
            if global_step >= args.steps:
                break
        epoch += 1
    return last


if __name__ == "__main__":
    summary = main(parse_arguments())
    sys.exit(0 if summary.get("finite", 0.0) == 1.0 else 1)
