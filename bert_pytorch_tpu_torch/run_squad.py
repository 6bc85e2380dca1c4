"""SQuAD v1.1/v2.0 finetuning and prediction on one GPU: the port of the
JAX package's ``run_squad.py``, with its flag names for what it
implements.

    python -m bert_pytorch_tpu_torch.run_squad \\
        --config_file configs/bert_large_uncased_config.json \\
        --vocab_file vocab.txt --do_lower_case \\
        --train_file train-v1.1.json --predict_file dev-v1.1.json \\
        --do_train --do_predict --do_eval \\
        --eval_script scripts/squad_evaluate_v11.py \\
        --output_dir results/squad

A run reads the examples and featurizes them into sliding windows (a
pickle cache beside the input file unless ``--skip_cache``), takes span-loss
optimizer steps of ``BertForQuestionAnswering`` over shuffled batches of
``--train_batch_size`` features (``--optimizer adamw``: global-norm clipping
to ``--max_grad_norm``, then AdamW without bias correction on a linear
warmup schedule; ``--optimizer bert_adam``: BertAdam with its internal
schedule and per-tensor clipping), with dropout drawn from explicit
per-step seeds; then predicts in full padded batches, decodes the n-best
spans (``squad.get_answers``), writes ``predictions.json`` and
``nbest_predictions.json`` (and ``null_odds.json`` for v2.0), and with
``--do_eval --eval_script`` runs the official eval script as a
subprocess. :func:`main` returns the summary (``e2e_train_time``,
``training_sequences_per_second``, ``final_loss``, ``e2e_inference_time``,
``exact_match``, ``F1``), which is also written to ``--json_summary``
under ``--output_dir``.

Checkpoints are the JAX package's (utils/checkpoint.py): every
``--save_steps`` steps an async save of ``{"model", "config"}`` to
``--output_dir`` (keeping the newest one), and at the end of training a
synchronous one, unless ``--skip_checkpoint``. SIGTERM, SIGINT or SIGUSR1
stop training at the next step, write that checkpoint, skip prediction
and exit with 75 (utils/preemption.py).

One optimizer step takes the whole ``--train_batch_size`` batch: the JAX
runner computes a microbatch size from ``--gradient_accumulation_steps``
but its step never uses it, and neither does this one.

Telemetry (telemetry/, the JAX runner's flags; window 50, sync every 1):
step windows with CUDA-event device time and MFU, allocator watermarks,
grad health, the loss sentinel, the heartbeat and ``--profile_steps``
traces go to ``<output_dir>/squad_telemetry.jsonl`` (or
``--telemetry_jsonl``; with a ``tag: "train"`` record every
``--log_freq`` steps), ``<output_dir>/heartbeat.json`` and
``<output_dir>/profile``. No TensorBoard files are written.

``--dtype float16`` is the reference's mixed-precision recipe: fp16
activations over fp32 master parameters, the loss multiplied by the
dynamic loss scale (``--init_loss_scale``, default 2**16) before the
backward, AdamW's clipping on the true norm (the scaled norm over the
scale), and the optimizer wrapped in ``DynamicLossScale``, which skips an
overflowing step and backs off the scale, as the JAX runner's.

``--device_prefetch`` (default 2) stages the training batches on the card
ahead of the step (data/device_prefetch.py).

``--mesh_data N`` (the JAX runner's flag) trains data-parallel over the
run's N ranks, one per GPU, launched by torchrun (parallel/launcher.py;
``--mesh_data`` must be the world size, or -1): every rank walks the same
batch order and takes its rows of each ``--train_batch_size`` batch, the
span loss is the global batch's (local sums over the global start and
end counts), the gradients are summed once per step before the clipping
(parallel/overlap.py), and each rank folds its index into the dropout
seeds. Rank 0 alone logs, writes the feature cache, the telemetry and
the checkpoints, and predicts. ``train_step`` and ``predict_step`` emit
their ``compile`` and ``compile_cost`` records
(``--telemetry_cost_analysis``, telemetry/memory.py); with
``--layer_norm_backend kernel`` the LayerNorm kernel's notes are in the
count.
``--compile_cache_dir`` names the directory the kernel libraries and the
tokenizer core are built into (ops/kernels/build.py ``set_build_dir``). The telemetry debug
planes (``--debug_port``, ``--postmortem_file``) are the JAX runner's.
The tokenizer (``--tokenizer``, else the model config's) is WordPiece or
byte-level BPE on the C++ core (``build_tokenizer``, JAX run_squad.py:138-142);
``--init_checkpoint`` reads torch archives, TF checkpoints and the JAX
package's msgpack checkpoints (models/convert.py
``load_pretrained_encoder``).
``--layer_norm_backend kernel`` (or its JAX name ``pallas``) runs every
LayerNorm through the hand-written forward kernel.

Runs on ``cuda`` unless ``--device cpu`` is given; asking for ``cuda``
where there is none raises.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from bert_pytorch_tpu_torch import finetune, squad, telemetry
from bert_pytorch_tpu_torch.telemetry import memory as memory_util
from bert_pytorch_tpu_torch.data import device_prefetch as dp_cli
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.data.tokenization import (check_tokenizer_files,
                                                      get_tokenizer)
from bert_pytorch_tpu_torch.models.bert import (BertForQuestionAnswering,
                                                draw_dropout_seeds,
                                                fold_dropout_seeds,
                                                init_weights)
from bert_pytorch_tpu_torch.models.convert import (check_pretrained_path,
                                                   load_pretrained_encoder,
                                                   to_jax_params)
from bert_pytorch_tpu_torch.models.losses import span_loss, span_loss_sums
from bert_pytorch_tpu_torch.ops.kernels import build
from bert_pytorch_tpu_torch.ops.layernorm import resolve_backend
from bert_pytorch_tpu_torch.optim.schedules import warmup_linear_schedule
from bert_pytorch_tpu_torch.optim.transforms import (AdamW, BertAdam,
                                                     DynamicLossScale,
                                                     global_norm,
                                                     param_groups)
from bert_pytorch_tpu_torch.telemetry import model_stats
from bert_pytorch_tpu_torch.parallel import launcher
from bert_pytorch_tpu_torch.parallel.overlap import GradReducer
from bert_pytorch_tpu_torch.utils import checkpoint as ckpt
from bert_pytorch_tpu_torch.utils import dist as dist_utils
from bert_pytorch_tpu_torch.utils import flops as flops_util
from bert_pytorch_tpu_torch.utils import preemption

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}
WEIGHT_DECAY = 0.01  # the JAX runner's optimizers' default


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="BERT SQuAD finetuning on GPUs (PyTorch / CUDA port)")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--init_checkpoint", type=str, default=None,
                        help="torch archive: a directory with "
                             "pytorch_model.bin, or a .bin/.pt file")
    parser.add_argument("--config_file", type=str, required=True,
                        help="BERT model config json")
    parser.add_argument("--train_file", type=str, default=None)
    parser.add_argument("--predict_file", type=str, default=None)
    parser.add_argument("--max_seq_length", type=int, default=384)
    parser.add_argument("--doc_stride", type=int, default=128)
    parser.add_argument("--max_query_length", type=int, default=64)
    parser.add_argument("--do_train", action="store_true")
    parser.add_argument("--do_predict", action="store_true")
    parser.add_argument("--do_eval", action="store_true")
    parser.add_argument("--train_batch_size", type=int, default=32)
    parser.add_argument("--predict_batch_size", type=int, default=8)
    parser.add_argument("--learning_rate", type=float, default=3e-5)
    parser.add_argument("--num_train_epochs", type=float, default=2.0)
    parser.add_argument("--max_steps", type=int, default=-1)
    parser.add_argument("--warmup_proportion", type=float, default=0.1)
    parser.add_argument("--n_best_size", type=int, default=20)
    parser.add_argument("--max_answer_length", type=int, default=30)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--gradient_accumulation_steps", type=int, default=1)
    parser.add_argument("--do_lower_case", action="store_true")
    parser.add_argument("--version_2_with_negative", action="store_true")
    parser.add_argument("--null_score_diff_threshold", type=float,
                        default=0.0)
    parser.add_argument("--vocab_file", type=str, default=None)
    parser.add_argument("--tokenizer", type=str, default=None,
                        choices=["wordpiece", "bpe"])
    parser.add_argument("--optimizer", type=str, default="adamw",
                        choices=["adamw", "bert_adam"],
                        help="adamw+linear-warmup = the reference fp16 path; "
                             "bert_adam = its fp32 path")
    parser.add_argument("--max_grad_norm", type=float, default=1.0)
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=sorted(DTYPES),
                        help="float16 adds the dynamic loss scaler")
    parser.add_argument("--init_loss_scale", type=float, default=2.0 ** 16,
                        help="fp16 only: initial dynamic loss scale")
    parser.add_argument("--log_freq", type=int, default=50)
    parser.add_argument("--json_summary", type=str, default="squad_log.json")
    parser.add_argument("--eval_script", type=str, default=None)
    parser.add_argument("--skip_checkpoint", action="store_true",
                        help="write no checkpoint")
    parser.add_argument("--save_steps", type=int, default=0,
                        help="async checkpoint every this many steps (the "
                             "newest is kept); 0: only the final one")
    parser.add_argument("--skip_cache", action="store_true")
    parser.add_argument("--cache_dir", type=str, default=None)
    parser.add_argument("--layer_norm_backend", type=str, default="plain",
                        help="plain (the JAX 'xla'; default) or kernel "
                             "(the JAX 'pallas'): the LayerNorm forward "
                             "kernel")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--mesh_data", type=int, default=-1,
                        help="data-parallel ranks: the world size, or -1 "
                             "(all of them); the batch size must divide it")
    parser.add_argument("--dist_init_method", type=str, default=None,
                        help="the process group's init_method (e.g. "
                             "file:///path) in place of torchrun's env://")
    dp_cli.add_cli_args(parser)
    telemetry.add_cli_args(parser, sync_every_default=1)
    build.add_cli_args(parser)
    args = parser.parse_args(argv)

    # vocab/tokenizer ride in the model config (reference run_squad.py:862-876)
    with open(args.config_file, encoding="utf-8") as f:
        configs = json.load(f)
    if args.vocab_file is None:
        args.vocab_file = configs.get("vocab_file")
        if args.vocab_file is None:
            raise ValueError("vocab_file must be in the model config or CLI")
    if args.tokenizer is None:
        args.tokenizer = configs.get("tokenizer")
        if args.tokenizer is None:
            raise ValueError("tokenizer must be in the model config or CLI")
    check_tokenizer_files(args.tokenizer, args.vocab_file)
    if args.init_checkpoint:
        check_pretrained_path(args.init_checkpoint)
    if not args.do_train and not args.do_predict:
        raise ValueError("At least one of do_train or do_predict required")
    if args.do_train and not args.train_file:
        raise ValueError("do_train requires train_file")
    if args.do_predict and not args.predict_file:
        raise ValueError("do_predict requires predict_file")
    args.layer_norm_backend = resolve_backend(args.layer_norm_backend)
    return args


def log(record: dict) -> None:
    if dist_utils.is_main_process():
        print(" ".join(f"{k} {v:.6g}" if isinstance(v, float)
                       else f"{k} {v}" for k, v in record.items()),
              flush=True)


def setup_device(args) -> torch.device:
    """The run's device, after joining its ranks (parallel/launcher.py):
    ``args.rank`` and ``args.world_size`` are set, and ``--mesh_data``
    must be the world size (or -1)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda but torch.cuda.is_available() is False; pass "
            "--device cpu to run on the CPU")
    topology = launcher.initialize(device.type,
                                   init_method=args.dist_init_method)
    args.rank, args.world_size = topology.rank, topology.world_size
    args.owns_group = topology.distributed and topology.source != "existing"
    args.distributed = topology.distributed
    if args.mesh_data not in (-1, args.world_size):
        raise ValueError(
            f"--mesh_data {args.mesh_data} must be the world size "
            f"{args.world_size} (or -1): one rank per GPU")
    if args.train_batch_size % args.world_size:
        raise ValueError(
            f"train_batch_size={args.train_batch_size} must be divisible by "
            f"the world size {args.world_size}")
    if device.type == "cuda" and topology.distributed:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type == "cuda":
        # fp32 products in full fp32, as the JAX package's parity tests.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def build_tokenizer(args):
    """The run's tokenizer on the C++ core: ``--tokenizer`` of
    ``--vocab_file``, lower-casing with ``--do_lower_case`` (JAX
    run_squad.py:138-142)."""
    return get_tokenizer(args.tokenizer, args.vocab_file,
                         uppercase=not args.do_lower_case)


def build_model(args, device):
    """(BertForQuestionAnswering with seeded random weights, or the encoder
    of ``--init_checkpoint`` under a fresh head; config). The vocab is
    padded to a multiple of 8 as the reference does. Dense attention, no
    remat: the JAX runner's model."""
    config = BertConfig.from_json_file(args.config_file)
    if config.vocab_size % 8 != 0:
        config.vocab_size += 8 - (config.vocab_size % 8)
    model = BertForQuestionAnswering(
        config, dtype=DTYPES[args.dtype], device=device,
        layer_norm_backend=args.layer_norm_backend)
    init_weights(model, config.initializer_range,
                 torch.Generator(device=device).manual_seed(args.seed))
    if args.init_checkpoint:
        load_pretrained_encoder(args.init_checkpoint, config, model)
    return model, config


def cached_features(args, examples, tokenizer, is_training, tag):
    """Pickle-cached featurization (reference run_squad.py:1027-1043)."""
    src = args.train_file if is_training else args.predict_file
    cache_dir = args.cache_dir or os.path.dirname(os.path.abspath(src))
    cache_file = os.path.join(
        cache_dir,
        f"{os.path.basename(src)}_{args.tokenizer}_{args.max_seq_length}_"
        f"{args.doc_stride}_{args.max_query_length}_{tag}.feat")
    if os.path.exists(cache_file) and not args.skip_cache:
        with open(cache_file, "rb") as f:
            return pickle.load(f)
    features = squad.convert_examples_to_features(
        examples, tokenizer, args.max_seq_length, args.doc_stride,
        args.max_query_length, is_training)
    if not args.skip_cache and dist_utils.is_main_process():
        try:
            with open(cache_file, "wb") as f:
                pickle.dump(features, f)
        except OSError:
            pass
    return features


def features_to_arrays(features, is_training):
    """int64 [B, S] input_ids/segment_ids/input_mask (+ [B] start/end
    positions for training) as numpy arrays."""
    arrays = {
        "input_ids": [f.input_ids for f in features],
        "segment_ids": [f.segment_ids for f in features],
        "input_mask": [f.input_mask for f in features],
    }
    if is_training:
        arrays["start_positions"] = [f.start_position for f in features]
        arrays["end_positions"] = [f.end_position for f in features]
    return {k: np.asarray(v, np.int64) for k, v in arrays.items()}


def features_to_tensors(features, is_training, device):
    """:func:`features_to_arrays` as int64 tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in features_to_arrays(features, is_training).items()}


def make_optimizer(args, model, total_steps: int):
    """AdamW (no bias correction) on the linear warmup schedule, or
    BertAdam with that schedule inside; both over the no-decay groups, in
    fp16 wrapped in ``DynamicLossScale``."""
    groups = param_groups(model, WEIGHT_DECAY)
    if args.optimizer == "adamw":
        schedule = warmup_linear_schedule(
            args.learning_rate, args.warmup_proportion, total_steps,
            offset=0)
        optimizer = AdamW(groups, schedule, weight_decay=WEIGHT_DECAY,
                          bias_correction=False)
    else:
        optimizer = BertAdam(groups, args.learning_rate,
                             schedule="warmup_linear",
                             warmup=args.warmup_proportion,
                             t_total=total_steps, weight_decay=WEIGHT_DECAY)
    if args.dtype == "float16":
        optimizer = DynamicLossScale(optimizer,
                                     init_scale=args.init_loss_scale)
    return optimizer


def make_train_step(model, optimizer, clip_norm: float,
                    generator: torch.Generator, stats_every: int = 0,
                    rank: Optional[int] = None):
    """``step(batch) -> metrics``: forward with dropout from seeds drawn
    for this step, span loss, backward, global-norm clipping to
    ``clip_norm`` when it is > 0 (the adamw path; BertAdam clips per
    tensor itself), one optimizer step. Parameters update in place.
    ``metrics["loss"]`` is the loss (a device tensor);
    ``metrics["grad_health"]`` the grad-health block on steps whose
    pre-update optimizer count is a multiple of ``stats_every`` (0
    disables). With a ``DynamicLossScale`` optimizer (fp16) the loss is
    multiplied by its scale before the backward, the clipping reads the
    true norm, and the grad-health block runs on every step with its grad
    norms unscaled (the JAX ``finetune_grad_health`` with
    ``fp16_scale``).

    ``rank`` (a run of several ranks; --mesh_data): ``batch`` is this
    rank's rows of the global batch; the loss is the global batch's (the
    local start and end sums over their global counts, one all-reduce),
    the gradients are summed over the ranks (one flat all-reduce) before
    the clipping, and the dropout seeds fold in the rank."""
    num_layers = model.config.num_hidden_layers
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in named]
    reducer = GradReducer(named) if rank is not None else None

    fp16 = isinstance(optimizer, DynamicLossScale)

    def step(batch):
        for p in params:
            p.grad = None
        seeds = draw_dropout_seeds(generator, num_layers)
        if reducer is not None:
            seeds = fold_dropout_seeds(seeds, rank)
        start_logits, end_logits = model(
            batch["input_ids"], batch["segment_ids"], batch["input_mask"],
            dropout_seeds=seeds)
        if reducer is None:
            loss = span_loss(start_logits, end_logits,
                             batch["start_positions"], batch["end_positions"])
            local_loss = loss
        else:
            s_sum, s_n, e_sum, e_n = span_loss_sums(
                start_logits, end_logits, batch["start_positions"],
                batch["end_positions"])
            counts = torch.stack([s_n, e_n]).float()
            torch.distributed.all_reduce(counts)
            c_s, c_e = counts.clamp(min=1)
            local_loss = (s_sum / c_s + e_sum / c_e) / 2.0
        loss_scale = optimizer.scale if fp16 else None
        (local_loss if loss_scale is None
         else local_loss * loss_scale).backward()
        if reducer is not None:
            reducer.finish()
            loss = local_loss.detach().clone()
            torch.distributed.all_reduce(loss)
        if clip_norm > 0:
            grads = [p.grad for p in params if p.grad is not None]
            norm = global_norm(grads)
            if loss_scale is not None:
                norm = norm / loss_scale  # clip on the true norm
            scale = torch.clamp(clip_norm / (norm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(scale)
        metrics = {"loss": loss.detach()}
        health = model_stats.step_with_health(
            optimizer, named, 1 if fp16 and stats_every > 0 else stats_every,
            grad_scale=loss_scale)
        if health is not None:
            metrics["grad_health"] = health
        return metrics

    return step


def save(args, model, config, global_step: int, async_write: bool) -> None:
    """``{"model", "config"}`` as ``ckpt_{global_step}.msgpack`` in
    ``--output_dir``, keeping the newest one (JAX run_squad.py:405-446);
    rank 0's alone."""
    if not dist_utils.is_main_process():
        return
    ckpt.save_checkpoint(
        args.output_dir, global_step,
        {"model": to_jax_params(model.state_dict(), config, "squad",
                                keep_device=True),
         "config": config.to_dict()},
        keep=1, async_write=async_write)


def open_telemetry(args, config, device):
    """The run's telemetry facade (JAX run_squad.py:262-275), shared by
    training and prediction; the JSONL also takes a train record every
    --log_freq steps."""
    return finetune.open_telemetry(
        args, "squad", device, args.train_batch_size,
        flops_util.bert_finetune_flops_per_seq(
            config, args.max_seq_length, head_outputs=2),
        is_primary=dist_utils.is_main_process(),
        n_devices=args.world_size)


def train(args, model, config, tokenizer, device, tele) -> dict:
    """The finetuning loop, threaded through ``tele`` (finished here,
    closed by the caller); returns the training half of the summary."""
    train_examples = squad.read_squad_examples(
        args.train_file, True, args.version_2_with_negative)
    train_features = cached_features(args, train_examples, tokenizer, True,
                                     "train")
    n = len(train_features)
    steps_per_epoch = n // args.train_batch_size
    total_steps = (args.max_steps if args.max_steps > 0 else
                   int(steps_per_epoch * args.num_train_epochs))
    if steps_per_epoch == 0:
        raise ValueError(f"{n} training features do not fill one batch of "
                         f"{args.train_batch_size}")
    log({"event": "train", "features": n, "optimizer_steps": total_steps})
    optimizer = make_optimizer(args, model, total_steps)
    step = make_train_step(
        model, optimizer,
        args.max_grad_norm if args.optimizer == "adamw" else 0.0,
        torch.Generator().manual_seed(args.seed), telemetry.stats_every(args),
        rank=args.rank if args.distributed else None)
    # Compile and cost attribution (JAX run_squad.py:343).
    step = tele.instrument(step, "train_step",
                           memory_util.training_state(model, optimizer))
    rows = args.train_batch_size // args.world_size
    mine = slice(args.rank * rows, (args.rank + 1) * rows)
    rng = np.random.RandomState(args.seed)
    global_step, seqs = 0, 0
    losses = []
    t_start = time.perf_counter()
    # Handlers stay installed through the final write (a re-delivered
    # signal must not kill it) and are restored after.
    stop = preemption.GracefulStop().install()

    def epoch_batches(order):
        for i in range(0, n - args.train_batch_size + 1,
                       args.train_batch_size):
            yield [train_features[j]
                   for j in order[i:i + args.train_batch_size][mine]]

    prefetcher = None
    try:
        while global_step < total_steps and not stop.requested:
            order = rng.permutation(n)
            prefetcher = dp_cli.prefetch(
                epoch_batches(order), device, args.device_prefetch,
                lambda feats, put: {k: put(v) for k, v in
                                    features_to_arrays(feats, True).items()})
            tele.attach_prefetcher(prefetcher)
            for batch in tele.timed(prefetcher):
                tele.profiler.maybe_start(global_step + 1)
                with tele.profiler.annotation(global_step + 1):
                    metrics = step(batch)
                tele.dispatch_done()
                global_step += 1
                seqs += args.train_batch_size
                tele.step_done(global_step, metrics)
                losses.append(metrics["loss"])
                if global_step % args.log_freq == 0:
                    record = {"step": global_step,
                              "step_loss": float(losses[-1]),
                              "samples_per_second":
                                  seqs / (time.perf_counter() - t_start)}
                    log(record)
                    tele.emit(tag="train", **record)
                if (args.save_steps and not args.skip_checkpoint
                        and global_step % args.save_steps == 0):
                    with tele.checkpoint_stall():
                        save(args, model, config, global_step,
                             async_write=True)
                if global_step >= total_steps or stop.requested:
                    break
        step_losses = [float(x) for x in losses]  # synchronises
        train_time = time.perf_counter() - t_start
        if stop.requested:
            log({"event": "termination signal", "signal": stop.signal_name,
                 "exit_code": preemption.EXIT_PREEMPTED})
            tele.emit(preemption.preemption_record(global_step, stop))
        tele.finish(global_step, summary={
            "training_seq_per_sec": round(seqs / train_time, 2)})
        if not args.skip_checkpoint:
            t_save = time.perf_counter()
            save(args, model, config, global_step, async_write=False)
            log({"event": "checkpoint", "step": global_step, "seconds":
                 time.perf_counter() - t_save})
        ckpt.wait_for_pending_save()
    finally:
        if prefetcher is not None:
            prefetcher.close()
        stop.restore()
    summary = {"e2e_train_time": train_time,
               "training_sequences_per_second": seqs / train_time,
               "final_loss": step_losses[-1], "global_step": global_step,
               "step_losses": step_losses,
               "terminated_by_signal": stop.requested}
    if isinstance(optimizer, DynamicLossScale):
        summary["loss_scale"] = optimizer.scale
    return summary


@torch.no_grad()
def predict(args, model, tokenizer, device, tele) -> dict:
    """Prediction over ``--predict_file`` in full batches (the last padded
    with copies of the last feature), n-best decoding, the output files
    and the official eval; returns the prediction half of the summary.
    The forward is ``tele``'s instrumented ``predict_step``."""
    predict_step = tele.instrument(model, "predict_step")
    eval_examples = squad.read_squad_examples(
        args.predict_file, False, args.version_2_with_negative)
    eval_features = cached_features(args, eval_examples, tokenizer, False,
                                    "predict")
    log({"event": "predict", "features": len(eval_features)})
    t_infer = time.perf_counter()
    results = []
    bs = args.predict_batch_size
    padded = list(eval_features)
    while len(padded) % bs != 0:
        padded.append(eval_features[-1])
    for i in range(0, len(padded), bs):
        feats = padded[i:i + bs]
        batch = features_to_tensors(feats, False, device)
        start_logits, end_logits = predict_step(
            batch["input_ids"], batch["segment_ids"], batch["input_mask"])
        start_logits = start_logits.float().cpu().numpy()
        end_logits = end_logits.float().cpu().numpy()
        for j, f in enumerate(feats):
            if i + j < len(eval_features):
                results.append(squad.RawResult(
                    unique_id=f.unique_id,
                    start_logits=start_logits[j].tolist(),
                    end_logits=end_logits[j].tolist()))
    summary = {"e2e_inference_time": time.perf_counter() - t_infer,
               "predict_batches": len(padded) // bs}

    answers, nbest, null_odds = squad.get_answers(
        eval_examples, eval_features, results, args)
    prediction_file = os.path.join(args.output_dir, "predictions.json")
    with open(prediction_file, "w", encoding="utf-8") as f:
        f.write(json.dumps(answers, indent=4) + "\n")
    with open(os.path.join(args.output_dir, "nbest_predictions.json"), "w",
              encoding="utf-8") as f:
        f.write(json.dumps(nbest, indent=4) + "\n")
    null_odds_file = None
    if args.version_2_with_negative:
        # The v2.0 official metric's best-threshold search reads these
        # (reference run_squad.py:1190-1194).
        null_odds_file = os.path.join(args.output_dir, "null_odds.json")
        with open(null_odds_file, "w", encoding="utf-8") as f:
            f.write(json.dumps(null_odds, indent=4) + "\n")

    if args.do_eval and args.eval_script:
        # Official-oracle evaluation (reference run_squad.py:1197-1204).
        eval_cmd = [sys.executable, args.eval_script, args.predict_file,
                    prediction_file]
        if null_odds_file:
            eval_cmd += ["--na-prob-file", null_odds_file,
                         "--na-prob-thresh",
                         str(args.null_score_diff_threshold)]
        proc = subprocess.run(eval_cmd, capture_output=True, text=True,
                              check=True)
        scores = json.loads(proc.stdout)
        summary["exact_match"] = scores.get("exact_match")
        summary["F1"] = scores.get("f1")
    return summary


def main(args) -> dict:
    try:
        return run(args)[0]
    finally:
        if getattr(args, "owns_group", False):
            launcher.shutdown()


def run(args):
    """(summary, model, config): the whole run; ``main`` keeps the
    summary."""
    build.set_build_dir(args.compile_cache_dir or None)
    device = setup_device(args)
    torch.manual_seed(args.seed)
    os.makedirs(args.output_dir, exist_ok=True)
    model, config = build_model(args, device)
    tokenizer = build_tokenizer(args)
    log({"event": "start", "device": str(device), "dtype": args.dtype,
         "layer_norm_backend": args.layer_norm_backend,
         "optimizer": args.optimizer, "layers": config.num_hidden_layers})
    summary = {}
    tele = open_telemetry(args, config, device)
    try:
        if args.do_train:
            summary.update(train(args, model, config, tokenizer, device,
                                 tele))
        if args.distributed:
            # Prediction, the official eval and the summary are rank 0's.
            dist_utils.barrier()
            if not dist_utils.is_main_process():
                return summary, model, config
        if args.do_predict and not summary.get("terminated_by_signal"):
            # A preempted run exits after its checkpoint: the grace period
            # is for durability, not for prediction.
            summary.update(predict(args, model, tokenizer, device, tele))
    finally:
        tele.close()
    log({"event": "summary", **{k: v for k, v in summary.items()
                                if isinstance(v, (int, float))}})
    with open(os.path.join(args.output_dir, args.json_summary), "w",
              encoding="utf-8") as f:
        json.dump(summary, f, indent=2)
    return summary, model, config


if __name__ == "__main__":
    outcome = main(parse_args())
    if outcome.get("terminated_by_signal"):
        sys.exit(preemption.EXIT_PREEMPTED)
    losses = outcome.get("step_losses", [])
    sys.exit(0 if all(np.isfinite(losses)) else 1)
