"""BERT MLM+NSP pretraining on one GPU or many: the port of the JAX
package's ``run_pretraining.py``, with its flag names for what it
implements.

    python -m bert_pytorch_tpu_torch.run_pretraining \\
        --config_file configs/bert_pretraining_phase1_config.json \\
        --model_config_file configs/bert_large_uncased_config.json \\
        --input_dir <dir of HDF5 shards> --output_dir out/
    python -m bert_pytorch_tpu_torch.run_pretraining \\
        --config_file configs/bert_pretraining_phase2_config.json \\
        --model_config_file configs/bert_large_uncased_config.json \\
        --input_dir <dir of seq-512 shards> --output_dir out/ \\
        --previous_phase_end_step 7038
    torchrun --nproc_per_node 8 -m bert_pytorch_tpu_torch.run_pretraining \\
        --mesh dp=8 ...     # or fsdp=8, dp=2,pipe=2,model=2, seq=2, ...

Across GPUs (parallel/): one process per GPU, launched by torchrun (or
with the JAX launcher's or SLURM's environment; parallel/launcher.py),
on ``nccl`` (``gloo`` on the CPU, or when the host's ranks outnumber its
cards). ``--mesh`` (the JAX grammar, parallel/mesh.py ``MeshSpec``; or the
legacy ``--parallel_strategy dp|fsdp|sp|tp|tp_fsdp|pp|pp_tp`` with the
``--mesh_*`` sizes) lays the ranks out in the JAX order ``(data, fsdp,
pipe, seq, model)``, ``dcn`` the outer factor of ``data``: ``dp``
replicates the parameters and sums the gradients once per step (one flat
all-reduce, or three availability buckets launched during the last
backward with ``--overlap_grad_reduce``), ``fsdp`` shards them with FSDP2
(HSDP on a 2-D mesh), ``model`` splits the layers Megatron's way
(parallel/tensor_parallel.py), ``seq`` shards the sequence with ring
attention (ops/ring.py; ``seq`` > 1 forces ``--attention_backend ring``,
as the JAX runner does), and ``pipe`` runs the encoder as a GPipe
pipeline (parallel/pipeline.py; at least as many accumulation steps as
stages). The step is the JAX step over the global batch (pretrain.py:
local loss sums over global masked counts). Each data coordinate (the
rank's index along ``dcn x data x fsdp``) reads its part of the index
space (``DistributedSampler(num_replicas=data replicas, rank=data
coordinate)``, ``global_batch_size / data replicas`` rows a step) and
masks under ``seed + data coordinate``; ranks along ``pipe``, ``seq`` and
``model`` that share one read the same rows. ``local_batch_size`` is per
data replica, as in the JAX runner.
Rank 0 prints, logs and writes the telemetry; ``--checkpoint_layout
sharded`` has every rank write its shard (utils/checkpoint.py), the
gathered layout gathers to rank 0; a resume goes through
``agree_on_resume_step``, so the ranks restore one step, and a sharded
checkpoint resumes at any world size.

A run streams the HDF5 shards (data/dataset.py; dynamic masking, optional
``--pack_sequences``), stacks each global batch into ``accumulation_steps
= global_batch_size / local_batch_size`` microbatches, and takes optimizer
steps with pretrain.make_train_step (LAMB or AdamW with a warmup schedule,
bf16, fp16 or fp32, ``--remat``, the ``flash`` attention kernels). Every
``--log_steps`` it prints the loss, learning rate and sequences per
second.

Checkpoints are the JAX package's (utils/checkpoint.py):
``<output_dir>/pretrain_ckpts/ckpt_{step}.msgpack`` holding ``{model,
optimizer, sampler, epoch}``, so either package resumes the other's run.
A run resumes from the newest checkpoint there that verifies (walking
back past corrupt ones, with a record of each skip); with
``--previous_phase_end_step`` N > 0 and a checkpoint at step >= N, it is
phase 2 of the two-phase recipe: the optimizer's count restarts at the
step within the phase, the moments are kept, and saves are numbered N +
the step within the phase. Every ``--num_steps_per_checkpoint`` steps it
saves (``--checkpoint_write async`` by default: the step pays a device
copy, a background thread writes), keeping the newest
``--keep_checkpoints``; at the end it saves synchronously unless
``--skip_final_checkpoint``. SIGTERM, SIGINT or SIGUSR1 stop the run at
the next ``--term_check_steps`` boundary, write the checkpoint even with
``--skip_final_checkpoint``, and exit with 75 (utils/preemption.py). The
dropout seeds come from ``--seed`` afresh in a resumed run, as the JAX
runner draws its dropout rng afresh (its checkpoints hold none).

``--kfac`` preconditions every step with K-FAC (optim/kfac.py; the JAX
runner's 11 ``--kfac*`` flags and defaults). ``--kfac_capture train``
(default) captures the factors in the step's own backward (microbatch 0,
or every microbatch with ``--kfac_capture_microbatches all``) every
``--kfac_factor_interval`` steps and rebuilds the inverses inside the step
every ``--kfac_inv_interval``; ``stats`` runs a separate tapped forward
and backward (no remat, dropout seeds of its own) on ``--kfac_stats_batch``
strided rows of microbatch 0 on those steps, then the inverses, then the
step. Both fire on the first step. Checkpoints carry the state as
``preconditioner``; a ``--kfac`` resume restores it and recomputes the
inverses from the restored factors, a resume without ``--kfac`` skips it.
Across ranks the statistics are summed over the data replicas (and
under ``seq`` the token shards) and the inverses split by layer over
them, the taps of a layer split over ``model`` gather its features, and
the step preconditions whole gradients (optim/kfac.py); under ``pipe``
the capture falls back to ``stats`` (logged, as the JAX runner does).
The stats pass of a model split over ``fsdp``, ``pipe`` or ``model``, or
on the ring, runs on a whole-model twin that takes the run's weights
gathered whole before each pass.

Telemetry (telemetry/, the JAX runner's flags and defaults: window 20,
sync every 4): ``<output_dir>/<log_prefix>.txt`` keeps the log lines,
``<log_prefix>_metrics.csv`` and the JSONL sink
(``<log_prefix>_telemetry.jsonl`` unless ``--telemetry_jsonl``; schema v1,
``telemetry/schema.py``) the train records (``tag: "train"``), and the
JSONL alone the telemetry records: step windows (data wait, host,
device time from CUDA events, MFU on the card's peak, the loader's
gauges), allocator watermarks, grad health (``--grad_stats_every``),
sentinels (``--sentinel_policy abort`` ends the run with a non-zero
code), a ``resume`` record naming each checkpoint the walk-back skipped,
the preemption ``fault`` record and a ``run_summary``. The heartbeat goes
to ``<output_dir>/heartbeat.json``; ``--profile_steps`` writes a Chrome
trace of ``torch.profiler`` into ``<output_dir>/profile``. The debug
planes take the JAX flags: ``--debug_port`` serves /healthz, /statsz,
/metricsz and ``POST /profilez`` (an on-demand capture: host-thread
samples and a trace under ``<output_dir>/profile/ondemand_<n>``, its
``profile_window`` record in the JSONL), and the flight recorder keeps
``<output_dir>/postmortem.json`` (``--postmortem_file``) through a crash
and removes it on a clean exit. Standard
output keeps the port's one ``key value`` line per logged step. No
TensorBoard files are written, with or without ``--disable_tensorboard``
(accepted for the JAX command lines).

``--dtype float16`` is the reference's mixed-precision recipe: fp16
activations over fp32 master parameters, the optimizer wrapped in
``DynamicLossScale`` (``--init_loss_scale``, default 2**16, and
``--loss_scale_growth_interval``, default 2000, the JAX runner's flags);
every train record carries ``loss_scale``, an overflowing step is skipped
(``finite 0``) and the scale rides in the checkpoint's ``optimizer`` tree
as the JAX runner's does. K-FAC with fp16 is refused, as in the JAX
runner.

The feed of a long run (the JAX runner's flags and defaults): the loader
produces on a thread, or on ``--num_workers`` spawned processes
(data/loader.py; the batches are the same byte for byte); the shard
reads retry (``--data_read_retries``, ``--data_retry_base_s``) and an
unreadable shard at start-up is skipped or fails the run
(``--shard_error_policy``), each retry and skip a ``fault`` record in the
JSONL; and ``--device_prefetch`` batches (default 2) are staged on the
card ahead of the step by a thread, through pinned memory on a side CUDA
stream (data/device_prefetch.py; 0 stages inline), the staging share of
each wait reported as ``h2d_wait``. ``--val_input_dir`` adds a held-out
pass every ``--num_steps_per_eval`` steps: ``--eval_batches`` batches
(at most what the shards fill) from the start of the held-out shards,
masked under ``seed + 7919``, through pretrain.make_eval_step, logged as a
``val`` record with ``average_loss`` and ``mlm_accuracy``.
``--fault_spec`` (or ``BERT_FAULTS``) arms testing/faults.py: ``nonfinite@N``
poisons step N's metrics before the sentinel sees them, ``die``, ``term``
and ``hang`` fire after the step's checkpoint block, ``shard_errorxK``
fails the first K shard reads (tools/chaos_run.py drives them).
``--max_grad_norm`` is LAMB's clip norm, ``--max_sequences_per_pack`` the
on-the-fly packing's limit, and ``--checkpoint_activations`` is
``--remat full``.

Every ``--mesh`` product the JAX runner takes runs, ``--kfac`` under each
of them; the JAX runner's own refusals are made before the rendezvous
(every rank prints them): ``--overlap_grad_reduce`` outside a plain data
mesh, ``--dtype float16`` with a pipeline or with K-FAC, and packing with
``seq``. Not ported, so rejected rather than ignored: ``--rng_impl``,
which picks the TPU's hardware PRNG where the port draws Philox (the
kernels' dropout, keyed by coordinates); argparse refuses the flags it
does not know. ``train_step`` and the held-out ``eval_step`` emit their
``compile`` and ``compile_cost`` records (``--telemetry_cost_analysis``,
telemetry/memory.py) under every layout; each rank counts its own work.
``attention_backend "pallas"`` in a config file (the JAX recipe's
phase-2 setting) selects its counterpart, ``flash``. ``--layer_norm_backend kernel`` (or its JAX name ``pallas``)
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

from bert_pytorch_tpu_torch import pretrain, telemetry
from bert_pytorch_tpu_torch.telemetry import memory as memory_util
from bert_pytorch_tpu_torch.models.convert import (optimizer_to_jax,
                                                   to_jax_params)
from bert_pytorch_tpu_torch.utils import checkpoint as ckpt
from bert_pytorch_tpu_torch.utils import flops as flops_util
from bert_pytorch_tpu_torch.utils import logging as logging_util
from bert_pytorch_tpu_torch.utils import preemption
from bert_pytorch_tpu_torch.config import (BertConfig,
                                           parse_args_with_config_file,
                                           require_args)
from bert_pytorch_tpu_torch.data import device_prefetch as dp_cli
from bert_pytorch_tpu_torch.data.dataset import (ShardedPretrainingDataset,
                                                 input_files)
from bert_pytorch_tpu_torch.data.loader import DataLoader
from bert_pytorch_tpu_torch.data.sampler import DistributedSampler
from bert_pytorch_tpu_torch.data.tokenization import get_tokenizer
from bert_pytorch_tpu_torch.models.bert import (BertForPreTraining,
                                                draw_dropout_seeds,
                                                init_weights)
from bert_pytorch_tpu_torch.ops.kernels import build
from bert_pytorch_tpu_torch.ops.layernorm import resolve_backend
from bert_pytorch_tpu_torch.optim.kfac import KFAC
from bert_pytorch_tpu_torch.optim.schedules import SCHEDULES, make_schedule
from bert_pytorch_tpu_torch.optim.transforms import (AdamW,
                                                     DynamicLossScale, Lamb,
                                                     opt_step_count,
                                                     param_groups,
                                                     reset_count)
from bert_pytorch_tpu_torch.parallel import launcher
from bert_pytorch_tpu_torch.parallel import mesh as mesh_lib
from bert_pytorch_tpu_torch.parallel import pipeline, sharding
from bert_pytorch_tpu_torch.parallel import state as state_lib
from bert_pytorch_tpu_torch.testing import faults
from bert_pytorch_tpu_torch.utils import dist as dist_utils

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}
# The JAX recipe's phase-2 config file names the fused kernels "pallas".
BACKEND_ALIASES = {"pallas": "flash"}
# The held-out masks' seed offset (the JAX runner's seed + 7919).
VAL_SEED_OFFSET = 7919
# The stats pass's dropout seeds: a generator of its own per step (the JAX
# runner's fold_in(PRNGKey(seed + 17), step)).
KFAC_STATS_SEED_OFFSET = 17


def parse_arguments(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="BERT pretraining on GPUs (PyTorch / CUDA port)")
    # data / io
    parser.add_argument("--input_dir", type=str, default=None,
                        help="HDF5 shard file or directory of *.hdf5")
    parser.add_argument("--output_dir", type=str, default=None,
                        help="checkpoints go to <output_dir>/pretrain_ckpts, "
                             "and a run resumes from there")
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
    parser.add_argument("--max_sequences_per_pack", type=int, default=8,
                        help="sequences per packed row on the fly (offline-"
                             "packed shards carry their own); scales the "
                             "row's MLM budget: max_predictions_per_seq "
                             "applies per sequence")
    parser.add_argument("--num_workers", type=int, default=0,
                        help="loader worker processes (spawned; each "
                             "featurizes every Nth batch); 0 = one "
                             "background thread")
    # held-out evaluation through pretrain.make_eval_step
    parser.add_argument("--val_input_dir", type=str, default=None,
                        help="directory of held-out HDF5 shards; enables a "
                             "validation pass")
    parser.add_argument("--num_steps_per_eval", type=int, default=200,
                        help="optimizer steps between validation passes")
    parser.add_argument("--eval_batches", type=int, default=16,
                        help="validation batches per pass")
    dp_cli.add_cli_args(parser)
    # the data path's resilience (data/dataset.py, utils/retry.py)
    parser.add_argument("--data_read_retries", type=int, default=2,
                        help="retries of a shard open or read (exponential "
                             "backoff with jitter) before it fails")
    parser.add_argument("--data_retry_base_s", type=float, default=0.2,
                        help="the backoff's base delay, doubled per retry")
    parser.add_argument("--shard_error_policy", type=str, default="skip",
                        choices=["skip", "abort"],
                        help="a shard unreadable at start-up past the "
                             "retries: 'skip' warns and trains on the rest; "
                             "'abort' fails. A mid-run failure always "
                             "fails")
    parser.add_argument("--fault_spec", type=str, default="",
                        help="deterministic fault injection for tests "
                             "(testing/faults.py), e.g. 'die@7' or "
                             "'shard_errorx2,nonfinite@5'; also armed by "
                             "BERT_FAULTS. Empty disables")
    # checkpoints
    parser.add_argument("--num_steps_per_checkpoint", type=int, default=200)
    parser.add_argument("--keep_checkpoints", type=int, default=3)
    parser.add_argument("--checkpoint_write", type=str, default="async",
                        choices=["async", "sync"],
                        help="periodic saves: 'async' clones the state on "
                             "the device and writes it from a background "
                             "thread; 'sync' writes before the next step. "
                             "Final and preemption saves are synchronous")
    parser.add_argument("--checkpoint_layout", type=str, default="gathered",
                        choices=["gathered", "sharded"],
                        help="'gathered' (default): one full msgpack, "
                             "written by rank 0; 'sharded': every rank "
                             "writes its shard's slice records plus a "
                             "rank-0 index, resumable at any world size")
    parser.add_argument("--skip_final_checkpoint", action="store_true")
    parser.add_argument("--term_check_steps", type=int, default=10,
                        help="act on SIGTERM/SIGINT/SIGUSR1 every this many "
                             "steps: save and exit with 75; 0 installs no "
                             "handler")
    # K-FAC (SURVEY §2.2), the JAX runner's flags and defaults
    parser.add_argument("--kfac", action="store_true",
                        help="precondition with K-FAC (optim/kfac.py)")
    parser.add_argument("--kfac_stat_decay", type=float, default=0.95)
    parser.add_argument("--kfac_damping", type=float, default=0.001)
    parser.add_argument("--kfac_kl_clip", type=float, default=0.001)
    parser.add_argument("--kfac_factor_interval", type=int, default=10)
    parser.add_argument("--kfac_inv_interval", type=int, default=100)
    parser.add_argument("--kfac_inv_method", type=str, default="cholesky",
                        choices=["cholesky", "eigen"],
                        help="'cholesky': damped factor inverses; 'eigen': "
                             "eigenbasis preconditioning (kfac_pytorch's "
                             "eigen method)")
    parser.add_argument("--kfac_capture", type=str, default="train",
                        choices=["train", "stats"],
                        help="'train': factors from the training step's own "
                             "backward; 'stats': a separate stats pass on "
                             "--kfac_stats_batch rows every factor interval")
    parser.add_argument("--kfac_capture_microbatches", type=str,
                        default="first", choices=["first", "all"],
                        help="fused capture source: microbatch 0 ('first') "
                             "or every microbatch's backward ('all')")
    parser.add_argument("--kfac_stats_batch", type=int, default=16,
                        help="sequences of microbatch 0, strided, for the "
                             "stats pass (0 = the whole microbatch)")
    parser.add_argument("--kfac_skip_layers", type=str, nargs="+",
                        default=["embeddings", "predictions"])
    parser.add_argument("--log_steps", type=int, default=1)
    parser.add_argument("--log_prefix", type=str, default="pretraining",
                        help="<output_dir>/<log_prefix>.txt, "
                             "_metrics.csv and _telemetry.jsonl")
    parser.add_argument("--disable_tensorboard", action="store_true",
                        help="accepted for the JAX runner's command lines; "
                             "the port writes no TensorBoard files")
    # telemetry: step-time windows + MFU, profiler trace windows, failure
    # sentinels, grad health, heartbeat, hung-step watchdog
    telemetry.add_cli_args(parser, window_default=20, sync_every_default=4)
    build.add_cli_args(parser)
    # numerics / memory
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=sorted(DTYPES),
                        help="activation dtype; float16 adds the dynamic "
                             "loss scaler")
    parser.add_argument("--init_loss_scale", type=float, default=2.0 ** 16,
                        help="fp16 only: initial dynamic loss scale")
    parser.add_argument("--loss_scale_growth_interval", type=int,
                        default=2000,
                        help="fp16 only: consecutive finite steps before "
                             "the loss scale doubles")
    parser.add_argument("--checkpoint_activations", action="store_true",
                        help="shorthand for --remat full")
    parser.add_argument("--remat", type=str, default=None,
                        choices=["none", "dots", "full"],
                        help="activation recompute in backward (default "
                             "none, or full with --checkpoint_activations)")
    parser.add_argument("--attention_backend", type=str, default="auto",
                        choices=["auto", "dense", "flash", "ring"],
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
    parser.add_argument("--max_grad_norm", type=float, default=1.0,
                        help="LAMB's global-norm gradient clip")
    # mesh (the JAX runner's flags; parallel/mesh.py)
    parser.add_argument("--mesh", type=str, default=None,
                        help="declarative mesh spec, e.g. 'dp=4,fsdp=2' "
                             "(MeshSpec grammar); overrides "
                             "--parallel_strategy and the --mesh_* sizes")
    parser.add_argument("--parallel_strategy", type=str, default="dp",
                        choices=["dp", "fsdp", "tp", "tp_fsdp", "sp", "pp",
                                 "pp_tp"],
                        help="legacy strategy alias lowered onto a mesh "
                             "spec with the --mesh_* sizes")
    parser.add_argument("--mesh_data", type=int, default=-1,
                        help="data-parallel ranks; -1 = all the rest")
    parser.add_argument("--mesh_fsdp", type=int, default=1)
    parser.add_argument("--mesh_pipe", type=int, default=1)
    parser.add_argument("--mesh_seq", type=int, default=1)
    parser.add_argument("--mesh_model", type=int, default=1)
    parser.add_argument("--mesh_dcn_data", type=int, default=1)
    parser.add_argument("--overlap_grad_reduce", action="store_true",
                        help="reduce the gradients in three availability "
                             "buckets (heads, encoder, embeddings) launched "
                             "during the last backward (dp only, "
                             "first-order optimizers, bf16/fp32)")
    parser.add_argument("--dist_init_method", type=str, default=None,
                        help="the process group's init_method (e.g. "
                             "file:///path) in place of torchrun's "
                             "env:// TCP store")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parse_args_with_config_file(parser, argv)


def log(record: dict, logger=None) -> None:
    """One ``key value`` line on standard output (rank 0's), and in
    ``logger``'s text file when the run's logger is given."""
    line = " ".join(f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in record.items())
    if dist_utils.is_main_process():
        print(line, flush=True)
    if logger is not None:
        logger.info(line)


def append_record(path: str, record: dict) -> None:
    """Append one telemetry record to the JSONL at ``path`` (the records
    written before ``train`` opens the run's sink)."""
    sink = logging_util.JSONLHandler(
        path, is_primary=dist_utils.is_main_process())
    try:
        sink.write_record(record)
    finally:
        sink.close()


def mesh_spec(args) -> mesh_lib.MeshSpec:
    """``--mesh``, or the legacy ``--parallel_strategy`` with the
    ``--mesh_*`` sizes, with the JAX runner's alias rules
    (run_pretraining.py:346-378)."""
    if args.mesh:
        return mesh_lib.MeshSpec.parse(args.mesh)
    spec = mesh_lib.MeshSpec.from_strategy(
        args.parallel_strategy, data=args.mesh_data, fsdp=args.mesh_fsdp,
        pipe=args.mesh_pipe, seq=args.mesh_seq, model=args.mesh_model,
        dcn_data=args.mesh_dcn_data)
    if args.mesh_pipe > 1 and args.parallel_strategy not in ("pp", "pp_tp"):
        raise ValueError(
            f"--mesh_pipe {args.mesh_pipe} requires --parallel_strategy "
            "pp or pp_tp (or express the product with --mesh)")
    if args.parallel_strategy in ("pp", "pp_tp") and args.mesh_pipe < 2:
        raise ValueError(
            "--parallel_strategy pp/pp_tp needs --mesh_pipe >= 2 (a "
            "1-stage pipeline is just dp with schedule overhead)")
    if args.parallel_strategy == "pp_tp" and args.mesh_model < 2:
        raise ValueError(
            "--parallel_strategy pp_tp needs --mesh_model >= 2 "
            "(with one model shard use plain pp)")
    if args.parallel_strategy == "pp" and args.mesh_model > 1:
        raise ValueError(
            f"--mesh_model {args.mesh_model} with --parallel_strategy pp "
            "replicates all stage weights over the model axis; use pp_tp "
            "(or --mesh)")
    return spec


def refuse_layout(args, spec: mesh_lib.MeshSpec) -> None:
    """The layout's refusals, from flags alone (raised before the
    rendezvous, on every rank): the overlap outside the plain dp path and
    fp16 with a pipeline (the JAX runner's rules). Every other product of
    the mesh axes, with or without ``--kfac``, is taken."""
    if args.overlap_grad_reduce and (
            spec.active_axes() - {mesh_lib.AXIS_DATA}
            or args.kfac or args.dtype == "float16"):
        raise ValueError(
            "--overlap_grad_reduce requires a pure data-parallel mesh "
            "(fsdp=pipe=seq=model=1) with a first-order optimizer "
            "(no --kfac) and bf16/fp32")
    if spec.pipe > 1 and args.dtype == "float16":
        raise ValueError("--dtype float16 is not supported with pipeline "
                         "parallelism; use bfloat16")


def setup_parallel(args, device_type: str) -> None:
    """Lay the run's ranks out as the mesh spec says and join them
    (parallel/launcher.py): sets ``args.rank``, ``args.world_size``,
    ``args.backend``, ``args.mesh_spec`` (resolved) and ``args.layout``
    (a ``parallel.mesh.Layout``, or None for a single process). Everything that depends only on the flags
    and the launcher's environment is checked before the rendezvous: the
    spec against the world size, ``dcn`` against the nodes, the refusals
    (:func:`refuse_layout`) and the accumulation math."""
    import torch.distributed as dist

    if dist.is_initialized():
        world = dist.get_world_size()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    else:
        found = launcher.discover(args.dist_init_method)
        world = found["world_size"] if found else 1
        local_world = found["local_world_size"] if found else 1
    spec = mesh_spec(args)
    spec.validate(packed=bool(args.pack_sequences))
    spec = mesh_lib.resolved(spec, world)
    mesh_lib.check_dcn(spec, world, local_world)
    refuse_layout(args, spec)
    accumulation_math(args, spec)
    topology = launcher.initialize(device_type,
                                   init_method=args.dist_init_method)
    args.rank, args.world_size = topology.rank, topology.world_size
    args.backend = topology.backend
    args.owns_group = topology.distributed and topology.source != "existing"
    args.mesh_spec = spec
    args.layout = None
    if topology.distributed:
        device_mesh = (mesh_lib.create_mesh(spec, device_type)
                       if spec.fsdp > 1 else None)
        args.layout = mesh_lib.make_layout(spec, args.rank, args.world_size,
                                           args.backend, device_mesh)
    args.data_index = args.layout.data_index if args.layout else 0


def accumulation_math(args, spec: mesh_lib.MeshSpec) -> None:
    """The accumulation math in global terms (JAX run_pretraining.py:
    444-451, 795): ``local_batch_size`` rows per data replica per
    microbatch, and under ``pipe`` at least as many microbatches as
    stages. Sets ``args.n_data``, ``args.accumulation_steps`` and
    ``args.host_batch_per_step``."""
    args.n_data = spec.dcn_data * spec.data * spec.fsdp
    global_microbatch = args.local_batch_size * args.n_data
    if args.global_batch_size % global_microbatch:
        raise ValueError(
            f"global_batch_size={args.global_batch_size} must be divisible "
            f"by local_batch_size*data_shards={global_microbatch}")
    args.accumulation_steps = args.global_batch_size // global_microbatch
    args.host_batch_per_step = args.global_batch_size // args.n_data
    if spec.pipe > 1:
        pipeline.check_microbatches(args.accumulation_steps, spec.pipe)


def data_parallel(args) -> "pretrain.DataParallel | None":
    """The train step's :class:`~bert_pytorch_tpu_torch.pretrain.
    DataParallel` for a run of several ranks (or one under a launcher),
    else None (the single-process step)."""
    if getattr(args, "layout", None) is None:
        return None
    return pretrain.DataParallel(
        rank=args.rank, world_size=args.world_size,
        fsdp=args.mesh_spec.fsdp > 1, overlap=args.overlap_grad_reduce,
        layout=args.layout)


def setup_training(args) -> argparse.Namespace:
    """Ranks and mesh, device, numerics, accumulation math and the
    checkpoint directory; the batches are unpacked until prepare_dataset
    finds packed data."""
    require_args(args, ["model_config_file", "output_dir",
                        "global_batch_size", "local_batch_size", "max_steps"])
    # The kernel libraries' directory, before anything loads one.
    build.set_build_dir(args.compile_cache_dir or None)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda but torch.cuda.is_available() is False; pass "
            "--device cpu to run on the CPU")
    args.attention_backend = BACKEND_ALIASES.get(args.attention_backend,
                                                 args.attention_backend)
    if args.attention_backend not in ("auto", "dense", "flash", "ring"):
        raise ValueError(
            f"attention_backend {args.attention_backend!r} is not one of "
            "auto, dense, flash, ring")
    setup_parallel(args, device.type)
    if device.type == "cuda" and args.layout is not None:
        device = torch.device("cuda", torch.cuda.current_device())
    args.device = device
    args.remat = args.remat or ("full" if args.checkpoint_activations
                                else "none")
    if args.mesh_spec.seq > 1 and args.attention_backend != "ring":
        # A seq axis exists to avoid O(S^2) attention (JAX
        # run_pretraining.py:463-470): the ring, never a silent dense path.
        log({"event": "attention_backend", "was": args.attention_backend,
             "now": "ring", "reason": "mesh seq>1"})
        args.attention_backend = "ring"
    args.layer_norm_backend = resolve_backend(args.layer_norm_backend)
    if args.dtype not in DTYPES:
        raise ValueError(f"dtype {args.dtype!r} is not one of {sorted(DTYPES)}")
    if args.dtype == "float16" and args.kfac:
        raise ValueError(
            "--dtype float16 is the first-order parity mode; K-FAC runs in "
            "bf16/f32 (no loss scaler needed)")
    args.packed, args.pack_k = False, 1
    args.model_output_dir = os.path.join(args.output_dir, "pretrain_ckpts")
    os.makedirs(args.model_output_dir, exist_ok=True)
    if args.layout is not None:
        spec = args.mesh_spec
        log({"event": "mesh", "dcn": spec.dcn_data, "data": spec.data,
             "fsdp": spec.fsdp, "world_size": args.world_size,
             "backend": args.backend, "pipe": spec.pipe, "seq": spec.seq,
             "model": spec.model,
             "transport": ",".join(f"{k}={v}" for k, v in
                                   args.layout.transports().items())
             or "none", "spec": spec.canonical(), "device": str(device)})
    # The telemetry paths (JAX run_pretraining.py:394-399): the sink shared
    # by the train records and the telemetry facade, the heartbeat and the
    # profiler's traces.
    args.telemetry_jsonl = telemetry.default_jsonl_path(
        args, args.output_dir, args.log_prefix)
    args.heartbeat_file = args.heartbeat_file or os.path.join(
        args.output_dir, "heartbeat.json")
    args.profile_dir = args.profile_dir or os.path.join(
        args.output_dir, "profile")
    telemetry.parse_profile_spec(args.profile_steps)  # fail before any work
    if device.type == "cuda":
        # fp32 products in full fp32, as the JAX package's parity tests.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(args.seed)
    return args


def prepare_model(args):
    """(model with seeded random weights, config); vocab padded to a
    multiple of 8 as the reference does (run_pretraining.py:237). Every
    rank draws the same weights; under ``fsdp`` > 1 FSDP2 then shards
    them (parallel/sharding.py)."""
    config = BertConfig.from_json_file(args.model_config_file)
    if config.vocab_size % 8 != 0:
        config.vocab_size += 8 - (config.vocab_size % 8)
    model = BertForPreTraining(
        config, dtype=DTYPES[args.dtype],
        attention_backend=args.attention_backend, remat=args.remat,
        device=args.device, layer_norm_backend=args.layer_norm_backend)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    init_weights(model, config.initializer_range, gen)
    layout = getattr(args, "layout", None)
    model = mesh_lib.place_model(model, layout)
    model = sharding.shard_model(
        model, layout.device_mesh if layout is not None else None)
    mesh_lib.mark_norms(model, layout)
    return model, config


def prepare_optimizer(args, model):
    """(LAMB or AdamW over the no-decay param groups, in fp16 wrapped in
    ``DynamicLossScale``; schedule)."""
    schedule = make_schedule(args.lr_decay, args.learning_rate,
                             args.warmup_proportion, args.max_steps)
    groups = param_groups(model, args.weight_decay)
    if args.optimizer == "lamb":
        optimizer = Lamb(groups, schedule, weight_decay=args.weight_decay,
                         max_grad_norm=args.max_grad_norm)
    else:
        optimizer = AdamW(groups, schedule, weight_decay=args.weight_decay)
    if args.dtype == "float16":
        optimizer = DynamicLossScale(
            optimizer, init_scale=args.init_loss_scale,
            growth_interval=args.loss_scale_growth_interval)
    return optimizer, schedule


def mask_token_id(config) -> int:
    """``mask_token_id`` of the model config, else the id its tokenizer
    gives ``[MASK]``, else ``<mask>`` (the RoBERTa convention), else 4
    (the synthetic-data default) when the config names no ``vocab_file``
    or the file does not exist (JAX run_pretraining.py:582-599). The
    tokenizer is the one the config's ``tokenizer`` key names
    (``"wordpiece"`` or ``"bpe"``), lower-casing unless ``lowercase`` is
    false, on the C++ core."""
    found = getattr(config, "mask_token_id", None)
    vocab_file = getattr(config, "vocab_file", None)
    if found is None and vocab_file and os.path.exists(vocab_file):
        tok = get_tokenizer(getattr(config, "tokenizer", "wordpiece"),
                            vocab_file,
                            uppercase=not getattr(config, "lowercase", True))
        found = tok.token_to_id("[MASK]")
        if found is None:
            found = tok.token_to_id("<mask>")
    return 4 if found is None else int(found)


def prepare_kfac(args, model, config):
    """(KFAC, its zeroed state) with ``--kfac``, else (None, None) (JAX
    run_pretraining.py:725-785). Under ``pipe`` the capture falls back to
    the stats pass (logged), as the JAX runner's. The fused capture runs
    on the run's model, split or not, and sums over the ``grad`` group
    (the data replicas, and under ``seq`` the token shards); the stats
    pass of a model split over ``fsdp``, ``pipe`` or ``model``, or on the
    ring, runs on a whole-model twin, which takes the run's weights
    gathered whole before each factor update (:func:`whole_parts` of
    ``sharding.full_state_dict``), and sums over the data replicas."""
    if not args.kfac:
        return None, None
    layout = getattr(args, "layout", None)
    tapped = model
    if args.mesh_spec.pipe > 1 and args.kfac_capture == "train":
        log({"event": "kfac_capture", "was": "train", "now": "stats",
             "reason": "pipeline parallelism has no fused capture"})
        args.kfac_capture = "stats"
    group = None
    if layout is not None:
        # The fused capture's taps see this rank's rows and, under seq,
        # its tokens; the twin sees the data coordinate's whole rows.
        group = layout.groups["grad" if args.kfac_capture == "train"
                              else "batch"]
    split = args.mesh_spec.active_axes() - {mesh_lib.AXIS_DATA}
    if args.kfac_capture == "stats" and split:
        tapped = BertForPreTraining(
            config, dtype=DTYPES[args.dtype],
            attention_backend=("auto" if args.attention_backend == "ring"
                               else args.attention_backend),
            device=args.device, layer_norm_backend=args.layer_norm_backend)
    kfac = KFAC(tapped, factor_decay=args.kfac_stat_decay,
                damping=args.kfac_damping, kl_clip=args.kfac_kl_clip,
                inv_method=args.kfac_inv_method,
                skip_layers=tuple(args.kfac_skip_layers),
                group=group, replicas=getattr(args, "n_data", 1))
    kfac_state = kfac.init()
    log({"event": "kfac", "layer_groups": len(kfac.specs),
         "capture": ("train (fused)" if args.kfac_capture == "train"
                     else "stats"),
         "microbatches": args.kfac_capture_microbatches,
         "inv_method": args.kfac_inv_method, "damping": args.kfac_damping,
         "kl_clip": args.kfac_kl_clip,
         "factor_interval": args.kfac_factor_interval,
         "inv_interval": args.kfac_inv_interval,
         "state_bytes": kfac_state.nbytes()})
    return kfac, kfac_state


def restore_checkpoint(args, model, optimizer, kfac=None, kfac_state=None):
    """Resume from the newest checkpoint of ``args.model_output_dir`` that
    verifies (the walk-back logs each skipped file); returns (its extras:
    sampler, epoch, count, preconditioner, or None with no checkpoint, the
    step within the phase). With ``--previous_phase_end_step`` N > 0 and a
    checkpoint at step >= N, the optimizer count becomes the step within
    the phase and the moments stay (the phase-2 surgery, JAX
    run_pretraining.py:717-721); an N above the checkpoint's step raises.
    With ``kfac_state`` a checkpoint's preconditioner restores into it and
    the inverses are recomputed from the restored factors (the file may
    hold the other inverse method's operators; JAX :766-777)."""
    skipped: list = []
    t0 = time.perf_counter()
    found = ckpt.load_latest_checkpoint(
        args.model_output_dir, model, optimizer, on_skip=skipped.append,
        preconditioner=kfac_state, agree=dist_utils.agree_on_resume_step)
    for record in skipped:
        log({"event": "resume_skip", **record})
    args.resume_step = 0
    if found is None:
        if skipped:
            log({"event": "resume_walk_back_exhausted",
                 "skipped": len(skipped),
                 "note": "NO loadable checkpoint: every retained checkpoint "
                         "failed verification; training restarts from "
                         "scratch"})
            append_record(args.telemetry_jsonl, {
                "kind": "fault", "tag": "telemetry",
                "fault": "resume_walk_back_exhausted", "injected": False,
                "step": 0, "skipped": skipped})
        return None, 0
    resume_step, extras = found
    args.resume_step = resume_step
    if args.previous_phase_end_step > resume_step:
        raise ValueError(
            f"previous_phase_end_step={args.previous_phase_end_step} cannot "
            f"be larger than resume_step={resume_step}")
    global_step = resume_step - args.previous_phase_end_step
    if resume_step >= args.previous_phase_end_step > 0:
        reset_count(optimizer, global_step)
    restored = extras.get("preconditioner", False)
    if restored:
        kfac.update_inverses(kfac_state)
    log({"event": "resume", "step": resume_step, "global_step": global_step,
         "optimizer_count": optimizer.param_groups[0]["count"],
         **({"loss_scale": optimizer.scale}
            if isinstance(optimizer, DynamicLossScale) else {}),
         "preconditioner": int(restored),
         "skipped": len(skipped),
         "seconds": time.perf_counter() - t0})
    # Which step resumed and what the walk-back passed over (JAX
    # run_pretraining.py:537-542).
    append_record(args.telemetry_jsonl, {
        "kind": "resume", "tag": "telemetry", "step": int(resume_step),
        "skipped": skipped})
    return extras, global_step


def shard_dataset(args, config, input_dir: str, seed: int):
    """The shards under ``input_dir`` with the run's masking (``seed``;
    callers add the rank) and the data path's retries and policy; retries
    and skips go to the run's JSONL as ``fault`` records (``train`` points
    ``on_fault`` at its telemetry while it runs)."""
    def on_fault(record):
        append_record(args.telemetry_jsonl, record)

    return ShardedPretrainingDataset(
        input_files(input_dir), mask_token_id(config),
        args.max_predictions_per_seq, args.masked_token_fraction,
        vocab_size=int(config.vocab_size), seed=seed,
        read_retries=args.data_read_retries,
        retry_base_delay_s=args.data_retry_base_s,
        shard_error_policy=args.shard_error_policy,
        on_fault=on_fault)


def prepare_dataset(args, config, checkpoint=None, dataset=None):
    """(loader of global batches, sampler) over the shards of
    ``--input_dir``, or over ``dataset`` when one is given (any object
    with the shard dataset's items); the sampler resumes from
    ``checkpoint``'s position. Sets ``args.packed`` and ``args.pack_k``
    (sequences per row) from the data."""
    if dataset is None:
        require_args(args, ["input_dir"])
        dataset = shard_dataset(args, config, args.input_dir,
                                args.seed + getattr(args, "data_index", 0))
    args.packed = bool(dataset.packed)
    args.pack_k = dataset.max_sequences_per_pack if dataset.packed else 1
    if not dataset.packed and args.pack_sequences:
        from bert_pytorch_tpu_torch.data.packing import (
            PackedPretrainingDataset)

        dataset = PackedPretrainingDataset(
            dataset, max_sequences_per_pack=args.max_sequences_per_pack)
        args.packed = True
        args.pack_k = args.max_sequences_per_pack
    sampler = DistributedSampler(dataset, num_replicas=args.n_data,
                                 rank=args.data_index)
    if checkpoint is not None and checkpoint.get("sampler") is not None:
        sampler.load_state_dict(checkpoint["sampler"])
    loader = DataLoader(dataset, sampler,
                        batch_size=args.host_batch_per_step, drop_last=True,
                        num_workers=args.num_workers)
    if len(loader) == 0:
        raise ValueError(
            f"{len(dataset)} samples do not fill one global batch of "
            f"{args.global_batch_size} over {args.n_data} data replicas")
    return loader, sampler


def prepare_val_loader(args, config, val_dataset=None):
    """The held-out loader (this data coordinate's rows of each global
    batch, a thread) over the shards of ``--val_input_dir`` masked under
    ``seed + 7919 + data coordinate``, or over ``val_dataset``; None
    without either."""
    if val_dataset is None:
        if not args.val_input_dir:
            return None
        val_dataset = shard_dataset(args, config, args.val_input_dir,
                                    args.seed + VAL_SEED_OFFSET
                                    + args.data_index)
    return DataLoader(val_dataset,
                      DistributedSampler(val_dataset,
                                         num_replicas=args.n_data,
                                         rank=args.data_index),
                      batch_size=args.host_batch_per_step, drop_last=True)


def make_validation(args, model, config, val_loader, logger,
                    instrument=None):
    """``run(step, epoch)``: one held-out pass (the JAX runner's
    ``run_validation``). Every pass evaluates the same batches: the
    sampler restarts at 0, and the pass takes ``min(--eval_batches, the
    batches the held-out set fills)`` (``run.batches``); it logs and
    returns the ``val`` record (None when the set fills no batch).
    ``instrument`` (``TrainTelemetry.instrument``) wraps the eval step as
    ``"eval_step"``."""
    eval_step = pretrain.make_eval_step(
        model, next_sentence=bool(config.next_sentence),
        data_parallel=data_parallel(args))
    if instrument is not None:
        eval_step = instrument(eval_step, "eval_step")
    n_batches = min(args.eval_batches,
                    len(val_loader.sampler) // args.host_batch_per_step)

    def run(step: int, epoch: int):
        if n_batches == 0:
            return None
        val_loader.sampler.index = 0
        loss_sum = acc_sum = 0.0
        n = 0
        batches = iter(val_loader)
        try:
            for host_batch in batches:
                loss, acc = eval_step(pretrain.to_device(host_batch,
                                                         args.device))
                loss_sum += float(loss)
                acc_sum += float(acc)
                n += 1
                if n >= n_batches:
                    break
        finally:
            batches.close()
        record = {"step": step, "epoch": epoch,
                  "average_loss": loss_sum / n, "mlm_accuracy": acc_sum / n}
        log({"event": "val", **record})
        logger.log(tag="val", **record)
        return record

    run.batches = n_batches
    return run


def make_step(args, model, optimizer, schedule, config, kfac=None,
              kfac_state=None):
    """The train step for this run, ``step(batch) -> metrics``: the per-row
    MLM gather cap is ``max_predictions_per_seq`` per packed sequence. With
    ``kfac`` it preconditions ``kfac_state``'s way and follows the JAX
    runner's dispatch (run_pretraining.py:940-980): ``--kfac_capture
    train`` does everything inside the step; ``stats`` first runs the stats
    pass on steps where the phase's step (the optimizer count, which
    restore_checkpoint keeps equal to it) is a multiple of
    ``--kfac_factor_interval``, then the inverses where it is one of
    ``--kfac_inv_interval``. The grad-health block follows
    ``--grad_stats_every``, counted from the optimizer count the step is
    built at (the run's start)."""
    fused = kfac is not None and args.kfac_capture == "train"
    common = dict(next_sentence=config.next_sentence,
                  max_pred_per_seq=args.max_predictions_per_seq * args.pack_k,
                  generator=torch.Generator().manual_seed(args.seed),
                  kfac=kfac, stats_every=telemetry.stats_every(args),
                  stats_phase=opt_step_count(optimizer),
                  data_parallel=data_parallel(args))
    if args.mesh_spec.pipe > 1:
        train_step = pretrain.make_pp_train_step(model, optimizer, schedule,
                                                 **common)
    else:
        train_step = pretrain.make_train_step(
            model, optimizer, schedule, kfac_fused=fused,
            kfac_factor_interval=args.kfac_factor_interval,
            kfac_inv_interval=args.kfac_inv_interval if fused else 0,
            kfac_capture_microbatches=args.kfac_capture_microbatches,
            loss_scale=args.dtype == "float16", **common)
    if kfac is None:
        return train_step
    if fused:
        return lambda batch: train_step(batch, kfac_state)
    # The stats pass's loss runs without remat, as the JAX stats twin.
    layout = getattr(args, "layout", None)
    kfac.apply_loss = pretrain.make_kfac_loss(
        kfac.model, next_sentence=config.next_sentence,
        max_pred_per_seq=args.max_predictions_per_seq * args.pack_k,
        group=kfac.group)
    layers = config.num_hidden_layers
    # The stats rows of each data replica (JAX strides them over the
    # global microbatch 0, so each replica's share is its own rows').
    n_stats = (args.kfac_stats_batch // args.n_data
               if args.kfac_stats_batch else 0)

    def stats_step(batch):
        global_step = opt_step_count(optimizer)
        if global_step % args.kfac_factor_interval == 0:
            if kfac.model is not model:
                kfac.model.load_state_dict(whole_parts(model)(
                    sharding.full_state_dict(model)))
            kfac.update_factors(
                kfac_state, stats_rows(batch, n_stats),
                draw_dropout_seeds(torch.Generator().manual_seed(
                    (args.seed + KFAC_STATS_SEED_OFFSET) * 2 ** 32
                    + global_step), layers))
        if global_step % args.kfac_inv_interval == 0:
            kfac.update_inverses(kfac_state)
        return train_step(batch, kfac_state)

    return stats_step


def stats_rows(batch: dict, n_stats: int) -> dict:
    """The stats pass's microbatch: ``n_stats`` rows of microbatch 0 taken
    strided (so every shard of a global batch would contribute), or all of
    it for ``n_stats`` 0 or not under its size."""
    rows = batch["input_ids"].shape[1]
    if n_stats and n_stats < rows:
        stride = rows // n_stats
        return {k: v[0][::stride][:n_stats] for k, v in batch.items()}
    return {k: v[0] for k, v in batch.items()}


def checkpoint_contents(model, optimizer, config, sampler_state: dict,
                        epoch: int, kfac_state=None,
                        layout: str = "gathered") -> dict:
    """The training checkpoint's tree, in the JAX package's layout, its
    tensors on the model's device (the transposes and layer stacks run
    there; the writer copies one leaf at a time to the host); with
    ``kfac_state``, its ``preconditioner``. Gathered under FSDP, ``pipe``
    or ``model``, every split tensor is gathered whole first (a
    collective: every rank calls this); ``layout="sharded"`` holds this rank's shards as slice
    records instead (utils/checkpoint.py ``sharded_training_state``)."""
    if layout == "sharded":
        contents = ckpt.sharded_training_state(model, optimizer, config)
    else:
        regroup = whole_parts(model)
        state = regroup(sharding.full_state_dict(model))
        contents = {"model": to_jax_params(state, config, "pretraining",
                                           keep_device=True),
                    "optimizer": optimizer_to_jax(model, optimizer, config,
                                                  "pretraining",
                                                  keep_device=True,
                                                  regroup=regroup)}
    contents.update(sampler=sampler_state, epoch=int(epoch))
    if kfac_state is not None:
        contents["preconditioner"] = kfac_state.state_dict()
    return contents


def whole_parts(model):
    """``regroup(named) -> whole tensors``: the ``pipe`` and ``model`` parts
    of a state gathered (parallel/state.py; a collective), or the state
    itself for a model split over neither."""
    layout = getattr(model, "layout", None)
    if layout is None or not layout.model_parallel:
        return lambda named: named
    return lambda named: state_lib.gather_full(
        named, layout.axis(mesh_lib.AXIS_MODEL),
        layout.axis(mesh_lib.AXIS_PIPE), model.config.num_hidden_layers)


def write_checkpoint(output_dir: str, step: int, model, optimizer, config,
                     sampler_state: dict, epoch: int, layout: str = "gathered",
                     async_write: bool = False, mesh_spec=None, keep: int = 3,
                     kfac_state=None) -> None:
    """:func:`checkpoint_contents` written as ``ckpt_{step}`` in
    ``layout`` (every rank calls it: the gathered layout's gathers are
    collectives, the sharded layout's shards are every rank's)."""
    ckpt.save_checkpoint(
        output_dir, step,
        checkpoint_contents(model, optimizer, config, sampler_state, epoch,
                            kfac_state, layout),
        keep=keep, async_write=async_write, layout=layout,
        mesh_spec=mesh_spec)


def save(args, model, optimizer, config, global_step: int,
         sampler_state: dict, epoch: int, async_write: bool,
         kfac_state=None, logger=None) -> float:
    """Save at ``global_step`` (numbered ``previous_phase_end_step`` +
    it); returns the seconds the call took (an async save's stall)."""
    t0 = time.perf_counter()
    save_step = global_step + args.previous_phase_end_step
    write_checkpoint(args.model_output_dir, save_step, model, optimizer,
                     config, sampler_state, epoch, args.checkpoint_layout,
                     async_write, args.mesh_spec.as_dict(),
                     args.keep_checkpoints, kfac_state)
    stall = time.perf_counter() - t0
    log({"event": "checkpoint", "step": save_step,
         "mode": "async" if async_write else "sync", "stall_s": stall},
        logger)
    return stall


def open_logger(args) -> logging_util.Logger:
    """The run's file sinks (JAX run_pretraining.py:400-415): the text
    log, the metrics CSV and the JSONL sink (``logger.handlers[-1]``),
    appended to across resumed runs; rank 0's only. Standard output is
    ``log``'s."""
    primary = dist_utils.is_main_process()
    logger = logging_util.Logger()
    logger.init([
        logging_util.FileHandler(
            os.path.join(args.output_dir, args.log_prefix + ".txt"),
            is_primary=primary),
        logging_util.CSVHandler(
            os.path.join(args.output_dir, args.log_prefix + "_metrics.csv"),
            is_primary=primary),
        logging_util.JSONLHandler(args.telemetry_jsonl, is_primary=primary)])
    return logger


def train(args, model, optimizer, config, step, loader, sampler,
          checkpoint=None, global_step: int = 0, kfac_state=None,
          val_loader=None) -> dict:
    """The training loop from ``global_step``: ``--steps`` steps (or to
    ``--max_steps``), the cadence and final saves, and the stop on a
    preemption signal, threaded through the telemetry facade (step
    windows, sentinels, grad health, heartbeat, profiler window; JAX
    run_pretraining.py:827-848, 1001-1215). Returns the last logged
    metrics with ``global_step``, ``terminated_by_signal``,
    ``training_seq_per_sec`` and ``training_mfu`` (the steps after the
    first), the wall time of each step (``step_times``: (start, end)
    perf_counter pairs; a step's end is read after its metrics, when it
    is logged), each save's stall (``saves``) and the held-out records
    (``val``; with ``val_loader``, every ``--num_steps_per_eval`` steps).
    Each epoch's batches come through a device prefetcher
    (``--device_prefetch``), closed when the epoch is left. ``kfac_state``
    goes into every save. The armed fault plan poisons metrics before the
    sentinel sees a step and fires its process faults after the step's
    checkpoint block. Under ``--sentinel_policy abort`` a diverged run
    raises ``NonFiniteError``."""
    steps_this_run = args.steps or (args.max_steps - global_step)
    steps_this_run = min(steps_this_run, args.max_steps - global_step)
    epoch = int(checkpoint["epoch"]) if checkpoint and checkpoint.get(
        "epoch") is not None else 0
    # Inert unless --fault_spec or BERT_FAULTS armed it.
    fault_plan = (faults.arm(args.fault_spec) if args.fault_spec
                  else faults.get_plan())
    logger = open_logger(args)
    eff_max_pred = args.max_predictions_per_seq * args.pack_k
    seq_len = config.max_position_embeddings
    try:
        tele = telemetry.from_args(
            args, sink=logger.handlers[-1],
            seq_per_step=args.global_batch_size,
            flops_per_seq=flops_util.bert_train_flops_per_seq(
                config, seq_len, eff_max_pred,
                next_sentence=bool(config.next_sentence)),
            tokens_per_step=args.global_batch_size * seq_len,
            output_dir=args.output_dir, device=args.device,
            process="pretrain", logger=logger,
            is_primary=dist_utils.is_main_process(),
            n_devices=args.world_size)
    except BaseException:
        logger.close()
        raise
    tele.attach_loader(loader)
    # The shard readers' fault records go through the telemetry's sink
    # while it is open (ordered with the step records), to the file
    # before and after.
    fault_sinks = [(ds, ds.on_fault) for ds in (
        loader.dataset,
        val_loader.dataset if val_loader is not None else None)
        if isinstance(ds, ShardedPretrainingDataset)]
    for ds, _ in fault_sinks:
        ds.on_fault = tele.emit
    # The config's mask id (the one the shards are masked with), logged
    # and returned with the run.
    mask_id = mask_token_id(config)
    # Compile and cost attribution (JAX run_pretraining.py:848-858): the
    # first call of each shapes digest emits compile + compile_cost.
    step = tele.instrument(step, "train_step",
                           memory_util.training_state(model, optimizer))
    validate = (make_validation(args, model, config, val_loader, logger,
                                instrument=tele.instrument)
                if val_loader is not None else None)
    log({"event": "start", "device": str(args.device),
         "dtype": args.dtype, "attention_backend": args.attention_backend,
         "remat": args.remat, "layer_norm_backend": args.layer_norm_backend,
         "accumulation_steps": args.accumulation_steps,
         "samples": len(loader.dataset), "packed": int(args.packed),
         "global_step": global_step, "steps": steps_this_run,
         "mask_token_id": mask_id}, logger)
    # The position of the last TRAINED sample of the epoch: the loader's
    # read-ahead moves the sampler's live index past it, so checkpoints
    # save this (JAX run_pretraining.py:926-938).
    trained_index = sampler.index

    def sampler_state() -> dict:
        state = sampler.state_dict()
        state["index"] = trained_index
        return state

    last: dict = {}
    step_times, saves, val_records = [], [], []
    step_in_run, terminated, done = 0, False, steps_this_run <= 0
    window_t0, window_steps = time.perf_counter(), 0
    data_seq_len, train_start, samples_seen = None, time.perf_counter(), 0
    stop = preemption.GracefulStop()
    if args.term_check_steps:
        stop.install()
    prefetcher = None
    try:
        while not done:
            sampler.set_epoch(epoch)
            # One prefetcher per epoch (a one-shot iterator), closed below
            # or in the finally, so a left epoch leaks no thread.
            prefetcher = pretrain.device_prefetch(
                loader, args.accumulation_steps, args.device,
                depth=args.device_prefetch)
            tele.attach_prefetcher(prefetcher)
            for batch in tele.timed(prefetcher):
                t_start = time.perf_counter()
                # Profiler window in step-in-run terms: this iteration runs
                # step step_in_run + 1.
                tele.profiler.maybe_start(step_in_run + 1)
                with tele.profiler.annotation(step_in_run + 1):
                    metrics = step(batch)
                tele.dispatch_done()
                global_step += 1
                step_in_run += 1
                window_steps += 1
                trained_index += args.host_batch_per_step
                if data_seq_len is None:
                    # MFU must use the DATA shape, not the model's cap.
                    data_seq_len = int(batch["input_ids"].shape[-1])
                    tele.timer.flops_per_seq = (
                        flops_util.bert_train_flops_per_seq(
                            config, data_seq_len, eff_max_pred,
                            # Host-resident: a config flag.
                            # torchlint: disable=HS101
                            next_sentence=bool(config.next_sentence)))
                    tele.timer.tokens_per_step = (
                        args.global_batch_size * data_seq_len)
                if step_in_run == 1:
                    # The run's throughput starts once the first step has
                    # run (its kernel builds and allocator warm-up stay
                    # out, as the JAX runner leaves its compile out).
                    if args.device.type == "cuda":
                        torch.cuda.synchronize(args.device)
                    train_start = time.perf_counter()
                else:
                    samples_seen += args.global_batch_size
                finished = (step_in_run >= steps_this_run
                            or global_step >= args.max_steps)
                if fault_plan.active:
                    # An armed NaN replaces this step's metrics before the
                    # sentinel observes them.
                    metrics = fault_plan.poison_metrics(global_step, metrics,
                                                        emit=tele.emit)
                # Step close-out: device sync (per cadence), step window,
                # sentinel policy, grad health, heartbeat, profiler
                # auto-stop. NonFiniteError propagates under
                # --sentinel_policy abort.
                tele.step_done(global_step, metrics, profile_step=step_in_run)
                if global_step % args.log_steps == 0 or finished:
                    values = {k: float(v) for k, v in metrics.items()}
                    if not tele.last_step_synced:
                        # The float() reads above were this step's sync:
                        # feed the sentinel and heartbeat that missed the
                        # cadence.
                        tele.sentinel.observe(global_step, values["finite"],
                                              values["loss"])
                        tele.heartbeat.beat(global_step, values["loss"])
                    elapsed = time.perf_counter() - window_t0
                    last = dict(step=global_step, **values,
                                seq_per_s=window_steps
                                * args.global_batch_size / elapsed)
                    log(last)
                    logger.log(tag="train", epoch=epoch, **last)
                    window_t0, window_steps = time.perf_counter(), 0
                step_times.append((t_start, time.perf_counter()))
                if (validate is not None
                        and global_step % args.num_steps_per_eval == 0):
                    record = validate(global_step, epoch)
                    if record is not None:
                        val_records.append(record)
                if global_step % args.num_steps_per_checkpoint == 0:
                    with tele.checkpoint_stall():
                        saves.append({"step": global_step, "stall_s": save(
                            args, model, optimizer, config, global_step,
                            sampler_state(), epoch,
                            args.checkpoint_write == "async", kfac_state,
                            logger)})
                if fault_plan.active:
                    # die/term/hang after the checkpoint block: die@N
                    # resumes from what N's cadence wrote.
                    fault_plan.fire_process_faults(global_step,
                                                   emit=tele.emit)
                if (args.term_check_steps
                        and global_step % args.term_check_steps == 0
                        and stop.requested):
                    record = preemption.preemption_record(global_step, stop)
                    log({"event": "termination signal",
                         "signal": stop.signal_name,
                         "exit_code": preemption.EXIT_PREEMPTED, **record},
                        logger)
                    tele.emit(record)
                    terminated = done = True
                    break
                if finished:
                    done = True
                    break
            else:
                prefetcher.close()
                epoch += 1
                trained_index = 0
                continue
            break
        if tele.profiler.active:  # the run ended inside the profile window
            tele.profiler.stop()
        if tele.profiler.last_trace:
            logger.info(f"profiler trace written to {tele.profiler.last_trace}")
        train_time = time.perf_counter() - train_start
        seq_per_sec = samples_seen / max(train_time, 1e-9)
        train_mfu = flops_util.mfu(seq_per_sec, tele.timer.flops_per_seq,
                                   tele.timer.device_kind)
        logger.info(f"Total time: {train_time:.2f} s")
        logger.info(f"training_seq_per_sec = {seq_per_sec:.2f}")
        if train_mfu:
            logger.info(f"training_mfu = {train_mfu:.4f}")
        # The final save; a preemption's is written even with
        # --skip_final_checkpoint. Synchronous: it joins a pending write to
        # the directory first, so checkpoints land in order.
        if not args.skip_final_checkpoint or terminated:
            with tele.checkpoint_stall():
                saves.append({"step": global_step, "stall_s": save(
                    args, model, optimizer, config, global_step,
                    sampler_state(), epoch, async_write=False,
                    kfac_state=kfac_state, logger=logger)})
        ckpt.wait_for_pending_save()
        run_summary = {"training_seq_per_sec": round(seq_per_sec, 2),
                       "training_mfu": round(train_mfu, 4),
                       "terminated_by_signal": terminated}
        run_eff = tele.timer.run_padding_efficiency()
        if run_eff is not None:
            run_summary["padding_efficiency"] = round(run_eff, 4)
            run_summary["real_tokens_per_sec"] = round(
                seq_per_sec * (data_seq_len or seq_len) * run_eff, 2)
        # The partial window, the final heartbeat and the run summary.
        tele.finish(global_step, summary=run_summary)
    finally:
        if prefetcher is not None:
            prefetcher.close()
        for ds, on_fault in fault_sinks:
            ds.on_fault = on_fault
        stop.restore()
        tele.close()
        logger.close()
    return dict(last, global_step=global_step, terminated_by_signal=terminated,
                training_seq_per_sec=seq_per_sec, training_mfu=train_mfu,
                step_times=step_times, saves=saves, val=val_records,
                mask_token_id=mask_id)


def main(args, dataset=None, val_dataset=None) -> dict:
    """A whole run; ``dataset`` stands in for the shards of
    ``--input_dir`` (prepare_dataset), ``val_dataset`` for those of
    ``--val_input_dir`` (prepare_val_loader). A run that formed its
    process group destroys it at the end."""
    try:
        return _main(args, dataset, val_dataset)
    finally:
        if getattr(args, "owns_group", False):
            launcher.shutdown()


def _main(args, dataset=None, val_dataset=None) -> dict:
    args = setup_training(args)
    model, config = prepare_model(args)
    optimizer, schedule = prepare_optimizer(args, model)
    kfac, kfac_state = prepare_kfac(args, model, config)
    checkpoint, global_step = restore_checkpoint(args, model, optimizer,
                                                 kfac, kfac_state)
    loader, sampler = prepare_dataset(args, config, checkpoint, dataset)
    val_loader = prepare_val_loader(args, config, val_dataset)
    step = make_step(args, model, optimizer, schedule, config, kfac,
                     kfac_state)
    return train(args, model, optimizer, config, step, loader, sampler,
                 checkpoint, global_step, kfac_state, val_loader)


if __name__ == "__main__":
    summary = main(parse_arguments())
    if summary["terminated_by_signal"]:
        sys.exit(preemption.EXIT_PREEMPTED)
    sys.exit(0 if summary.get("finite", 1.0) == 1.0 else 1)
