"""What the port's GLUE, NER and SWAG runners share: the JAX runners'
fixed-shape batching (``run_glue.batches``, which ``run_swag`` imports
too), the device and model set-up, AdamW without bias correction over the
no-decay groups, the train step (dropout from per-step seeds, global-norm
clipping, one optimizer step, the grad-health block on due steps), the
telemetry facade (:func:`open_telemetry`), the staging of a (batch,
valid) item for ``data/device_prefetch.py`` (:func:`put_valid_batch`,
``--device_prefetch``), and the model-only checkpoint of ``{"model"}`` in the JAX package's layout.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Optional

import numpy as np
import torch

from bert_pytorch_tpu_torch import telemetry
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.data.tokenization import (check_tokenizer_files,
                                                      get_tokenizer)
from bert_pytorch_tpu_torch.models.bert import draw_dropout_seeds, init_weights
from bert_pytorch_tpu_torch.models.convert import (check_pretrained_path,
                                                   load_pretrained_encoder,
                                                   to_jax_params)
from bert_pytorch_tpu_torch.optim.transforms import (AdamW, LearningRate,
                                                     global_norm,
                                                     param_groups)
from bert_pytorch_tpu_torch.telemetry import model_stats
from bert_pytorch_tpu_torch.utils import checkpoint as ckpt
from bert_pytorch_tpu_torch.utils import logging as logging_util

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def read_vocab_args(args, checkpoint_flag: str = "init_checkpoint"
                    ) -> argparse.Namespace:
    """``vocab_file`` and ``tokenizer`` (``wordpiece`` or ``bpe``) from
    the model config when the command line omits them (the JAX runners'
    rule). Missing tokenizer files and an unreadable ``--<checkpoint_flag>``
    (a missing file, a TF ``.index`` that is not one) are refused here,
    by name, before any weights load."""
    with open(args.model_config_file, encoding="utf-8") as f:
        configs = json.load(f)
    if args.vocab_file is None:
        args.vocab_file = configs.get("vocab_file")
        if args.vocab_file is None:
            raise ValueError("vocab_file must be in model config or CLI")
    if args.tokenizer is None:
        args.tokenizer = configs.get("tokenizer", "wordpiece")
    check_tokenizer_files(args.tokenizer, args.vocab_file)
    if getattr(args, checkpoint_flag, None):
        check_pretrained_path(getattr(args, checkpoint_flag))
    return args


def make_tokenizer(args):
    """The ``--tokenizer`` of ``args`` on the C++ core (data/
    tokenization.py ``get_tokenizer``), lower-casing unless
    ``--uppercase``."""
    return get_tokenizer(args.tokenizer, args.vocab_file,
                         uppercase=args.uppercase)


def setup_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda but torch.cuda.is_available() is False; pass "
            "--device cpu to run on the CPU")
    if device.type == "cuda":
        # fp32 products in full fp32, as the JAX package's parity tests.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def load_config(path: str) -> BertConfig:
    """The model config, its vocab padded to a multiple of 8."""
    config = BertConfig.from_json_file(path)
    if config.vocab_size % 8 != 0:
        config.vocab_size += 8 - (config.vocab_size % 8)
    return config


def init_model(model: torch.nn.Module, config: BertConfig, seed: int,
               init_checkpoint: Optional[str]) -> torch.nn.Module:
    """Seeded random weights, then the encoder of ``init_checkpoint`` (a
    JAX-layout msgpack checkpoint, a torch archive or a TF checkpoint)
    when one is named;
    a checkpoint that cannot be read fails here."""
    device = next(model.parameters()).device
    init_weights(model, config.initializer_range,
                 torch.Generator(device=device).manual_seed(seed))
    if init_checkpoint:
        load_pretrained_encoder(init_checkpoint, config, model)
        print(f"loaded pretrained encoder from {init_checkpoint}",
              flush=True)
    return model


def adamw(model: torch.nn.Module, lr: LearningRate,
          weight_decay: float) -> AdamW:
    """AdamW without bias correction (the reference's FusedAdam recipe)
    over the no-decay parameter groups."""
    return AdamW(param_groups(model, weight_decay), lr,
                 weight_decay=weight_decay, bias_correction=False)


def batches(arrays: dict, batch_size: int, shuffle: bool, rng):
    """Yield (batch, valid) of dict minibatches; the last partial batch is
    padded to a full one with repeated rows and a ``valid`` mask (the JAX
    run_glue.py ``batches``)."""
    n = len(arrays["labels"])
    order = rng.permutation(n) if shuffle else np.arange(n)
    for i in range(0, n, batch_size):
        idx = order[i:i + batch_size]
        valid = np.ones(batch_size, bool)
        if len(idx) < batch_size:
            valid[len(idx):] = False
            idx = np.concatenate([idx, np.zeros(batch_size - len(idx),
                                                idx.dtype)])
        yield {k: v[idx] for k, v in arrays.items()}, valid


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str,
                                                            torch.Tensor]:
    """Integer arrays as int64 tensors, float arrays as fp32, on
    ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(
        device, torch.float32 if np.asarray(v).dtype.kind == "f"
        else torch.int64) for k, v in batch.items()}


def put_valid_batch(item, put):
    """``prepare`` of a (batch, valid) item of :func:`batches`: (the batch
    on the card, ``valid`` on the card, ``valid`` on the host)."""
    batch, valid = item
    return {k: put(v) for k, v in batch.items()}, put(valid), valid


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Callable, clip_norm: float,
                    generator: torch.Generator, stats_every: int = 0):
    """``step(*inputs) -> metrics``: zero the gradients, ``loss_fn(*inputs,
    dropout_seeds)`` with seeds drawn for this step, backward, clip to a
    global norm of ``clip_norm`` (``min(1, clip / (norm + 1e-6))``, the
    JAX ``clip_by_global_norm``), one optimizer step. Parameters update in
    place. ``metrics["loss"]`` is the loss (a device tensor);
    ``metrics["grad_health"]`` the grad-health block of the clipped
    gradients on steps whose pre-update optimizer count is a multiple of
    ``stats_every`` (the JAX ``finetune_grad_health``; 0 disables)."""
    num_layers = model.bert.config.num_hidden_layers
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in named]

    # torchlint: hot
    def step(*inputs):
        for p in params:
            p.grad = None
        seeds = draw_dropout_seeds(generator, num_layers)
        loss = loss_fn(*inputs, seeds)
        loss.backward()
        grads = [p.grad for p in params if p.grad is not None]
        scale = torch.clamp(clip_norm / (global_norm(grads) + 1e-6), max=1.0)
        for g in grads:
            g.mul_(scale.to(g.dtype))
        metrics = {"loss": loss.detach()}
        health = model_stats.step_with_health(optimizer, named, stats_every)
        if health is not None:
            metrics["grad_health"] = health
        return metrics

    return step


def open_telemetry(args, prefix: str, device, seq_per_step: int,
                   flops_per_seq: float, is_primary: bool = True,
                   n_devices: int = 1):
    """The finetune runners' telemetry facade (JAX run_glue.py:124-129,
    209-219; run_squad's too): its JSONL sink at ``--telemetry_jsonl``,
    else ``<output_dir>/<prefix>_telemetry.jsonl``, else none; ``prefix``
    also names the process in the debug plane and the postmortem. Of a
    run's ranks only the primary writes (``is_primary``); MFU is per card
    over ``n_devices``."""
    path = telemetry.default_jsonl_path(args, args.output_dir, prefix)
    return telemetry.from_args(
        args, sink=(logging_util.JSONLHandler(path, is_primary=is_primary)
                    if path else None),
        seq_per_step=seq_per_step, flops_per_seq=flops_per_seq,
        output_dir=args.output_dir or None, device=device, process=prefix,
        is_primary=is_primary, n_devices=n_devices)


def save(output_dir: str, step: int, model: torch.nn.Module,
         config: BertConfig, head: str, async_write: bool) -> str:
    """``{"model"}`` as ``ckpt_{step}.msgpack`` in ``output_dir`` (the
    JAX runners' model-only checkpoint, keeping the newest three)."""
    return ckpt.save_checkpoint(
        output_dir, step,
        {"model": to_jax_params(model.state_dict(), config, head,
                                keep_device=True)},
        async_write=async_write)
