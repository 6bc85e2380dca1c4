"""Pretraining engine: the train step (first-order, or preconditioned by
K-FAC) and the eval step, the port of the JAX package's ``pretrain.py``
(``make_train_step`` without bucketed overlap, with fp16 loss scaling;
``make_kfac_fns`` as :func:`make_kfac_loss`; ``make_eval_step``;
``stack_microbatches``; ``device_prefetch``).

One optimizer step consumes a batch of [A, B, ...] arrays: A microbatches
run forward and backward in turn, their gradients accumulate in the fp32
``.grad`` of the master parameters, are divided by A, and one optimizer
step follows (reference run_pretraining.py:405-460). Each microbatch draws
its dropout seeds (embeddings + one per layer) from the step's
``torch.Generator`` before its forward, as the JAX step splits its rng per
microbatch and per layer. With K-FAC the averaged gradients are
preconditioned before the optimizer, in the JAX step's order (factors
captured in the step's own backward, due inverses, precondition,
``grad_norm``, optimizer). In fp16 each microbatch's loss is multiplied
by the loss scale before its backward, and the optimizer (a
``DynamicLossScale``) unscales, skips an overflowing step and adjusts the
scale.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch

from bert_pytorch_tpu_torch.models.bert import draw_dropout_seeds
from bert_pytorch_tpu_torch.models.losses import mlm_accuracy, pretraining_loss
from bert_pytorch_tpu_torch.optim.transforms import (DynamicLossScale,
                                                     global_norm)
from bert_pytorch_tpu_torch.telemetry import model_stats


def _mlm_positions(labels: torch.Tensor, max_pred_per_seq: Optional[int]):
    """(labels [B, P], masked positions [B, P]) when P < S: the first P
    masked positions of each row in index order, then the lowest unmasked
    ones (``jax.lax.top_k`` on the label mask keeps the lowest index first
    among ties; a stable sort gives the same order). (labels, None) when P
    covers the row."""
    if max_pred_per_seq is None or max_pred_per_seq >= labels.shape[-1]:
        return labels, None
    is_masked = (labels != -1).to(torch.int32)
    positions = torch.argsort(-is_masked, dim=1, stable=True)[
        :, :max_pred_per_seq]
    return torch.gather(labels, 1, positions), positions


def pretraining_loss_and_accuracy(model, mb: Dict[str, torch.Tensor],
                                  next_sentence: bool,
                                  max_pred_per_seq: Optional[int],
                                  dropout_seeds=None):
    """The shared apply + loss (+ accuracy) of one microbatch."""
    labels, positions = _mlm_positions(mb["masked_lm_labels"],
                                       max_pred_per_seq)
    mlm_logits, nsp_logits = model(
        mb["input_ids"], mb["segment_ids"], mb["input_mask"], positions,
        mb.get("sequence_ids"), mb.get("cls_positions"), dropout_seeds)
    loss = pretraining_loss(
        mlm_logits, nsp_logits if next_sentence else None, labels,
        mb["next_sentence_labels"] if next_sentence else None)
    return loss, mlm_accuracy(mlm_logits, labels)


def make_kfac_loss(model: torch.nn.Module, next_sentence: bool = True,
                   max_pred_per_seq: Optional[int] = None):
    """``apply_loss(mb, dropout_seeds) -> loss`` for ``KFAC``'s stats pass
    (the JAX ``make_kfac_fns``), sharing the train step's loss. Its forward
    runs without remat, as the JAX stats twin is built (``remat="none"``:
    a small decoupled batch, where remat would only cost recompute)."""

    def apply_loss(mb, dropout_seeds=None):
        encoder = model.bert.encoder
        saved, encoder.remat = encoder.remat, "none"
        try:
            loss, _ = pretraining_loss_and_accuracy(
                model, mb, next_sentence, max_pred_per_seq, dropout_seeds)
        finally:
            encoder.remat = saved
        return loss

    return apply_loss


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    schedule: Optional[Callable[[int], float]] = None,
                    next_sentence: bool = True,
                    max_pred_per_seq: Optional[int] = None,
                    generator: Optional[torch.Generator] = None,
                    kfac=None, kfac_fused: bool = False,
                    kfac_factor_interval: int = 1,
                    kfac_inv_interval: int = 0,
                    kfac_capture_microbatches: str = "first",
                    stats_every: int = 0, stats_phase: int = 0,
                    loss_scale: bool = False):
    """Build ``step(batch) -> metrics`` for [A, B, ...] batches
    (input_ids/segment_ids/input_mask/masked_lm_labels [A, B, S],
    next_sentence_labels [A, B] or [A, B, K], and for packed rows
    sequence_ids [A, B, S] and cls_positions [A, B, K]) already on the
    model's device. The model's parameters are updated in place.

    Metrics (device tensors; reading one synchronises): ``loss`` and
    ``mlm_accuracy`` (means over the microbatches), ``grad_norm`` (of the
    averaged gradients, preconditioned with K-FAC, before LAMB's
    clipping), ``finite``, ``real_tokens`` (the non-pad tokens of the step)
    and, with a ``schedule``, ``learning_rate`` (at the pre-step count).

    ``generator`` (CPU) draws the dropout seeds; a model whose dropout
    rates are 0 draws them and drops nothing.

    ``kfac`` (an ``optim.KFAC`` on ``model``, initialised): the step is
    ``step(batch, kfac_state)`` and preconditions the averaged gradients
    with ``lr = schedule(count)`` before the optimizer (needs a
    ``schedule``). ``kfac_fused`` (the JAX ``kfac_capture_model``)
    captures the factors in the step's own backward on steps where
    ``count % kfac_factor_interval == 0``: microbatch 0's
    (``kfac_capture_microbatches="first"``) or every microbatch's
    (``"all"``, summed over A·B·S rows); with ``kfac_inv_interval`` > 0 the
    inverses are rebuilt inside the step, from the factors it just
    captured, where ``count % kfac_inv_interval == 0``. ``kfac_state`` is
    updated in place. Without ``kfac_fused`` the caller drives
    ``kfac.update_factors`` / ``update_inverses`` (the stats flow).

    ``loss_scale=True`` is the fp16 mode (the JAX ``loss_scale``):
    ``optimizer`` is a ``DynamicLossScale``; each microbatch's loss is
    multiplied by its current scale before the backward, ``grad_norm``
    is the true norm (the scaled norm over the scale), ``loss_scale``
    reports the scale the step used, and the grad-health block (when
    ``stats_every`` > 0) runs on every step with its grad norms unscaled.
    An overflowing step's ``grad_norm`` is inf, so ``finite`` is 0 and
    the sentinel sees it as the JAX runner's does."""
    if kfac is not None and schedule is None:
        raise ValueError("kfac preconditioning requires a schedule")
    if kfac is not None and loss_scale:
        raise ValueError(
            "loss_scale composes with first-order optimizers only; K-FAC "
            "runs in bf16/f32 where no scaler is needed")
    if loss_scale and not isinstance(optimizer, DynamicLossScale):
        raise ValueError("loss_scale needs a DynamicLossScale optimizer")
    if kfac_fused and kfac is None:
        raise ValueError("kfac_fused (the JAX kfac_capture_model) requires "
                         "kfac")
    if kfac_fused and kfac_factor_interval < 1:
        raise ValueError(
            f"kfac_factor_interval must be >= 1, got {kfac_factor_interval}")
    if kfac_inv_interval and not kfac_fused:
        raise ValueError(
            "kfac_inv_interval (inverse updates inside the step) requires the "
            "fused capture (kfac_fused); the stats flow calls "
            "kfac.update_inverses itself")
    if kfac_capture_microbatches not in ("first", "all"):
        raise ValueError(
            f"kfac_capture_microbatches must be first|all, got "
            f"{kfac_capture_microbatches!r}")
    num_layers = model.config.num_hidden_layers
    generator = generator or torch.Generator().manual_seed(0)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in named]

    def step(batch: Dict[str, torch.Tensor],
             kfac_state=None) -> Dict[str, torch.Tensor]:
        accum_steps = batch["input_ids"].shape[0]
        count = optimizer.param_groups[0]["count"]
        if kfac is not None and kfac_state is None:
            raise ValueError("a K-FAC step takes step(batch, kfac_state)")
        capture = kfac_fused and count % kfac_factor_interval == 0
        scale = optimizer.scale if loss_scale else None
        sums = kfac.zero_statistics() if capture else None
        for p in params:
            p.grad = None
        losses, accs = [], []
        for a in range(accum_steps):
            mb = {key: value[a] for key, value in batch.items()}
            seeds = draw_dropout_seeds(generator, num_layers)
            tapped = capture and (a == 0
                                  or kfac_capture_microbatches == "all")
            # Armed through the backward: a remat recompute runs the taps.
            with kfac.capture(sums) if tapped else contextlib.nullcontext():
                loss, acc = pretraining_loss_and_accuracy(
                    model, mb, next_sentence, max_pred_per_seq, seeds)
                (loss if scale is None else loss * scale).backward()
            losses.append(loss.detach())
            accs.append(acc.detach())
        if capture:
            shape = batch["input_ids"].shape
            rows = shape[1] * shape[2] * (
                accum_steps if kfac_capture_microbatches == "all" else 1)
            kfac.ema_factors(kfac_state, sums, rows, kfac.grad_scale(
                {key: value[0] for key, value in batch.items()}))
        if kfac_fused and kfac_inv_interval and (
                count % kfac_inv_interval == 0):
            kfac.inverse_factors(kfac_state)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            p.grad.div_(accum_steps)
        if kfac is not None:
            pre = kfac.precondition(kfac_state, {n: p.grad for n, p in named},
                                    schedule(count))
            for name, p in named:
                p.grad = pre[name]
        gnorm = global_norm(p.grad for p in params)
        if scale is not None:
            gnorm = gnorm / scale  # the gradients carry the loss scale
        health = model_stats.step_with_health(
            optimizer, named, 1 if scale is not None and stats_every > 0
            else stats_every, stats_phase, grad_scale=scale)
        losses = torch.stack(losses)
        metrics = {
            "loss": losses.mean(),
            "mlm_accuracy": torch.stack(accs).float().mean(),
            "grad_norm": gnorm,
            "finite": (torch.isfinite(losses.sum())
                       & torch.isfinite(gnorm)).float(),
            "real_tokens": batch["input_mask"].sum().float(),
        }
        if scale is not None:
            metrics["loss_scale"] = torch.tensor(scale)
        if schedule is not None:
            metrics["learning_rate"] = torch.tensor(float(schedule(count)))
        if health is not None:
            metrics["grad_health"] = health
        return metrics

    return step


def make_eval_step(model: torch.nn.Module, next_sentence: bool = True):
    """Deterministic forward + loss for held-out evaluation, on every
    position (no masked-position gather), packed batches included."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]):
        mlm_logits, nsp_logits = model(
            batch["input_ids"], batch["segment_ids"], batch["input_mask"],
            None, batch.get("sequence_ids"), batch.get("cls_positions"))
        loss = pretraining_loss(
            mlm_logits, nsp_logits if next_sentence else None,
            batch["masked_lm_labels"],
            batch["next_sentence_labels"] if next_sentence else None)
        return loss, mlm_accuracy(mlm_logits, batch["masked_lm_labels"])

    return eval_step


def stack_microbatches(batch: dict, accum_steps: int) -> dict:
    """[A*B, ...] host batch -> [A, B, ...] (numpy arrays or tensors)."""
    out = {}
    for key, value in batch.items():
        if value.shape[0] % accum_steps != 0:
            raise ValueError(
                f"batch dim {value.shape[0]} not divisible by accumulation "
                f"steps {accum_steps}")
        out[key] = value.reshape(
            (accum_steps, value.shape[0] // accum_steps)
            + tuple(value.shape[1:]))
    return out


def device_prefetch(loader, accum_steps: int, device, depth: int = 2):
    """The loader's global batches stacked into [A, B, ...] microbatches
    and staged on ``device`` ``depth`` ahead (the JAX ``device_prefetch``):
    a :class:`~bert_pytorch_tpu_torch.data.device_prefetch.
    DevicePrefetcher` whose thread stacks each batch and copies it through
    pinned memory on a side CUDA stream (int32 on the wire, int64 on the
    card); the loop receives it on its own stream. ``depth <= 0`` stages
    inline on the loop's thread. Attach the result to ``TrainTelemetry``
    for the ``h2d_wait`` sub-phase; close it when the epoch is left."""
    from bert_pytorch_tpu_torch.data.device_prefetch import prefetch

    return prefetch(loader, device, depth, prepare=lambda host, put: {
        k: put(v) for k, v in stack_microbatches(host, accum_steps).items()})


def to_device(batch: dict, device) -> Dict[str, torch.Tensor]:
    """numpy int arrays (or tensors) -> int64 tensors on ``device``."""
    return {key: torch.as_tensor(np.asarray(value) if not isinstance(
        value, torch.Tensor) else value).to(device=device, dtype=torch.int64,
                                             non_blocking=True)
            for key, value in batch.items()}
