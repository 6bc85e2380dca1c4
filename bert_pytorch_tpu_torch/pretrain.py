"""Pretraining engine: the first-order train step and the eval step, the
port of the JAX package's ``pretrain.py`` (``make_train_step`` without
K-FAC, bucketed overlap or fp16 loss scaling; ``make_eval_step``;
``stack_microbatches``).

One optimizer step consumes a batch of [A, B, ...] arrays: A microbatches
run forward and backward in turn, their gradients accumulate in the fp32
``.grad`` of the master parameters, are divided by A, and one optimizer
step follows (reference run_pretraining.py:405-460). Each microbatch draws
its dropout seeds (embeddings + one per layer) from the step's
``torch.Generator`` before its forward, as the JAX step splits its rng per
microbatch and per layer.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from bert_pytorch_tpu_torch.models.bert import draw_dropout_seeds
from bert_pytorch_tpu_torch.models.losses import mlm_accuracy, pretraining_loss
from bert_pytorch_tpu_torch.optim.transforms import global_norm


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


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    schedule: Optional[Callable[[int], float]] = None,
                    next_sentence: bool = True,
                    max_pred_per_seq: Optional[int] = None,
                    generator: Optional[torch.Generator] = None):
    """Build ``step(batch) -> metrics`` for [A, B, ...] batches
    (input_ids/segment_ids/input_mask/masked_lm_labels [A, B, S],
    next_sentence_labels [A, B] or [A, B, K], and for packed rows
    sequence_ids [A, B, S] and cls_positions [A, B, K]) already on the
    model's device. The model's parameters are updated in place.

    Metrics (device tensors; reading one synchronises): ``loss`` and
    ``mlm_accuracy`` (means over the microbatches), ``grad_norm`` (of the
    averaged gradients, before LAMB's clipping), ``finite``,
    ``real_tokens`` (the non-pad tokens of the step) and, with a
    ``schedule``, ``learning_rate`` (at the pre-step count).

    ``generator`` (CPU) draws the dropout seeds; a model whose dropout
    rates are 0 draws them and drops nothing."""
    num_layers = model.config.num_hidden_layers
    generator = generator or torch.Generator().manual_seed(0)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        accum_steps = batch["input_ids"].shape[0]
        count = optimizer.param_groups[0]["count"]
        for p in params:
            p.grad = None
        losses, accs = [], []
        for a in range(accum_steps):
            mb = {key: value[a] for key, value in batch.items()}
            seeds = draw_dropout_seeds(generator, num_layers)
            loss, acc = pretraining_loss_and_accuracy(
                model, mb, next_sentence, max_pred_per_seq, seeds)
            loss.backward()
            losses.append(loss.detach())
            accs.append(acc.detach())
        grads = []
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            p.grad.div_(accum_steps)
            grads.append(p.grad)
        gnorm = global_norm(grads)
        optimizer.step()
        losses = torch.stack(losses)
        metrics = {
            "loss": losses.mean(),
            "mlm_accuracy": torch.stack(accs).float().mean(),
            "grad_norm": gnorm,
            "finite": (torch.isfinite(losses.sum())
                       & torch.isfinite(gnorm)).float(),
            "real_tokens": batch["input_mask"].sum().float(),
        }
        if schedule is not None:
            metrics["learning_rate"] = torch.tensor(float(schedule(count)))
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


def to_device(batch: dict, device) -> Dict[str, torch.Tensor]:
    """numpy int arrays (or tensors) -> int64 tensors on ``device``."""
    return {key: torch.as_tensor(np.asarray(value) if not isinstance(
        value, torch.Tensor) else value).to(device=device, dtype=torch.int64,
                                             non_blocking=True)
            for key, value in batch.items()}
