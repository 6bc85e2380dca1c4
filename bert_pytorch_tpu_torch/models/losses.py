"""Losses: the port of the JAX package's ``models/losses.py``
(``pretraining_loss`` and ``pretraining_loss_sums``, ``mlm_accuracy``,
``span_loss``).

Parity targets: ``BertPretrainingCriterion`` (reference run_pretraining.py:
58-72), masked-LM cross-entropy with ignore_index -1 plus NSP
cross-entropy, summed; the SQuAD span loss (reference run_squad.py:
1085-1092), start and end cross-entropy averaged. Each cross-entropy is
computed in fp32 whatever the logits' dtype and averaged over the
positions that carry a label (``max(count, 1)``, so a batch with none
gives 0).
"""

from __future__ import annotations

from typing import Optional

import torch


def _xent_sums(logits: torch.Tensor, labels: torch.Tensor,
               ignore_index: int):
    """(sum of fp32 CE, count) over positions where label !=
    ignore_index."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits, dim=-1)
    per_pos = -logp.gather(-1, safe[..., None])[..., 0]
    per_pos = torch.where(valid, per_pos, torch.zeros_like(per_pos))
    return per_pos.sum(), valid.sum()


def _xent_ignore(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_index: int) -> torch.Tensor:
    """Mean fp32 CE over positions where label != ignore_index."""
    total, count = _xent_sums(logits, labels, ignore_index)
    return total / count.clamp(min=1)


def pretraining_loss(prediction_logits: torch.Tensor,
                     seq_relationship_logits: Optional[torch.Tensor],
                     masked_lm_labels: torch.Tensor,
                     next_sentence_labels: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """MLM + NSP total (run_pretraining.py:58-72); MLM only when NSP is
    off. Each term is its :func:`pretraining_loss_sums` sum over its
    count."""
    mlm_sum, mlm_count, nsp_sum, nsp_count, _ = pretraining_loss_sums(
        prediction_logits, seq_relationship_logits, masked_lm_labels,
        next_sentence_labels)
    loss = mlm_sum / mlm_count.clamp(min=1)
    if seq_relationship_logits is not None and next_sentence_labels is not None:
        loss = loss + nsp_sum / nsp_count.clamp(min=1)
    return loss


def pretraining_loss_sums(prediction_logits: torch.Tensor,
                          seq_relationship_logits: Optional[torch.Tensor],
                          masked_lm_labels: torch.Tensor,
                          next_sentence_labels: Optional[torch.Tensor] = None):
    """Unnormalized pieces of :func:`pretraining_loss` (the JAX
    ``pretraining_loss_sums``): ``(mlm_sum, mlm_count, nsp_sum,
    nsp_count, mlm_correct)``, the per-rank sums a data-parallel step
    divides by the GLOBAL counts. ``pretraining_loss == mlm_sum /
    max(mlm_count, 1) + nsp_sum / max(nsp_count, 1)`` and ``mlm_accuracy
    == mlm_correct / max(mlm_count, 1)`` by construction."""
    vocab = prediction_logits.shape[-1]
    labels_flat = masked_lm_labels.reshape(-1)
    mlm_sum, mlm_count = _xent_sums(prediction_logits.reshape(-1, vocab),
                                    labels_flat, -1)
    preds = prediction_logits.argmax(dim=-1).reshape(-1)
    mlm_correct = ((preds == labels_flat) & (labels_flat != -1)).sum()
    if seq_relationship_logits is not None and next_sentence_labels is not None:
        nsp_sum, nsp_count = _xent_sums(seq_relationship_logits.reshape(-1, 2),
                                        next_sentence_labels.reshape(-1), -1)
    else:
        nsp_sum = torch.zeros((), device=prediction_logits.device)
        nsp_count = torch.zeros((), dtype=torch.int64,
                                device=prediction_logits.device)
    return mlm_sum, mlm_count, nsp_sum, nsp_count, mlm_correct


def span_loss_sums(start_logits: torch.Tensor, end_logits: torch.Tensor,
                   start_positions: torch.Tensor,
                   end_positions: torch.Tensor):
    """Unnormalized pieces of :func:`span_loss`: ``(start_sum,
    start_count, end_sum, end_count)``, the per-rank sums a data-parallel
    step divides by the GLOBAL counts."""
    seq_len = start_logits.shape[-1]
    start_positions = start_positions.clamp(0, seq_len)
    end_positions = end_positions.clamp(0, seq_len)
    pad = torch.full(start_logits.shape[:-1] + (1,), -10000.0,
                     dtype=start_logits.dtype, device=start_logits.device)
    start_l = torch.cat([start_logits, pad], dim=-1).float()
    end_l = torch.cat([end_logits, pad], dim=-1).float()
    return (*_xent_sums(start_l, start_positions, ignore_index=seq_len),
            *_xent_sums(end_l, end_positions, ignore_index=seq_len))


def span_loss(start_logits: torch.Tensor, end_logits: torch.Tensor,
              start_positions: torch.Tensor,
              end_positions: torch.Tensor) -> torch.Tensor:
    """SQuAD loss over [B, S] logits: positions clamped into [0, S], one
    extra class of logit -10000 appended, CE with ignore_index S on start
    and on end, averaged (run_squad.py:1085-1092: a clamped index is the
    ignored index S)."""
    seq_len = start_logits.shape[-1]
    start_positions = start_positions.clamp(0, seq_len)
    end_positions = end_positions.clamp(0, seq_len)
    pad = torch.full(start_logits.shape[:-1] + (1,), -10000.0,
                     dtype=start_logits.dtype, device=start_logits.device)
    start_l = torch.cat([start_logits, pad], dim=-1).float()
    end_l = torch.cat([end_logits, pad], dim=-1).float()
    s = _xent_ignore(start_l, start_positions, ignore_index=seq_len)
    e = _xent_ignore(end_l, end_positions, ignore_index=seq_len)
    return (s + e) / 2.0


def mlm_accuracy(prediction_logits: torch.Tensor,
                 masked_lm_labels: torch.Tensor,
                 ignore_index: int = -1) -> torch.Tensor:
    """Fraction of labelled positions predicted correctly (argmax takes the
    first maximum, as ``jnp.argmax`` does)."""
    preds = prediction_logits.argmax(dim=-1)
    valid = masked_lm_labels != ignore_index
    correct = (preds == masked_lm_labels) & valid
    return correct.sum() / valid.sum().clamp(min=1)


def token_classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                              ignore_index: int = -100) -> torch.Tensor:
    """Per-token CE skipping the special tokens' labels (the JAX
    package's ``token_classification_loss``; run_ner.py)."""
    num_labels = logits.shape[-1]
    return _xent_ignore(logits.reshape(-1, num_labels), labels.reshape(-1),
                        ignore_index)
