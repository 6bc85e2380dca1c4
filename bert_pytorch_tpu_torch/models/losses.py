"""Pretraining losses: the port of the JAX package's ``models/losses.py``
(``pretraining_loss``, ``masked_lm_loss``, ``next_sentence_loss``,
``mlm_accuracy``).

Parity target ``BertPretrainingCriterion`` (reference run_pretraining.py:
58-72): masked-LM cross-entropy with ignore_index -1 plus NSP
cross-entropy, summed. Each cross-entropy is computed in fp32 whatever the
logits' dtype and averaged over the positions that carry a label
(``max(count, 1)``, so a batch with none gives 0).
"""

from __future__ import annotations

from typing import Optional

import torch


def _xent_ignore(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_index: int) -> torch.Tensor:
    """Mean fp32 CE over positions where label != ignore_index."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits, dim=-1)
    per_pos = -logp.gather(-1, safe[..., None])[..., 0]
    per_pos = torch.where(valid, per_pos, torch.zeros_like(per_pos))
    count = valid.sum().clamp(min=1)
    return per_pos.sum() / count


def masked_lm_loss(prediction_logits: torch.Tensor,
                   masked_lm_labels: torch.Tensor,
                   ignore_index: int = -1) -> torch.Tensor:
    """CE over [B, S (or P), V] logits with ignore_index
    (run_pretraining.py:64-69)."""
    vocab = prediction_logits.shape[-1]
    return _xent_ignore(prediction_logits.reshape(-1, vocab),
                        masked_lm_labels.reshape(-1), ignore_index)


def next_sentence_loss(seq_relationship_logits: torch.Tensor,
                       next_sentence_labels: torch.Tensor) -> torch.Tensor:
    """CE over [B, 2] (or packed [B, K, 2]) NSP logits, -1 ignored
    (run_pretraining.py:70-71)."""
    return _xent_ignore(seq_relationship_logits.reshape(-1, 2),
                        next_sentence_labels.reshape(-1), -1)


def pretraining_loss(prediction_logits: torch.Tensor,
                     seq_relationship_logits: Optional[torch.Tensor],
                     masked_lm_labels: torch.Tensor,
                     next_sentence_labels: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """MLM + NSP total (run_pretraining.py:58-72); MLM only when NSP is
    off."""
    loss = masked_lm_loss(prediction_logits, masked_lm_labels)
    if seq_relationship_logits is not None and next_sentence_labels is not None:
        loss = loss + next_sentence_loss(seq_relationship_logits,
                                         next_sentence_labels)
    return loss


def mlm_accuracy(prediction_logits: torch.Tensor,
                 masked_lm_labels: torch.Tensor,
                 ignore_index: int = -1) -> torch.Tensor:
    """Fraction of labelled positions predicted correctly (argmax takes the
    first maximum, as ``jnp.argmax`` does)."""
    preds = prediction_logits.argmax(dim=-1)
    valid = masked_lm_labels != ignore_index
    correct = (preds == masked_lm_labels) & valid
    return correct.sum() / valid.sum().clamp(min=1)
