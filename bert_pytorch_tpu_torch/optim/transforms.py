"""Optimizers: the port of the JAX package's ``optim/transforms.py``
``lamb`` and ``adamw`` as ``torch.optim.Optimizer`` subclasses, with the
same update math (Apex ``FusedLAMB``/``FusedAdam`` semantics, reference
run_pretraining.py:279-295 and src/optimization.py:25).

* The learning rate is a float or a schedule (optim/schedules.py) read at
  the optimizer's step count BEFORE the step increments it; each param
  group carries that count (``group["count"]``, :func:`reset_count`) and
  the lr it last used (``group["lr"]``).
* Moments are fp32 and bias-corrected; the update is
  ``m_hat / (sqrt(v_hat) + eps) + weight_decay * p``.
* LAMB clips the gradients to a global norm first
  (``min(1, max_norm / (||g|| + 1e-6))``) and scales each tensor's lr by
  the trust ratio ``||p|| / ||update||`` (1.0 where either norm is 0).
* Weight decay applies per param group: :func:`param_groups` splits a
  model's parameters with :func:`no_decay_mask`, the counterpart of the
  JAX ``weight_decay_mask``.

``bert_adam``, ``dynamic_loss_scale`` (fp16), LAMB's ``trust_clip`` and
the option to turn bias correction off (the finetuning runners' AdamW) are
not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch

LearningRate = Union[float, Callable[[int], float]]


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """L2 norm over every tensor, accumulated in fp32."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def no_decay_mask(named_parameters) -> Dict[str, bool]:
    """True where weight decay applies, by parameter name: not on any
    ``bias``, and not on any LayerNorm parameter (``scale`` lives only in
    LayerNorm modules, whose names contain ``layer_norm``) — the JAX
    ``no_decay_mask`` and the reference's no-decay grouping
    (run_pretraining.py:279-286)."""
    mask = {}
    for name, _ in named_parameters:
        parts = name.split(".")
        mask[name] = not (parts[-1] in ("bias", "scale")
                          or any("layer_norm" in part for part in parts))
    return mask


def param_groups(model: torch.nn.Module, weight_decay: float) -> List[dict]:
    """The model's parameters as (decayed, not decayed) param groups."""
    named = list(model.named_parameters())
    mask = no_decay_mask(named)
    return [
        {"params": [p for n, p in named if mask[n]],
         "weight_decay": weight_decay},
        {"params": [p for n, p in named if not mask[n]],
         "weight_decay": 0.0},
    ]


def reset_count(optimizer: torch.optim.Optimizer, count: int) -> None:
    """Phase-switch surgery: overwrite the step count, keep the moments
    (reference run_pretraining.py:298-309)."""
    for group in optimizer.param_groups:
        group["count"] = int(count)


class _Adam(torch.optim.Optimizer):
    """The shared state and moment update of :class:`Lamb` and
    :class:`AdamW`."""

    def __init__(self, params, lr: LearningRate, betas: Tuple[float, float],
                 eps: float, weight_decay: float):
        self.schedule = lr if callable(lr) else (lambda count: lr)
        super().__init__(params, dict(
            lr=self.schedule(0), betas=betas, eps=eps,
            weight_decay=weight_decay, count=0))

    def _updates(self, group, grads):
        """Advance the moments of ``group`` with ``grads``; yields (param,
        fp32 update before the lr) and sets ``group["lr"]``."""
        count = group["count"]
        group["lr"] = float(self.schedule(count))
        b1, b2 = group["betas"]
        c1 = 1.0 - b1 ** (count + 1)
        c2 = 1.0 - b2 ** (count + 1)
        for p, g in zip(group["params"], grads):
            state = self.state[p]
            if not state:
                state["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                state["exp_avg_sq"] = torch.zeros_like(p,
                                                       dtype=torch.float32)
            m, v = state["exp_avg"], state["exp_avg_sq"]
            g = g.float()
            m.mul_(b1).add_((1.0 - b1) * g)
            v.mul_(b2).add_((1.0 - b2) * g.square())
            upd = (m / c1) / (torch.sqrt(v / c2) + group["eps"])
            if group["weight_decay"] > 0:
                upd = upd + group["weight_decay"] * p.float()
            yield p, upd
        group["count"] = count + 1


class Lamb(_Adam):
    """LAMB, the large-batch optimizer of the BERT recipe (the JAX
    ``lamb``): global-norm clipping to ``max_grad_norm``, bias-corrected
    Adam moments, and a per-tensor trust ratio on the lr."""

    def __init__(self, params, lr: LearningRate, betas=(0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.01,
                 max_grad_norm: Optional[float] = 1.0):
        super().__init__(params, lr, betas, eps, weight_decay)
        self.max_grad_norm = max_grad_norm

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Lamb.step takes no closure")
        grads = [[torch.zeros_like(p) if p.grad is None else p.grad
                  for p in group["params"]] for group in self.param_groups]
        if self.max_grad_norm is not None and self.max_grad_norm > 0:
            norm = global_norm(g for group in grads for g in group)
            scale = torch.clamp(self.max_grad_norm / (norm + 1e-6), max=1.0)
            grads = [[g * scale for g in group] for group in grads]
        for group, group_grads in zip(self.param_groups, grads):
            for p, upd in self._updates(group, group_grads):
                p_norm = torch.linalg.vector_norm(p.float())
                u_norm = torch.linalg.vector_norm(upd)
                ratio = torch.where((p_norm > 0) & (u_norm > 0),
                                    p_norm / u_norm, torch.ones_like(p_norm))
                p.add_((-group["lr"] * ratio * upd).to(p.dtype))


class AdamW(_Adam):
    """Adam with decoupled weight decay (the JAX ``adamw``; the Apex
    ``FusedAdam`` role in finetuning)."""

    def __init__(self, params, lr: LearningRate, betas=(0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.01):
        super().__init__(params, lr, betas, eps, weight_decay)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        for group in self.param_groups:
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in group["params"]]
            for p, upd in self._updates(group, grads):
                p.add_((-group["lr"] * upd).to(p.dtype))
