"""Optimizers: the port of the JAX package's ``optim/transforms.py``
``lamb``, ``adamw`` and ``bert_adam`` as ``torch.optim.Optimizer``
subclasses, with the same update math (Apex ``FusedLAMB``/``FusedAdam``
semantics, reference run_pretraining.py:279-295 and src/optimization.py:25;
``BertAdam``, src/optimization.py:64-174).

* The learning rate is a float or a schedule (optim/schedules.py) read at
  the optimizer's step count BEFORE the step increments it; each param
  group carries that count (``group["count"]``, :func:`reset_count`) and
  the lr it last used (``group["lr"]``).
* Moments are fp32; the update is ``m_hat / (sqrt(v_hat) + eps) +
  weight_decay * p``, bias-corrected for LAMB and (by default) AdamW.
  ``AdamW(bias_correction=False)`` (the finetuning runners' FusedAdam) and
  ``BertAdam`` use the raw moments.
* LAMB clips the gradients to a global norm first
  (``min(1, max_norm / (||g|| + 1e-6))``) and scales each tensor's lr by
  the trust ratio ``||p|| / ||update||`` (1.0 where either norm is 0).
  ``BertAdam`` clips each tensor to ``max_grad_norm`` on its own and reads
  its schedule (``warmup_linear`` and the others of
  optim/schedules.py, with no +1 offset) inside the optimizer.
* Weight decay applies per param group: :func:`param_groups` splits a
  model's parameters with :func:`no_decay_mask`, the counterpart of the
  JAX ``weight_decay_mask``.

``dynamic_loss_scale`` (fp16) and LAMB's ``trust_clip`` are not ported
yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch

from bert_pytorch_tpu_torch.optim import schedules

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
                 eps: float, weight_decay: float,
                 bias_correction: bool = True):
        self.schedule = lr if callable(lr) else (lambda count: lr)
        self.bias_correction = bias_correction
        super().__init__(params, dict(
            lr=self.schedule(0), betas=betas, eps=eps,
            weight_decay=weight_decay, count=0))

    def _updates(self, group, grads):
        """Advance the moments of ``group`` with ``grads``; yields (param,
        fp32 update before the lr) and sets ``group["lr"]``."""
        count = group["count"]
        group["lr"] = float(self.schedule(count))
        b1, b2 = group["betas"]
        c1 = c2 = 1.0
        if self.bias_correction:
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
    ``FusedAdam`` role in finetuning, where the runners turn
    ``bias_correction`` off, reference run_squad.py:982-988)."""

    def __init__(self, params, lr: LearningRate, betas=(0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.01,
                 bias_correction: bool = True):
        super().__init__(params, lr, betas, eps, weight_decay,
                         bias_correction)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        for group in self.param_groups:
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in group["params"]]
            for p, upd in self._updates(group, grads):
                p.add_((-group["lr"] * upd).to(p.dtype))


_BERT_ADAM_SCHEDULES = {
    "warmup_linear": schedules.warmup_linear_schedule,
    "warmup_cosine": schedules.warmup_cosine_schedule,
    "warmup_constant": schedules.warmup_constant_schedule,
    "warmup_poly": schedules.warmup_poly_schedule,
}


class BertAdam(_Adam):
    """``BertAdam`` (the JAX ``bert_adam``; reference
    src/optimization.py:64-174): the lr at step t is ``schedule(lr,
    warmup, t_total)`` read at the pre-update count (no +1 offset; a
    constant ``lr`` when ``t_total`` is -1), each gradient tensor is
    clipped to ``max_grad_norm`` on its own, and the update ``m / (sqrt(v)
    + eps) + weight_decay * p`` has no bias correction. The SQuAD runner's
    fp32 path (run_squad.py:999-1002)."""

    def __init__(self, params, lr: float, schedule: str = "warmup_linear",
                 warmup: float = -1.0, t_total: int = -1,
                 betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.01, max_grad_norm: float = 1.0):
        if schedule not in _BERT_ADAM_SCHEDULES:
            raise ValueError(f"Invalid schedule parameter: {schedule}")
        rate: LearningRate = lr
        if t_total != -1:
            rate = _BERT_ADAM_SCHEDULES[schedule](lr, warmup, t_total,
                                                  offset=0)
        super().__init__(params, rate, betas, eps, weight_decay,
                         bias_correction=False)
        self.max_grad_norm = max_grad_norm

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("BertAdam.step takes no closure")
        for group in self.param_groups:
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in group["params"]]
            if self.max_grad_norm > 0:
                grads = [g * torch.clamp(
                    self.max_grad_norm
                    / (torch.linalg.vector_norm(g.float()) + 1e-6),
                    max=1.0).to(g.dtype) for g in grads]
            for p, upd in self._updates(group, grads):
                p.add_((-group["lr"] * upd).to(p.dtype))
