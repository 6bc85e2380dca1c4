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
* "Each tensor" is a leaf of the JAX params tree: the JAX encoder stacks
  every layer's copy of a parameter into one [L, ...] leaf (``nn.scan``),
  so LAMB's trust ratio and BertAdam's clipping norm span all layers of
  ``bert.encoder.layers.<i>.<name>`` together. :func:`param_groups` names
  each parameter's leaf (the group's ``"stacks"``); a group without them
  takes each tensor alone.
* Weight decay applies per param group: :func:`param_groups` splits a
  model's parameters with :func:`no_decay_mask`, the counterpart of the
  JAX ``weight_decay_mask``.

``dynamic_loss_scale`` (fp16) and LAMB's ``trust_clip`` are not ported
yet.
"""

from __future__ import annotations

import re
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


_LAYER_INDEX = re.compile(r"(?<=\.encoder\.layers\.)\d+\.")


def stack_key(name: str) -> str:
    """The JAX params leaf a port parameter belongs to: the layer index of
    ``...encoder.layers.<i>.<rest>`` dropped (the scan-stacked leaf), any
    other name itself."""
    return _LAYER_INDEX.sub("", name, count=1)


def param_groups(model: torch.nn.Module, weight_decay: float) -> List[dict]:
    """The model's parameters as (decayed, not decayed) param groups, each
    with its parameters' JAX leaves (``"stacks"``, :func:`stack_key`)."""
    named = list(model.named_parameters())
    mask = no_decay_mask(named)
    return [
        {"params": [p for n, p in named if mask[n] == decay],
         "stacks": [stack_key(n) for n, _ in named if mask[n] == decay],
         "weight_decay": weight_decay if decay else 0.0}
        for decay in (True, False)
    ]


def _stack_norms(group, tensors) -> Dict[object, torch.Tensor]:
    """The L2 norm of each of ``group``'s JAX leaves over ``tensors`` (one
    per parameter of the group, in order), accumulated in fp32."""
    keys = group.get("stacks") or range(len(group["params"]))
    members: Dict[object, list] = {}
    for key, t in zip(keys, tensors):
        members.setdefault(key, []).append(
            torch.linalg.vector_norm(t.float()))
    return {key: norms[0] if len(norms) == 1
            else torch.linalg.vector_norm(torch.stack(norms))
            for key, norms in members.items()}


def reset_count(optimizer: torch.optim.Optimizer, count: int) -> None:
    """Phase-switch surgery: overwrite the step count, keep the moments
    (reference run_pretraining.py:298-309)."""
    for group in optimizer.param_groups:
        group["count"] = int(count)


def opt_step_count(optimizer: torch.optim.Optimizer) -> int:
    """The optimizer's step count (every param group carries the same)."""
    return int(optimizer.param_groups[0]["count"])


def init_state(optimizer: torch.optim.Optimizer) -> None:
    """Create every parameter's fp32 moments now (zeros, as the JAX
    ``init`` does) rather than at the first step: a checkpoint writes
    them and a restore fills them."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state[p]
            if not state:
                state["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                state["exp_avg_sq"] = torch.zeros_like(p,
                                                       dtype=torch.float32)


def moments(optimizer: torch.optim.Optimizer, named_params: Dict[
        str, torch.nn.Parameter]) -> Tuple[Dict[str, torch.Tensor],
                                           Dict[str, torch.Tensor]]:
    """(exp_avg, exp_avg_sq) by parameter name, the live tensors (created
    by :func:`init_state` if no step has run)."""
    init_state(optimizer)
    mu = {n: optimizer.state[p]["exp_avg"] for n, p in named_params.items()}
    nu = {n: optimizer.state[p]["exp_avg_sq"]
          for n, p in named_params.items()}
    return mu, nu


@torch.no_grad()
def load_moments(optimizer: torch.optim.Optimizer,
                 named_params: Dict[str, torch.nn.Parameter], count: int,
                 exp_avg: Dict[str, torch.Tensor],
                 exp_avg_sq: Dict[str, torch.Tensor]) -> None:
    """Set every parameter's moments (by name) and the step count; a name
    missing from either dict raises ``KeyError`` before anything is set."""
    missing = sorted(n for n in named_params
                     if n not in exp_avg or n not in exp_avg_sq)
    if missing:
        raise KeyError(f"optimizer state lacks the moments of {len(missing)} "
                       f"parameters, e.g. {missing[:4]}")
    init_state(optimizer)
    for name, p in named_params.items():
        state = optimizer.state[p]
        state["exp_avg"].copy_(exp_avg[name])
        state["exp_avg_sq"].copy_(exp_avg_sq[name])
    reset_count(optimizer, count)


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

    @staticmethod
    def _apply(p, delta, updates) -> None:
        """``p += delta``; ``delta`` kept in ``updates`` under ``p`` when a
        dict is given (the update each parameter received, before it is
        rounded into the parameter: what the grad-health block reads)."""
        p.add_(delta)
        if updates is not None:
            updates[p] = delta


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
    def step(self, closure=None, updates=None):
        if closure is not None:
            raise ValueError("Lamb.step takes no closure")
        grads = [[torch.zeros_like(p) if p.grad is None else p.grad
                  for p in group["params"]] for group in self.param_groups]
        if self.max_grad_norm is not None and self.max_grad_norm > 0:
            norm = global_norm(g for group in grads for g in group)
            scale = torch.clamp(self.max_grad_norm / (norm + 1e-6), max=1.0)
            grads = [[g * scale for g in group] for group in grads]
        for group, group_grads in zip(self.param_groups, grads):
            # The trust ratio of each JAX leaf needs all of its layers'
            # parameters and updates before any of them moves.
            pairs = list(self._updates(group, group_grads))
            p_norms = _stack_norms(group, [p for p, _ in pairs])
            u_norms = _stack_norms(group, [u for _, u in pairs])
            keys = group.get("stacks") or range(len(pairs))
            for key, (p, upd) in zip(keys, pairs):
                p_norm, u_norm = p_norms[key], u_norms[key]
                ratio = torch.where((p_norm > 0) & (u_norm > 0),
                                    p_norm / u_norm, torch.ones_like(p_norm))
                self._apply(p, (-group["lr"] * ratio * upd).to(p.dtype),
                            updates)


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
    def step(self, closure=None, updates=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        for group in self.param_groups:
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in group["params"]]
            for p, upd in self._updates(group, grads):
                self._apply(p, (-group["lr"] * upd).to(p.dtype), updates)


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
    def step(self, closure=None, updates=None):
        if closure is not None:
            raise ValueError("BertAdam.step takes no closure")
        for group in self.param_groups:
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in group["params"]]
            if self.max_grad_norm > 0:
                norms = _stack_norms(group, grads)
                keys = group.get("stacks") or range(len(grads))
                grads = [g * torch.clamp(
                    self.max_grad_norm / (norms[key] + 1e-6),
                    max=1.0).to(g.dtype) for key, g in zip(keys, grads)]
            for p, upd in self._updates(group, grads):
                self._apply(p, (-group["lr"] * upd).to(p.dtype), updates)
