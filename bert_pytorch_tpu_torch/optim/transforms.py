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
  the trust ratio ``||p|| / ||update||`` (1.0 where either norm is 0),
  capped at ``trust_clip`` when one is given.
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
* Under FSDP (parallel/sharding.py) each parameter is a ``DTensor`` of
  which this rank holds a shard: the moments are kept for the shard, the
  update is the shard's, and every norm (the global clip, each leaf's
  trust ratio or clip) is a local sum of squares added over the shard
  group in one all-reduce of one vector for all leaves (LAMB needs two
  per step: the clip norm with the parameter norms before the moments
  move, the update norms after), never one collective per tensor.
* Under ``pipe`` or ``model`` (parallel/mesh.py ``mark_norms``) a leaf is
  spread over the ranks of its parameters' ``norm_group`` (the stages
  hold different layers of a stacked leaf, the model ranks different
  columns): each rank adds its parts' squares divided by
  ``norm_copies`` (the ranks holding the same part), and the same one
  vector all-reduce sums them over that group.

* fp16 training wraps any of them in :class:`DynamicLossScale`, the
  counterpart of the JAX ``dynamic_loss_scale`` (GradScaler semantics):
  the caller multiplies the loss by ``scale``, and the wrapper unscales
  the gradients, skips a step whose gradients are not all finite and
  grows or backs off the scale.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from bert_pytorch_tpu_torch.optim import schedules
from bert_pytorch_tpu_torch.parallel.sharding import (all_finite_across_ranks,
                                                      local, local_rows,
                                                      shard_group,
                                                      sum_over_shards)

LearningRate = Union[float, Callable[[int], float]]


def norm_reduction(params) -> Tuple[object, Optional[List[int]]]:
    """(the group a norm over ``params`` sums its squares over, the copies
    of each parameter in it, or None): the ``norm_group`` and
    ``norm_copies`` of a model split over ``pipe``/``model``, else the
    FSDP shard group (or None) with no copies."""
    params = list(params)
    group = next((p.norm_group for p in params
                  if getattr(p, "norm_group", None) is not None), None)
    if group is None:
        return shard_group(params), None
    return group, [getattr(p, "norm_copies", 1) for p in params]


def _sumsq(t: torch.Tensor, copies: Optional[int] = None) -> torch.Tensor:
    sq = torch.linalg.vector_norm(local(t).float()).square()
    return sq if copies is None else sq / copies


def global_norm(tensors: Iterable[torch.Tensor], params=None) -> torch.Tensor:
    """L2 norm over every tensor, accumulated in fp32; over FSDP shards,
    the local sums of squares added over the shard group (one
    all-reduce); with ``params`` (the parameters the tensors belong to,
    in order) split over ``pipe``/``model``, over their ``norm_group``."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    if params is not None:
        group, copies = norm_reduction(params)
        if copies is not None:
            sq = sum(_sumsq(t, c) for t, c in zip(tensors, copies))
            return torch.sqrt(sum_over_shards(sq.reshape(1), group)[0])
    group = shard_group(tensors)
    sq = sum(local(t).float().square().sum() for t in tensors)
    return torch.sqrt(sum_over_shards(sq.reshape(1), group)[0]
                      if group is not None else sq)


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
    per parameter of the group, in order, whole tensors), accumulated in
    fp32."""
    keys = group.get("stacks") or range(len(group["params"]))
    members: Dict[object, list] = {}
    for key, t in zip(keys, tensors):
        members.setdefault(key, []).append(
            torch.linalg.vector_norm(t.float()))
    return {key: norms[0] if len(norms) == 1
            else torch.linalg.vector_norm(torch.stack(norms))
            for key, norms in members.items()}


def _leaf_sumsq(group, tensors, copies=None) -> Dict[object, torch.Tensor]:
    """The local sum of squares of each of ``group``'s JAX leaves over
    ``tensors`` (this rank's shards), fp32; each tensor's over its
    ``copies`` when given."""
    keys = group.get("stacks") or range(len(group["params"]))
    copies = copies or [None] * len(group["params"])
    members: Dict[object, list] = {}
    for key, t, c in zip(keys, tensors, copies):
        members.setdefault(key, []).append(_sumsq(t, c))
    return {key: torch.stack(sq).sum() for key, sq in members.items()}


def _group_copies(groups) -> Tuple[object, Optional[list]]:
    """(the norms' reduction group, per param group the copies of its
    parameters or None): :func:`norm_reduction` over every group."""
    shards, copies = norm_reduction(p for g in groups for p in g["params"])
    if copies is None:
        return shards, None
    out, i = [], 0
    for g in groups:
        out.append(copies[i:i + len(g["params"])])
        i += len(g["params"])
    return shards, out


def _leaf_norms(groups, tensors, shards, extra=(), copies=None):
    """Per param group, ``{leaf: L2 norm}`` of ``tensors`` (one list per
    group). Whole tensors (``shards`` None) take :func:`_stack_norms`;
    shards sum their leaves' squares over the shard group in ONE
    all-reduce for every leaf of every group, with the scalars of
    ``extra`` (local sums of squares) riding in the same vector; with
    ``copies`` (per group, :func:`_group_copies`) each tensor's squares
    count once over its copies. Returns (norms per group, the square
    roots of ``extra`` summed)."""
    if shards is None:
        return ([_stack_norms(g, ts) for g, ts in zip(groups, tensors)],
                [torch.sqrt(e) for e in extra])
    local_sq = [_leaf_sumsq(g, ts, None if copies is None else copies[i])
                for i, (g, ts) in enumerate(zip(groups, tensors))]
    flat = [v for sq in local_sq for v in sq.values()] + list(extra)
    total = torch.sqrt(sum_over_shards(torch.stack(flat), shards))
    out, i = [], 0
    for sq in local_sq:
        out.append(dict(zip(sq.keys(), total[i:i + len(sq)])))
        i += len(sq)
    return out, list(total[i:])


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
                state["exp_avg"] = torch.zeros_like(local(p),
                                                    dtype=torch.float32)
                state["exp_avg_sq"] = torch.zeros_like(local(p),
                                                       dtype=torch.float32)


def moments(optimizer: torch.optim.Optimizer, named_params: Dict[
        str, torch.nn.Parameter]) -> Tuple[Dict[str, torch.Tensor],
                                           Dict[str, torch.Tensor]]:
    """(exp_avg, exp_avg_sq) by parameter name, the live tensors (created
    by :func:`init_state` if no step has run): under FSDP, this rank's
    shard of each."""
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
    """Set every parameter's moments (by name, whole tensors; under FSDP
    each rank takes its shard's rows) and the step count; a name missing
    from either dict raises ``KeyError`` before anything is set."""
    missing = sorted(n for n in named_params
                     if n not in exp_avg or n not in exp_avg_sq)
    if missing:
        raise KeyError(f"optimizer state lacks the moments of {len(missing)} "
                       f"parameters, e.g. {missing[:4]}")
    init_state(optimizer)
    for name, p in named_params.items():
        state = optimizer.state[p]
        state["exp_avg"].copy_(local_rows(exp_avg[name], p))
        state["exp_avg_sq"].copy_(local_rows(exp_avg_sq[name], p))
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
        """Advance the moments of ``group`` with ``grads`` (local shards);
        yields (param, fp32 update of its shard before the lr) and sets
        ``group["lr"]``."""
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
                state["exp_avg"] = torch.zeros_like(local(p),
                                                    dtype=torch.float32)
                state["exp_avg_sq"] = torch.zeros_like(local(p),
                                                       dtype=torch.float32)
            m, v = state["exp_avg"], state["exp_avg_sq"]
            g = local(g).float()
            m.mul_(b1).add_((1.0 - b1) * g)
            v.mul_(b2).add_((1.0 - b2) * g.square())
            upd = (m / c1) / (torch.sqrt(v / c2) + group["eps"])
            if group["weight_decay"] > 0:
                upd = upd + group["weight_decay"] * local(p).float()
            yield p, upd
        group["count"] = count + 1

    @staticmethod
    def _apply(p, delta, updates) -> None:
        """``p += delta`` (on this rank's shard); ``delta`` kept in
        ``updates`` under ``p`` when a dict is given (the update each
        parameter received, before it is rounded into the parameter: what
        the grad-health block reads)."""
        local(p).add_(delta)
        if updates is not None:
            updates[p] = delta


class Lamb(_Adam):
    """LAMB, the large-batch optimizer of the BERT recipe (the JAX
    ``lamb``): global-norm clipping to ``max_grad_norm``, bias-corrected
    Adam moments, and a per-tensor trust ratio on the lr, at most
    ``trust_clip`` when one is given."""

    def __init__(self, params, lr: LearningRate, betas=(0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.01,
                 max_grad_norm: Optional[float] = 1.0,
                 trust_clip: Optional[float] = None):
        super().__init__(params, lr, betas, eps, weight_decay)
        self.max_grad_norm = max_grad_norm
        self.trust_clip = trust_clip

    @torch.no_grad()
    def step(self, closure=None, updates=None):
        if closure is not None:
            raise ValueError("Lamb.step takes no closure")
        groups = self.param_groups
        shards, copies = _group_copies(groups)
        grads = [[torch.zeros_like(local(p)) if p.grad is None
                  else local(p.grad) for p in group["params"]]
                 for group in groups]
        clip = self.max_grad_norm is not None and self.max_grad_norm > 0
        params = [[local(p) for p in g["params"]] for g in groups]
        if copies is None:
            clip_sq = [sum(g.float().square().sum() for group in grads
                           for g in group)] if clip else []
        else:
            clip_sq = [sum(_sumsq(g, c) for group, cs in zip(grads, copies)
                           for g, c in zip(group, cs))] if clip else []
        # The clip norm and every leaf's parameter norm (over shards, in
        # one all-reduce: the parameters do not move before the update).
        p_norms, clip_norm = _leaf_norms(groups, params, shards, clip_sq,
                                         copies)
        if clip:
            scale = torch.clamp(self.max_grad_norm / (clip_norm[0] + 1e-6),
                                max=1.0)
            grads = [[g * scale for g in group] for group in grads]
        # The trust ratio of each JAX leaf needs all of its layers'
        # parameters and updates before any of them moves.
        pairs = [list(self._updates(group, group_grads))
                 for group, group_grads in zip(groups, grads)]
        u_norms = _leaf_norms(groups, [[u for _, u in gp] for gp in pairs],
                              shards, copies=copies)[0]
        for i, group in enumerate(groups):
            keys = group.get("stacks") or range(len(pairs[i]))
            for key, (p, upd) in zip(keys, pairs[i]):
                p_norm, u_norm = p_norms[i][key], u_norms[i][key]
                ratio = torch.where((p_norm > 0) & (u_norm > 0),
                                    p_norm / u_norm, torch.ones_like(p_norm))
                if self.trust_clip is not None:
                    ratio = torch.clamp(ratio, max=self.trust_clip)
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
            grads = [torch.zeros_like(local(p)) if p.grad is None
                     else local(p.grad) for p in group["params"]]
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
        groups = self.param_groups
        shards, copies = _group_copies(groups)
        grads = [[torch.zeros_like(local(p)) if p.grad is None
                  else local(p.grad) for p in group["params"]]
                 for group in groups]
        if self.max_grad_norm > 0:
            # Every leaf's clip norm, in one all-reduce under FSDP.
            norms = _leaf_norms(groups, grads, shards, copies=copies)[0]
            for i, group in enumerate(groups):
                keys = group.get("stacks") or range(len(grads[i]))
                grads[i] = [g * torch.clamp(
                    self.max_grad_norm / (norms[i][key] + 1e-6),
                    max=1.0).to(g.dtype) for key, g in zip(keys, grads[i])]
        for group, group_grads in zip(groups, grads):
            for p, upd in self._updates(group, group_grads):
                self._apply(p, (-group["lr"] * upd).to(p.dtype), updates)


class DynamicLossScale:
    """fp16 dynamic loss scaling around an Adam-family optimizer: the JAX
    ``dynamic_loss_scale`` (optim/transforms.py; torch GradScaler's
    defaults: init 2**16, growth 2x after ``growth_interval`` finite steps,
    backoff 0.5x), with its state ``{scale: f32, growth_count: i32,
    inner}`` (the JAX ``LossScaleState``).

    The caller multiplies the loss by :attr:`scale` before the backward;
    :meth:`step` multiplies every ``.grad`` by ``1 / scale`` (fp32, in
    place) and then:

    * all finite: the inner step runs; after ``growth_interval``
      consecutive finite steps the scale doubles and the count resets;
    * any inf or nan: the step is skipped (parameters, moments and the
      inner count unchanged, no update recorded), the scale halves and
      the count resets to 0.

    The skip is decided on the host: one read of one device scalar per
    step. Under FSDP, ``pipe`` or ``model`` each rank sees its parts'
    gradients only, so the flag is agreed over every rank of the world (a
    MIN all-reduce): one rank never skips while another steps. ``param_groups`` and ``state`` are the
    inner optimizer's, so :func:`reset_count`, :func:`opt_step_count`,
    :func:`moments` and :func:`load_moments` see through the wrapper and
    the scale survives the phase switch."""

    GROWTH_FACTOR, BACKOFF_FACTOR = 2.0, 0.5

    def __init__(self, inner: torch.optim.Optimizer,
                 init_scale: float = 2.0 ** 16, growth_interval: int = 2000):
        self.inner = inner
        self.scale = float(np.float32(init_scale))
        self.growth_count = 0
        self.growth_interval = int(growth_interval)

    @property
    def param_groups(self) -> List[dict]:
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def load_scale_state(self, scale: float, growth_count: int) -> None:
        """Set the scale and growth count (a checkpoint's)."""
        self.scale = float(np.float32(scale))
        self.growth_count = int(growth_count)

    @torch.no_grad()
    def step(self, closure=None, updates=None) -> bool:
        """Unscale, then step or skip; returns whether the step ran.
        ``updates`` is passed to the inner step (a skipped step records
        none: its updates are zero)."""
        if closure is not None:
            raise ValueError("DynamicLossScale.step takes no closure")
        params = [p for group in self.param_groups for p in group["params"]]
        grads = [local(p.grad) for p in params if p.grad is not None]
        inv = float(np.float32(1.0) / np.float32(self.scale))
        finite = True
        if grads:
            torch._foreach_mul_(grads, inv)
            # max |g| is finite iff every element is (nan propagates).
            finite = bool(torch.isfinite(torch.stack(
                torch._foreach_norm(grads, float("inf")))).all())
        group, copies = norm_reduction(params)
        if group is not None or copies is not None:
            # Agreed over the whole world: no rank skips alone.
            finite = all_finite_across_ranks(finite, local(params[0]).device)
        if finite:
            self.inner.step(updates=updates)
            self.growth_count += 1
            if self.growth_count >= self.growth_interval:
                self.scale = float(np.float32(self.scale
                                              * self.GROWTH_FACTOR))
                self.growth_count = 0
        else:
            self.scale = float(np.float32(self.scale * self.BACKOFF_FACTOR))
            self.growth_count = 0
        return finite
