"""Model-internals health: in-step grad/param/update statistics + the
host-side divergence early-warning that consumes them (the port of the
JAX package's ``telemetry/model_stats.py``).

The systems telemetry (step_timer/sentinels) says where the wall clock
goes; this module says whether the MODEL is healthy while it goes there: a
divergence announces itself as a grad-norm spike, or an update:weight
ratio drifting toward 1, many steps before the loss goes NaN and the
FailureSentinel's non-finite tripwire could fire.

In-step half (:func:`grad_health`, called through :func:`step_with_health`
by the pretraining step and the finetune steps on due steps): per-layer-group
gradient norms, parameter norms and update:weight ratios, reduced on the
device (``torch._foreach_norm``, then one sum per group). The updates are
the ones the optimizer applied, as the JAX block's are ``tx.update``'s,
not the difference of the weights (which adds one fp32 rounding of each
weight). A Python ``if`` on the optimizer count (:func:`is_due`) replaces
the JAX ``lax.cond`` gate: an off-cadence step computes nothing, and the
host only reads the block on synced steps (``TrainTelemetry.step_done``).

Layer groups carry the JAX package's keys. The port's parameter names
are the JAX params paths with ``.`` for ``/`` (``models/convert.py`` maps
them name for name), so the shared ``bert`` container splits one level
deeper (``bert/embeddings``, ``bert/encoder``, ``bert/pooler``) and every
other top-level module (``predictions``, ``qa_outputs``, ``classifier``,
...) is one group. The encoder's layers (``bert.encoder.layers.<i>``,
stacked on a leading axis in the JAX tree) also report a per-layer
gradient-norm vector, which localises a divergence to a layer index.

Host half (:class:`DivergenceMonitor`, driven by
``TrainTelemetry.step_done``): an EMA envelope over the global grad norm
plus an absolute bound on the update:weight ratio. Violations emit
``kind="divergence"`` records and follow the FailureSentinel policy:
``continue`` logs, ``abort`` raises :class:`DivergenceError` (a
:class:`~bert_pytorch_tpu_torch.telemetry.sentinels.NonFiniteError`, so
runner-level handling is shared) after ``patience`` consecutive warned
observations.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional, Sequence

import torch

from bert_pytorch_tpu_torch.parallel.sharding import (local, shard_group,
                                                      sum_over_shards)

from bert_pytorch_tpu_torch.telemetry.sentinels import NonFiniteError

_EPS = 1e-12
_LAYER = re.compile(r"bert\.encoder\.layers\.(\d+)\.")


class DivergenceError(NonFiniteError):
    """Raised by the abort policy after ``patience`` consecutive
    grad-health warnings (grad-norm spike / update-ratio drift)."""


def group_key(name: str) -> str:
    """The JAX layer-group key of one port parameter name: the shared
    ``bert`` container splits one level deeper; everything else groups by
    its top-level module."""
    parts = name.split(".")
    if len(parts) >= 2 and parts[0] == "bert":
        return f"{parts[0]}/{parts[1]}"
    return parts[0]


def tensor_norms(tensors: Sequence[Optional[torch.Tensor]]
                 ) -> List[torch.Tensor]:
    """fp32 L2 norm of each tensor, on its device (a zero for a missing
    one): the per-tensor reduction :func:`grad_health` groups. Of a
    sharded tensor (FSDP), the norm of this rank's shard."""
    present = [local(t).float() for t in tensors if t is not None]
    norms = iter(torch._foreach_norm(present)) if present else iter(())
    zero = torch.zeros((), device=present[0].device if present else None)
    return [zero if t is None else next(norms) for t in tensors]


def _sumsq(norms: List[torch.Tensor], members: List[int]) -> torch.Tensor:
    return torch.stack([norms[i] for i in members]).square().sum()


def grad_health(names: Sequence[str], param_norms: List[torch.Tensor],
                grad_norms: List[torch.Tensor],
                update_norms: List[torch.Tensor],
                grad_scale: Optional[float] = None) -> dict:
    """Grouped grad/param/update statistics (0-d device tensors) from the
    per-tensor norms (:func:`tensor_norms`) of the parameters BEFORE the
    update, the gradients the step applied and the updates the optimizer
    applied, all aligned with the parameter ``names``.

    Returns ``{"grad_norm", "param_norm", "update_ratio", "groups":
    {group: {"grad_norm", "param_norm", "update_ratio"}}}`` plus
    ``"per_layer_grad_norm"`` ([L]) when the model has encoder layers.
    ``update_ratio`` is ||update|| / ||param||, the step-relative weight
    change. ``grad_scale`` divides the reported grad norms: fp16
    gradients carry the dynamic loss scale, and a scaled norm would show
    every doubling of the scale to the spike detector as a 2x spike."""
    members: Dict[str, List[int]] = {}
    layers: Dict[int, List[int]] = {}
    for i, name in enumerate(names):
        members.setdefault(group_key(name), []).append(i)
        match = _LAYER.match(name)
        if match:
            # Host-resident: a regex group of a parameter name.
            # torchlint: disable=HS101
            layers.setdefault(int(match.group(1)), []).append(i)
    if grad_scale is not None:
        grad_norms = [g / grad_scale for g in grad_norms]
    out_groups = {}
    tot_g = tot_p = tot_u = 0.0
    for key in sorted(members):
        gsq = _sumsq(grad_norms, members[key])
        psq = _sumsq(param_norms, members[key])
        usq = _sumsq(update_norms, members[key])
        tot_g, tot_p, tot_u = tot_g + gsq, tot_p + psq, tot_u + usq
        pn = torch.sqrt(psq)
        out_groups[key] = {
            "grad_norm": torch.sqrt(gsq),
            "param_norm": pn,
            "update_ratio": torch.sqrt(usq) / (pn + _EPS),
        }
    pn = torch.sqrt(tot_p)
    out = {
        "grad_norm": torch.sqrt(tot_g),
        "param_norm": pn,
        "update_ratio": torch.sqrt(tot_u) / (pn + _EPS),
        "groups": out_groups,
    }
    if layers:
        out["per_layer_grad_norm"] = torch.sqrt(torch.stack(
            [_sumsq(grad_norms, layers[i]) for i in sorted(layers)]))
    return out


def is_due(count: int, every: int, phase: int = 0) -> bool:
    """Whether the optimizer step at (pre-update) ``count`` computes the
    block: ``(count - phase) % every == 0``; never when ``every`` <= 0.

    ``phase`` is the optimizer count at RUN START: the host reads the
    block on its own run-local 0-based sync cadence, so a
    checkpoint-resumed run whose absolute count is not a multiple of
    ``every`` would otherwise have its due steps land only on unsynced
    steps."""
    # Host-resident: ints of the optimizer count and the flags.
    # torchlint: disable=HS101
    return bool(every) and every > 0 and (count - phase) % every == 0


def step_with_health(optimizer, named: Sequence, every: int,
                     phase: int = 0,
                     grad_scale: Optional[float] = None,
                     whole_names: Optional[Sequence[str]] = None
                     ) -> Optional[dict]:
    """One ``optimizer.step()``; on a due step (:func:`is_due` at the
    optimizer's pre-update count) also the block for
    ``metrics["grad_health"]``, else None. ``named`` is the step's (name,
    parameter) list: the block reduces the parameters' norms and their
    gradients' taken just before the step (the gradients the step is
    given, as the JAX block reads those given to ``tx.update``) and the
    updates the optimizer applied (its ``step(updates=)`` dict). ``"due"``
    is 1.0 (the host reads the JAX block's flag).

    ``grad_scale`` (fp16: the loss scale the gradients carry, the JAX
    ``grad_scale`` / ``finetune_grad_health``'s ``fp16_scale``) divides
    the reported grad norms, and the caller passes ``every`` 1: a skipped
    overflow step does not advance the count, so a count gate would drift
    off the host's sync cadence.

    ``whole_names`` (the single-process model's parameter names) for a
    model split over ``pipe``/``model``: each rank's squares, over their
    ``norm_copies``, go into one vector over the whole names, summed over
    the ``norm_group`` (one all-reduce), so the block is the whole
    model's on every rank."""
    if not is_due(optimizer.param_groups[0]["count"], every, phase):
        optimizer.step()
        return None
    params = [p for _, p in named]
    param_norms = tensor_norms(params)
    grad_norms = tensor_norms([p.grad for p in params])
    updates = {}
    optimizer.step(updates=updates)
    with torch.no_grad():
        update_norms = tensor_norms([updates.get(p) for p in params])
        shards = shard_group(params)
        group = next((p.norm_group for p in params
                      if getattr(p, "norm_group", None) is not None), None)
        if group is not None and whole_names is not None:
            names = list(whole_names)
            at = {n: i for i, n in enumerate(names)}
            w = len(names)
            squares = param_norms[0].new_zeros(3 * w)
            for (name, p), norms in zip(named, zip(
                    param_norms, grad_norms, update_norms)):
                for k, norm in enumerate(norms):
                    squares[k * w + at[name]] += norm.square() / p.norm_copies
            total = torch.sqrt(sum_over_shards(squares, group))
            stats = grad_health(names, list(total[:w]),
                                list(total[w:2 * w]), list(total[2 * w:]),
                                grad_scale)
            stats["due"] = 1.0
            return stats
        if shards is not None:
            # Shards' norms -> whole tensors' norms: every square in one
            # all-reduce over the shard group.
            n = len(params)
            total = torch.sqrt(sum_over_shards(torch.stack(
                param_norms + grad_norms + update_norms).square(), shards))
            param_norms, grad_norms, update_norms = (
                list(total[:n]), list(total[n:2 * n]), list(total[2 * n:]))
        stats = grad_health([n for n, _ in named], param_norms, grad_norms,
                            update_norms, grad_scale)
    stats["due"] = 1.0
    return stats


def health_record(step: int, stats) -> dict:
    """Host-side conversion of a grad-health block into one
    ``kind="grad_health"`` JSONL record (floats/lists only). The caller
    has already synced; every value comes to the host in ONE transfer."""
    groups = stats["groups"]
    scalars = [stats["grad_norm"], stats["param_norm"],
               stats["update_ratio"]]
    for vals in groups.values():
        scalars += [vals["grad_norm"], vals["param_norm"],
                    vals["update_ratio"]]
    parts = [torch.stack(scalars).float()]
    if "per_layer_grad_norm" in stats:
        parts.append(stats["per_layer_grad_norm"].float())
    host = torch.cat(parts).tolist()
    record = {
        "kind": "grad_health",
        "tag": "telemetry",
        "step": int(step),
        "grad_norm": host[0],
        "param_norm": host[1],
        "update_ratio": host[2],
        "groups": {
            name: dict(zip(("grad_norm", "param_norm", "update_ratio"),
                           host[3 + 3 * i:6 + 3 * i]))
            for i, name in enumerate(groups)
        },
    }
    if "per_layer_grad_norm" in stats:
        record["per_layer_grad_norm"] = [
            round(v, 8) for v in host[3 + 3 * len(groups):]]
    return record


class DivergenceMonitor:
    """Host-side divergence early-warning over the grad-health stream.

    Two checks, both configurable and individually disabled by 0:

    * grad-norm spike — the observed global grad norm exceeds
      ``spike_factor`` x its own EMA (seeded over the first ``warmup``
      observations, during which no spike can fire: step-0 norms are
      legitimately wild);
    * update-ratio drift — the global update:weight ratio exceeds
      ``ratio_max`` (a per-step relative weight change of that size means
      the optimizer is rewriting the model, the signature of a blown
      learning rate or a mistuned K-FAC kl_clip).

    Warnings emit ``kind="divergence"`` records and follow the
    FailureSentinel policy: ``abort`` raises :class:`DivergenceError`
    after ``patience`` CONSECUTIVE warned observations.
    """

    POLICIES = ("continue", "abort")

    def __init__(self, emit: Optional[Callable[[dict], None]] = None,
                 policy: str = "continue", patience: int = 3,
                 spike_factor: float = 10.0, ratio_max: float = 1.0,
                 warmup: int = 10, ema_decay: float = 0.9):
        if policy not in self.POLICIES:
            raise ValueError(
                f"divergence policy must be one of {self.POLICIES}, got "
                f"{policy!r}")
        self._emit = emit
        self.policy = policy
        self.patience = max(1, int(patience))
        self.spike_factor = float(spike_factor)
        self.ratio_max = float(ratio_max)
        self.warmup = max(1, int(warmup))
        self.ema_decay = float(ema_decay)
        self.ema = None
        self.observations = 0
        self.consecutive = 0
        self.total_warnings = 0

    def observe(self, step: int, grad_norm: float,
                update_ratio: Optional[float] = None) -> bool:
        """Feed one grad-health observation; True when healthy."""
        grad_norm = float(grad_norm)
        if not math.isfinite(grad_norm):
            return True  # the non-finite sentinel owns that signal
        warnings = []
        if (self.spike_factor and self.ema is not None
                and self.observations >= self.warmup
                and grad_norm > self.spike_factor * self.ema):
            warnings.append(("grad_norm_spike", grad_norm,
                             self.spike_factor * self.ema))
        if (self.ratio_max and update_ratio is not None
                and math.isfinite(float(update_ratio))
                and float(update_ratio) > self.ratio_max):
            warnings.append(("update_ratio_high", float(update_ratio),
                             self.ratio_max))
        if not warnings:
            # The EMA only absorbs HEALTHY observations: folding a
            # spiked norm in would raise the threshold under a
            # diverged-but-plateaued run, so it warns once and then the
            # abort policy's consecutive count can never accumulate.
            self.ema = (grad_norm if self.ema is None
                        else self.ema_decay * self.ema
                        + (1.0 - self.ema_decay) * grad_norm)
        self.observations += 1
        if not warnings:
            self.consecutive = 0
            return True
        self.consecutive += 1
        self.total_warnings += len(warnings)
        for reason, value, threshold in warnings:
            if self._emit is not None:
                self._emit({
                    "kind": "divergence",
                    "tag": "telemetry",
                    "step": int(step),
                    "reason": reason,
                    "value": round(value, 8),
                    "threshold": round(threshold, 8),
                    "consecutive": self.consecutive,
                    "policy": self.policy,
                })
        if self.policy == "abort" and self.consecutive >= self.patience:
            reason, value, threshold = warnings[0]
            raise DivergenceError(
                f"grad-health divergence warning ({reason}: {value:.4g} vs "
                f"threshold {threshold:.4g}) for {self.consecutive} "
                f"consecutive observations (last step {step}); aborting per "
                f"--sentinel_policy abort")
        return False
