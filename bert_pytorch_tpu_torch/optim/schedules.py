"""Learning-rate schedules: the port of the JAX package's
``optim/schedules.py`` (parity with reference src/schedulers.py and
src/optimization.py:36-62), as plain functions of the optimizer's step
count.

Offset semantics: the reference sets ``last_epoch = optimizer_step + 1``
before computing the lr (schedulers.py:97-105,126-134), so the lr used at
0-indexed optimizer step t is schedule((t+1)/total); the factories below
reproduce that with ``offset=1``. Values are Python floats (float64), where
the JAX schedules compute in fp32.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def _warmup(progress: float, warmup: float) -> float:
    return progress / max(warmup, 1e-12)


def warmup_poly_schedule(base_lr: float, warmup: float, total_steps: int,
                         degree: float = 0.5, offset: int = 1) -> Schedule:
    """Warmup then (1-progress)^degree decay (PolyWarmUpScheduler,
    schedulers.py:115-141; degree 0.5 is the BERT recipe)."""

    def schedule(count):
        progress = (count + offset) / total_steps
        if progress < warmup:
            return base_lr * _warmup(progress, warmup)
        return base_lr * max(1.0 - progress, 0.0) ** degree

    return schedule


def warmup_linear_schedule(base_lr: float, warmup: float, total_steps: int,
                           offset: int = 1) -> Schedule:
    """Warmup then linear decay to 0 at progress=1 (LinearWarmUpScheduler,
    schedulers.py:87-112)."""

    def schedule(count):
        progress = (count + offset) / total_steps
        if progress < warmup:
            return base_lr * _warmup(progress, warmup)
        return base_lr * max((progress - 1.0) / (warmup - 1.0), 0.0)

    return schedule


def warmup_cosine_schedule(base_lr: float, warmup: float, total_steps: int,
                           offset: int = 1) -> Schedule:
    """Warmup then 0.5*(1+cos(pi + progress)) decay: the reference's formula
    verbatim (schedulers.py:66 adds pi to progress rather than multiplying;
    its behaviour is kept)."""

    def schedule(count):
        progress = (count + offset) / total_steps
        if progress < warmup:
            return base_lr * _warmup(progress, warmup)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi + progress))

    return schedule


def warmup_constant_schedule(base_lr: float, warmup: float, total_steps: int,
                             offset: int = 1) -> Schedule:
    """Warmup then constant (ConstantWarmUpScheduler, schedulers.py:69-84)."""

    def schedule(count):
        progress = (count + offset) / total_steps
        if progress < warmup:
            return base_lr * _warmup(progress, warmup)
        return base_lr

    return schedule


def warmup_exp_decay_exp_schedule(base_lr: float, decay_rate: float,
                                  decay_steps: int, total_steps: int,
                                  warmup: float = 0.002,
                                  degree: float = 2.0) -> Schedule:
    """Polynomial warmup then exponential decay (``warmup_exp_decay_exp``,
    schedulers.py:144-158). No +1 offset: the reference calls this one with
    the raw global step."""

    def schedule(count):
        if warmup == 0.0:
            return base_lr
        x = count / total_steps
        if x < warmup:
            return base_lr * _warmup(x, warmup) ** degree
        warmup_end = warmup * total_steps
        return base_lr * decay_rate ** ((count - warmup_end) / decay_steps)

    return schedule


SCHEDULES = {
    "poly": warmup_poly_schedule,
    "linear": warmup_linear_schedule,
    "cosine": warmup_cosine_schedule,
    "constant": warmup_constant_schedule,
}


def make_schedule(name: str, base_lr: float, warmup: float,
                  total_steps: int, **kwargs) -> Schedule:
    """Factory keyed the way ``--lr_decay`` is (run_pretraining.py:288-293)."""
    if name not in SCHEDULES:
        raise ValueError(
            f"Unknown lr decay '{name}'; options: {sorted(SCHEDULES)}")
    return SCHEDULES[name](base_lr, warmup, total_steps, **kwargs)
