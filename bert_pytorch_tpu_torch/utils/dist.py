"""Distributed helpers: the port of the JAX package's ``utils/dist.py``
(parity with reference src/utils.py:22-74) over ``torch.distributed``.

Rank and world size are the default process group's (0 and 1 when none
was initialised, as a single JAX process reports). ``barrier`` is the
process group's. :func:`agree_on_resume_step` keeps the JAX policy: every
rank proposes the newest checkpoint step it could load, and a run resumes
from one step that every rank can see.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def initialized() -> bool:
    """Whether a default process group exists."""
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    """This process's rank; reference utils.py:29-34."""
    return dist.get_rank() if initialized() else 0


def get_world_size() -> int:
    """Number of processes; reference utils.py:37-42."""
    return dist.get_world_size() if initialized() else 1


def is_main_process() -> bool:
    """reference utils.py:45-46."""
    return get_rank() == 0


def barrier() -> None:
    """Block until all processes arrive; reference utils.py:49-51."""
    if get_world_size() > 1:
        dist.barrier()


def collective_device() -> torch.device:
    """Where the default group's small host-value collectives put their
    tensor: the current card under NCCL, the CPU otherwise."""
    if initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shared_token() -> str:
    """A random token that every rank holds the same: rank 0's, in one
    broadcast (every rank calls this at the same point). It names one
    act of the ranks together, such as a sharded checkpoint save."""
    token = torch.tensor([int.from_bytes(os.urandom(7), "little")],
                         dtype=torch.int64, device=collective_device())
    if get_world_size() > 1:
        dist.broadcast(token, 0)
    return f"{int(token.item()):014x}"


def agree_on_resume_step(step: Optional[int]) -> Optional[int]:
    """Cross-process agreement on which checkpoint step to resume from
    (the JAX ``agree_on_resume_step``).

    Every process proposes the newest step it could LOAD (or None). On a
    single process this is the identity. The ranks share a checkpoint
    directory but can observe it differently (a network file system's lag
    after an async write, a partial copy): resuming from different steps
    would silently diverge the run. Policy: if all propose the same step,
    proceed; if they differ but all have one, everyone resumes from the
    MINIMUM (the newest checkpoint every process can see); if any process
    has none while others do, fail fast: the shared storage is
    inconsistent and no silent choice is safe. One int all-gather."""
    world = get_world_size()
    if world == 1:
        return step
    mine = torch.tensor([-1 if step is None else int(step)],
                        dtype=torch.int64, device=collective_device())
    gathered = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(gathered, mine)
    proposals = np.asarray([int(t.item()) for t in gathered])
    lo, hi = int(proposals.min()), int(proposals.max())
    if lo == hi:
        return None if lo == -1 else lo
    if lo == -1:
        raise RuntimeError(
            f"checkpoint directory inconsistent across ranks: some processes "
            f"see no loadable checkpoint while others see step {hi} "
            f"(proposals per process: {proposals.tolist()})")
    return lo


def format_step(epoch, step, split: str = "") -> str:
    """Human-readable step tag; reference utils.py:54-64."""
    parts = []
    if epoch is not None:
        parts.append(f"Epoch: {epoch}")
    if step is not None:
        parts.append(f"Step: {step}")
    if split:
        parts.append(f"Split: {split}")
    return " ".join(parts)


def seed_for_worker(seed: int, rank: Optional[int] = None
                    ) -> np.random.Generator:
    """Seeded numpy generator per (seed, rank): the WorkerInitObj analog
    (reference utils.py:22-26, run_pretraining.py:583-586 seeds with
    seed + local_rank)."""
    rank = get_rank() if rank is None else rank
    return np.random.default_rng(seed + rank)
