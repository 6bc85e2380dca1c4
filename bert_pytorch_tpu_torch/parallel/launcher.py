"""Multi-process launcher: the port of the JAX package's
``parallel/launcher.py`` (``initialize``, ``infer_coordinator``) over
``torch.distributed``.

One process drives one GPU. A run is launched as PyTorch users launch it::

    torchrun --nproc_per_node N -m bert_pytorch_tpu_torch.run_pretraining \\
        --mesh dp=N ...

and :func:`initialize` joins the rendezvous from the environment:

1. torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
   ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``;
2. the JAX launcher's ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``
   and ``JAX_PROCESS_ID`` (the Cobalt fan-out script sets them);
3. SLURM's (``SLURM_NODELIST`` with more than one task: ``SLURM_NTASKS``,
   ``SLURM_PROCID``, ``SLURM_LOCALID``; the coordinator is the first
   host of the node list, as the reference's sbatch infers it).

ANY name of a family present marks the run as explicitly multi-process,
so a partly configured rank fails here, naming what it lacks, instead of
training solo while its peers block on the rendezvous (the JAX rule,
launcher.py:77-99). A single process with none of them initialises
nothing, as in JAX; a rendezvous that fails raises.

The backend follows the device: ``nccl`` on ``cuda``, ``gloo`` on
``cpu``. Ranks of one host that outnumber its cards share them, and NCCL
refuses two ranks on one device, so they take ``gloo``: the choice is made
from the topology before ``init_process_group``, never after a failure.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import subprocess
from typing import Optional

import torch
import torch.distributed as dist

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
JAX_ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class Topology:
    """What :func:`initialize` found: this process's place in the run and
    the backend its group uses (None when nothing was initialised)."""

    rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    local_world_size: int = 1
    backend: Optional[str] = None
    source: str = "single"

    @property
    def distributed(self) -> bool:
        return self.backend is not None


def infer_coordinator(port: int = 9731) -> Optional[str]:
    """Infer the coordinator address the way the reference's sbatch infers
    the master node from $SLURM_NODELIST / $COBALT_NODEFILE
    (sbatch:49-62)."""
    nodelist = os.environ.get("SLURM_NODELIST")
    if nodelist:
        out = subprocess.run(["scontrol", "show", "hostnames", nodelist],
                             capture_output=True, text=True, check=False)
        if out.returncode == 0 and out.stdout.strip():
            return f"{out.stdout.splitlines()[0].strip()}:{port}"
    nodefile = os.environ.get("COBALT_NODEFILE")
    if nodefile and os.path.exists(nodefile):
        with open(nodefile) as f:
            first = f.readline().strip()
        if first:
            return f"{first}:{port}"
    return None


def _require(names, family: str, allowed_missing=()) -> None:
    missing = [n for n in names
               if n not in os.environ and n not in allowed_missing]
    if missing:
        present = [n for n in names if n in os.environ]
        raise ValueError(
            f"partly configured {family} rank: {present} set but {missing} "
            "missing; a rank must never train solo while its peers wait at "
            "the rendezvous")


def discover(init_method: Optional[str] = None) -> Optional[dict]:
    """The rendezvous this process is configured for, by the precedence of
    the module docstring: ``{rank, world_size, local_rank,
    local_world_size, init_method, source}``, or None for a single
    process. ``init_method`` (a ``file://`` rendezvous, say) replaces the
    environment's address. Raises ``ValueError`` for a partly configured
    rank."""
    if any(n in os.environ for n in TORCHRUN_ENV):
        # An init_method given by the caller (a file:// rendezvous) stands
        # in for the TCP store's address.
        _require(TORCHRUN_ENV, "torchrun",
                 ("MASTER_ADDR", "MASTER_PORT") if init_method else ())
        world = int(os.environ["WORLD_SIZE"])
        rank_ = int(os.environ["RANK"])
        return dict(rank=rank_, world_size=world,
                    local_rank=int(os.environ.get("LOCAL_RANK", rank_)),
                    local_world_size=int(os.environ.get(
                        "LOCAL_WORLD_SIZE", world)),
                    init_method=init_method or "env://", source="torchrun")
    if any(n in os.environ for n in JAX_ENV):
        _require(JAX_ENV, "JAX_*")
        world = int(os.environ["JAX_NUM_PROCESSES"])
        rank_ = int(os.environ["JAX_PROCESS_ID"])
        return dict(rank=rank_, world_size=world,
                    local_rank=int(os.environ.get("LOCAL_RANK", 0)),
                    local_world_size=int(os.environ.get(
                        "LOCAL_WORLD_SIZE", 1)),
                    init_method=init_method or
                    f"tcp://{os.environ['JAX_COORDINATOR_ADDRESS']}",
                    source="jax")
    tasks = int(os.environ.get("SLURM_NTASKS",
                               os.environ.get("SLURM_NNODES", "1")))
    if "SLURM_NODELIST" in os.environ and tasks > 1:
        coordinator = init_method or infer_coordinator()
        if coordinator is None:
            raise ValueError("SLURM run with more than one task but no "
                             "coordinator could be inferred from "
                             "SLURM_NODELIST (scontrol unavailable)")
        return dict(rank=int(os.environ.get(
                        "SLURM_PROCID", os.environ.get("SLURM_NODEID", 0))),
                    world_size=tasks,
                    local_rank=int(os.environ.get("SLURM_LOCALID", 0)),
                    local_world_size=int(os.environ.get(
                        "SLURM_NTASKS_PER_NODE", 1)),
                    init_method=(coordinator if "://" in coordinator
                                 else f"tcp://{coordinator}"),
                    source="slurm")
    return None


def choose_backend(device_type: str, local_world_size: int,
                   n_cards: Optional[int] = None) -> str:
    """``nccl`` for ranks on their own cards, ``gloo`` on the CPU or when
    the host's ranks outnumber its cards (NCCL refuses two ranks on one
    device)."""
    if device_type != "cuda":
        return "gloo"
    n_cards = torch.cuda.device_count() if n_cards is None else n_cards
    return "nccl" if local_world_size <= n_cards else "gloo"


def initialize(device_type: str = "cuda", init_method: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> Topology:
    """Join the run's rendezvous (see the module docstring) and return its
    :class:`Topology`; a single process without any launcher environment
    initialises nothing. On ``cuda`` the process takes card ``local_rank``
    (modulo the host's cards when ranks share them) before the group
    forms. A group that already exists is reused. A rendezvous that fails
    or times out raises."""
    if dist.is_initialized():
        backend = dist.get_backend()
        return Topology(dist.get_rank(), dist.get_world_size(),
                        int(os.environ.get("LOCAL_RANK", dist.get_rank())),
                        int(os.environ.get("LOCAL_WORLD_SIZE",
                                           dist.get_world_size())),
                        backend, "existing")
    found = discover(init_method)
    if found is None:
        return Topology()
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda but torch.cuda.is_available() is False; pass "
                "--device cpu to run on the CPU")
        torch.cuda.set_device(found["local_rank"]
                              % torch.cuda.device_count())
    backend = choose_backend(device_type, found["local_world_size"])
    dist.init_process_group(
        backend=backend, init_method=found["init_method"],
        rank=found["rank"], world_size=found["world_size"],
        timeout=datetime.timedelta(seconds=timeout_s))
    return Topology(found["rank"], found["world_size"], found["local_rank"],
                    found["local_world_size"], backend, found["source"])


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
