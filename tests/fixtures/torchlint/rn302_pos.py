"""RN302 positive: seeds from a wall clock and from a process id — two
processes started in the same second share a stream, and no run can be
replayed."""
import os
import time

import torch


def seed_everything():
    torch.manual_seed(int(time.time()))


def make_generator():
    return torch.Generator().manual_seed(os.getpid())
