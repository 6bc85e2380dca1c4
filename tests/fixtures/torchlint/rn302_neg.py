"""RN302 negative: seeds from config/arguments; clock calls used for
TIMING are not seeds."""
import time

import numpy as np
import torch


def seed_everything(args):
    torch.manual_seed(args.seed)
    return np.random.default_rng(args.seed)


def timed_draw(shape, generator):
    t0 = time.perf_counter()
    out = torch.rand(shape, generator=generator)
    return out, time.perf_counter() - t0
