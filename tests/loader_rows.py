"""Datasets for the port's loader-worker tests, in a module that imports
neither JAX nor torch: a spawned worker unpickles them by importing this
module."""

import os

import numpy as np


class RowsDataset:
    """``n`` rows of five int32 arrays; the process with the row
    ``die_at`` in its batch exits with code 3 there (a worker dying)."""

    packed = False
    max_sequences_per_pack = 1

    def __init__(self, n: int, seq: int = 8, die_at: int = -1):
        self.n, self.seq, self.die_at = n, seq, die_at

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        if idx == self.die_at:
            os._exit(3)
        row = np.full(self.seq, idx, np.int32)
        return [row, row * 0, row * 0 + 1, row - 1, np.int32(idx % 2)]
