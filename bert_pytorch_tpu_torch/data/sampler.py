"""Contiguous-chunk distributed sampler with a checkpointable position: a
copy of the JAX package's ``data/sampler.py`` (parity with reference
src/dataset.py:341-428 ``DistributedSampler``). Each rank takes a
contiguous chunk of the index space, so ranks stream different shard files
sequentially; the sampler is its own iterator, so its ``index`` is the
resume position, saved and restored with :meth:`state_dict` and
:meth:`load_state_dict` under the JAX package's keys and rules."""

from __future__ import annotations

import math
import warnings


class DistributedSampler:
    def __init__(self, dataset, num_replicas: int = 1, rank: int = 0,
                 drop_last: bool = False, seed: int = 0):
        if rank >= num_replicas or rank < 0:
            raise ValueError(
                f"rank {rank} out of range for {num_replicas} replicas")
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        n = len(dataset)
        if self.drop_last and n % num_replicas != 0:
            self.num_samples = n // num_replicas
        else:
            self.num_samples = math.ceil(n / num_replicas)
        self.total_size = self.num_samples * num_replicas
        indices = list(range(n))
        if not self.drop_last:
            padding_size = self.total_size - len(indices)
            if padding_size <= len(indices):
                indices += indices[:padding_size]
            else:
                indices += (indices * math.ceil(
                    padding_size / len(indices)))[:padding_size]
        else:
            indices = indices[:self.total_size]
        assert len(indices) == self.total_size
        self.global_indices = indices
        self.index = 0

    def __len__(self) -> int:
        return self.num_samples

    def __iter__(self):
        return self

    def __next__(self) -> int:
        if self.index == self.num_samples:
            self.index = 0
            raise StopIteration()
        x = self.global_indices[self.index + self.rank * self.num_samples]
        self.index += 1
        return x

    def state_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "seed": self.seed,
            "num_replicas": self.num_replicas,
            "total_size": self.total_size,
            "index": self.index,
        }

    def load_state_dict(self, state_dict: dict) -> None:
        """Restore the position; a changed dataset size or replica count
        warns and keeps the fresh position, as the JAX sampler does."""
        if state_dict["total_size"] != self.total_size:
            warnings.warn(
                "The number of samples in the Sampler has changed. Skipping "
                f"restoring sampler state. Expected size {self.total_size} "
                f"but got size {state_dict['total_size']}. If the dataset "
                "was changed and the sampler should be reset, ignore this "
                "message")
            return
        if state_dict["num_replicas"] != self.num_replicas:
            warnings.warn(
                "The number of replicas has changed so the resume index "
                "from the sampler is no longer valid. Skipping restoring "
                "sampler state.")
            return
        self.epoch = int(state_dict["epoch"])
        self.seed = int(state_dict["seed"])
        self.index = int(state_dict["index"])

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
