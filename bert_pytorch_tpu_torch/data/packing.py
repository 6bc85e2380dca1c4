"""Sequence packing (Krell et al. 2021, arXiv:2107.02027): the greedy
first-fit-decreasing packer the serving engine plans packed batches with.

A copy of the JAX package's ``data.packing.first_fit_decreasing``; the
HDF5 shard format and the packed pretraining dataset are not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence


def first_fit_decreasing(
    lengths: Sequence[int],
    max_seq_len: int,
    max_sequences_per_pack: int,
) -> List[List[int]]:
    """Greedy first-fit-decreasing bin packing.

    Returns packs as lists of indices into ``lengths``; every pack's total
    length fits ``max_seq_len`` and holds at most ``max_sequences_per_pack``
    members. Over-long inputs (length > max_seq_len) get a singleton pack —
    the assembler truncates, matching the unpacked pipeline's behavior.

    FFD is the strategy both packing papers converge on (Krell 2021 §3's
    NNLSHP refines it, Kosec 2021 uses it directly): sorting by decreasing
    length first places the hard-to-fit long sequences, then back-fills the
    gaps with short ones — within ~1-2% of optimal occupancy on BERT-phase
    length histograms at a fraction of the cost.
    """
    if max_seq_len <= 0:
        raise ValueError(f"max_seq_len must be positive, got {max_seq_len}")
    if max_sequences_per_pack < 1:
        raise ValueError(
            "max_sequences_per_pack must be >= 1, got "
            f"{max_sequences_per_pack}")
    order = sorted(range(len(lengths)), key=lambda i: -int(lengths[i]))
    packs: List[List[int]] = []
    residual: List[int] = []  # remaining room per pack
    for idx in order:
        n = min(int(lengths[idx]), max_seq_len)
        placed = False
        for p, room in enumerate(residual):
            if room >= n and len(packs[p]) < max_sequences_per_pack:
                packs[p].append(idx)
                residual[p] = room - n
                placed = True
                break
        if not placed:
            packs.append([idx])
            residual.append(max_seq_len - n)
    # Emit packs ordered by their smallest member index so a streaming
    # consumer (PackedPretrainingDataset over sorted shards) walks the
    # underlying samples roughly forward.
    packs.sort(key=min)
    return packs
