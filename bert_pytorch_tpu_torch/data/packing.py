"""Sequence packing (Krell et al. 2021, arXiv:2107.02027): a copy of the
JAX package's ``data/packing.py``.

* :func:`first_fit_decreasing` — the greedy packer the serving engine and
  the on-the-fly pretraining mode use;
* :func:`pack_features` — one packed row from per-sample features;
* :func:`write_packed_shard` — an offline-packed HDF5 shard (``h5py``
  imported inside);
* :class:`PackedPretrainingDataset` — ``--pack_sequences``: packs within
  each shard of a :class:`~bert_pytorch_tpu_torch.data.dataset.
  ShardedPretrainingDataset` and assembles rows from its already-masked
  samples.

A packed row carries ``sequence_ids`` [S] (0 = pad, k = k-th sequence) and
``cls_positions`` [K], and ``next_sentence_labels`` [K] (-1 = empty slot).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


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


def pack_features(samples: Sequence[Sequence[np.ndarray]], max_seq_len: int,
                  max_sequences_per_pack: int) -> list:
    """One packed row from per-sample features ``[input_ids, segment_ids,
    input_mask, masked_lm_labels, next_sentence_label]`` (already masked,
    padded rows): the non-pad prefix of each is concatenated. Returns
    ``[input_ids, segment_ids, input_mask, masked_lm_labels,
    next_sentence_labels[K], sequence_ids, cls_positions[K]]``."""
    if not 1 <= len(samples) <= max_sequences_per_pack:
        raise ValueError(
            f"pack holds {len(samples)} sequences, limit is "
            f"{max_sequences_per_pack}")
    input_ids = np.zeros(max_seq_len, np.int32)
    segment_ids = np.zeros(max_seq_len, np.int32)
    input_mask = np.zeros(max_seq_len, np.int32)
    labels = np.full(max_seq_len, -1, np.int32)
    sequence_ids = np.zeros(max_seq_len, np.int32)
    nsp = np.full(max_sequences_per_pack, -1, np.int32)
    cls_positions = np.zeros(max_sequences_per_pack, np.int32)
    offset = 0
    for k, sample in enumerate(samples):
        ids, segs, mask, labs, nsp_k = sample[:5]
        n = int(np.sum(np.asarray(mask) != 0))
        n = min(n, max_seq_len - offset)
        if n <= 0:
            raise ValueError(
                "pack overflows max_seq_len "
                f"({max_seq_len}); the packer must pre-fit lengths")
        input_ids[offset:offset + n] = np.asarray(ids)[:n]
        segment_ids[offset:offset + n] = np.asarray(segs)[:n]
        input_mask[offset:offset + n] = 1
        labels[offset:offset + n] = np.asarray(labs)[:n]
        sequence_ids[offset:offset + n] = k + 1
        nsp[k] = int(np.asarray(nsp_k).reshape(()))
        cls_positions[k] = offset
        offset += n
    return [input_ids, segment_ids, input_mask, labels, nsp, sequence_ids,
            cls_positions]


def write_packed_shard(path: str, rows: Sequence[Sequence],
                       max_seq_len: int, max_sequences_per_pack: int) -> int:
    """Write an offline-packed HDF5 shard; returns its row count. ``rows``
    is a list of packed rows, each a list of members ``(token_ids,
    special_token_positions, next_sentence_label)`` with positions
    relative to the member (rebased onto the row here) and token ids
    unpadded, [CLS]/[SEP] included. The shard stores raw ids: the dataset
    masks each member at read time, as unpacked."""
    import h5py

    from bert_pytorch_tpu_torch.data.dataset import PACKED_MAX_SEQUENCES_ATTR

    n = len(rows)
    input_ids = np.zeros((n, max_seq_len), np.int32)
    seq_lengths, specials, nsp_labels = [], [], []
    for r, members in enumerate(rows):
        if not 1 <= len(members) <= max_sequences_per_pack:
            raise ValueError(
                f"row {r} holds {len(members)} sequences, limit is "
                f"{max_sequences_per_pack}")
        offset = 0
        lens, specs, nsps = [], [], []
        for ids, special, nsp in members:
            ids = np.asarray(ids, np.int32)
            if offset + len(ids) > max_seq_len:
                raise ValueError(
                    f"row {r} overflows max_seq_len ({max_seq_len})")
            input_ids[r, offset:offset + len(ids)] = ids
            lens.append(len(ids))
            specs.extend(int(p) + offset for p in special)
            nsps.append(int(nsp))
            offset += len(ids)
        seq_lengths.append(np.asarray(lens, np.int32))
        specials.append(np.asarray(specs, np.int32))
        nsp_labels.append(np.asarray(nsps, np.int8))

    vlen_i4 = h5py.vlen_dtype(np.dtype("i4"))
    vlen_i1 = h5py.vlen_dtype(np.dtype("i1"))
    with h5py.File(path, "w") as f:
        f.create_dataset("input_ids", data=input_ids, dtype="i4",
                         compression="gzip")
        ds_len = f.create_dataset(
            "packed_sequence_lengths", (n,), dtype=vlen_i4)
        ds_spec = f.create_dataset(
            "packed_special_token_positions", (n,), dtype=vlen_i4)
        ds_nsp = f.create_dataset("next_sentence_labels", (n,), dtype=vlen_i1)
        for r in range(n):
            ds_len[r] = seq_lengths[r]
            ds_spec[r] = specials[r]
            ds_nsp[r] = nsp_labels[r]
        f.attrs[PACKED_MAX_SEQUENCES_ATTR] = int(max_sequences_per_pack)
    return n


def _sample_lengths_for_file(path: str) -> np.ndarray:
    """Per-sample token lengths of one unpacked shard, from its metadata."""
    import h5py

    with h5py.File(path, "r") as f:
        if "special_token_positions" in f:
            specials = f["special_token_positions"][:]
            return np.asarray([int(sp[-1]) + 1 for sp in specials], np.int64)
        return np.asarray(f["input_mask"][:], np.int64).sum(axis=1)


class PackedPretrainingDataset:
    """On-the-fly packing over a ``ShardedPretrainingDataset``: samples are
    packed first-fit-decreasing WITHIN each shard (so the base dataset's
    forward-moving file access holds), and ``__getitem__(i)`` fetches the
    pack's members through the base dataset (masking per member exactly as
    unpacked) and assembles one row with :func:`pack_features`."""

    def __init__(self, base, max_sequences_per_pack: int = 8,
                 max_seq_len: Optional[int] = None):
        if getattr(base, "packed", False):
            raise ValueError(
                "base dataset already reads offline-packed shards; "
                "on-the-fly packing would pack packs")
        self.base = base
        self.max_sequences_per_pack = int(max_sequences_per_pack)
        if max_seq_len is None:
            import h5py

            with h5py.File(base.files[0], "r") as f:
                max_seq_len = int(f["input_ids"].shape[1])
        self.max_seq_len = int(max_seq_len)
        self.packs: List[List[int]] = []
        total_tokens = 0
        for fpath, (start, _end) in zip(base.files, base.file_idxs):
            lengths = _sample_lengths_for_file(fpath)
            total_tokens += int(lengths.sum())
            for pack in first_fit_decreasing(
                    lengths, self.max_seq_len, self.max_sequences_per_pack):
                self.packs.append([start + i for i in pack])
        self.occupancy = float(total_tokens) / max(
            1, len(self.packs) * self.max_seq_len)
        self.n_samples = len(base)

    def set_epoch(self, epoch: int) -> None:
        self.base.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.packs)

    def __getitem__(self, idx: int):
        members = [self.base[i] for i in self.packs[idx]]
        return pack_features(members, self.max_seq_len,
                             self.max_sequences_per_pack)
