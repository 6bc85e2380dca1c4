"""Sharded HDF5 pretraining dataset with dynamic masking: a copy of the
JAX package's ``data/dataset.py`` (parity with reference src/dataset.py:
9-338, ``ShardedPretrainingDataset``).

The same samples for the same shards and seed: at most two shard files in
memory (the current one and a background-thread prefetch of the next),
segment ids and input mask derived from ``special_token_positions``,
dynamic masking with the 80/10/10 split drawn WITHOUT replacement from a
per-sample generator seeded on ``(seed, epoch, index)``, the legacy NVIDIA
pre-masked format, offline-packed shards (``packed_sequence_lengths``),
and warn-and-skip verification of unreadable shards.

Not copied: the read retries with backoff, the fault-injection hooks and
the ``shard_error_policy='abort'`` option of the JAX package's data path (a
failed read of a verified shard raises :class:`DataReadError`).
``h5py`` is imported inside the shard reader only: the port runs on
machines without it as long as it reads no shard.
"""

from __future__ import annotations

import os
import threading
import warnings
from typing import Optional, Sequence

import numpy as np

NEW_FORMAT_KEYS = ("input_ids", "special_token_positions",
                   "next_sentence_labels")
LEGACY_FORMAT_KEYS = ("input_ids", "segment_ids", "input_mask",
                      "masked_lm_positions", "masked_lm_ids",
                      "next_sentence_labels")
PACKED_KEY = "packed_sequence_lengths"
PACKED_MAX_SEQUENCES_ATTR = "packed_max_sequences"


class DataReadError(RuntimeError):
    """A read of a verified shard failed."""


def _read_shard(filepath: str, reader):
    """Run ``reader(h5py.File)`` on one shard."""
    import h5py

    with h5py.File(filepath, "r") as f:
        return reader(f)


def mask_input(rng: np.random.Generator, input_ids: np.ndarray,
               special_token_positions, max_pred_per_seq: int,
               masked_lm_prob: float, vocab_size: int,
               mask_token_index: Optional[int],
               original_token_prob: float = 0.1,
               random_token_prob: float = 0.1):
    """Dynamic masking (reference dataset.py:277-296), in place on
    ``input_ids``: choose min(max_pred, max(1, int(n * prob))) of the n
    non-special positions before the last special token, without
    replacement; each keeps its token w.p. ``original_token_prob``, becomes
    a random id w.p. ``random_token_prob``, else ``mask_token_index``.
    Returns (input_ids, labels) with labels -1 where nothing is masked."""
    masked_lm_labels = np.full_like(input_ids, -1)
    candidates = np.arange(int(special_token_positions[-1]))
    candidates = candidates[
        ~np.isin(candidates, np.asarray(special_token_positions))]
    if candidates.size == 0:
        return input_ids, masked_lm_labels
    mask_count = min(max_pred_per_seq,
                     max(1, int(candidates.size * masked_lm_prob)))
    mask_indices = rng.choice(candidates,
                              size=min(mask_count, candidates.size),
                              replace=False)
    masked_lm_labels[mask_indices] = input_ids[mask_indices]
    draws = rng.random(mask_indices.size)
    rand_sel = mask_indices[
        (draws >= original_token_prob)
        & (draws < original_token_prob + random_token_prob)]
    mask_sel = mask_indices[draws >= original_token_prob + random_token_prob]
    if rand_sel.size:
        input_ids[rand_sel] = rng.integers(0, vocab_size - 1,
                                           size=rand_sel.size)
    input_ids[mask_sel] = mask_token_index
    return input_ids, masked_lm_labels


def segment_ids_for(input_ids, special_token_positions):
    """[CLS] a... [SEP] b... [SEP] pad -> 0 0...0 0 1...1 1 0...0
    (reference dataset.py:224-238)."""
    segment_ids = np.zeros_like(input_ids)
    if len(special_token_positions) == 3:
        segment_ids[special_token_positions[1] + 1:
                    special_token_positions[2] + 1] = 1
    return segment_ids


def input_mask_for(input_ids, special_token_positions):
    """1 through the final [SEP], 0 on padding (dataset.py:240-252)."""
    input_mask = np.zeros_like(input_ids)
    input_mask[:special_token_positions[-1] + 1] = 1
    return input_mask


class ShardedPretrainingDataset:
    """Streams sorted HDF5 shards keeping <= 2 files in memory.

    ``__getitem__`` expects forward-moving indices (per reader), which
    :class:`~bert_pytorch_tpu_torch.data.sampler.DistributedSampler` gives;
    forward skips and cyclic wrap-around are supported, random access
    reloads shard files."""

    def __init__(self, files, mask_token_index: Optional[int],
                 max_pred_per_seq: int, masked_lm_prob: float,
                 vocab_size: int, original_token_prob: float = 0.1,
                 random_token_prob: float = 0.1, seed: Optional[int] = None):
        if mask_token_index is not None and not isinstance(
                mask_token_index, (int, np.integer)):
            raise ValueError("mask_token_index must be an integer")
        if (not isinstance(max_pred_per_seq, (int, np.integer))
                or max_pred_per_seq < 0):
            raise ValueError("max_pred_per_seq must be an integer >= 0")
        if not 0 <= masked_lm_prob <= 1:
            raise ValueError("masked_lm_prob must be in [0,1]")
        if not isinstance(vocab_size, (int, np.integer)) or vocab_size < 0:
            raise ValueError("vocab_size must be an integer >= 0")
        if not 0 <= original_token_prob <= 1:
            raise ValueError("original_token_prob must be in [0,1]")
        if not 0 <= random_token_prob <= 1:
            raise ValueError("random_token_prob must be in [0,1]")
        if random_token_prob + original_token_prob > 1:
            raise ValueError("random_token_prob + original_token_prob > 1")
        if isinstance(files, str):
            files = [files]
        files = sorted(files)  # all processes must agree on the order
        (self.files, self.file_idxs, self.packed,
         self.max_sequences_per_pack) = self._verify_and_count_samples(files)

        self.mask_token_index = mask_token_index
        self.max_pred_per_seq = int(max_pred_per_seq)
        self.masked_lm_prob = float(masked_lm_prob)
        self.vocab_size = int(vocab_size)
        self.original_token_prob = float(original_token_prob)
        self.random_token_prob = float(random_token_prob)
        self.seed = seed
        self.epoch = 0
        self._mask_seed_base = self._seed_base(seed)
        self._rng = np.random.default_rng(seed)

        self.file_idx: Optional[int] = None
        self.next_file_idx: Optional[int] = None
        self.file_sample_start_idx = -1
        self.file_sample_end_idx = -1
        self.data = None
        self._next_file_data = None
        self._next_file_error: Optional[BaseException] = None
        self._next_file_thread: Optional[threading.Thread] = None

    @staticmethod
    def _seed_base(seed: Optional[int]) -> int:
        """Base entropy of the per-sample masking generators; ``None``
        draws fresh OS entropy, so unseeded runs draw run-unique masks."""
        if seed is not None:
            return int(seed) % (2 ** 63)
        return int(np.random.SeedSequence().entropy) % (2 ** 63)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.file_idxs[-1][1]

    def __getitem__(self, idx: int):
        if self.data is None:
            self.next_file_idx = self._file_idx_for(idx)
            self._next_file_thread = self._async_load_file(self.next_file_idx)
        if not (self.file_sample_start_idx <= idx < self.file_sample_end_idx):
            # Walk the cyclic file sequence forward to the file holding idx.
            target = self._file_idx_for(idx)
            while self.file_idx != target:
                del self.data
                self._next_file_thread.join()
                if self._next_file_error is not None:
                    error, self._next_file_error = self._next_file_error, None
                    self.data = None
                    raise DataReadError(
                        f"shard load failed: {type(error).__name__}: "
                        f"{error}") from error
                self.data = self._next_file_data
                self.file_idx = self.next_file_idx
                self.next_file_idx = (self.next_file_idx + 1) % len(self.files)
                self._next_file_thread = self._async_load_file(
                    self.next_file_idx)
                (self.file_sample_start_idx,
                 self.file_sample_end_idx) = self.file_idxs[self.file_idx]

        # Per-sample masking generator from (seed, epoch, index).
        self._rng = np.random.default_rng(
            (self._mask_seed_base, int(self.epoch), int(idx)))
        local = idx - self.file_sample_start_idx
        input_ids = np.array(self.data["input_ids"][local])
        next_sentence_label = np.asarray(
            self.data["next_sentence_labels"][local])

        if self.packed:
            return self._packed_item(local, input_ids, next_sentence_label)
        if "special_token_positions" in self.data:
            special = np.asarray(self.data["special_token_positions"][local])
            segment_ids = segment_ids_for(input_ids, special)
            input_mask = input_mask_for(input_ids, special)
            masked_input_ids, masked_lm_labels = self._mask_input(
                input_ids, special)
        else:
            # Legacy NVIDIA pre-masked format (reference dataset.py:184-192).
            segment_ids = np.asarray(self.data["segment_ids"][local])
            input_mask = np.asarray(self.data["input_mask"][local])
            positions = np.asarray(self.data["masked_lm_positions"][local])
            ids = np.asarray(self.data["masked_lm_ids"][local])
            masked_input_ids = input_ids
            masked_lm_labels = self._get_masked_labels(input_ids, positions,
                                                       ids)
        return [
            masked_input_ids.astype(np.int32),
            segment_ids.astype(np.int32),
            input_mask.astype(np.int32),
            masked_lm_labels.astype(np.int32),
            next_sentence_label.astype(np.int32),
        ]

    def _mask_input(self, input_ids, special_token_positions):
        return mask_input(self._rng, input_ids, special_token_positions,
                          self.max_pred_per_seq, self.masked_lm_prob,
                          self.vocab_size, self.mask_token_index,
                          self.original_token_prob, self.random_token_prob)

    def _packed_item(self, local: int, input_ids, nsp_labels):
        """One offline-packed row: sequence ids, segments and [CLS]
        positions from the per-member lengths, and dynamic masking per
        member, rebased onto its offset in the row."""
        lengths = np.asarray(self.data[PACKED_KEY][local], np.int64)
        specials_all = np.asarray(
            self.data["packed_special_token_positions"][local], np.int64)
        nsp_labels = np.asarray(nsp_labels, np.int64).reshape(-1)
        k_max = self.max_sequences_per_pack
        seq_len = input_ids.shape[0]

        segment_ids = np.zeros_like(input_ids)
        input_mask = np.zeros_like(input_ids)
        sequence_ids = np.zeros_like(input_ids)
        labels = np.full_like(input_ids, -1)
        nsp = np.full(k_max, -1, np.int32)
        cls_positions = np.zeros(k_max, np.int32)
        offset = 0
        for k, n in enumerate(lengths):
            n = int(n)
            span = slice(offset, offset + n)
            sequence_ids[span] = k + 1
            input_mask[span] = 1
            cls_positions[k] = offset
            nsp[k] = int(nsp_labels[k])
            member_specials = (
                specials_all[(specials_all >= offset)
                             & (specials_all < offset + n)] - offset)
            if len(member_specials) == 3:
                segment_ids[offset + member_specials[1] + 1:
                            offset + member_specials[2] + 1] = 1
            _, member_labels = self._mask_input(input_ids[span],
                                                member_specials)
            labels[span] = member_labels
            offset += n
        assert offset <= seq_len, (offset, seq_len)
        return [
            input_ids.astype(np.int32),
            segment_ids.astype(np.int32),
            input_mask.astype(np.int32),
            labels.astype(np.int32),
            nsp.astype(np.int32),
            sequence_ids.astype(np.int32),
            cls_positions.astype(np.int32),
        ]

    def _file_idx_for(self, idx: int) -> int:
        for i, (start, end) in enumerate(self.file_idxs):
            if start <= idx < end:
                return i
        raise ValueError(f"idx ({idx}) exceeds dataset size ({len(self)})")

    def _async_load_file(self, file_idx: int) -> threading.Thread:
        self._next_file_error = None
        th = threading.Thread(target=self._load_hdf5,
                              args=(self.files[file_idx],), daemon=True)
        th.start()
        return th

    def _load_hdf5(self, filepath: str) -> None:
        try:
            self._next_file_data = _read_shard(
                filepath,
                lambda f: {key: np.asarray(f[key][:]) for key in f.keys()})
        except BaseException as e:  # re-raised by the swap in __getitem__
            self._next_file_error = e

    @staticmethod
    def _get_masked_labels(input_ids, masked_lm_positions, masked_lm_ids):
        """Scatter true ids at masked positions, -1 elsewhere (legacy
        format; dataset.py:254-275)."""
        labels = np.full_like(input_ids, -1)
        index = len(input_ids)
        padded = np.nonzero(masked_lm_positions == 0)[0]
        if len(padded) != 0:
            index = padded[0]
        labels[masked_lm_positions[:index]] = masked_lm_ids[:index]
        return labels

    def _verify_and_count_samples(self, files):
        """Open every shard and count samples; an unreadable shard is
        skipped with a warning."""
        current_idx = 0
        verified_files, verified_idxs = [], []
        packed_flags, pack_limits = [], []
        keys = ["input_ids", "next_sentence_labels"]

        def skip(fpath, why):
            warnings.warn(f"{why}: {fpath}. Skipping File")

        def read_counts(f):
            counts = [len(f[key]) for key in keys]
            is_packed = PACKED_KEY in f
            limit = int(f.attrs[PACKED_MAX_SEQUENCES_ATTR]) if is_packed else 0
            return counts, is_packed, limit

        for fpath in files:
            if not os.path.isfile(fpath):
                skip(fpath, "File not found")
                continue
            try:
                counts, is_packed, limit = _read_shard(fpath, read_counts)
            except Exception:
                skip(fpath, f"Unable to read keys ({keys})")
                continue
            if len(set(counts)) != 1:
                skip(fpath, "Number of samples per key do not match")
                continue
            verified_files.append(fpath)
            verified_idxs.append((current_idx, current_idx + counts[0]))
            packed_flags.append(is_packed)
            if is_packed:
                pack_limits.append(limit)
            current_idx += counts[0]
        if not verified_files:
            raise RuntimeError("Unable to open any valid data files")
        if len(set(packed_flags)) > 1:
            raise ValueError(
                "cannot mix packed and unpacked shards in one dataset")
        packed = packed_flags[0]
        return (verified_files, verified_idxs, packed,
                max(pack_limits) if packed else 0)


def input_files(input_dir: str) -> Sequence[str]:
    """The ``*.hdf5`` shards under ``input_dir`` (or the file itself),
    sorted."""
    if os.path.isfile(input_dir):
        return [input_dir]
    found = []
    for root, _, names in os.walk(input_dir):
        found += [os.path.join(root, n) for n in names if n.endswith(".hdf5")]
    return sorted(found)
