"""Encode formatted text into pretraining HDF5 shards.

Parity with reference utils/encode_data.py: documents delimited by blank
lines (:48-62), chunk sentences up to a (possibly short_seq_prob-reduced)
target length (:65-167), optional NSP pair construction with a random next
segment drawn from another document and index rewind (:112-130), in-file
shuffle (:179), and gzip HDF5 output with ``input_ids`` i4,
``special_token_positions`` i4 and ``next_sentence_labels`` i1 (:204-210).

Sample layout (consumed by data/dataset.py):
  NSP:    [CLS] seq [SEP] next_seq [SEP] pad   specials = [0, p1, p2]
  no NSP: [CLS] seq [SEP] pad                  specials = [0, p1]

The port's copy of the JAX package's ``tools/encode_data.py``, on the
port's tokenizers (the C++ core) and its packing module: with the same
``random`` state it writes the same arrays. The HDF5 writer imports
``h5py`` inside the functions that write, as the shard reader
(data/dataset.py) does: a machine without ``h5py`` cannot run this step,
and a pretraining run there takes ``SyntheticPretrainingDataset`` rows
instead of shards.

::

    python -m bert_pytorch_tpu_torch.tools.encode_data --input_dir shards/ \
        --output_dir hdf5/ --vocab_file vocab/vocab.json --tokenizer bpe \
        --max_seq_len 128 --uppercase --processes 1
"""

from __future__ import annotations

import argparse
import dataclasses
import multiprocessing as mp
import os
import random
import time
from pathlib import Path
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class TrainingSample:
    """[CLS]/[SEP]-wrapped token sequence with special-token bookkeeping
    (reference utils/encode_data.py:12-35)."""

    seq_tokens: List[str]
    next_seq_tokens: Optional[List[str]] = None
    is_random_next: bool = False

    def __post_init__(self):
        self.sequence = ["[CLS]"] + list(self.seq_tokens)
        self.special_token_positions = [0]
        if self.next_seq_tokens is not None:
            self.special_token_positions.append(len(self.sequence))
            self.sequence.append("[SEP]")
            self.sequence.extend(self.next_seq_tokens)
        self.special_token_positions.append(len(self.sequence))
        self.sequence.append("[SEP]")


def documents_from_file(input_file: str, tokenizer) -> List[List[List[str]]]:
    """Blank-line-delimited documents -> lists of tokenized sentences
    (reference :48-62)."""
    documents: List[List[List[str]]] = [[]]
    with open(input_file, "r", encoding="utf-8", errors="ignore") as reader:
        for line in reader:
            line = line.strip()
            if not line:
                documents.append([])
                continue
            tokens = tokenizer.encode(line, add_special_tokens=False).tokens
            if tokens:
                documents[-1].append(tokens)
    return [d for d in documents if d]


def _target_length(max_num_tokens: int, short_seq_prob: float, rng) -> int:
    if rng.random() < short_seq_prob:
        return rng.randint(2, max_num_tokens)
    return max_num_tokens


def _truncate_pair(seq_tokens: List[str], next_seq_tokens: List[str],
                   budget: int) -> None:
    """Trim the longer segment from the back until the pair fits (the
    canonical-BERT truncate_seq_pair role; the chunk may overshoot the
    target because the closing sentence is included before the flush)."""
    while len(seq_tokens) + len(next_seq_tokens) > budget:
        longer = (seq_tokens if len(seq_tokens) >= len(next_seq_tokens)
                  else next_seq_tokens)
        longer.pop()


def create_samples_from_document(
    document_idx: int,
    documents: List[List[List[str]]],
    max_seq_len: int,
    next_seq_prob: float,
    short_seq_prob: float,
    rng=random,
) -> List[TrainingSample]:
    """Chunk one document into samples (reference :65-167).

    Two deliberate fixes over the reference's loop (which checks the
    flush condition *before* appending the current sentence,
    encode_data.py:92-96):
      - the final sentence of every document is included in the last sample
        instead of being silently dropped (and 1-sentence documents yield a
        sample at all);
      - a flushed chunk holding a single segment forces ``is_random_next``
        (canonical BERT behavior) instead of emitting a degenerate pair with
        an empty second segment labeled "actual next".
    """
    nsp = next_seq_prob > 0
    max_num_tokens = max_seq_len - (3 if nsp else 2)
    target_len = _target_length(max_num_tokens, short_seq_prob, rng)

    document = documents[document_idx]
    samples: List[TrainingSample] = []
    chunk: List[List[str]] = []
    chunk_length = 0
    i = 0
    while i < len(document):
        current = document[i][:target_len]
        chunk.append(current)
        chunk_length += len(current)
        if i + 1 == len(document) or chunk_length >= target_len:
            if nsp:
                if len(documents) <= 1:
                    raise ValueError(
                        "File only contained one document; unable to draw a "
                        "random next sequence."
                    )
                seq_end = rng.randint(1, len(chunk) - 1) if len(chunk) >= 2 else 1
                seq_tokens = [t for seg in chunk[:seq_end] for t in seg]
                if len(chunk) == 1 or rng.random() < next_seq_prob:
                    # Random next: fill from a random position in another
                    # document, and rewind i to reuse the displaced segments.
                    is_random_next = True
                    rand_idx = rng.randint(0, len(documents) - 1)
                    while rand_idx == document_idx:
                        rand_idx = rng.randint(0, len(documents) - 1)
                    rand_doc = documents[rand_idx]
                    rand_start = rng.randint(0, len(rand_doc) - 1)
                    budget = max(1, target_len - len(seq_tokens))
                    next_seq_tokens: List[str] = []
                    for j in range(rand_start, len(rand_doc)):
                        next_seq_tokens.extend(rand_doc[j])
                        if len(next_seq_tokens) >= budget:
                            next_seq_tokens = next_seq_tokens[:budget]
                            break
                    i -= len(chunk) - seq_end
                else:
                    is_random_next = False
                    next_seq_tokens = [
                        t for seg in chunk[seq_end:] for t in seg
                    ]
                _truncate_pair(seq_tokens, next_seq_tokens, target_len)
                samples.append(
                    TrainingSample(seq_tokens, next_seq_tokens, is_random_next)
                )
            else:
                seq_tokens = [t for seg in chunk for t in seg][:target_len]
                samples.append(TrainingSample(seq_tokens))
            target_len = _target_length(max_num_tokens, short_seq_prob, rng)
            chunk = []
            chunk_length = 0
        i += 1
    return samples


def create_samples(
    input_file: str, tokenizer, max_seq_len: int, next_seq_prob: float,
    short_seq_prob: float, rng=random,
) -> List[TrainingSample]:
    documents = documents_from_file(input_file, tokenizer)
    samples: List[TrainingSample] = []
    for i in range(len(documents)):
        samples.extend(
            create_samples_from_document(
                i, documents, max_seq_len, next_seq_prob, short_seq_prob, rng
            )
        )
    rng.shuffle(samples)
    return samples


def write_packed_samples_to_hdf5(output_file, samples, tokenizer,
                                 max_seq_len, max_sequences_per_pack) -> int:
    """Offline sequence packing (docs/packing.md): greedy
    first-fit-decreasing over the encoded samples, written in the packed
    shard layout data/packing.py owns. Dynamic masking still happens in
    the runtime dataset — the shard stores raw token ids plus per-member
    lengths/special positions; returns the packed row count."""
    from bert_pytorch_tpu_torch.data.packing import (first_fit_decreasing,
                                                     write_packed_shard)

    encoded = []
    for sample in samples:
        ids = [tokenizer.token_to_id(t) for t in sample.sequence]
        assert None not in ids, "token missing from vocab"
        assert len(ids) <= max_seq_len
        encoded.append((np.asarray(ids, np.int32),
                        sample.special_token_positions,
                        1 if sample.is_random_next else 0))
    packs = first_fit_decreasing(
        [len(e[0]) for e in encoded], max_seq_len, max_sequences_per_pack)
    rows = [[encoded[i] for i in pack] for pack in packs]
    n = write_packed_shard(output_file, rows, max_seq_len,
                           max_sequences_per_pack)
    total = sum(len(e[0]) for e in encoded)
    print(f"[encoder] packed {len(encoded)} samples into {n} rows "
          f"(occupancy {total / max(1, n * max_seq_len):.3f})")
    return n


def write_samples_to_hdf5(output_file, samples, tokenizer, max_seq_len) -> int:
    """Gzip HDF5 in the runtime dataset's format (reference :183-210);
    special_token_positions is a ragged (vlen) i4 dataset since samples mix
    2- and 3-entry position lists."""
    import h5py

    n = len(samples)
    input_ids = np.zeros((n, max_seq_len), np.int32)
    next_labels = np.zeros((n,), np.int8)
    specials = []
    for row, sample in enumerate(samples):
        ids = [tokenizer.token_to_id(t) for t in sample.sequence]
        assert None not in ids, "token missing from vocab"
        assert len(ids) <= max_seq_len
        input_ids[row, : len(ids)] = ids
        specials.append(np.asarray(sample.special_token_positions, np.int32))
        next_labels[row] = 1 if sample.is_random_next else 0

    with h5py.File(output_file, "w") as f:
        f.create_dataset("input_ids", data=input_ids, dtype="i4",
                         compression="gzip")
        dt = h5py.vlen_dtype(np.dtype("i4"))
        ds = f.create_dataset("special_token_positions", (n,), dtype=dt,
                              compression="gzip")
        for row, sp in enumerate(specials):
            ds[row] = sp
        f.create_dataset("next_sentence_labels", data=next_labels, dtype="i1",
                         compression="gzip")
    return n


def _make_tokenizer(args):
    from bert_pytorch_tpu_torch.data.tokenization import get_tokenizer

    return get_tokenizer(args.tokenizer, args.vocab_file,
                         uppercase=args.uppercase)


def encode_file(args, input_file: str, output_file: str) -> None:
    print(f"[encoder] Creating instances from {input_file}")
    start = time.time()
    tokenizer = _make_tokenizer(args)
    samples = create_samples(
        input_file, tokenizer, args.max_seq_len, args.next_seq_prob,
        args.short_seq_prob)
    if getattr(args, "pack_sequences", False):
        n = write_packed_samples_to_hdf5(
            output_file, samples, tokenizer, args.max_seq_len,
            args.max_sequences_per_pack)
    else:
        n = write_samples_to_hdf5(output_file, samples, tokenizer,
                                  args.max_seq_len)
    print(f"[encoder] Encoded {output_file} ({n} samples, "
          f"time={time.time() - start:.0f}s)")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--vocab_file", type=str, required=True)
    parser.add_argument("--max_seq_len", type=int, default=512)
    parser.add_argument("--short_seq_prob", type=float, default=0.1)
    parser.add_argument("--next_seq_prob", type=float, default=0.0,
                        help="probability of a random next segment; 0 "
                             "disables the NSP task entirely")
    parser.add_argument("--uppercase", action="store_true")
    parser.add_argument("--tokenizer", type=str, default="wordpiece",
                        choices=["wordpiece", "bpe"])
    parser.add_argument("--processes", type=int, default=4)
    parser.add_argument("--pack_sequences", action="store_true",
                        help="emit offline-PACKED shards (greedy first-fit-"
                             "decreasing, data/packing.py layout): several "
                             "sequences share one max_seq_len row; the "
                             "runtime derives block-diagonal attention "
                             "masks from it (docs/packing.md)")
    parser.add_argument("--max_sequences_per_pack", type=int, default=8,
                        help="cap on sequences per packed row")
    args = parser.parse_args(argv)

    input_files = []
    if os.path.isfile(args.input_dir):
        input_files.append(args.input_dir)
    elif os.path.isdir(args.input_dir):
        input_files = sorted(
            str(p) for p in Path(args.input_dir).rglob("*.txt") if p.is_file())
    else:
        raise ValueError(f"{args.input_dir} is not a valid path")
    print(f"[encoder] Found {len(input_files)} input files")

    prefix = (
        f"sequences_{'uppercase' if args.uppercase else 'lowercase'}"
        f"_max_seq_len_{args.max_seq_len}"
        f"_next_seq_task_{str(args.next_seq_prob > 0).lower()}"
        # Packed and unpacked shards cannot share a dataset directory
        # (data/dataset.py refuses the mix), so the prefix keeps them apart.
        + ("_packed" if args.pack_sequences else "")
    )
    out_dir = os.path.join(args.output_dir, prefix)
    os.makedirs(out_dir, exist_ok=True)

    jobs = [
        (args, ifile, os.path.join(out_dir, f"train_{i}.hdf5"))
        for i, ifile in enumerate(input_files)
    ]
    start = time.time()
    if args.processes <= 1 or len(jobs) <= 1:
        for job in jobs:
            encode_file(*job)
    else:
        with mp.Pool(processes=args.processes) as pool:
            pool.starmap(encode_file, jobs)
    print(f"[encoder] Finished processing (time={time.time() - start:.0f}s)")


if __name__ == "__main__":
    main()
