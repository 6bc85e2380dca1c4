"""Host input-pipeline throughput of the port: is the loader fast enough to
feed the card? The port of the JAX package's ``tools/bench_loader.py``.

It measures the real pipeline, the dataset's rows with dynamic masking,
collated by the port's ``DataLoader`` (data/loader.py) with N worker
processes, and prints the JAX tool's JSON line per worker setting::

    {"metric": "loader_seq_per_sec", "num_workers": 2, "batch_size": 64,
     "seq_len": 128, "value": 5123.4, "unit": "seq/s/host"}

``--source hdf5`` streams synthetic HDF5 shards through
``ShardedPretrainingDataset`` (the JAX tool's path; needs ``h5py``);
``--source rows`` reads ``SyntheticPretrainingDataset``'s in-memory rows,
masked by the same code, where no ``h5py`` is installed. ``auto`` (the
default) takes ``hdf5`` when ``h5py`` imports. The source goes to
standard error.

Usage::

    python -m bert_pytorch_tpu_torch.tools.bench_loader [--seq_len 128]
        [--batch_size 64] [--workers 0 1 2 4] [--samples 16384]
        [--source auto|hdf5|rows] [--input_dir DIR]   # DIR: real shards
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

MAX_PRED_PER_SEQ = 76
MASK_TOKEN_INDEX = 4


def bench_one(dataset, num_workers: int, batch_size: int,
              warmup_batches: int = 4) -> dict:
    """The JSON record of one worker setting over ``dataset``."""
    from bert_pytorch_tpu_torch.data.loader import DataLoader
    from bert_pytorch_tpu_torch.data.sampler import DistributedSampler

    loader = DataLoader(dataset, DistributedSampler(dataset, 1, 0),
                        batch_size=batch_size, num_workers=num_workers)
    total_batches = len(loader)
    if total_batches < warmup_batches + 2:
        raise ValueError(
            f"need at least {warmup_batches + 2} batches to measure "
            f"(warmup {warmup_batches} + a timing window), got "
            f"{total_batches}; lower --batch_size or raise --samples")
    n, start = 0, None
    for i, batch in enumerate(loader):
        if i == warmup_batches:  # spawn/prefetch startup out of the window
            start = time.perf_counter()
        elif i > warmup_batches:
            n += batch["input_ids"].shape[0]
    elapsed = time.perf_counter() - start
    return {
        "metric": "loader_seq_per_sec",
        "num_workers": num_workers,
        "batch_size": batch_size,
        "seq_len": int(batch["input_ids"].shape[1]),
        "value": round(n / elapsed, 1),
        "unit": "seq/s/host",
    }


def resolve_source(source: str) -> str:
    if source != "auto":
        return source
    try:
        import h5py  # noqa: F401
    except ImportError:
        return "rows"
    return "hdf5"


def make_dataset(source: str, samples: int, seq_len: int, vocab: int,
                 input_dir=None):
    """The dataset the bench reads: HDF5 shards (``input_dir``'s, else
    four synthetic ones in a temporary directory) or synthetic rows."""
    from bert_pytorch_tpu_torch.tools import make_synthetic_data as synth

    if source == "rows":
        return synth.SyntheticPretrainingDataset(
            0, samples, seq_len, vocab, MAX_PRED_PER_SEQ,
            mask_token_index=MASK_TOKEN_INDEX)
    from bert_pytorch_tpu_torch.data.dataset import ShardedPretrainingDataset

    if input_dir:
        files = sorted(str(f) for f in Path(input_dir).rglob("*.hdf5"))
    else:
        d = tempfile.mkdtemp(prefix="bench_loader_")
        files = [synth.make_shard(os.path.join(d, f"s{i}.hdf5"),
                                  samples // 4, seq_len, vocab, seed=i)
                 for i in range(4)]
    return ShardedPretrainingDataset(
        files, MASK_TOKEN_INDEX, max_pred_per_seq=MAX_PRED_PER_SEQ,
        masked_lm_prob=0.15, vocab_size=vocab, seed=0)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seq_len", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--samples", type=int, default=16384)
    p.add_argument("--vocab_size", type=int, default=30528)
    p.add_argument("--workers", type=int, nargs="+", default=[0, 1, 2, 4])
    p.add_argument("--source", choices=["auto", "hdf5", "rows"],
                   default="auto",
                   help="HDF5 shards or in-memory synthetic rows (auto: "
                        "hdf5 where h5py imports)")
    p.add_argument("--input_dir", default=None,
                   help="existing HDF5 shard dir (default: synthesize)")
    args = p.parse_args(argv)
    source = "hdf5" if args.input_dir else resolve_source(args.source)
    print(f"bench_loader: source {source}", file=sys.stderr, flush=True)
    dataset = make_dataset(source, args.samples, args.seq_len,
                           args.vocab_size, args.input_dir)
    for w in args.workers:
        print(json.dumps(bench_one(dataset, w, args.batch_size)),
              flush=True)


if __name__ == "__main__":
    main()
