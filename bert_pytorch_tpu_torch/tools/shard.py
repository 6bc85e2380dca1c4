"""Split formatted one-sentence-per-line text into ~N-byte shards on article
boundaries.

Parity with reference utils/shard.py (:6-27: greedy fill to max_bytes,
never splitting inside an article) and utils/sample_and_shard.py (the
``--sample_sentences`` variant that uniformly subsamples sentences before
sharding, :83-121). Size strings accept k/M/G suffixes
(reference shard.py:30-43). The port's copy of the JAX package's
``tools/shard.py``: one input gives the same shards from both.

::

    python -m bert_pytorch_tpu_torch.tools.shard --input_glob 'text/*.txt' \
        --output_dir shards/ --max_bytes_per_shard 1M
"""

from __future__ import annotations

import argparse
import glob
import os
import random


def parse_value_as_int(value) -> int:
    """'250M' -> 250_000_000 (reference shard.py:30-43)."""
    if isinstance(value, int):
        return value
    value = value.strip()
    suffixes = {"k": 10**3, "K": 10**3, "m": 10**6, "M": 10**6,
                "g": 10**9, "G": 10**9}
    if value and value[-1] in suffixes:
        return int(float(value[:-1]) * suffixes[value[-1]])
    return int(value)


def iter_articles(paths):
    """Yield articles (lists of sentences) across files."""
    for path in sorted(paths):
        article: list[str] = []
        with open(path, "r", encoding="utf-8", errors="ignore") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    if article:
                        yield article
                        article = []
                    continue
                article.append(line)
        if article:
            yield article


def shard(input_files, output_dir: str, max_bytes: int,
          prefix: str = "shard", sample_sentences: int | None = None,
          seed: int = 0) -> list[str]:
    os.makedirs(output_dir, exist_ok=True)
    articles = list(iter_articles(input_files))

    if sample_sentences is not None:
        # Uniform sentence subsample, preserving article grouping
        # (sample_and_shard.py:83-121).
        rng = random.Random(seed)
        flat = [(ai, s) for ai, art in enumerate(articles) for s in art]
        keep = set(
            rng.sample(range(len(flat)), min(sample_sentences, len(flat))))
        regrouped: dict[int, list[str]] = {}
        for i, (ai, s) in enumerate(flat):
            if i in keep:
                regrouped.setdefault(ai, []).append(s)
        articles = [regrouped[k] for k in sorted(regrouped)]

    outputs = []
    shard_idx = 0
    current_bytes = 0
    out = None
    for article in articles:
        if out is None or current_bytes >= max_bytes:
            if out is not None:
                out.close()
            path = os.path.join(output_dir, f"{prefix}_{shard_idx:04d}.txt")
            out = open(path, "w", encoding="utf-8")
            outputs.append(path)
            shard_idx += 1
            current_bytes = 0
        for sentence in article:
            out.write(sentence + "\n")
            current_bytes += len(sentence) + 1
        out.write("\n")
        current_bytes += 1
    if out is not None:
        out.close()
    return outputs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_glob", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--max_bytes_per_shard", type=str, default="250M")
    parser.add_argument("--prefix", type=str, default="shard")
    parser.add_argument("--sample_sentences", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    files = glob.glob(args.input_glob, recursive=True)
    outs = shard(files, args.output_dir,
                 parse_value_as_int(args.max_bytes_per_shard), args.prefix,
                 args.sample_sentences, args.seed)
    print(f"[shard] wrote {len(outs)} shards from {len(files)} files")


if __name__ == "__main__":
    main()
