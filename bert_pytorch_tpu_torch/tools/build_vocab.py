"""Train a WordPiece or byte-level-BPE vocabulary from formatted text.

Parity with reference utils/build_vocab.py: trains on the corpus with the
standard special tokens, then reorders so the specials sit at the front
with [PAD] at index 0 (:53-75). Both tokenizers train on the port's C++
core (``tools/tokenizer_cpp.py``), whose files are byte for byte those of
the JAX package's ``build_vocab`` with ``backend="cpp"``: a ``vocab.txt``
for WordPiece, a ``vocab.json`` and ``merges.txt`` in a directory for
BPE. The BPE trainer rescans its pairs on every merge (a reference
implementation), so it suits small vocabs: seconds for a few thousand
merges on a corpus of a few MB.

::

    python -m bert_pytorch_tpu_torch.tools.build_vocab \\
        --input_glob 'shards/*.txt' --tokenizer bpe --output vocab/ \\
        --vocab_size 2000 --uppercase
"""

from __future__ import annotations

import argparse
import glob
import os

SPECIAL_TOKENS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def build_wordpiece_vocab(input_files, output_file: str, vocab_size: int,
                          lowercase: bool = True,
                          min_frequency: int = 2) -> str:
    from bert_pytorch_tpu_torch.tools.tokenizer_cpp import \
        train_wordpiece_vocab

    parent = os.path.dirname(os.path.abspath(output_file))
    os.makedirs(parent, exist_ok=True)
    return train_wordpiece_vocab(
        list(input_files), vocab_size, output_file,
        special_tokens=tuple(SPECIAL_TOKENS),
        min_frequency=min_frequency, lowercase=lowercase)


def build_bpe_vocab(input_files, output_dir: str, vocab_size: int,
                    lowercase: bool = True, min_frequency: int = 2) -> str:
    """``vocab.json`` + ``merges.txt`` in ``output_dir``; returns the
    ``vocab.json`` path."""
    from bert_pytorch_tpu_torch.tools.tokenizer_cpp import train_bpe_vocab

    return train_bpe_vocab(
        list(input_files), vocab_size, output_dir,
        special_tokens=tuple(SPECIAL_TOKENS),
        min_frequency=min_frequency, lowercase=lowercase)


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--input_glob", type=str, required=True)
    parser.add_argument("--output", type=str, required=True,
                        help="vocab .txt path (wordpiece) or directory (bpe)")
    parser.add_argument("--tokenizer", choices=["wordpiece", "bpe"],
                        default="wordpiece")
    parser.add_argument("--vocab_size", type=int, default=30522)
    parser.add_argument("--min_frequency", type=int, default=2)
    parser.add_argument("--uppercase", action="store_true")
    args = parser.parse_args(argv)
    files = sorted(glob.glob(args.input_glob, recursive=True))
    if not files:
        raise ValueError(f"no files match {args.input_glob}")
    if args.tokenizer == "wordpiece":
        out = build_wordpiece_vocab(files, args.output, args.vocab_size,
                                    not args.uppercase, args.min_frequency)
    else:
        out = build_bpe_vocab(files, args.output, args.vocab_size,
                              not args.uppercase, args.min_frequency)
    print(f"[vocab] wrote {out}")
    return out


if __name__ == "__main__":
    main()
