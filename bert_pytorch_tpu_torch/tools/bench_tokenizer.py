"""Tokenizer throughput of the port: its C++ core (tools/tokenizer_cpp.py,
csrc/tokenizer/) against HF's Rust ``tokenizers`` where that imports. The
port of the JAX package's ``tools/bench_tokenizer.py``; it prints the JAX
tool's JSON lines, one per backend::

    {"metric": "wordpiece_encode_tokens_per_sec", "backend": "cpp",
     "lines": 20000, "tokens": 412345, "value": 812345.0, "unit": "tokens/s"}

(``{"backend": "hf_rust", "skipped": "not installed"}`` where
``tokenizers`` does not import), then their ratio when both ran.

The corpus is synthetic English (tools/make_synthetic_text.py) and a
WordPiece vocab is trained on it, unless ``--vocab_file`` names one (its
tokens need not cover the corpus: unknown words encode as ``[UNK]``). A
``vocab.json`` there (with its ``merges.txt`` beside it, the runners'
``--tokenizer bpe`` files) times byte-level BPE instead, cased (as the
RoBERTa vocab is), as ``bpe_encode_tokens_per_sec`` (HF side:
``ByteLevelBPETokenizer``).

Usage::

    python -m bert_pytorch_tpu_torch.tools.bench_tokenizer [--lines 20000]
        [--repeat 3] [--vocab_file vocab.txt | vocab.json]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def build_corpus(n_lines: int, seed: int):
    """(directory, the first ``n_lines`` non-empty lines) of a synthetic
    corpus written to a temporary directory."""
    from bert_pytorch_tpu_torch.tools.make_synthetic_text import write_corpus

    d = tempfile.mkdtemp(prefix="bench_tok_")
    paths = write_corpus(d, n_files=1,
                         articles_per_file=max(1, n_lines // 10), seed=seed)
    lines = []
    with open(paths[0]) as f:
        for ln in f:
            ln = ln.strip()
            if ln:
                lines.append(ln)
            if len(lines) >= n_lines:
                break
    return d, lines


def train_vocab(corpus_dir: str, out: str) -> None:
    from bert_pytorch_tpu_torch.tools.tokenizer_cpp import \
        train_wordpiece_vocab

    train_wordpiece_vocab(
        [os.path.join(corpus_dir, f) for f in os.listdir(corpus_dir)
         if f.endswith(".txt")],
        4096, out, min_frequency=1)


def merges_of(vocab_file: str):
    """The merges.txt beside a BPE vocab.json, or None for WordPiece."""
    if not vocab_file.endswith(".json"):
        return None
    return os.path.join(os.path.dirname(vocab_file), "merges.txt")


def bench_cpp(vocab_file: str, lines, repeat: int):
    from bert_pytorch_tpu_torch.tools import tokenizer_cpp

    merges = merges_of(vocab_file)
    tok = (tokenizer_cpp.CppByteLevelBPETokenizer(vocab_file, merges)
           if merges else tokenizer_cpp.CppWordPieceTokenizer(
               vocab_file, lowercase=True))
    # warmup + token count
    n_tokens = sum(len(e.ids) for e in tok.encode_batch(lines))
    t0 = time.perf_counter()
    for _ in range(repeat):
        tok.encode_batch(lines)
    return n_tokens, (time.perf_counter() - t0) / repeat


def bench_hf(vocab_file: str, lines, repeat: int):
    try:
        import tokenizers
    except ImportError:
        return None
    merges = merges_of(vocab_file)
    tok = (tokenizers.ByteLevelBPETokenizer(vocab_file, merges)
           if merges else tokenizers.BertWordPieceTokenizer(
               vocab_file, lowercase=True))
    # no [CLS]/[SEP] so both backends do identical token work
    n_tokens = sum(len(e.ids)
                   for e in tok.encode_batch(lines, add_special_tokens=False))
    t0 = time.perf_counter()
    for _ in range(repeat):
        tok.encode_batch(lines, add_special_tokens=False)
    return n_tokens, (time.perf_counter() - t0) / repeat


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--lines", type=int, default=20000)
    p.add_argument("--repeat", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vocab_file", default="",
                   help="a WordPiece vocab.txt, or a BPE vocab.json with "
                        "merges.txt beside it (default: a WordPiece vocab "
                        "trained on the corpus)")
    args = p.parse_args(argv)
    metric = ("bpe" if merges_of(args.vocab_file) else "wordpiece") + \
        "_encode_tokens_per_sec"

    corpus_dir, lines = build_corpus(args.lines, args.seed)
    vocab = args.vocab_file or os.path.join(corpus_dir, "vocab.txt")
    if not args.vocab_file:
        train_vocab(corpus_dir, vocab)

    results = {}
    for backend, fn in (("cpp", bench_cpp), ("hf_rust", bench_hf)):
        got = fn(vocab, lines, args.repeat)
        if got is None:
            print(json.dumps({"backend": backend, "skipped": "not installed"}),
                  flush=True)
            continue
        n_tokens, dt = got
        results[backend] = n_tokens / dt
        print(json.dumps({
            "metric": metric,
            "backend": backend,
            "lines": len(lines),
            "tokens": n_tokens,
            "value": round(n_tokens / dt, 0),
            "unit": "tokens/s",
        }), flush=True)
    if "cpp" in results and "hf_rust" in results:
        print(json.dumps({
            "metric": "cpp_vs_hf_rust_ratio",
            "value": round(results["cpp"] / results["hf_rust"], 3),
            "note": ("identical token work (no specials), same vocab; cpp "
                     "side is a SEQUENTIAL python loop over ctypes calls, "
                     "hf_rust side is tokenizers' default encode_batch "
                     "(rayon-parallel unless TOKENIZERS_PARALLELISM "
                     "disables it); sentence-length synthetic English"),
        }), flush=True)


if __name__ == "__main__":
    main()
