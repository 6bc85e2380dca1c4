"""Synthetic serving inputs: a small WordPiece vocab written from a fixed
word list (the port's copy of the JAX package's ``write_trace_vocab``).

The repository holds no 30522-entry vocab, so demo-mode serving (seeded
random weights) tokenizes with this file: its ids are all < 30522, so a
model at the published vocab width serves it unchanged.
"""

from __future__ import annotations

import os

TRACE_WORDS = (
    "the capital of france is paris what who wrote hamlet shakespeare "
    "william city big a in was by play london england river runs through "
    "where mountain tall old new house red blue green").split()


def write_trace_vocab(path: str) -> str:
    """WordPiece vocab covering :data:`TRACE_WORDS` + the BERT specials."""
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + list(TRACE_WORDS)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(tokens) + "\n")
    return path
