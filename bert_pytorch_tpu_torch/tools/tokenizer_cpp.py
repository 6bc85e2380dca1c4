"""ctypes bindings for the port's C++ tokenizer core
(``bert_pytorch_tpu_torch/csrc/tokenizer/tokenizer.cpp``).

The port's copy of the JAX package's native tokenizer: the same source and
Unicode tables, built by the host C++ compiler into the kernel build
directory at first use (``ops/kernels/build.py`` ``load_host``: one build
per directory under a per-library lock, a ``compile`` record to the
installed monitors), never at import. A missing compiler or a failed build
raises: there is no fallback to another implementation. The API mirrors
the fast-tokenizer surface the data modules call: ``encode(text).ids`` /
``.tokens``, ``token_to_id``, ``id_to_token``; the trainers write
``vocab.txt`` (WordPiece) or ``vocab.json`` + ``merges.txt`` (byte-level
BPE).

Thread-safety: the C++ core keeps the LAST encode's ids/tokens in
per-handle buffers (``wp_encode`` fills, ``wp_get_ids``/``wp_get_tokens``
read), so an unguarded concurrent encode would hand one thread another
thread's result. Every tokenizer instance therefore serializes
``encode`` behind its own ``_encode_lock`` — shared instances are safe
under the serving engine's worker threads, one encode at a time per
instance; ``token_to_id``/``id_to_token`` are read-only lookups and take
no lock.
"""

from __future__ import annotations

import ctypes
import json
import os
import threading
from dataclasses import dataclass
from typing import List, Optional

# ctypes prototypes: entry point -> (argtypes, restype).
_C = ctypes
_PROTOTYPES = {
    "wp_create": ([_C.c_char_p, _C.c_int], _C.c_void_p),
    "wp_free": ([_C.c_void_p], None),
    "wp_vocab_size": ([_C.c_void_p], _C.c_int),
    "wp_token_to_id": ([_C.c_void_p, _C.c_char_p], _C.c_int),
    "wp_id_to_token": ([_C.c_void_p, _C.c_int], _C.c_char_p),
    "wp_encode": ([_C.c_void_p, _C.c_char_p, _C.c_int], _C.c_int),
    "wp_get_ids": ([_C.c_void_p], _C.POINTER(_C.c_int)),
    "wp_get_tokens": ([_C.c_void_p], _C.c_char_p),
    "wp_train": ([_C.c_char_p, _C.c_char_p, _C.c_int, _C.c_int, _C.c_int,
                  _C.c_char_p], _C.c_int),
    "bpe_create": ([_C.c_char_p, _C.c_char_p, _C.c_int], _C.c_void_p),
    "bpe_free": ([_C.c_void_p], None),
    "bpe_vocab_size": ([_C.c_void_p], _C.c_int),
    "bpe_token_to_id": ([_C.c_void_p, _C.c_char_p], _C.c_int),
    "bpe_id_to_token": ([_C.c_void_p, _C.c_int], _C.c_char_p),
    "bpe_encode": ([_C.c_void_p, _C.c_char_p, _C.c_int], _C.c_int),
    "bpe_get_ids": ([_C.c_void_p], _C.POINTER(_C.c_int)),
    "bpe_get_tokens": ([_C.c_void_p], _C.c_char_p),
    "bpe_train": ([_C.c_char_p, _C.c_char_p, _C.c_int, _C.c_int, _C.c_int,
                   _C.c_char_p], _C.c_int),
}


def _load_library() -> ctypes.CDLL:
    """The core's library (``build.load_host``: built at first use, then
    kept loaded), with every prototype set."""
    from bert_pytorch_tpu_torch.ops.kernels import build

    lib = build.load_host("tokenizer")
    for name, (argtypes, restype) in _PROTOTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


@dataclass
class Encoding:
    ids: List[int]
    tokens: List[str]


class CppWordPieceTokenizer:
    """BERT WordPiece tokenizer backed by the C++ core."""

    def __init__(self, vocab_file: str, lowercase: bool = True):
        self._lib = _load_library()
        self._handle = self._lib.wp_create(
            vocab_file.encode("utf-8"), 1 if lowercase else 0
        )
        if not self._handle:
            raise OSError(f"could not load vocab from {vocab_file}")
        self.lowercase = lowercase
        # Encoding is stateful per handle; serialize access.
        self._encode_lock = threading.Lock()

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.wp_free(handle)
            self._handle = None

    def get_vocab_size(self) -> int:
        return self._lib.wp_vocab_size(self._handle)

    def token_to_id(self, token: str) -> Optional[int]:
        tid = self._lib.wp_token_to_id(self._handle, token.encode("utf-8"))
        return None if tid < 0 else tid

    def id_to_token(self, token_id: int) -> str:
        return self._lib.wp_id_to_token(self._handle, token_id).decode("utf-8")

    def encode(self, text: str, add_special_tokens: bool = False) -> Encoding:
        with self._encode_lock:
            raw_text = text.encode("utf-8")
            n = self._lib.wp_encode(self._handle, raw_text, len(raw_text))
            ids = list(self._lib.wp_get_ids(self._handle)[:n])
            raw = self._lib.wp_get_tokens(self._handle).decode("utf-8")
        tokens = raw.split("\n") if raw else []
        if add_special_tokens:
            cls_id, sep_id = self.token_to_id("[CLS]"), self.token_to_id("[SEP]")
            ids = [cls_id] + ids + [sep_id]
            tokens = ["[CLS]"] + tokens + ["[SEP]"]
        return Encoding(ids=ids, tokens=tokens)

    def encode_batch(self, texts: List[str]) -> List[Encoding]:
        return [self.encode(t) for t in texts]


class CppByteLevelBPETokenizer:
    """Byte-level BPE tokenizer (GPT-2/RoBERTa) backed by the C++ core.

    Mirrors HF ``ByteLevelBPETokenizer(vocab.json, merges.txt)``'s encode
    surface (reference src/tokenization.py:51-57): GPT-2 byte-to-unicode
    mapping + pre-tokenizer regex + ranked merge loop. ``vocab_file`` is
    the vocab.json (token -> id); ``merges_file`` the merges.txt.
    """

    def __init__(self, vocab_file: str, merges_file: str,
                 lowercase: bool = False):
        self._lib = _load_library()
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        by_id = sorted(vocab.items(), key=lambda kv: kv[1])
        n = by_id[-1][1] + 1 if by_id else 0
        tokens = [""] * n
        for tok, tid in by_id:
            tokens[tid] = tok
        with open(merges_file, encoding="utf-8") as f:
            merges = f.read()
        self._handle = self._lib.bpe_create(
            "\n".join(tokens).encode("utf-8"), merges.encode("utf-8"),
            1 if lowercase else 0)
        if not self._handle:
            raise OSError(f"could not build BPE from {vocab_file}")
        self.lowercase = lowercase
        self._encode_lock = threading.Lock()

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.bpe_free(handle)
            self._handle = None

    def get_vocab_size(self) -> int:
        return self._lib.bpe_vocab_size(self._handle)

    def token_to_id(self, token: str) -> Optional[int]:
        tid = self._lib.bpe_token_to_id(self._handle, token.encode("utf-8"))
        return None if tid < 0 else tid

    def id_to_token(self, token_id: int) -> str:
        return self._lib.bpe_id_to_token(self._handle, token_id).decode("utf-8")

    def encode(self, text: str, add_special_tokens: bool = False) -> Encoding:
        # ``add_special_tokens`` is accepted for HF signature compatibility
        # (callers like tools/encode_data.py pass it); like HF's
        # ByteLevelBPETokenizer — which has no post-processor template —
        # it is a no-op here.
        del add_special_tokens
        with self._encode_lock:
            raw_text = text.encode("utf-8")
            n = self._lib.bpe_encode(self._handle, raw_text, len(raw_text))
            ids = list(self._lib.bpe_get_ids(self._handle)[:n])
            raw = self._lib.bpe_get_tokens(self._handle).decode("utf-8")
        return Encoding(ids=ids, tokens=raw.split("\n") if raw else [])

    def encode_batch(self, texts: List[str]) -> List[Encoding]:
        return [self.encode(t) for t in texts]


def train_bpe_vocab(
    files: List[str],
    vocab_size: int,
    out_dir: str,
    special_tokens=("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"),
    min_frequency: int = 2,
    lowercase: bool = False,
) -> str:
    """Train a byte-level BPE (vocab.json + merges.txt into ``out_dir``) —
    the ByteLevelBPETokenizer.train role of reference
    utils/build_vocab.py:39-58. The output files load into
    :class:`CppByteLevelBPETokenizer` (and into HF's
    ``ByteLevelBPETokenizer``)."""
    lib = _load_library()
    os.makedirs(out_dir, exist_ok=True)
    rc = lib.bpe_train(
        "\n".join(files).encode("utf-8"),
        "\n".join(special_tokens).encode("utf-8"),
        vocab_size,
        min_frequency,
        1 if lowercase else 0,
        out_dir.encode("utf-8"),
    )
    if rc != 0:
        raise RuntimeError(f"bpe_train failed with code {rc}")
    return os.path.join(out_dir, "vocab.json")


def train_wordpiece_vocab(
    files: List[str],
    vocab_size: int,
    out_path: str,
    special_tokens=("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"),
    min_frequency: int = 2,
    lowercase: bool = True,
) -> str:
    """Train a WordPiece vocab (reference utils/build_vocab.py:39-75 role:
    specials forced to the front, [PAD] at index 0)."""
    lib = _load_library()
    rc = lib.wp_train(
        "\n".join(files).encode("utf-8"),
        "\n".join(special_tokens).encode("utf-8"),
        vocab_size,
        min_frequency,
        1 if lowercase else 0,
        out_path.encode("utf-8"),
    )
    if rc != 0:
        raise RuntimeError(f"wp_train failed with code {rc}")
    return out_path
