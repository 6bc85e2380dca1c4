"""Tokenization facade (reference src/tokenization.py:42-229).

:func:`get_wordpiece_tokenizer` and :func:`get_bpe_tokenizer` hand every
runner and the server the port's C++ tokenizer core
(``tools/tokenizer_cpp.py``, built from ``csrc/tokenizer/`` at first
use), as the JAX package's constructors of the same names do. If the core
cannot be built or loaded they raise: nothing falls back to another
implementation. A byte-level BPE ``vocab_file`` is a ``vocab.json`` whose
``merges.txt`` sits beside it (``vocab_file.replace("vocab.json",
"merges.txt")``, the JAX rule).

A copy of the JAX package's pure-Python behavioral-spec tokenizers stays
beside them: ``load_vocab``, ``BasicTokenizer``, ``WordpieceTokenizer``
and ``BertTokenizer`` (SQuAD's answer realignment assumes exactly their
semantics), and :class:`WordpieceEncoder`, the same WordPiece with the
fast-tokenizer surface (the tests' oracle for the C++ core).

Thread-safety: the pure-Python classes hold only read-only state after
construction (vocab dicts, flags); the C++ tokenizers serialize ``encode``
behind a per-instance lock. One shared instance serves all HTTP worker
threads either way.
"""

from __future__ import annotations

import collections
import os
import unicodedata
from typing import Iterable, List, NamedTuple, Optional


def load_vocab(vocab_file: str) -> "collections.OrderedDict[str, int]":
    """token -> id, file order (reference tokenization.py:18-27)."""
    vocab = collections.OrderedDict()
    with open(vocab_file, "r", encoding="utf-8") as reader:
        for index, line in enumerate(reader):
            token = line.rstrip("\n")
            if not token:
                continue
            vocab[token] = index
    return vocab


def _is_whitespace(char: str) -> bool:
    if char in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(char) == "Zs"


def _is_control(char: str) -> bool:
    if char in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(char).startswith("C")


def _is_punctuation(char: str) -> bool:
    cp = ord(char)
    # ASCII non-alphanumeric ranges count as punctuation even when unicode
    # disagrees (e.g. '$', '`'), matching Google BERT behavior.
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(char).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def whitespace_tokenize(text: str) -> list[str]:
    text = text.strip()
    return text.split() if text else []


class BasicTokenizer:
    """Whitespace/punctuation splitting + lowercase/accent-strip + CJK
    isolation (reference tokenization.py:60-173). SQuAD's character-level
    answer realignment assumes exactly these semantics.

    ``never_split`` tokens (the special tokens, reference
    tokenization.py:64-75) pass through verbatim: no lowercasing, no
    accent-stripping, no punctuation split — "[MASK]" must stay one token,
    not become "[", "mask", "]".
    """

    def __init__(
        self,
        do_lower_case: bool = True,
        never_split=("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]"),
    ):
        self.do_lower_case = do_lower_case
        self.never_split = never_split

    def tokenize(self, text: str) -> list[str]:
        text = self._clean_text(text)
        text = self._pad_cjk(text)
        tokens = []
        for token in whitespace_tokenize(text):
            if self.do_lower_case and token not in self.never_split:
                token = token.lower()
                token = self._strip_accents(token)
            tokens.extend(self._split_on_punc(token))
        return whitespace_tokenize(" ".join(tokens))

    @staticmethod
    def _clean_text(text: str) -> str:
        out = []
        for char in text:
            cp = ord(char)
            if cp == 0 or cp == 0xFFFD or _is_control(char):
                continue
            out.append(" " if _is_whitespace(char) else char)
        return "".join(out)

    @staticmethod
    def _pad_cjk(text: str) -> str:
        out = []
        for char in text:
            if _is_cjk(ord(char)):
                out.append(f" {char} ")
            else:
                out.append(char)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        return "".join(c for c in text if unicodedata.category(c) != "Mn")

    def _split_on_punc(self, token: str) -> list[str]:
        if token in self.never_split:
            return [token]
        pieces: list[list[str]] = []
        start_new = True
        for char in token:
            if _is_punctuation(char):
                pieces.append([char])
                start_new = True
            else:
                if start_new:
                    pieces.append([])
                    start_new = False
                pieces[-1].append(char)
        return ["".join(p) for p in pieces]


class WordpieceTokenizer:
    """Greedy longest-match-first subword split with '##' continuations
    (reference tokenization.py:176-229)."""

    def __init__(
        self,
        vocab,
        unk_token: str = "[UNK]",
        max_input_chars_per_word: int = 100,
    ):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def tokenize(self, text: str) -> list[str]:
        output = []
        for token in whitespace_tokenize(text):
            chars = list(token)
            if len(chars) > self.max_input_chars_per_word:
                output.append(self.unk_token)
                continue
            pieces = []
            start = 0
            bad = False
            while start < len(chars):
                end = len(chars)
                found = None
                while start < end:
                    substr = "".join(chars[start:end])
                    if start > 0:
                        substr = "##" + substr
                    if substr in self.vocab:
                        found = substr
                        break
                    end -= 1
                if found is None:
                    bad = True
                    break
                pieces.append(found)
                start = end
            output.extend([self.unk_token] if bad else pieces)
        return output


class BertTokenizer:
    """Basic + WordPiece composition with ids conversion
    (reference tokenization.py:232-318)."""

    def __init__(
        self,
        vocab_file: str,
        do_lower_case: bool = True,
        max_len: Optional[int] = None,
    ):
        self.vocab = load_vocab(vocab_file)
        self.ids_to_tokens = {v: k for k, v in self.vocab.items()}
        self.basic_tokenizer = BasicTokenizer(do_lower_case=do_lower_case)
        self.wordpiece_tokenizer = WordpieceTokenizer(vocab=self.vocab)
        self.max_len = max_len if max_len is not None else int(1e12)

    def tokenize(self, text: str) -> list[str]:
        tokens = []
        for token in self.basic_tokenizer.tokenize(text):
            tokens.extend(self.wordpiece_tokenizer.tokenize(token))
        return tokens

    def convert_tokens_to_ids(self, tokens: Iterable[str]) -> list[int]:
        ids = [self.vocab[t] for t in tokens]
        if len(ids) > self.max_len:
            raise ValueError(
                f"Sequence length {len(ids)} exceeds model max {self.max_len}"
            )
        return ids

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> list[str]:
        return [self.ids_to_tokens[i] for i in ids]


class Encoding(NamedTuple):
    """What a fast tokenizer's ``encode`` returns, as far as the data
    modules read it."""

    ids: List[int]
    tokens: List[str]


class WordpieceEncoder(BertTokenizer):
    """:class:`BertTokenizer` with the fast-tokenizer interface that the
    GLUE, NER and SWAG data modules call (``encode(text,
    add_special_tokens=False).ids``/``.tokens``, ``token_to_id``), where
    the JAX package hands them its C++ or HF WordPiece tokenizer."""

    def encode(self, text: str, add_special_tokens: bool = True
               ) -> Encoding:
        tokens = self.tokenize(text)
        if add_special_tokens:
            tokens = ["[CLS]"] + tokens + ["[SEP]"]
        return Encoding([self.vocab[t] for t in tokens], tokens)

    def token_to_id(self, token: str) -> Optional[int]:
        return self.vocab.get(token)


def get_wordpiece_tokenizer(vocab_file: str, uppercase: bool = False):
    """BERT WordPiece tokenizer (reference tokenization.py:42-49): the C++
    core's ``CppWordPieceTokenizer``, lower-cased and accent-stripped
    unless ``uppercase``. Raises if the core cannot be built or loaded."""
    from bert_pytorch_tpu_torch.tools.tokenizer_cpp import \
        CppWordPieceTokenizer

    return CppWordPieceTokenizer(vocab_file, lowercase=not uppercase)


def bpe_merges_file(vocab_file: str) -> str:
    """The ``merges.txt`` beside a byte-level BPE ``vocab.json``."""
    return vocab_file.replace("vocab.json", "merges.txt")


def get_bpe_tokenizer(vocab_file: str, uppercase: bool = False):
    """Byte-level BPE tokenizer (reference tokenization.py:51-57) from a
    ``vocab.json`` and the :func:`bpe_merges_file` beside it: the C++
    core's ``CppByteLevelBPETokenizer``, lower-casing unless
    ``uppercase``. Raises if the core cannot be built or loaded."""
    from bert_pytorch_tpu_torch.tools.tokenizer_cpp import \
        CppByteLevelBPETokenizer

    return CppByteLevelBPETokenizer(vocab_file, bpe_merges_file(vocab_file),
                                    lowercase=not uppercase)


def check_tokenizer_files(kind: str, vocab_file: str) -> None:
    """Refuse, by name, a ``kind`` (``"wordpiece"`` or ``"bpe"``)
    tokenizer whose files are missing, before a caller loads any weights:
    a BPE ``vocab_file`` must be a ``vocab.json`` with its ``merges.txt``
    beside it."""
    if kind == "wordpiece":
        files = [vocab_file]
    elif kind == "bpe":
        if not str(vocab_file).endswith("vocab.json"):
            raise ValueError(f"bpe vocab_file {vocab_file!r} is not a "
                             "vocab.json (its merges.txt is found beside "
                             "it)")
        files = [vocab_file, bpe_merges_file(vocab_file)]
    else:
        raise ValueError(f"tokenizer {kind!r}; known: wordpiece, bpe")
    for path in files:
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{kind} tokenizer file {path} does not "
                                    "exist")


def get_tokenizer(kind: str, vocab_file: str, uppercase: bool = False):
    """The ``kind`` tokenizer (``"wordpiece"`` or ``"bpe"``) of
    ``vocab_file`` on the C++ core, its files checked first."""
    check_tokenizer_files(kind, vocab_file)
    if kind == "wordpiece":
        return get_wordpiece_tokenizer(vocab_file, uppercase=uppercase)
    return get_bpe_tokenizer(vocab_file, uppercase=uppercase)
