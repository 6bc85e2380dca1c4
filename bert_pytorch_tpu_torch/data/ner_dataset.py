"""CoNLL-style NER dataset.

A copy of the JAX package's ``data/ner_dataset.py`` (numpy only), its imports
rewritten to the port's.

Parity with reference src/ner_dataset.py: per-word tokenization with the
word's label propagated to every subtoken (:13-26), [CLS]/[SEP] wrapping
with the special label encoded as -100 (:28-35), zero-padding to
max_seq_len (:37-44), and the CoNLL file parser that splits sentences on
blank/-DOCSTART lines reading column 0 (token) and column 3 (tag) (:66-85).

Label ids start at 1 (0 is reserved, matching the reference's
``enumerate(labels, start=1)`` at :54 and the +1 head size in run_ner.py:224).
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Sequence

import numpy as np

SPECIAL_LABEL = -100


def _encode_word(tokenizer, word: str) -> List[str]:
    if hasattr(tokenizer, "encode"):
        return tokenizer.encode(word, add_special_tokens=False).tokens
    return tokenizer.tokenize(word)


def _token_id(tokenizer, token: str) -> int:
    if hasattr(tokenizer, "token_to_id"):
        tid = tokenizer.token_to_id(token)
        return tid if tid is not None else tokenizer.token_to_id("[UNK]")
    return tokenizer.vocab.get(token, tokenizer.vocab["[UNK]"])


@dataclasses.dataclass
class Sample:
    sentence: List[str]
    labels: List[str]

    def __post_init__(self):
        assert len(self.sentence) == len(self.labels)

    def encoded(self, tokenizer, label_to_id, max_seq_len: int):
        tokens: List[str] = []
        labels: List[str] = []
        for word, label in zip(self.sentence, self.labels):
            subtokens = _encode_word(tokenizer, word)
            tokens.extend(subtokens)
            labels.extend([label] * len(subtokens))

        tokens = tokens[: max_seq_len - 2]
        labels = labels[: max_seq_len - 2]
        tokens = ["[CLS]"] + tokens + ["[SEP]"]

        encoded_seq = [_token_id(tokenizer, t) for t in tokens]
        encoded_labels = (
            [SPECIAL_LABEL]
            + [label_to_id[l] for l in labels]
            + [SPECIAL_LABEL]
        )
        mask = [1] * len(encoded_seq)
        pad = max_seq_len - len(encoded_seq)
        encoded_seq += [0] * pad
        encoded_labels += [0] * pad
        mask += [0] * pad
        return tokens, encoded_seq, encoded_labels, mask


class NERDataset:
    def __init__(self, filename: str, tokenizer, labels: Sequence[str],
                 max_seq_len: int):
        self.samples = self._parse_file(filename)
        self.tokenizer = tokenizer
        self.label_to_id = {label: i for i, label in enumerate(labels, start=1)}
        self.max_seq_len = max_seq_len

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int):
        _, seq, labels, mask = self.samples[idx].encoded(
            self.tokenizer, self.label_to_id, self.max_seq_len)
        return (np.asarray(seq, np.int32), np.asarray(labels, np.int32),
                np.asarray(mask, np.int32))

    @staticmethod
    def _parse_file(filename: str) -> List[Sample]:
        samples = []
        sentence: List[str] = []
        labels: List[str] = []
        with open(filename, "r", encoding="utf-8") as f:
            for line in f:
                if line == "" or line.startswith("-DOCSTART") or line[0] == "\n":
                    if sentence:
                        samples.append(Sample(sentence, labels))
                        sentence, labels = [], []
                    continue
                cols = [c.strip() for c in re.split(" |\t", line)]
                sentence.append(cols[0])
                labels.append(cols[3])
        if sentence:
            samples.append(Sample(sentence, labels))
        return samples
