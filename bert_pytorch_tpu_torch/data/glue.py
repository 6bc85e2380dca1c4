"""GLUE task processors, featurization, and metrics.

A copy of the JAX package's ``data/glue.py`` (numpy only), its imports
rewritten to the port's.

Beyond-reference capability: the reference ships a GLUE *downloader*
(utils/download.py:81-101) but no GLUE runner — the TSVs it fetches can't be
consumed anywhere in that repo. This module closes the loop: per-task readers
for the standard GLUE TSV layouts (the format produced by the community
``download_glue_data.py`` script the downloader drives), sentence-pair
featurization in the [CLS] A [SEP] B [SEP] convention of the model library
(models/bert.py ``BertForSequenceClassification``), and the official GLUE
per-task metrics (accuracy, F1, Matthews correlation, Pearson/Spearman) in
plain numpy.

Task name → processor registry in :data:`PROCESSORS`; ``sts-b`` is the one
regression task (``num_labels == 1``, MSE loss in the runner).
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class InputExample:
    guid: str
    text_a: str
    text_b: Optional[str] = None
    label: Optional[str] = None


@dataclasses.dataclass
class InputFeatures:
    input_ids: np.ndarray  # [S] int32
    input_mask: np.ndarray  # [S] int32
    segment_ids: np.ndarray  # [S] int32
    label: float  # class index, or the raw score for regression


def _read_tsv(path: str, quotechar: Optional[str] = None) -> List[List[str]]:
    with open(path, encoding="utf-8-sig") as f:
        return [
            line
            for line in csv.reader(f, delimiter="\t", quotechar=quotechar)
            if line
        ]


class DataProcessor:
    """One GLUE task: how to parse its TSVs and what its labels/metric are."""

    #: column spec, overridden per task
    labels: Sequence[str] = ("0", "1")
    metric: str = "accuracy"
    regression: bool = False
    train_file = "train.tsv"
    dev_file = "dev.tsv"

    def get_train_examples(self, data_dir: str) -> List[InputExample]:
        return self._create_examples(
            _read_tsv(os.path.join(data_dir, self.train_file)), "train"
        )

    def get_dev_examples(self, data_dir: str) -> List[InputExample]:
        return self._create_examples(
            _read_tsv(os.path.join(data_dir, self.dev_file)), "dev"
        )

    def _create_examples(self, rows, set_type) -> List[InputExample]:
        raise NotImplementedError


class ColaProcessor(DataProcessor):
    """CoLA: no header; [source, label, author-mark, sentence]."""

    metric = "matthews"

    def _create_examples(self, rows, set_type):
        return [
            InputExample(f"{set_type}-{i}", row[3], None, row[1])
            for i, row in enumerate(rows)
        ]


class Sst2Processor(DataProcessor):
    """SST-2: header; [sentence, label]."""

    def _create_examples(self, rows, set_type):
        return [
            InputExample(f"{set_type}-{i}", row[0], None, row[1])
            for i, row in enumerate(rows[1:])
        ]


class MrpcProcessor(DataProcessor):
    """MRPC: header; [Quality, #1 ID, #2 ID, #1 String, #2 String]."""

    metric = "acc_and_f1"

    def _create_examples(self, rows, set_type):
        return [
            InputExample(f"{set_type}-{i}", row[3], row[4], row[0])
            for i, row in enumerate(rows[1:])
        ]


class StsbProcessor(DataProcessor):
    """STS-B: header; sentence1/sentence2 at 7/8, score at 9. Regression."""

    labels = ()
    metric = "pearson_and_spearman"
    regression = True

    def _create_examples(self, rows, set_type):
        return [
            InputExample(f"{set_type}-{i}", row[7], row[8], row[9])
            for i, row in enumerate(rows[1:])
        ]


class QqpProcessor(DataProcessor):
    """QQP: header; question1/question2 at 3/4, is_duplicate at 5."""

    metric = "acc_and_f1"

    def _create_examples(self, rows, set_type):
        examples = []
        for i, row in enumerate(rows[1:]):
            if len(row) < 6:  # a handful of malformed rows exist in the dump
                continue
            examples.append(
                InputExample(f"{set_type}-{i}", row[3], row[4], row[5])
            )
        return examples


class MnliProcessor(DataProcessor):
    """MNLI matched: header; sentence1/sentence2 at 8/9, gold label last."""

    labels = ("contradiction", "entailment", "neutral")
    dev_file = "dev_matched.tsv"

    def _create_examples(self, rows, set_type):
        return [
            InputExample(f"{set_type}-{i}", row[8], row[9], row[-1])
            for i, row in enumerate(rows[1:])
        ]


class MnliMismatchedProcessor(MnliProcessor):
    dev_file = "dev_mismatched.tsv"


class QnliProcessor(DataProcessor):
    """QNLI: header; [index, question, sentence, label]."""

    labels = ("entailment", "not_entailment")

    def _create_examples(self, rows, set_type):
        return [
            InputExample(f"{set_type}-{i}", row[1], row[2], row[3])
            for i, row in enumerate(rows[1:])
        ]


class RteProcessor(QnliProcessor):
    """RTE: same layout as QNLI ([index, sentence1, sentence2, label])."""


class WnliProcessor(DataProcessor):
    """WNLI: header; [index, sentence1, sentence2, label]."""

    def _create_examples(self, rows, set_type):
        return [
            InputExample(f"{set_type}-{i}", row[1], row[2], row[3])
            for i, row in enumerate(rows[1:])
        ]


PROCESSORS = {
    "cola": ColaProcessor,
    "sst-2": Sst2Processor,
    "mrpc": MrpcProcessor,
    "sts-b": StsbProcessor,
    "qqp": QqpProcessor,
    "mnli": MnliProcessor,
    "mnli-mm": MnliMismatchedProcessor,
    "qnli": QnliProcessor,
    "rte": RteProcessor,
    "wnli": WnliProcessor,
}


def _encode_ids(tokenizer, text: str) -> List[int]:
    return tokenizer.encode(text, add_special_tokens=False).ids


def _truncate_pair(tokens_a: List[int], tokens_b: List[int], max_len: int):
    """Truncate the longer sequence first, one token at a time — the
    length-budgeting convention BERT sentence-pair tasks use (keeps the more
    informative short side intact)."""
    while len(tokens_a) + len(tokens_b) > max_len:
        if len(tokens_a) > len(tokens_b):
            tokens_a.pop()
        else:
            tokens_b.pop()


def convert_examples_to_features(
    examples: Sequence[InputExample],
    tokenizer,
    max_seq_length: int,
    label_list: Sequence[str],
    regression: bool = False,
) -> List[InputFeatures]:
    label_map = {label: i for i, label in enumerate(label_list)}
    cls_id = tokenizer.token_to_id("[CLS]")
    sep_id = tokenizer.token_to_id("[SEP]")
    features = []
    for example in examples:
        ids_a = _encode_ids(tokenizer, example.text_a)
        ids_b = _encode_ids(tokenizer, example.text_b) if example.text_b else []
        if ids_b:
            _truncate_pair(ids_a, ids_b, max_seq_length - 3)
        else:
            ids_a = ids_a[: max_seq_length - 2]

        input_ids = [cls_id] + ids_a + [sep_id]
        segment_ids = [0] * len(input_ids)
        if ids_b:
            input_ids += ids_b + [sep_id]
            segment_ids += [1] * (len(ids_b) + 1)
        input_mask = [1] * len(input_ids)

        pad = max_seq_length - len(input_ids)
        input_ids += [0] * pad
        input_mask += [0] * pad
        segment_ids += [0] * pad

        if example.label is None:
            label = 0.0
        elif regression:
            label = float(example.label)
        else:
            label = float(label_map[example.label])
        features.append(
            InputFeatures(
                input_ids=np.asarray(input_ids, np.int32),
                input_mask=np.asarray(input_mask, np.int32),
                segment_ids=np.asarray(segment_ids, np.int32),
                label=label,
            )
        )
    return features


def features_to_arrays(features: Sequence[InputFeatures], regression: bool):
    return {
        "input_ids": np.stack([f.input_ids for f in features]),
        "input_mask": np.stack([f.input_mask for f in features]),
        "segment_ids": np.stack([f.segment_ids for f in features]),
        "labels": np.asarray(
            [f.label for f in features],
            np.float32 if regression else np.int32,
        ),
    }


# ---------------------------------------------------------------------------
# Metrics (official GLUE per-task definitions, numpy)


def accuracy(preds: np.ndarray, labels: np.ndarray) -> dict:
    return {"accuracy": float((preds == labels).mean())}


def acc_and_f1(preds: np.ndarray, labels: np.ndarray) -> dict:
    acc = float((preds == labels).mean())
    tp = float(np.sum((preds == 1) & (labels == 1)))
    fp = float(np.sum((preds == 1) & (labels == 0)))
    fn = float(np.sum((preds == 0) & (labels == 1)))
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (
        2 * precision * recall / (precision + recall)
        if precision + recall
        else 0.0
    )
    return {"accuracy": acc, "f1": f1, "acc_and_f1": (acc + f1) / 2}


def matthews(preds: np.ndarray, labels: np.ndarray) -> dict:
    tp = float(np.sum((preds == 1) & (labels == 1)))
    tn = float(np.sum((preds == 0) & (labels == 0)))
    fp = float(np.sum((preds == 1) & (labels == 0)))
    fn = float(np.sum((preds == 0) & (labels == 1)))
    denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return {"matthews": float((tp * tn - fp * fn) / denom) if denom else 0.0}


def _pearson(x: np.ndarray, y: np.ndarray) -> float:
    x = x - x.mean()
    y = y - y.mean()
    denom = np.sqrt((x * x).sum() * (y * y).sum())
    return float((x * y).sum() / denom) if denom else 0.0


def _rank(x: np.ndarray) -> np.ndarray:
    """Average ranks (ties share the mean of their rank range)."""
    order = np.argsort(x, kind="stable")
    ranks = np.empty(len(x), np.float64)
    ranks[order] = np.arange(1, len(x) + 1, dtype=np.float64)
    for value in np.unique(x):
        mask = x == value
        if mask.sum() > 1:
            ranks[mask] = ranks[mask].mean()
    return ranks


def pearson_and_spearman(preds: np.ndarray, labels: np.ndarray) -> dict:
    pearson = _pearson(preds.astype(np.float64), labels.astype(np.float64))
    spearman = _pearson(_rank(preds), _rank(labels))
    return {
        "pearson": pearson,
        "spearman": spearman,
        "corr": (pearson + spearman) / 2,
    }


METRICS = {
    "accuracy": accuracy,
    "acc_and_f1": acc_and_f1,
    "matthews": matthews,
    "pearson_and_spearman": pearson_and_spearman,
}


def compute_metrics(task: str, preds: np.ndarray, labels: np.ndarray) -> dict:
    return METRICS[PROCESSORS[task].metric](preds, labels)
