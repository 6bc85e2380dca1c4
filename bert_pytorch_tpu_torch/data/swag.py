"""SWAG multiple-choice dataset: reading and featurization.

A copy of the JAX package's ``data/swag.py`` (numpy only), its imports
rewritten to the port's.

Beyond-reference capability: the reference ships ``BertForMultipleChoice``
with a SWAG usage example in its docstring (modeling.py:1131-1197) but no
runner or data path that can feed it. This module reads the standard SWAG
CSV layout (``train.csv``/``val.csv``: video-id, fold-ind, startphrase,
sent1, sent2, gold-source, ending0..3, label) and featurizes each example
into the [choices, seq] layout ``BertForMultipleChoice`` expects: per
choice, ``[CLS] sent1 [SEP] sent2 ending_i [SEP]`` with segment 1 on the
continuation — the pairing convention of the original SWAG BERT recipe.
"""

from __future__ import annotations

import csv
import dataclasses
from typing import List, Optional

import numpy as np

from bert_pytorch_tpu_torch.data.glue import _truncate_pair

NUM_CHOICES = 4


@dataclasses.dataclass
class SwagExample:
    guid: str
    context: str  # sent1
    start: str  # sent2 (the shared beginning of every ending)
    endings: List[str]
    label: Optional[int] = None


def read_swag_examples(path: str, has_label: bool = True) -> List[SwagExample]:
    with open(path, encoding="utf-8") as f:
        rows = list(csv.reader(f))
    header = rows[0]
    col = {name: i for i, name in enumerate(header)}
    required = ["sent1", "sent2", "ending0", "ending1", "ending2", "ending3"]
    missing = [c for c in required if c not in col]
    if missing:
        raise ValueError(f"{path} is missing SWAG columns {missing}")
    examples = []
    for i, row in enumerate(rows[1:]):
        examples.append(
            SwagExample(
                guid=f"swag-{i}",
                context=row[col["sent1"]],
                start=row[col["sent2"]],
                endings=[row[col[f"ending{j}"]] for j in range(NUM_CHOICES)],
                label=int(row[col["label"]])
                if has_label and "label" in col
                else None,
            )
        )
    return examples


def convert_examples_to_arrays(
    examples, tokenizer, max_seq_length: int
) -> dict:
    """-> dict of [N, choices, S] int32 arrays + [N] labels."""
    cls_id = tokenizer.token_to_id("[CLS]")
    sep_id = tokenizer.token_to_id("[SEP]")
    unlabeled = [e.guid for e in examples if e.label is None]
    if unlabeled:
        raise ValueError(
            f"{len(unlabeled)} example(s) have no label (e.g. {unlabeled[0]}) "
            "— SWAG test.csv ships without labels and cannot be used for "
            "training or accuracy evaluation")
    n = len(examples)
    shape = (n, NUM_CHOICES, max_seq_length)
    input_ids = np.zeros(shape, np.int32)
    input_mask = np.zeros(shape, np.int32)
    segment_ids = np.zeros(shape, np.int32)
    labels = np.zeros((n,), np.int32)
    for idx, example in enumerate(examples):
        ids_context = tokenizer.encode(
            example.context, add_special_tokens=False).ids
        for c, ending in enumerate(example.endings):
            ids_a = list(ids_context)
            ids_b = tokenizer.encode(
                (example.start + " " + ending).strip(),
                add_special_tokens=False).ids
            _truncate_pair(ids_a, ids_b, max_seq_length - 3)
            ids = [cls_id] + ids_a + [sep_id] + ids_b + [sep_id]
            seg = [0] * (len(ids_a) + 2) + [1] * (len(ids_b) + 1)
            input_ids[idx, c, : len(ids)] = ids
            input_mask[idx, c, : len(ids)] = 1
            segment_ids[idx, c, : len(ids)] = seg
        labels[idx] = example.label
    return {
        "input_ids": input_ids,
        "input_mask": input_mask,
        "segment_ids": segment_ids,
        "labels": labels,
    }
