"""Synthetic inputs of the port.

* Serving: a small WordPiece vocab written from a fixed word list (the
  port's copy of the JAX package's ``write_trace_vocab``). The repository
  holds no 30522-entry vocab, so demo-mode serving (seeded random weights)
  tokenizes with this file: its ids are all < 30522, so a model at the
  published vocab width serves it unchanged.
* Pretraining: host batches of random rows shaped like the JAX package's
  synthetic shards and masked by the port's dataset code
  (:func:`synthetic_pretraining_batch`), for driving the train step where
  no shard (and no ``h5py``) is at hand.
* SQuAD: a seeded SQuAD-format JSON file from the same words
  (:func:`write_squad_json`), for finetuning and prediction where no
  ``train-v1.1.json``/``dev-v1.1.json`` is at hand.
"""

from __future__ import annotations

import json
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


def synthetic_samples(rng, num_samples: int, seq_len: int, vocab_size: int):
    """Rows of random tokens shaped like the JAX package's synthetic shards
    (``make_shard``): [CLS] a [SEP] b [SEP] with content length in
    [S/2, S-1), ids 5..vocab, special ids 2/3, then pad. Returns
    (input_ids [N, S] int32, special token positions per row, next-sentence
    labels [N] int8)."""
    import numpy as np

    input_ids = np.zeros((num_samples, seq_len), np.int32)
    specials = []
    next_sentence = rng.integers(0, 2, num_samples).astype(np.int8)
    cls_id, sep_id = 2, 3
    for i in range(num_samples):
        content = int(rng.integers(seq_len // 2, seq_len - 1))
        ids = rng.integers(5, vocab_size, size=content).astype(np.int32)
        split = int(rng.integers(1, content - 1)) if content > 2 else 1
        row = np.concatenate(
            [[cls_id], ids[:split], [sep_id], ids[split:], [sep_id]])
        special = [0, split + 1, len(row) - 1]
        row = row[:seq_len]
        special = [min(p, seq_len - 1) for p in special]
        input_ids[i, :len(row)] = row
        specials.append(special)
    return input_ids, specials, next_sentence


def synthetic_pretraining_batch(seed: int, batch_size: int, seq_len: int,
                                vocab_size: int, max_pred_per_seq: int,
                                masked_lm_prob: float = 0.15,
                                mask_token_index: int = 4) -> dict:
    """One host batch of the loader's layout (input_ids, segment_ids,
    input_mask, masked_lm_labels [N, S], next_sentence_labels [N]; int32),
    from :func:`synthetic_samples` masked by the dataset's own
    ``mask_input``, with per-sample generators seeded on (seed, index) as
    the dataset seeds them."""
    import numpy as np

    from bert_pytorch_tpu_torch.data.dataset import (input_mask_for,
                                                     mask_input,
                                                     segment_ids_for)

    ids, specials, nsp = synthetic_samples(np.random.default_rng(seed),
                                           batch_size, seq_len, vocab_size)
    rows = {"input_ids": [], "segment_ids": [], "input_mask": [],
            "masked_lm_labels": []}
    for i, special in enumerate(specials):
        rng = np.random.default_rng((seed, 0, i))
        special = np.asarray(special)
        rows["segment_ids"].append(segment_ids_for(ids[i], special))
        rows["input_mask"].append(input_mask_for(ids[i], special))
        masked, labels = mask_input(rng, ids[i].copy(), special,
                                    max_pred_per_seq, masked_lm_prob,
                                    vocab_size, mask_token_index)
        rows["input_ids"].append(masked)
        rows["masked_lm_labels"].append(labels)
    batch = {key: np.stack(value).astype(np.int32)
             for key, value in rows.items()}
    batch["next_sentence_labels"] = nsp.astype(np.int32)
    return batch


# Context lengths of write_squad_json, in words (= WordPiece tokens: every
# word is in the demo vocab): at max_seq_length 384, doc_stride 128 and a
# question of at most 10 tokens, 400-700 tokens cut into 2-4 windows.
SQUAD_CONTEXT_WORDS = (400, 700)
SQUAD_PARAGRAPHS, SQUAD_QUESTIONS = 2, 3  # per article, per paragraph


def _squad_paragraph(rng, article: int, paragraph: int,
                     version_2: bool) -> dict:
    """One paragraph: a context of sentences (first word capitalised, so the
    answers' casing must be restored from the context), and SQUAD_QUESTIONS
    questions, each of 3-7 words taken from the context before its answer,
    whose answer is a span of 1-4 context words at its character offset.
    Under ``version_2`` every third question is unanswerable: it asks
    about a word that is not in the demo vocab and has no answer."""
    n_words = int(rng.integers(SQUAD_CONTEXT_WORDS[0],
                               SQUAD_CONTEXT_WORDS[1] + 1))
    words = [str(w) for w in rng.choice(TRACE_WORDS, n_words)]
    i = 0
    while i < n_words:  # sentences of 6-14 words
        words[i] = words[i].capitalize()
        i += int(rng.integers(6, 15))
    context = " ".join(words)
    offsets = [0]
    for w in words[:-1]:
        offsets.append(offsets[-1] + len(w) + 1)
    qas = []
    for q in range(SQUAD_QUESTIONS):
        qid = f"a{article}p{paragraph}q{q}"
        if version_2 and q % 3 == 2:
            qas.append({"id": qid, "question": "what is the zebra",
                        "answers": [], "is_impossible": True})
            continue
        start = int(rng.integers(8, n_words - 4))
        length = int(rng.integers(1, 5))
        n_q = int(rng.integers(3, 8))
        question = " ".join(w.lower() for w in words[start - n_q:start])
        text = " ".join(words[start:start + length])
        qa = {"id": qid, "question": f"what {question}",
              "answers": [{"text": text, "answer_start": offsets[start]}]}
        if version_2:
            qa["is_impossible"] = False
        qas.append(qa)
    return {"context": context, "qas": qas}


def write_squad_json(path: str, seed: int, n_articles: int,
                     version_2: bool = False) -> str:
    """A SQuAD v1.1 (or, with ``version_2``, v2.0) JSON file of
    ``n_articles`` articles of SQUAD_PARAGRAPHS paragraphs with
    SQUAD_QUESTIONS questions each, made from :data:`TRACE_WORDS` with
    ``numpy.random.default_rng(seed)``. Every answer is a real span of its
    context with the right ``answer_start``, so the official eval script
    and the featurization read it as they read the real files."""
    import numpy as np

    rng = np.random.default_rng(seed)
    data = [{"title": f"synthetic {a}",
             "paragraphs": [_squad_paragraph(rng, a, p, version_2)
                            for p in range(SQUAD_PARAGRAPHS)]}
            for a in range(n_articles)]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": "v2.0" if version_2 else "1.1", "data": data}, f)
    return path
