"""Synthetic inputs of the port.

* Serving: a small WordPiece vocab written from a fixed word list (the
  port's copy of the JAX package's ``write_trace_vocab``). The repository
  holds no 30522-entry vocab, so demo-mode serving (seeded random weights)
  tokenizes with this file: its ids are all < 30522, so a model at the
  published vocab width serves it unchanged.
* Pretraining: host batches of random rows shaped like the JAX package's
  synthetic shards and masked by the port's dataset code
  (:func:`synthetic_pretraining_batch`), and a dataset of such rows
  (:class:`SyntheticPretrainingDataset`) for the runner's own loop, where
  no shard (and no ``h5py``) is at hand; and HDF5 shards in the JAX
  package's layout (:func:`make_shard`, a copy of its ``make_shard``;
  ``h5py`` imported inside), which the port's tests and its
  ``tools/chaos_run.py`` write without the JAX package.
* SQuAD: a seeded SQuAD-format JSON file from the same words
  (:func:`write_squad_json`), for finetuning and prediction where no
  ``train-v1.1.json``/``dev-v1.1.json`` is at hand.
* GLUE, NER and SWAG: seeded MRPC-shaped TSVs (:func:`write_mrpc_tsvs`),
  a CoNLL-shaped file (:func:`write_conll`) and a SWAG-shaped CSV
  (:func:`write_swag_csv`) from the same words.
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


def make_shard(path: str, num_samples: int, seq_len: int, vocab_size: int,
               seed: int = 0, nsp: bool = True, legacy: bool = False,
               max_pred_per_seq: int = 20, mixed_lengths: bool = False,
               packed: bool = False, max_sequences_per_pack: int = 8) -> str:
    """One synthetic HDF5 shard, byte for byte the JAX package's
    ``make_shard`` for the same arguments: ``num_samples`` rows of
    ``seq_len`` ids drawn from ``seed`` ([CLS] 2, [SEP] 3, content ids
    from 5), two segments under ``nsp``; ``legacy`` writes the NVIDIA
    pre-masked keys, ``mixed_lengths`` draws short-biased lengths, and
    ``packed`` writes an offline-packed shard of those rows instead."""
    import h5py
    import numpy as np

    if packed and legacy:
        raise ValueError("packed shards use the new format only")
    rng = np.random.default_rng(seed)
    input_ids = np.zeros((num_samples, seq_len), np.int32)
    specials = []
    next_sentence = rng.integers(0, 2 if nsp else 1,
                                 num_samples).astype(np.int8)
    cls_id, sep_id = 2, 3
    for i in range(num_samples):
        if mixed_lengths:
            lo = min(6, seq_len - 4)
            content = lo + int((seq_len - 2 - lo) * rng.random() ** 2)
        else:
            content = int(rng.integers(seq_len // 2, seq_len - 1))
        ids = rng.integers(5, vocab_size, size=content).astype(np.int32)
        if nsp:
            split = int(rng.integers(1, content - 1)) if content > 2 else 1
            row = np.concatenate(
                [[cls_id], ids[:split], [sep_id], ids[split:], [sep_id]])
            special = [0, split + 1, len(row) - 1]
        else:
            row = np.concatenate([[cls_id], ids, [sep_id]])
            special = [0, len(row) - 1]
        row = row[:seq_len]
        special = [min(p, seq_len - 1) for p in special]
        input_ids[i, :len(row)] = row
        specials.append(special)

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if packed:
        from bert_pytorch_tpu_torch.data.packing import (first_fit_decreasing,
                                                         write_packed_shard)

        lengths = [sp[-1] + 1 for sp in specials]
        packs = first_fit_decreasing(lengths, seq_len, max_sequences_per_pack)
        write_packed_shard(path, [
            [(input_ids[i, :lengths[i]], specials[i], int(next_sentence[i]))
             for i in pack] for pack in packs], seq_len,
            max_sequences_per_pack)
        return path
    with h5py.File(path, "w") as f:
        f.create_dataset("input_ids", data=input_ids, dtype="i4",
                         compression="gzip")
        if legacy:
            segment_ids = np.zeros_like(input_ids)
            input_mask = np.zeros_like(input_ids)
            positions = np.zeros((num_samples, max_pred_per_seq), np.int32)
            label_ids = np.zeros((num_samples, max_pred_per_seq), np.int32)
            for i, special in enumerate(specials):
                input_mask[i, :special[-1] + 1] = 1
                if len(special) == 3:
                    segment_ids[i, special[1] + 1:special[2] + 1] = 1
                n_mask = int(rng.integers(1, max_pred_per_seq))
                cand = [p for p in range(1, special[-1])
                        if p not in special][:n_mask]
                positions[i, :len(cand)] = cand
                label_ids[i, :len(cand)] = input_ids[i, cand]
            f.create_dataset("segment_ids", data=segment_ids, dtype="i4")
            f.create_dataset("input_mask", data=input_mask, dtype="i4")
            f.create_dataset("masked_lm_positions", data=positions,
                             dtype="i4")
            f.create_dataset("masked_lm_ids", data=label_ids, dtype="i4")
        else:
            dt = h5py.vlen_dtype(np.dtype("i4"))
            ds = f.create_dataset("special_token_positions", (num_samples,),
                                  dtype=dt)
            for i, special in enumerate(specials):
                ds[i] = np.asarray(special, np.int32)
        f.create_dataset("next_sentence_labels", data=next_sentence,
                         dtype="i1", compression="gzip")
    return path


class SyntheticPretrainingDataset:
    """An in-memory stand-in for ``data/dataset.py``'s shard dataset where
    no shard (and no ``h5py``) is at hand: ``num_samples`` rows of
    :func:`synthetic_samples`, each masked on access by the dataset's own
    ``mask_input`` under a generator seeded on (seed, epoch, index), as the
    shard dataset seeds it. Items are the shard dataset's five int32
    arrays, so the runner's sampler, loader and resume take it as they
    take the shards."""

    packed = False
    max_sequences_per_pack = 1

    def __init__(self, seed: int, num_samples: int, seq_len: int,
                 vocab_size: int, max_pred_per_seq: int,
                 masked_lm_prob: float = 0.15, mask_token_index: int = 4):
        import numpy as np

        self.seed = seed
        self.ids, self.specials, self.nsp = synthetic_samples(
            np.random.default_rng(seed), num_samples, seq_len, vocab_size)
        self.vocab_size = vocab_size
        self.max_pred_per_seq = max_pred_per_seq
        self.masked_lm_prob = masked_lm_prob
        self.mask_token_index = mask_token_index
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, idx: int):
        import numpy as np

        from bert_pytorch_tpu_torch.data.dataset import (input_mask_for,
                                                         mask_input,
                                                         segment_ids_for)

        ids = self.ids[idx]
        special = np.asarray(self.specials[idx])
        masked, labels = mask_input(
            np.random.default_rng((self.seed, self.epoch, int(idx))),
            ids.copy(), special, self.max_pred_per_seq, self.masked_lm_prob,
            self.vocab_size, self.mask_token_index)
        return [masked.astype(np.int32),
                segment_ids_for(ids, special).astype(np.int32),
                input_mask_for(ids, special).astype(np.int32),
                labels.astype(np.int32),
                np.asarray(self.nsp[idx]).astype(np.int32)]


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


# -- finetuning files -------------------------------------------------------
# Sentences of TRACE_WORDS (every word in the demo vocab), seeded by
# numpy.random.default_rng(seed); each file is laid out as its task's
# public release lays it out, so the data modules read it unchanged.

NER_LABELS = ("O", "B-PER", "I-PER", "B-LOC", "I-LOC")
_PEOPLE = ("william shakespeare", "william")
_PLACES = ("paris", "london", "france", "england")


def _sentence(rng, low: int, high: int) -> str:
    return " ".join(str(w) for w in rng.choice(
        TRACE_WORDS, int(rng.integers(low, high + 1))))


def write_mrpc_tsvs(directory: str, seed: int, n_train: int,
                    n_dev: int) -> str:
    """MRPC-shaped ``train.tsv`` and ``dev.tsv`` (header ``Quality, #1 ID,
    #2 ID, #1 String, #2 String``): a paraphrase pair (label 1) repeats
    sentence 1 with one word changed, a non-pair (label 0) is another
    sentence. Returns ``directory``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    header = "Quality\t#1 ID\t#2 ID\t#1 String\t#2 String"
    for name, n in (("train.tsv", n_train), ("dev.tsv", n_dev)):
        lines = [header]
        for i in range(n):
            first = _sentence(rng, 6, 24).split()
            label = int(rng.integers(0, 2))
            if label:
                second = list(first)
                second[int(rng.integers(0, len(second)))] = str(
                    rng.choice(TRACE_WORDS))
            else:
                second = _sentence(rng, 6, 24).split()
            lines.append(f"{label}\t{2 * i}\t{2 * i + 1}\t{' '.join(first)}"
                         f"\t{' '.join(second)}")
        with open(os.path.join(directory, name), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    return directory


def write_conll(path: str, seed: int, n_sentences: int) -> str:
    """A CoNLL-2003-shaped file (``token POS chunk tag`` per line, blank
    lines between sentences, a ``-DOCSTART-`` line first) tagged with
    :data:`NER_LABELS`: people and places among plain words."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lines = ["-DOCSTART- -X- -X- O", ""]
    for _ in range(n_sentences):
        for _ in range(int(rng.integers(4, 20))):
            kind = int(rng.integers(0, 6))
            if kind == 0:
                name = str(rng.choice(_PEOPLE)).split()
                tags = ["B-PER"] + ["I-PER"] * (len(name) - 1)
            elif kind == 1:
                name, tags = [str(rng.choice(_PLACES))], ["B-LOC"]
            else:
                name, tags = [str(rng.choice(TRACE_WORDS))], ["O"]
            lines += [f"{w} X X {t}" for w, t in zip(name, tags)]
        lines.append("")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return path


def write_swag_csv(path: str, seed: int, n_examples: int) -> str:
    """A SWAG-shaped CSV (``video-id, fold-ind, startphrase, sent1, sent2,
    gold-source, ending0..3, label``) whose gold ending repeats the last
    word of ``sent1``."""
    import csv

    import numpy as np

    rng = np.random.default_rng(seed)
    header = ["video-id", "fold-ind", "startphrase", "sent1", "sent2",
              "gold-source", "ending0", "ending1", "ending2", "ending3",
              "label"]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        for i in range(n_examples):
            context = _sentence(rng, 6, 20)
            label = int(rng.integers(0, 4))
            endings = [_sentence(rng, 3, 10) for _ in range(4)]
            endings[label] += " " + context.split()[-1]
            writer.writerow([f"v{i}", i, context, context,
                             _sentence(rng, 2, 5), "gold", *endings, label])
    return path
