"""Per-task-head request pre/post-processing: the port of the JAX
package's ``serve/tasks.py``.

One :class:`TaskHandler` per served head turns a JSON payload into the
unpadded feature arrays the engine batches (``prepare``) and the model's
per-request output slice back into a JSON-able result (``postprocess``).
Handlers accept both tokenizer surfaces (the fast ``encode().ids`` ones and
the pure-Python :class:`~bert_pytorch_tpu_torch.data.tokenization.
BertTokenizer`); SQuAD reuses the port's n-best decode
(:mod:`bert_pytorch_tpu_torch.squad`).

Tasks (``TASK_NAMES``):

* ``fill_mask`` — MLM head: top-k token predictions per ``[MASK]`` slot;
* ``classify`` — sequence classification: label + softmax probabilities
  (single sentence or sentence pair);
* ``squad`` — extractive QA: n-best span decode with the character-level
  answer realignment, in one window (the context is truncated to the
  largest bucket, the online-serving convention);
* ``ner`` — token classification: one tag per word (first-subtoken
  convention, label ids start at 1).

Every ``postprocess`` consumes fp32 numpy slices already demultiplexed per
request by the engine (packed or not), so results match between the
padded/packed batched path and a direct single-request forward. A head
that declares ``epilogue = "gather"`` (fill_mask) receives, from an engine
with fused epilogues, a :class:`GatheredTokens` of its positions of
interest instead of the whole token plane; ``"stack_span"`` (squad) has
its start and end logits stacked into one [B, 2, S] output, which the
engine splits back before ``postprocess``.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np

from bert_pytorch_tpu_torch import squad as squad_lib


class GatheredTokens(NamedTuple):
    """Per-request output of a fused-epilogue forward: token-level logits
    already gathered at the request's positions of interest (for
    fill_mask, one row per [MASK] in ``features['mask_positions']`` order)
    instead of the whole [request_len, vocab] plane. A wrapper type, not a
    bare array, so ``postprocess`` never guesses from a shape whether row i
    means token i or the i-th gathered position."""

    logits: np.ndarray  # [n_positions, vocab]


# -- tokenizer surface shims (the squad.py/ner_dataset.py conventions) ----

def _encode_ids(tokenizer, text: str) -> List[int]:
    if hasattr(tokenizer, "encode"):
        return tokenizer.encode(text, add_special_tokens=False).ids
    return tokenizer.convert_tokens_to_ids(tokenizer.tokenize(text))


def _encode_tokens(tokenizer, text: str) -> List[str]:
    if hasattr(tokenizer, "encode"):
        return tokenizer.encode(text, add_special_tokens=False).tokens
    return tokenizer.tokenize(text)


def _token_to_id(tokenizer, token: str) -> int:
    if hasattr(tokenizer, "token_to_id"):
        tid = tokenizer.token_to_id(token)
        if tid is None:
            tid = tokenizer.token_to_id("[UNK]")
        return tid
    return tokenizer.vocab.get(token, tokenizer.vocab["[UNK]"])


def _id_to_token(tokenizer, token_id: int) -> str:
    if hasattr(tokenizer, "id_to_token"):
        return tokenizer.id_to_token(int(token_id))
    return tokenizer.ids_to_tokens.get(int(token_id), "[UNK]")


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64)
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


class TaskHandler:
    """Pre/post-processing for one task head.

    ``prepare(payload, max_len)`` returns the feature dict the engine
    batches: ``input_ids``/``segment_ids`` (unpadded python lists, specials
    included, truncated to ``max_len``) plus whatever decode context
    ``postprocess`` needs. ``postprocess(features, outputs, payload)``
    receives the per-request fp32 numpy output slice (length ==
    ``len(features['input_ids'])`` for token-level outputs).
    """

    name: str = ""
    # Model output arity: how the engine slices per request.
    #   "tokens"  -> [S, ...] per-token array sliced to the request span
    #   "pooled"  -> one vector per request (pooled/classifier logits)
    #   "span"    -> (start_logits[S], end_logits[S]) tuple
    output_kind: str = "tokens"
    # Fused-epilogue capability (serve/engine.py ``fuse_epilogues``):
    #   "gather"     -> the forward gathers this head's positions of
    #                   interest (gather_positions) before its vocab
    #                   projection; demux hands postprocess a GatheredTokens
    #   "stack_span" -> start/end leave the device as one [B, 2, S] output
    #   None         -> nothing to fuse (pooled heads extract in-model)
    epilogue: Optional[str] = None

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer

    def gather_positions(self, features: dict) -> List[int]:
        """Request-relative positions a ``"gather"`` epilogue extracts;
        only heads that declare that epilogue implement it."""
        raise NotImplementedError

    def prepare(self, payload: dict, max_len: int) -> dict:
        raise NotImplementedError

    def postprocess(self, features: dict, outputs, payload: dict) -> dict:
        raise NotImplementedError

    # Shared [CLS] x [SEP] wrapping with truncation to the bucket budget.
    def _wrap(self, ids: List[int], max_len: int,
              ids_b: Optional[List[int]] = None) -> Dict[str, list]:
        cls_id = _token_to_id(self.tokenizer, "[CLS]")
        sep_id = _token_to_id(self.tokenizer, "[SEP]")
        if ids_b:
            # Balanced longest-first popping — the BERT sentence-pair
            # truncation convention (data/glue.py ``_truncate_pair``).
            ids, ids_b = list(ids), list(ids_b)
            while len(ids) + len(ids_b) > max_len - 3:
                (ids if len(ids) >= len(ids_b) else ids_b).pop()
            input_ids = [cls_id] + ids + [sep_id] + ids_b + [sep_id]
            segment_ids = [0] * (len(ids) + 2) + [1] * (len(ids_b) + 1)
        else:
            ids = ids[: max_len - 2]
            input_ids = [cls_id] + ids + [sep_id]
            segment_ids = [0] * len(input_ids)
        return {"input_ids": input_ids, "segment_ids": segment_ids}


class FillMaskHandler(TaskHandler):
    """MLM head: predict the top-k tokens for every ``[MASK]`` in the text.

    The text is split on the literal ``[MASK]`` marker and the pieces are
    encoded separately — tokenizer backends disagree on whether special
    tokens survive normalization (the pure-Python BasicTokenizer's
    ``never_split`` keeps them; byte-level BPE would shred them), so the
    mask id is inserted explicitly between encoded pieces.
    """

    name = "fill_mask"
    output_kind = "tokens"
    epilogue = "gather"

    def gather_positions(self, features: dict) -> List[int]:
        return features["mask_positions"]

    def prepare(self, payload: dict, max_len: int) -> dict:
        text = payload["text"]
        mask_id = _token_to_id(self.tokenizer, "[MASK]")
        ids: List[int] = []
        pieces = text.split("[MASK]")
        for i, piece in enumerate(pieces):
            if i:
                ids.append(mask_id)
            if piece.strip():
                ids.extend(_encode_ids(self.tokenizer, piece.strip()))
        if mask_id not in ids:
            raise ValueError("fill_mask payload text carries no [MASK]")
        budget = max_len - 2
        if len(ids) > budget:
            # Window AROUND the first mask instead of truncating the tail
            # blind — an over-long text must not lose its [MASK].
            m = ids.index(mask_id)
            start = max(0, min(m - budget // 2, len(ids) - budget))
            ids = ids[start:start + budget]
        features = self._wrap(ids, max_len)
        features["mask_positions"] = [
            i for i, t in enumerate(features["input_ids"]) if t == mask_id]
        if not features["mask_positions"]:
            raise ValueError(
                "[MASK] truncated away; shorten the text or raise buckets")
        return features

    def postprocess(self, features: dict, outputs, payload: dict) -> dict:
        if isinstance(outputs, GatheredTokens):
            # Already gathered on the device, one row per mask slot.
            rows = list(np.asarray(outputs.logits, np.float32))
        else:
            logits = np.asarray(outputs, np.float32)  # [len, vocab]
            rows = [logits[pos] for pos in features["mask_positions"]]
        top_k = int(payload.get("top_k", 5))
        slots = []
        for row in rows:
            best = np.argsort(-row)[:top_k]
            probs = _softmax(row)[best]
            slots.append([
                {"token": _id_to_token(self.tokenizer, tid),
                 "id": int(tid), "score": float(p)}
                for tid, p in zip(best, probs)])
        return {"masks": slots}


class ClassifyHandler(TaskHandler):
    """Sequence classification over the pooled [CLS] vector."""

    name = "classify"
    output_kind = "pooled"

    def __init__(self, tokenizer, labels: List[str]):
        super().__init__(tokenizer)
        self.labels = list(labels)

    def prepare(self, payload: dict, max_len: int) -> dict:
        ids = _encode_ids(self.tokenizer, payload["text"])
        ids_b = (_encode_ids(self.tokenizer, payload["text_pair"])
                 if payload.get("text_pair") else None)
        return self._wrap(ids, max_len, ids_b)

    def postprocess(self, features: dict, outputs, payload: dict) -> dict:
        logits = np.asarray(outputs, np.float32).reshape(-1)
        probs = _softmax(logits)
        best = int(np.argmax(logits))
        return {
            "label": self.labels[best] if best < len(self.labels) else best,
            "scores": {
                (self.labels[i] if i < len(self.labels) else str(i)):
                    float(p)
                for i, p in enumerate(probs)},
        }


class SquadHandler(TaskHandler):
    """Extractive QA with the run_squad n-best decode.

    Serving is single-window: the context is truncated to the request's
    length budget (``max_len`` = largest bucket) instead of sliding
    ``doc_stride`` windows, so one request maps to one row.
    ``convert_examples_to_features`` runs on the pre-truncated doc words,
    and ``get_answers`` performs the n-best and character-realignment
    decode the offline evaluator uses.
    """

    name = "squad"
    output_kind = "span"
    epilogue = "stack_span"

    def __init__(self, tokenizer, do_lower_case: bool = True,
                 max_query_length: int = 64):
        super().__init__(tokenizer)
        self.do_lower_case = do_lower_case
        self.max_query_length = max_query_length

    def prepare(self, payload: dict, max_len: int) -> dict:
        example = squad_lib.SquadExample(
            qas_id="live",
            question_text=payload["question"],
            doc_tokens=squad_lib.whitespace_tokenize(payload["context"]),
        )
        query_tokens = _encode_tokens(self.tokenizer, example.question_text)
        query_len = min(len(query_tokens), self.max_query_length)
        budget = max(1, max_len - query_len - 3)
        # Drop doc words from the end until their subtokens fit the one
        # window, so the featurizer emits exactly one span; each word is
        # tokenized once.
        doc_tokens = list(example.doc_tokens)
        counts = [len(_encode_tokens(self.tokenizer, w))
                  for w in doc_tokens]
        total = sum(counts)
        while doc_tokens and total > budget:
            total -= counts.pop()
            doc_tokens.pop()
        example.doc_tokens = doc_tokens or ["."]
        feat = squad_lib.convert_examples_to_features(
            [example], self.tokenizer, max_seq_length=max_len,
            doc_stride=max_len, max_query_length=self.max_query_length,
            is_training=False)[0]
        n = len(feat.tokens)
        return {
            "input_ids": list(feat.input_ids[:n]),
            "segment_ids": list(feat.segment_ids[:n]),
            "example": example,
            "feature": feat,
        }

    def postprocess(self, features: dict, outputs, payload: dict) -> dict:
        start, end = outputs
        start = np.asarray(start, np.float32)
        end = np.asarray(end, np.float32)
        feat = features["feature"]
        pad = len(feat.input_ids) - len(start)
        if pad > 0:  # re-pad to the featurizer's max_seq_length basis
            start = np.concatenate([start, np.full(pad, -1e4, np.float32)])
            end = np.concatenate([end, np.full(pad, -1e4, np.float32)])

        class _Args:
            n_best_size = int(payload.get("n_best", 5))
            max_answer_length = int(payload.get("max_answer_length", 30))
            version_2_with_negative = False
            null_score_diff_threshold = 0.0
            do_lower_case = self.do_lower_case

        answers, nbest, _ = squad_lib.get_answers(
            [features["example"]], [feat],
            [squad_lib.RawResult(feat.unique_id, start.tolist(),
                                 end.tolist())],
            _Args())
        return {
            "answer": answers["live"],
            "n_best": [
                {"text": e["text"], "probability": float(e["probability"]),
                 "start_logit": float(e["start_logit"]),
                 "end_logit": float(e["end_logit"])}
                for e in nbest["live"]],
        }


class NerHandler(TaskHandler):
    """Token classification: one tag per whitespace word.

    Every subtoken of a word rides the row; the word's tag is read from
    its FIRST subtoken, and label ids start at 1 (0 is the reserved
    non-entity/padding class), as the NER finetuning runner trains them.
    """

    name = "ner"
    output_kind = "tokens"

    def __init__(self, tokenizer, labels: List[str]):
        super().__init__(tokenizer)
        self.labels = list(labels)  # id i+1 -> labels[i]

    def prepare(self, payload: dict, max_len: int) -> dict:
        words = payload["text"].split()
        ids: List[int] = []
        word_starts: List[int] = []  # offset of each word's first subtoken
        for word in words:
            subtokens = _encode_tokens(self.tokenizer, word) or ["[UNK]"]
            if len(ids) + len(subtokens) > max_len - 2:
                break
            word_starts.append(len(ids) + 1)  # +1 for [CLS]
            ids.extend(_token_to_id(self.tokenizer, t) for t in subtokens)
        features = self._wrap(ids, max_len)
        features["words"] = words[: len(word_starts)]
        features["word_starts"] = word_starts
        return features

    def postprocess(self, features: dict, outputs, payload: dict) -> dict:
        logits = np.asarray(outputs, np.float32)  # [len, n_labels + 1]
        tags = []
        for word, pos in zip(features["words"], features["word_starts"]):
            pred = int(np.argmax(logits[pos]))
            # id 0 is the reserved class; real labels are 1-based.
            tag = (self.labels[pred - 1]
                   if 1 <= pred <= len(self.labels) else "O")
            tags.append({"word": word, "tag": tag,
                         "score": float(_softmax(logits[pos])[pred])})
        return {"entities": tags}


TASK_NAMES = ("fill_mask", "classify", "squad", "ner")


def build_handlers(tokenizer, task_config: dict) -> Dict[str, TaskHandler]:
    """Instantiate handlers for the configured tasks. ``task_config`` maps
    task name -> per-task options: ``classify`` and ``ner`` read
    ``labels``; ``squad`` reads ``do_lower_case`` and
    ``max_query_length``."""
    handlers: Dict[str, TaskHandler] = {}
    for name, options in task_config.items():
        options = options or {}
        if name == "fill_mask":
            handlers[name] = FillMaskHandler(tokenizer)
        elif name == "classify":
            handlers[name] = ClassifyHandler(
                tokenizer, options.get("labels") or ["0", "1"])
        elif name == "squad":
            handlers[name] = SquadHandler(
                tokenizer,
                do_lower_case=bool(options.get("do_lower_case", True)),
                max_query_length=int(options.get("max_query_length", 64)))
        elif name == "ner":
            handlers[name] = NerHandler(
                tokenizer, options.get("labels") or ["O"])
        else:
            raise ValueError(f"unknown serve task {name!r}; "
                             f"known: {', '.join(TASK_NAMES)}")
    return handlers
