"""Per-task-head request pre/post-processing: the port of the JAX
package's ``serve/tasks.py`` for the ``fill_mask`` and ``classify`` heads.

One :class:`TaskHandler` per served head turns a JSON payload into the
unpadded feature arrays the engine batches (``prepare``) and the model's
per-request output slice back into a JSON-able result (``postprocess``).
Handlers accept both tokenizer surfaces (the fast ``encode().ids`` ones and
the pure-Python :class:`~bert_pytorch_tpu_torch.data.tokenization.
BertTokenizer`). ``squad`` and ``ner`` are not ported yet.

Tasks (``TASKS``):

* ``fill_mask`` — MLM head: top-k token predictions per ``[MASK]`` slot;
* ``classify`` — sequence classification: label + softmax probabilities
  (single sentence or sentence pair).

Every ``postprocess`` consumes fp32 numpy slices already demultiplexed per
request by the engine (packed or not), so results match between the
padded/packed batched path and a direct single-request forward.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


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
    def __init__(self, tokenizer):
        self.tokenizer = tokenizer

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


TASK_NAMES = ("fill_mask", "classify")


def build_handlers(tokenizer, task_config: dict) -> Dict[str, TaskHandler]:
    """Instantiate handlers for the configured tasks. ``task_config`` maps
    task name -> per-task options; ``classify`` reads ``labels``."""
    handlers: Dict[str, TaskHandler] = {}
    for name, options in task_config.items():
        options = options or {}
        if name == "fill_mask":
            handlers[name] = FillMaskHandler(tokenizer)
        elif name == "classify":
            handlers[name] = ClassifyHandler(
                tokenizer, options.get("labels") or ["0", "1"])
        else:
            raise ValueError(f"unknown serve task {name!r}; "
                             f"known: {', '.join(TASK_NAMES)}")
    return handlers
