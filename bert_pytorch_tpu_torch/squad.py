"""SQuAD v1.1/v2.0 data processing and answer decoding.

Behavioral parity with reference run_squad.py (cited per function):
example reading (:131-206), sliding-window featurization with max-context
bookkeeping (:209-420), n-best span decoding with null handling (:427-556),
and the character-level answer realignment that depends on the pure-Python
BasicTokenizer semantics (:570-664).

These are host-side (pure Python) components; the model side is
BertForQuestionAnswering + span_loss run by run_squad.py. The port's copy
of the JAX package's ``squad.py``: the same logic line for line, with only
the tokenizer import pointing at the port's own copy.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
from typing import Dict, List, Optional, Tuple

from bert_pytorch_tpu_torch.data.tokenization import (BasicTokenizer,
                                                  whitespace_tokenize)


@dataclasses.dataclass
class SquadExample:
    """One question (+ its paragraph); reference run_squad.py:61-98."""

    qas_id: str
    question_text: str
    doc_tokens: List[str]
    orig_answer_text: Optional[str] = None
    start_position: Optional[int] = None
    end_position: Optional[int] = None
    is_impossible: bool = False


@dataclasses.dataclass
class InputFeatures:
    """One sliding-window view of one example; reference run_squad.py:101-128."""

    unique_id: int
    example_index: int
    doc_span_index: int
    tokens: List[str]
    token_to_orig_map: Dict[int, int]
    token_is_max_context: Dict[int, bool]
    input_ids: List[int]
    input_mask: List[int]
    segment_ids: List[int]
    start_position: Optional[int] = None
    end_position: Optional[int] = None
    is_impossible: bool = False


RawResult = collections.namedtuple(
    "RawResult", ["unique_id", "start_logits", "end_logits"]
)


def _squad_whitespace(c: str) -> bool:
    return c in (" ", "\t", "\r", "\n") or ord(c) == 0x202F


def read_squad_examples(
    input_file: str, is_training: bool, version_2_with_negative: bool
) -> List[SquadExample]:
    """Parse the SQuAD JSON into examples with word-level answer spans
    (reference run_squad.py:131-206). Training answers that cannot be
    recovered from the whitespace-tokenized document are skipped."""
    with open(input_file, "r", encoding="utf-8") as reader:
        input_data = json.load(reader)["data"]

    examples = []
    for entry in input_data:
        for paragraph in entry["paragraphs"]:
            text = paragraph["context"]
            doc_tokens: List[str] = []
            char_to_word: List[int] = []
            prev_ws = True
            for c in text:
                if _squad_whitespace(c):
                    prev_ws = True
                else:
                    if prev_ws:
                        doc_tokens.append(c)
                    else:
                        doc_tokens[-1] += c
                    prev_ws = False
                char_to_word.append(len(doc_tokens) - 1)

            for qa in paragraph["qas"]:
                start_position = end_position = None
                orig_answer_text = None
                is_impossible = False
                if is_training:
                    if version_2_with_negative:
                        is_impossible = qa["is_impossible"]
                    if len(qa["answers"]) != 1 and not is_impossible:
                        raise ValueError(
                            "For training, each question should have exactly "
                            "1 answer."
                        )
                    if not is_impossible:
                        answer = qa["answers"][0]
                        orig_answer_text = answer["text"]
                        offset = answer["answer_start"]
                        start_position = char_to_word[offset]
                        end_position = char_to_word[
                            offset + len(orig_answer_text) - 1
                        ]
                        actual = " ".join(
                            doc_tokens[start_position : end_position + 1]
                        )
                        cleaned = " ".join(whitespace_tokenize(orig_answer_text))
                        if actual.find(cleaned) == -1:
                            continue  # unrecoverable answer; skip example
                    else:
                        start_position = end_position = -1
                        orig_answer_text = ""
                examples.append(
                    SquadExample(
                        qas_id=qa["id"],
                        question_text=qa["question"],
                        doc_tokens=doc_tokens,
                        orig_answer_text=orig_answer_text,
                        start_position=start_position,
                        end_position=end_position,
                        is_impossible=is_impossible,
                    )
                )
    return examples


_DocSpan = collections.namedtuple("DocSpan", ["start", "length"])


def _improve_answer_span(
    doc_tokens, input_start, input_end, tokenizer, orig_answer_text
) -> Tuple[int, int]:
    """Tighten a word-span to the subtoken span matching the annotated answer
    (reference run_squad.py:349-383)."""
    tok_answer_text = " ".join(_encode_tokens(tokenizer, orig_answer_text))
    for new_start in range(input_start, input_end + 1):
        for new_end in range(input_end, new_start - 1, -1):
            span = " ".join(doc_tokens[new_start : new_end + 1])
            if span == tok_answer_text:
                return new_start, new_end
    return input_start, input_end


def _check_is_max_context(doc_spans, cur_span_index, position) -> bool:
    """True iff this span gives the token its maximum min(left,right) context
    (reference run_squad.py:386-420)."""
    best_score, best_index = None, None
    for span_index, span in enumerate(doc_spans):
        end = span.start + span.length - 1
        if position < span.start or position > end:
            continue
        score = min(position - span.start, end - position) + 0.01 * span.length
        if best_score is None or score > best_score:
            best_score, best_index = score, span_index
    return cur_span_index == best_index


def _encode_tokens(tokenizer, text: str) -> List[str]:
    """Subtoken strings from either a fast tokenizer (``encode().tokens``) or
    the pure-Python BertTokenizer (``tokenize()``)."""
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


def convert_examples_to_features(
    examples: List[SquadExample],
    tokenizer,
    max_seq_length: int,
    doc_stride: int,
    max_query_length: int,
    is_training: bool,
) -> List[InputFeatures]:
    """Sliding-window featurization (reference run_squad.py:209-346)."""
    unique_id = 1000000000
    features = []
    for example_index, example in enumerate(examples):
        query_tokens = _encode_tokens(tokenizer, example.question_text)
        query_tokens = query_tokens[:max_query_length]

        tok_to_orig_index: List[int] = []
        orig_to_tok_index: List[int] = []
        all_doc_tokens: List[str] = []
        for i, token in enumerate(example.doc_tokens):
            orig_to_tok_index.append(len(all_doc_tokens))
            for sub_token in _encode_tokens(tokenizer, token):
                tok_to_orig_index.append(i)
                all_doc_tokens.append(sub_token)

        tok_start = tok_end = None
        if is_training and example.is_impossible:
            tok_start = tok_end = -1
        if is_training and not example.is_impossible:
            tok_start = orig_to_tok_index[example.start_position]
            if example.end_position < len(example.doc_tokens) - 1:
                tok_end = orig_to_tok_index[example.end_position + 1] - 1
            else:
                tok_end = len(all_doc_tokens) - 1
            tok_start, tok_end = _improve_answer_span(
                all_doc_tokens, tok_start, tok_end, tokenizer,
                example.orig_answer_text,
            )

        max_tokens_for_doc = max_seq_length - len(query_tokens) - 3  # CLS+2SEP
        doc_spans = []
        start_offset = 0
        while start_offset < len(all_doc_tokens):
            length = min(len(all_doc_tokens) - start_offset, max_tokens_for_doc)
            doc_spans.append(_DocSpan(start=start_offset, length=length))
            if start_offset + length == len(all_doc_tokens):
                break
            start_offset += min(length, doc_stride)

        for doc_span_index, doc_span in enumerate(doc_spans):
            tokens = ["[CLS]"] + query_tokens + ["[SEP]"]
            segment_ids = [0] * len(tokens)
            token_to_orig_map: Dict[int, int] = {}
            token_is_max_context: Dict[int, bool] = {}
            for i in range(doc_span.length):
                split_index = doc_span.start + i
                token_to_orig_map[len(tokens)] = tok_to_orig_index[split_index]
                token_is_max_context[len(tokens)] = _check_is_max_context(
                    doc_spans, doc_span_index, split_index
                )
                tokens.append(all_doc_tokens[split_index])
                segment_ids.append(1)
            tokens.append("[SEP]")
            segment_ids.append(1)

            input_ids = [_token_to_id(tokenizer, t) for t in tokens]
            input_mask = [1] * len(input_ids)
            pad = max_seq_length - len(input_ids)
            input_ids += [0] * pad
            input_mask += [0] * pad
            segment_ids += [0] * pad

            start_position = end_position = None
            if is_training and not example.is_impossible:
                doc_start = doc_span.start
                doc_end = doc_span.start + doc_span.length - 1
                if tok_start >= doc_start and tok_end <= doc_end:
                    offset = len(query_tokens) + 2
                    start_position = tok_start - doc_start + offset
                    end_position = tok_end - doc_start + offset
                else:
                    start_position = end_position = 0  # span not in window
            if is_training and example.is_impossible:
                start_position = end_position = 0

            features.append(
                InputFeatures(
                    unique_id=unique_id,
                    example_index=example_index,
                    doc_span_index=doc_span_index,
                    tokens=tokens,
                    token_to_orig_map=token_to_orig_map,
                    token_is_max_context=token_is_max_context,
                    input_ids=input_ids,
                    input_mask=input_mask,
                    segment_ids=segment_ids,
                    start_position=start_position,
                    end_position=end_position,
                    is_impossible=example.is_impossible,
                )
            )
            unique_id += 1
    return features


# --------------------------------------------------------------------------
# Answer decoding (reference run_squad.py:427-699)
# --------------------------------------------------------------------------

Prediction = collections.namedtuple(
    "Prediction", ["text", "start_logit", "end_logit"]
)
_PrelimPrediction = collections.namedtuple(
    "PrelimPrediction", ["start_index", "end_index", "start_logit", "end_logit"]
)


def _best_indices(logits, n_best_size: int) -> List[int]:
    order = sorted(range(len(logits)), key=lambda i: logits[i], reverse=True)
    return order[:n_best_size]


def _softmax(scores: List[float]) -> List[float]:
    if not scores:
        return []
    m = max(scores)
    exps = [math.exp(s - m) for s in scores]
    total = sum(exps)
    return [e / total for e in exps]


def _valid_prelim_predictions(start_indices, end_indices, feature, result, args):
    """Filter index pairs to in-document, max-context, length-bounded spans
    (reference run_squad.py:527-556)."""
    prelim = []
    for start_index in start_indices:
        for end_index in end_indices:
            if start_index >= len(feature.tokens):
                continue
            if end_index >= len(feature.tokens):
                continue
            if start_index not in feature.token_to_orig_map:
                continue
            if end_index not in feature.token_to_orig_map:
                continue
            if not feature.token_is_max_context.get(start_index, False):
                continue
            if end_index < start_index:
                continue
            if end_index - start_index + 1 > args.max_answer_length:
                continue
            prelim.append(
                _PrelimPrediction(
                    start_index,
                    end_index,
                    result.start_logits[start_index],
                    result.end_logits[end_index],
                )
            )
    return prelim


def _match_results(examples, features, results):
    by_id = {r.unique_id: r for r in results}
    feats = sorted(
        (f for f in features if f.unique_id in by_id), key=lambda f: f.unique_id
    )
    for f in feats:
        yield examples[f.example_index], f, by_id[f.unique_id]


def get_answer_text(example, feature, pred, args) -> str:
    """Detokenize the span and realign to the original text
    (reference run_squad.py:508-525)."""
    tok_tokens = feature.tokens[pred.start_index : pred.end_index + 1]
    orig_doc_start = feature.token_to_orig_map[pred.start_index]
    orig_doc_end = feature.token_to_orig_map[pred.end_index]
    orig_tokens = example.doc_tokens[orig_doc_start : orig_doc_end + 1]
    tok_text = " ".join(tok_tokens).replace(" ##", "").replace("##", "")
    tok_text = " ".join(tok_text.strip().split())
    orig_text = " ".join(orig_tokens)
    return get_final_text(tok_text, orig_text, args.do_lower_case)


def get_final_text(pred_text: str, orig_text: str, do_lower_case: bool) -> str:
    """Character-level projection of the normalized prediction back onto the
    original text (reference run_squad.py:570-664). Falls back to
    ``orig_text`` whenever the alignment heuristic fails."""

    def strip_spaces(text):
        ns_chars = []
        ns_to_s = collections.OrderedDict()
        for i, c in enumerate(text):
            if c == " ":
                continue
            ns_to_s[len(ns_chars)] = i
            ns_chars.append(c)
        return "".join(ns_chars), ns_to_s

    tokenizer = BasicTokenizer(do_lower_case=do_lower_case)
    tok_text = " ".join(tokenizer.tokenize(orig_text))

    start_position = tok_text.find(pred_text)
    if start_position == -1:
        return orig_text
    end_position = start_position + len(pred_text) - 1

    orig_ns_text, orig_ns_to_s = strip_spaces(orig_text)
    tok_ns_text, tok_ns_to_s = strip_spaces(tok_text)
    if len(orig_ns_text) != len(tok_ns_text):
        return orig_text

    tok_s_to_ns = {s: ns for ns, s in tok_ns_to_s.items()}

    def project(pos):
        if pos in tok_s_to_ns and tok_s_to_ns[pos] in orig_ns_to_s:
            return orig_ns_to_s[tok_s_to_ns[pos]]
        return None

    orig_start = project(start_position)
    orig_end = project(end_position)
    if orig_start is None or orig_end is None:
        return orig_text
    return orig_text[orig_start : orig_end + 1]


def get_answers(examples, features, results, args):
    """n-best decode over all windows of each question
    (reference run_squad.py:427-506). Returns (answers, nbest_answers,
    null_odds); null_odds is empty unless version_2_with_negative, and
    holds each question's null score diff (null score minus best non-null
    span score — higher means more likely unanswerable), the score the
    official v2.0 metric's best-threshold search consumes."""
    predictions = collections.defaultdict(list)
    null_vals = collections.defaultdict(lambda: (float("inf"), 0, 0))

    for ex, feat, result in _match_results(examples, features, results):
        start_indices = _best_indices(result.start_logits, args.n_best_size)
        end_indices = _best_indices(result.end_logits, args.n_best_size)
        prelim = _valid_prelim_predictions(
            start_indices, end_indices, feat, result, args
        )
        prelim.sort(key=lambda p: p.start_logit + p.end_logit, reverse=True)

        if args.version_2_with_negative:
            score = result.start_logits[0] + result.end_logits[0]
            if score < null_vals[ex.qas_id][0]:
                null_vals[ex.qas_id] = (
                    score, result.start_logits[0], result.end_logits[0]
                )

        curr, seen = [], []
        for pred in prelim:
            if len(curr) == args.n_best_size:
                break
            if pred.start_index > 0:
                final_text = get_answer_text(ex, feat, pred, args)
                if final_text in seen:
                    continue
            else:
                final_text = ""
            seen.append(final_text)
            curr.append(Prediction(final_text, pred.start_logit, pred.end_logit))
        predictions[ex.qas_id] += curr

    if args.version_2_with_negative:
        for qas_id in predictions.keys():
            _, s, e = null_vals[qas_id]
            predictions[qas_id].append(Prediction("", s, e))

    nbest_answers = collections.defaultdict(list)
    answers = {}
    null_odds = {}
    for qas_id, preds in predictions.items():
        nbest = sorted(
            preds, key=lambda p: p.start_logit + p.end_logit, reverse=True
        )[: args.n_best_size]
        if not nbest:
            nbest = [Prediction("empty", 0.0, 0.0)]
        total_scores = [p.start_logit + p.end_logit for p in nbest]
        best_non_null = next((p for p in nbest if p.text), None)
        probs = _softmax(total_scores)
        for i, entry in enumerate(nbest):
            nbest_answers[qas_id].append(
                collections.OrderedDict(
                    text=entry.text,
                    probability=probs[i],
                    start_logit=entry.start_logit,
                    end_logit=entry.end_logit,
                )
            )
        if args.version_2_with_negative:
            if best_non_null is None:
                # No non-null candidate at all: definitively unanswerable
                # (finite stand-in for +inf; null_odds must stay JSON).
                answers[qas_id] = ""
                null_odds[qas_id] = 1e9
                continue
            score_diff = (
                null_vals[qas_id][0]
                - best_non_null.start_logit
                - best_non_null.end_logit
            )
            null_odds[qas_id] = score_diff
            answers[qas_id] = (
                "" if score_diff > args.null_score_diff_threshold
                else best_non_null.text
            )
        else:
            answers[qas_id] = nbest_answers[qas_id][0]["text"]
    return answers, nbest_answers, null_odds
