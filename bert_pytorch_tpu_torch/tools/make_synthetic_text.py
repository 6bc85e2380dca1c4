"""Synthesize a learnable text corpus + SQuAD-format QA data, offline.

The port's copy of the JAX package's ``tools/make_synthetic_text.py``:
the same generator, so one seed gives the same files from both packages.
The offline text chain (``make_synthetic_text corpus`` -> ``shard`` ->
``build_vocab`` -> ``encode_data`` -> ``run_pretraining``; the JAX
package's ``scripts/e2e_offline.sh``) starts from these files where a
deployment starts from a Wikipedia dump and the SQuAD downloads.

The corpus is templated English over a closed entity/fact world with a
Zipf-ish word distribution — structured enough that a vocab trained on it
is non-degenerate and a small model can learn the fact patterns. The
SQuAD generator emits v1.1-format train/dev JSON whose answers are
literal spans of the generated contexts, so the sliding-window
featurization, answer realignment, n-best decode and the official EM/F1
metric all exercise their real code paths.

::

    python -m bert_pytorch_tpu_torch.tools.make_synthetic_text corpus \
        --output_dir text/ --num_files 4 --seed 0
    python -m bert_pytorch_tpu_torch.tools.make_synthetic_text squad \
        --output squad/train.json --seed 1 --fact_seed 0
"""

from __future__ import annotations

import argparse
import json
import os
import random

ENTITIES = [
    "arveth", "brimlor", "caldus", "dorvane", "elmira", "fenwick",
    "garlan", "hestia", "ilmar", "jorund", "kelvar", "lorath",
    "mirren", "norvik", "ostara", "pellam", "quorin", "ravenna",
    "selwyn", "tormund", "ulfric", "vexley", "wendel", "ystral",
]
RELATIONS = [
    ("capital", "the capital of {a} is {b}.",
     "what is the capital of {a}?"),
    ("river", "the longest river in {a} is called {b}.",
     "what is the longest river in {a}?"),
    ("founder", "{b} founded the city of {a} long ago.",
     "who founded the city of {a}?"),
    ("export", "the main export of {a} is {b}.",
     "what is the main export of {a}?"),
    ("ruler", "during the old age {b} ruled over {a}.",
     "who ruled over {a} during the old age?"),
]
FILLER = [
    "the merchants travelled far across the plains.",
    "many scholars wrote about these lands in heavy books.",
    "winter in the north lasts for several long months.",
    "trade along the coast grew quickly in those years.",
    "the old roads connect every town to the harbour.",
    "farmers in the valley grow wheat and barley.",
    "sailors tell stories about the storms of the east.",
    "the great library holds maps of every province.",
]


def _facts(rng):
    """A consistent fact world: each (entity, relation) maps to one value."""
    facts = {}
    for a in ENTITIES:
        for rel, stmt, q in RELATIONS:
            facts[(a, rel)] = rng.choice([e for e in ENTITIES if e != a])
    return facts


def write_corpus(out_dir, n_files, articles_per_file, seed):
    """Formatted one-sentence-per-line text, blank line between articles
    (the contract of tools/shard.py's iter_articles)."""
    rng = random.Random(seed)
    facts = _facts(rng)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for fi in range(n_files):
        path = os.path.join(out_dir, f"corpus_{fi:03d}.txt")
        with open(path, "w") as f:
            for _ in range(articles_per_file):
                a = rng.choice(ENTITIES)
                n_sent = rng.randint(6, 14)
                for _ in range(n_sent):
                    if rng.random() < 0.55:
                        rel, stmt, _q = rng.choice(RELATIONS)
                        f.write(stmt.format(a=a, b=facts[(a, rel)]) + "\n")
                    else:
                        f.write(rng.choice(FILLER) + "\n")
                f.write("\n")
        paths.append(path)
    return paths


def write_squad(out_path, n_paragraphs, qas_per_paragraph, seed,
                fact_seed, impossible_frac=0.0):
    """SQuAD-format JSON; answers are literal context spans.

    With impossible_frac > 0 the output is v2.0-format: that fraction of
    questions ask about a relation whose fact sentence is NOT in the
    paragraph (``is_impossible: true``, empty answers — the official
    evaluate-v2.0 semantics; reference consumes the real v2.0 dev set the
    same way, run_squad.py:131-206)."""
    rng = random.Random(seed)
    facts = _facts(random.Random(fact_seed))  # same world as the corpus
    v2 = impossible_frac > 0
    data = []
    qid = 0
    for pi in range(n_paragraphs):
        a = rng.choice(ENTITIES)
        # keep at least one relation OUT of the context so impossible
        # questions (about the held-out relations) exist to ask
        k = min(qas_per_paragraph, len(RELATIONS) - 1 if v2 else len(RELATIONS))
        rels = rng.sample(RELATIONS, k=k)
        held_out = [r for r in RELATIONS if r not in rels]
        sentences, qas = [], []
        for rel, stmt, question in rels:
            b = facts[(a, rel)]
            sentences.append(stmt.format(a=a, b=b))
            sentences.append(rng.choice(FILLER))
        context = " ".join(sentences)
        for rel, stmt, question in rels:
            if v2 and rng.random() < impossible_frac:
                # Ask about a fact the paragraph does not state.
                mrel, _mstmt, mquestion = rng.choice(held_out)
                qas.append({
                    "id": f"q{qid}",
                    "question": mquestion.format(a=a),
                    "answers": [],
                    "is_impossible": True,
                })
                qid += 1
                continue
            b = facts[(a, rel)]
            # the answer span is b's occurrence inside its own fact
            # sentence (b may also appear elsewhere in the context)
            sent = stmt.format(a=a, b=b)
            sent_start = context.find(sent)
            start = sent_start + sent.find(b)
            assert context[start:start + len(b)] == b
            qa = {
                "id": f"q{qid}",
                "question": question.format(a=a),
                "answers": [{"text": b, "answer_start": start}],
            }
            if v2:
                qa["is_impossible"] = False
            qas.append(qa)
            qid += 1
        data.append({
            "title": f"article_{pi}",
            "paragraphs": [{"context": context, "qas": qas}],
        })
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"version": "v2.0" if v2 else "1.1", "data": data}, f)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="mode", required=True)
    c = sub.add_parser("corpus")
    c.add_argument("--output_dir", required=True)
    c.add_argument("--num_files", type=int, default=4)
    c.add_argument("--articles_per_file", type=int, default=200)
    c.add_argument("--seed", type=int, default=0)
    s = sub.add_parser("squad")
    s.add_argument("--output", required=True)
    s.add_argument("--paragraphs", type=int, default=200)
    s.add_argument("--qas_per_paragraph", type=int, default=3)
    s.add_argument("--seed", type=int, default=1)
    s.add_argument("--fact_seed", type=int, default=0,
                   help="must match the corpus --seed for a shared world")
    s.add_argument("--impossible_frac", type=float, default=0.0,
                   help=">0 emits SQuAD v2.0 format with this fraction of "
                        "unanswerable questions")
    args = p.parse_args(argv)
    if args.mode == "corpus":
        paths = write_corpus(args.output_dir, args.num_files,
                             args.articles_per_file, args.seed)
        print(f"wrote {len(paths)} corpus files to {args.output_dir}")
    else:
        path = write_squad(args.output, args.paragraphs,
                           args.qas_per_paragraph, args.seed, args.fact_seed,
                           args.impossible_frac)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
