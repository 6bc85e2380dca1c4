"""Format raw corpus dumps into one-sentence-per-line text: the port of the
JAX package's ``tools/format.py``.

wikiextractor output (``--json`` lines or ``<doc>`` blocks) or BooksCorpus
``.txt`` files become files with one sentence per line and a blank line
between articles, the inputs assigned round-robin to the output shards,
one worker process per shard. Sentences are split on sentence-final
punctuation followed by whitespace: the JAX tool's regex path, the one it
takes where nltk's punkt data is absent, so the two write the same bytes.

Usage::

    python -m bert_pytorch_tpu_torch.tools.format --input_glob 'wiki/**/wiki_*' \\
        --output_dir formatted --dataset wiki [--num_outputs 16] [--processes 4]
"""

from __future__ import annotations

import argparse
import glob
import json
import multiprocessing as mp
import os
import re


def get_sentences(text: str) -> list:
    """Split on sentence-final punctuation followed by whitespace."""
    parts = re.split(r"(?<=[.!?])\s+", text.strip())
    return [p.strip() for p in parts if p.strip()]


def _iter_wiki_articles(path: str):
    """wikiextractor output: either --json lines or <doc> ... </doc>
    blocks."""
    with open(path, "r", encoding="utf-8", errors="ignore") as f:
        first = f.read(1)
        f.seek(0)
        if first == "{":
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line).get("text", "")
                except json.JSONDecodeError:
                    continue
        else:
            article: list = []
            for line in f:
                if line.startswith("<doc"):
                    article = []
                elif line.startswith("</doc"):
                    yield "\n".join(article)
                else:
                    article.append(line.strip())


def _write_document(out, text: str) -> None:
    """One document's sentences, then a blank line if it had any."""
    wrote = False
    for paragraph in text.split("\n"):
        for sentence in get_sentences(paragraph):
            out.write(sentence + "\n")
            wrote = True
    if wrote:
        out.write("\n")


def _format_wiki(input_path: str, output_path: str) -> None:
    with open(output_path, "a", encoding="utf-8") as out:
        for article in _iter_wiki_articles(input_path):
            _write_document(out, article)


def _format_books(input_path: str, output_path: str) -> None:
    with open(input_path, "r", encoding="utf-8", errors="ignore") as f:
        text = f.read()
    with open(output_path, "a", encoding="utf-8") as out:
        _write_document(out, text)


FORMATTERS = {"wiki": _format_wiki, "books": _format_books}


def _run_job(dataset: str, output: str, inputs: list) -> None:
    """Module-level so a process pool can pickle it."""
    fmt = FORMATTERS[dataset]
    for path in inputs:
        fmt(path, output)


def format_corpus(input_files, output_dir: str, dataset: str,
                  num_outputs: int = 16, processes: int = 4) -> list:
    """Format ``input_files`` into ``<output_dir>/<dataset>_NNN.txt``;
    returns the output files that received input."""
    os.makedirs(output_dir, exist_ok=True)
    outputs = [os.path.join(output_dir, f"{dataset}_{i:03d}.txt")
               for i in range(num_outputs)]
    for path in outputs:
        open(path, "w").close()
    # Round-robin input->output assignment; one worker per output file so
    # appends never interleave.
    assignment: dict = {o: [] for o in outputs}
    for i, f in enumerate(sorted(input_files)):
        assignment[outputs[i % num_outputs]].append(f)
    jobs = [(dataset, o, ins) for o, ins in assignment.items() if ins]
    if processes <= 1:
        for job in jobs:
            _run_job(*job)
    else:
        with mp.Pool(processes=processes) as pool:
            pool.starmap(_run_job, jobs)
    return [o for o, ins in assignment.items() if ins]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_glob", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--dataset", choices=sorted(FORMATTERS),
                        required=True)
    parser.add_argument("--num_outputs", type=int, default=16)
    parser.add_argument("--processes", type=int, default=4)
    args = parser.parse_args(argv)
    files = glob.glob(args.input_glob, recursive=True)
    print(f"[formatter] {len(files)} input files")
    outs = format_corpus(files, args.output_dir, args.dataset,
                         args.num_outputs, args.processes)
    print(f"[formatter] wrote {len(outs)} formatted files")


if __name__ == "__main__":
    main()
