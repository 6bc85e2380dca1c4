"""The port's offline tools on the CPU (bert_pytorch_tpu_torch/tools/):
``format`` byte for byte against the JAX package's ``format_corpus``;
``verify_checkpoint`` classifying the port's own checkpoints, gathered and
sharded; ``perf_ledger`` and ``check_telemetry_schema`` against the
repo-root JAX tools on the same inputs (written here, never the repo's
own files); and smoke runs of ``bench_loader`` and ``bench_tokenizer``
printing their JSON lines."""

import json
import os
import subprocess
import sys

import pytest
import torch

from bert_pytorch_tpu.tools.format import format_corpus as jax_format_corpus
from bert_pytorch_tpu_torch.tools import bench_loader, bench_tokenizer
from bert_pytorch_tpu_torch.tools import format as port_format
from bert_pytorch_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TOOLS = os.path.join(REPO, "bert_pytorch_tpu_torch", "tools")
JAX_TOOLS = os.path.join(REPO, "tools")


def run_tool(directory, name, *argv):
    """(rc, stdout) of ``python <directory>/<name>.py argv`` as a script."""
    out = subprocess.run([sys.executable, os.path.join(directory,
                                                       f"{name}.py"), *argv],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    return out.returncode, out.stdout


# -- format ------------------------------------------------------------------

def write_corpus_inputs(root):
    """wikiextractor JSON lines, <doc> blocks and BooksCorpus text, with
    abbreviations, quotes, empty articles and non-ASCII text."""
    wiki = root / "wiki"
    wiki.mkdir()
    docs = [
        {"text": "Paris is the capital. It has 2.1 million people! Why? "
                 "Because.\nSecond paragraph here.  Really."},
        {"text": ""},
        {"text": "Ünïcode sentence one. «Quoted» two?\n\nAfter a gap."},
    ]
    (wiki / "wiki_00").write_text(
        "\n".join(json.dumps(d) for d in docs) + "\n\nnot json\n",
        encoding="utf-8")
    (wiki / "wiki_01").write_text(
        '<doc id="1">\nTitle\nFirst line. Second line.\n</doc>\n'
        '<doc id="2">\n\n</doc>\n<doc id="3">\nMr. Smith went home. '
        'Done.\n</doc>\n', encoding="utf-8")
    books = root / "books"
    books.mkdir()
    for i in range(3):
        (books / f"book_{i}.txt").write_text(
            f"Chapter {i}. It begins.\n\nShe said: yes! Then left...   "
            "The end.\n" * (i + 1), encoding="utf-8")
    return wiki, books


@pytest.mark.parametrize("dataset", ["wiki", "books"])
def test_format_writes_the_jax_bytes(tmp_path, dataset):
    wiki, books = write_corpus_inputs(tmp_path)
    inputs = sorted(str(p) for p in (wiki if dataset == "wiki"
                                     else books).iterdir())
    ours = port_format.format_corpus(inputs, str(tmp_path / "port"), dataset,
                                     num_outputs=2, processes=1)
    theirs = jax_format_corpus(inputs, str(tmp_path / "jax"), dataset,
                               num_outputs=2, processes=1)
    assert [os.path.basename(p) for p in ours] == [
        os.path.basename(p) for p in theirs]
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes(), name
    assert any((tmp_path / "port" / n).stat().st_size for n in names)


def test_format_command_line_runs_with_a_pool(tmp_path):
    wiki, _ = write_corpus_inputs(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "bert_pytorch_tpu_torch.tools.format",
         "--input_glob", str(wiki / "wiki_*"), "--output_dir",
         str(tmp_path / "out"), "--dataset", "wiki", "--num_outputs", "2",
         "--processes", "2"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert "[formatter] 2 input files" in out.stdout
    inputs = sorted(str(p) for p in wiki.iterdir())
    jax_format_corpus(inputs, str(tmp_path / "jax"), "wiki", 2, 1)
    for name in os.listdir(tmp_path / "jax"):
        assert ((tmp_path / "out" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())


# -- verify_checkpoint ---------------------------------------------------------

def contents(seed):
    gen = torch.Generator().manual_seed(seed)
    return {"model": {"w": torch.randn(16, 4, generator=gen),
                      "b": torch.randn(4, generator=gen)}, "epoch": 0}


@pytest.fixture
def checkpoints(tmp_path):
    """A gathered directory with three saves and a sharded one with one."""
    gathered = tmp_path / "gathered"
    for step in (1, 2, 3):
        ckpt.save_checkpoint(str(gathered), step, contents(step))
    sharded = tmp_path / "sharded"
    ckpt.save_checkpoint(str(sharded), 4, contents(4), layout="sharded",
                         mesh_spec={"data": 1})
    return gathered, sharded


def verdicts(stdout):
    """path basename -> status of each ``path: status (detail)`` line."""
    out = {}
    for line in stdout.splitlines():
        path, _, rest = line.partition(": ")
        if rest.split(" ")[0] in ("verified", "no_manifest", "corrupt"):
            out[os.path.basename(path)] = rest.split(" ")[0]
    return out


def test_verify_checkpoint_classifies_port_checkpoints(checkpoints):
    gathered, sharded = checkpoints
    rc, stdout = run_tool(PORT_TOOLS, "verify_checkpoint", str(gathered),
                          str(sharded))
    assert rc == 0, stdout
    assert verdicts(stdout) == {
        "ckpt_1.msgpack": "verified", "ckpt_2.msgpack": "verified",
        "ckpt_3.msgpack": "verified", "ckpt_4.msgpack": "verified",
        "ckpt_4.shard0of1.msgpack": "verified"}
    assert "ckpt_4.msgpack: mesh_spec data=1 (layout=sharded)" in stdout
    rc, _ = run_tool(PORT_TOOLS, "verify_checkpoint", "--strict",
                     str(sharded))
    assert rc == 0

    os.remove(str(gathered / "ckpt_2.msgpack") + ".manifest.json")
    with open(gathered / "ckpt_3.msgpack", "r+b") as f:
        f.seek(20)
        byte = f.read(1)
        f.seek(20)
        f.write(bytes([byte[0] ^ 0xFF]))
    shard = sharded / "ckpt_4.shard0of1.msgpack"
    shard.write_bytes(shard.read_bytes()[:-3])
    rc, stdout = run_tool(PORT_TOOLS, "verify_checkpoint", str(gathered),
                          str(sharded))
    assert rc == 1
    assert verdicts(stdout) == {
        "ckpt_1.msgpack": "verified", "ckpt_2.msgpack": "no_manifest",
        "ckpt_3.msgpack": "corrupt", "ckpt_4.msgpack": "corrupt",
        "ckpt_4.shard0of1.msgpack": "corrupt"}
    # The JAX tool reads the port's manifests the same way.
    rc_jax, stdout_jax = run_tool(JAX_TOOLS, "verify_checkpoint",
                                  str(gathered), str(sharded))
    assert (rc_jax, verdicts(stdout_jax)) == (rc, verdicts(stdout))
    rc, _ = run_tool(PORT_TOOLS, "verify_checkpoint", "--strict",
                     str(gathered / "ckpt_2.msgpack"))
    assert rc == 1
    rc, _ = run_tool(PORT_TOOLS, "verify_checkpoint",
                     str(gathered / "missing.msgpack"))
    assert rc == 2


# -- perf_ledger, check_telemetry_schema ----------------------------------------

LEDGER_STEPS = (
    ("append", "--leg", "train", "--metric", "step_ms_p50=40",
     "--metric", "mfu=0.4", "--config", "seq_len=128"),
    ("append", "--leg", "train", "--metric", "step_ms_p50=41",
     "--metric", "mfu=0.41", "--config", "seq_len=128"),
    ("append", "--leg", "train", "--metric", "step_ms_p50=39",
     "--metric", "mfu=0.4", "--config", "seq_len=128"),
    ("check",),
    ("append", "--leg", "train", "--metric", "step_ms_p50=90",
     "--metric", "mfu=0.2", "--config", "seq_len=128"),
    ("check",), ("check", "--leg", "serve"), ("append", "--leg", "train"),
    ("append", "--leg", "x", "--metric", "bad"),
)


def test_perf_ledger_matches_the_jax_tool(tmp_path):
    outputs = {}
    for name, directory in (("port", PORT_TOOLS), ("jax", JAX_TOOLS)):
        path = str(tmp_path / name / "perf_ledger.jsonl")
        os.makedirs(os.path.dirname(path))
        outputs[name] = []
        for cmd, *rest in LEDGER_STEPS:
            rc, stdout = run_tool(directory, "perf_ledger", cmd, path, *rest)
            outputs[name].append((rc, stdout.replace(path, "L")))
        rc, stdout = run_tool(directory, "perf_ledger", "check",
                              str(tmp_path / name / "missing.jsonl"))
        outputs[name].append((rc, stdout))
    assert outputs["port"] == outputs["jax"]
    rcs = [rc for rc, _ in outputs["port"]]
    assert rcs == [0, 0, 0, 0, 0, 1, 0, 2, 2, 2]
    assert "perf ledger drift" in outputs["port"][5][1]


def test_check_telemetry_schema_matches_the_jax_tool(tmp_path):
    good = tmp_path / "good.jsonl"
    good.write_text(json.dumps({
        "schema": 1, "ts": 1.0, "kind": "compile_cost", "tag": "telemetry",
        "fn": "train_step", "shapes_digest": "0123456789ab",
        "analysis": "counted", "flops": 1.0}) + "\n")
    bad = tmp_path / "bad.jsonl"
    bad.write_text(
        json.dumps({"schema": 1, "ts": 1.0, "kind": "compile",
                    "fn": "train_step"}) + "\n"
        + '{"schema": 1, "ts": NaN}\nnot json\n')
    for argv, want_rc in (([str(good)], 0), ([str(good), str(bad)], 1),
                          ([str(tmp_path / "none.jsonl")], 2)):
        port = run_tool(PORT_TOOLS, "check_telemetry_schema", *argv)
        jax = run_tool(JAX_TOOLS, "check_telemetry_schema", *argv)
        assert port == jax and port[0] == want_rc, (argv, port, jax)
    # The port names its inputs: no default sweep of the repo root.
    assert run_tool(PORT_TOOLS, "check_telemetry_schema")[0] == 2


# -- the bench tools -------------------------------------------------------------

def json_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("source", ["hdf5", "rows"])
def test_bench_loader_prints_its_lines(capsys, source):
    bench_loader.main(["--samples", "512", "--batch_size", "32",
                       "--seq_len", "32", "--vocab_size", "512",
                       "--workers", "0", "--source", source])
    captured = capsys.readouterr()
    line, = json_lines(captured.out)
    assert line["metric"] == "loader_seq_per_sec" and line["value"] > 0
    assert (line["num_workers"], line["batch_size"], line["seq_len"],
            line["unit"]) == (0, 32, 32, "seq/s/host")
    assert f"source {source}" in captured.err


@pytest.mark.parametrize("kind", ["wordpiece", "bpe"])
def test_bench_tokenizer_prints_its_lines(capsys, tmp_path, kind):
    """WordPiece on a vocab trained on the corpus (the JAX bench), or
    byte-level BPE on a vocab.json with merges.txt beside it."""
    argv = ["--lines", "300", "--repeat", "1"]
    if kind == "bpe":
        from bert_pytorch_tpu_torch.tools import (build_vocab,
                                                  make_synthetic_text)

        make_synthetic_text.write_corpus(str(tmp_path / "text"), 1, 20, 0)
        argv += ["--vocab_file", build_vocab.main([
            "--input_glob", str(tmp_path / "text" / "*.txt"),
            "--tokenizer", "bpe", "--output", str(tmp_path / "vocab"),
            "--vocab_size", "500", "--uppercase"])]
    capsys.readouterr()
    bench_tokenizer.main(argv)
    lines = json_lines(capsys.readouterr().out)
    cpp = lines[0]
    assert (cpp["metric"], cpp["backend"], cpp["unit"]) == (
        f"{kind}_encode_tokens_per_sec", "cpp", "tokens/s")
    assert cpp["tokens"] > 0 and cpp["value"] > 0
    hf = lines[1]
    if "skipped" in hf:
        assert hf == {"backend": "hf_rust", "skipped": "not installed"}
    else:
        # Identical token work on both backends, then their ratio.
        assert hf["tokens"] == cpp["tokens"]
        assert lines[2]["metric"] == "cpp_vs_hf_rust_ratio"


# -- launch scripts ---------------------------------------------------------

SCRIPTS = {"run_pretraining.slurm": "run_pretraining",
           "run_pretraining.cobalt": "run_pretraining",
           "run_squad.sh": "run_squad", "run_glue.sh": "run_glue",
           "run_ner.sh": "run_ner", "run_swag.sh": "run_swag"}


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_launch_scripts_drive_the_port_runners(script, monkeypatch):
    """Each script runs its port runner with flags its parser takes (the
    JAX script's flags; checked before the runner's own checks of the
    files they name), and names nothing of the JAX package."""
    import argparse
    import importlib
    import re
    import shlex

    text = open(os.path.join(REPO, "bert_pytorch_tpu_torch", "scripts",
                             script)).read()
    assert "bert_pytorch_tpu." not in text and "run_pretraining.py" not in text
    assert subprocess.run(["bash", "-n", "-c", text]).returncode == 0
    module = SCRIPTS[script]
    body = text.replace("\\\n", " ")
    line = next(ln for ln in body.splitlines()
                if f"-m bert_pytorch_tpu_torch.{module}" in ln)
    # The cobalt script's ssh command string closes after the flags.
    tail = re.sub(r'"\s*&\s*$', "", line.split(
        f"bert_pytorch_tpu_torch.{module}")[1])
    tail = tail.replace('"$TASK"', "mrpc")
    argv = shlex.split(re.sub(r"\$\{?[A-Za-z_]+[^\s'\"]*", "X", tail))
    argv = [a.strip("'") for a in argv]
    runner = importlib.import_module(f"bert_pytorch_tpu_torch.{module}")
    parse = getattr(runner, "parse_arguments", None) or runner.parse_args
    unknown = []

    def parse_args(self, args=None, namespace=None):
        unknown.extend(self.parse_known_args(args, namespace)[1])
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    with pytest.raises(_Parsed):
        parse(argv)
    assert unknown == [] and "--output_dir" in argv + ["--output_dir"]
