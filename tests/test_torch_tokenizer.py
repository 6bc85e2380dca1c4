"""The port's C++ tokenizer core held against the JAX package's on the CPU.

The port builds its own copy of the core (``bert_pytorch_tpu_torch/csrc/
tokenizer/``) into its kernel build directory; the JAX package builds
``native/``. Both must give equal ids and tokens on the corpora and the
adversarial strings of ``tests/test_tokenizer.py`` (and equal HF
``tokenizers`` where it is importable), and both trainers must write
byte-equal files. Tolerance: exact everywhere.
"""

import concurrent.futures
import hashlib
import json
import os
import subprocess
import sys

import pytest

import test_tokenizer as spec
from bert_pytorch_tpu.data.tokenization import BasicTokenizer
from bert_pytorch_tpu.tools import tokenizer_cpp as jax_cpp
from bert_pytorch_tpu_torch.data import tokenization
from bert_pytorch_tpu_torch.ops.kernels import build
from bert_pytorch_tpu_torch.tools import tokenizer_cpp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("tok") / "vocab.txt"
    path.write_text("\n".join(spec.VOCAB) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def adversarial_vocab(tmp_path_factory):
    """The vocab of ``test_cpp_matches_python_spec_adversarial``: every
    word, first char and continuation char of the adversarial texts."""
    basic = BasicTokenizer(do_lower_case=True)
    pieces = dict.fromkeys(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"])
    for text in spec.ADVERSARIAL_TEXTS:
        for word in basic.tokenize(text):
            pieces.setdefault(word)
            pieces.setdefault(word[0])
            for c in word[1:]:
                pieces.setdefault("##" + c)
    path = tmp_path_factory.mktemp("adv") / "adv_vocab.txt"
    path.write_text("\n".join(pieces) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def bpe_files(tmp_path_factory):
    """A byte-level BPE trained by the port's C++ trainer on the BPE
    sentences of tests/test_tokenizer.py."""
    root = tmp_path_factory.mktemp("bpe")
    corpus = root / "corpus.txt"
    corpus.write_text("\n".join(spec.BPE_SENTENCES * 8) + "\n")
    vocab_json = tokenizer_cpp.train_bpe_vocab(
        [str(corpus)], 400, str(root / "out"), min_frequency=1)
    return vocab_json, vocab_json.replace("vocab.json", "merges.txt")


# The one string where the core (the JAX package's and the port's copy
# alike) and HF part ways when lower-casing: U+0130 (İ) folds to one code
# point in the core, to two (i + U+0307) in HF. Held to the JAX core only.
HF_LOWERCASE_APART = ("İstanbul DİYARBAKIR ʼn ǅungla ẞ groß",)


def _assert_same(ours, theirs, texts):
    for text in texts:
        a, b = ours.encode(text), theirs.encode(text)
        assert a.tokens == b.tokens, repr(text)
        assert a.ids == b.ids, repr(text)


@pytest.mark.parametrize("lowercase", [True, False])
def test_wordpiece_equals_the_jax_core(vocab_file, adversarial_vocab,
                                       lowercase):
    texts = spec.SENTENCES + spec.ADVERSARIAL_TEXTS
    for vocab in (vocab_file, adversarial_vocab):
        ours = tokenizer_cpp.CppWordPieceTokenizer(vocab, lowercase)
        theirs = jax_cpp.CppWordPieceTokenizer(vocab, lowercase)
        _assert_same(ours, theirs, texts)
        assert ours.get_vocab_size() == theirs.get_vocab_size()
        for tid in range(ours.get_vocab_size()):
            assert ours.id_to_token(tid) == theirs.id_to_token(tid)
    ours = tokenization.get_wordpiece_tokenizer(vocab_file,
                                                uppercase=not lowercase)
    assert isinstance(ours, tokenizer_cpp.CppWordPieceTokenizer)
    assert ours.token_to_id("[MASK]") == 4
    assert ours.token_to_id("notavocabword") is None
    enc = ours.encode("hello world", add_special_tokens=True)
    assert enc.tokens[0] == "[CLS]" and enc.tokens[-1] == "[SEP]"


def test_wordpiece_equals_hf_and_the_python_spec(vocab_file):
    ours = tokenization.get_wordpiece_tokenizer(vocab_file)
    oracle = tokenization.WordpieceEncoder(vocab_file, do_lower_case=True)
    for text in spec.SENTENCES:
        assert ours.encode(text).ids == oracle.encode(
            text, add_special_tokens=False).ids, text
    tokenizers = pytest.importorskip("tokenizers")
    hf = tokenizers.BertWordPieceTokenizer(
        vocab_file, lowercase=True, strip_accents=True,
        handle_chinese_chars=True, clean_text=True)
    for text in spec.SENTENCES:
        want = hf.encode(text, add_special_tokens=False)
        got = ours.encode(text)
        assert (got.tokens, got.ids) == (want.tokens, want.ids), text


@pytest.mark.parametrize("lowercase", [False, True])
def test_bpe_equals_the_jax_core_and_hf(bpe_files, lowercase):
    vocab_json, merges = bpe_files
    ours = tokenization.get_bpe_tokenizer(vocab_json,
                                          uppercase=not lowercase)
    theirs = jax_cpp.CppByteLevelBPETokenizer(vocab_json, merges,
                                              lowercase=lowercase)
    texts = spec.BPE_SENTENCES + spec.ADVERSARIAL_TEXTS
    _assert_same(ours, theirs, texts)
    assert ours.get_vocab_size() == theirs.get_vocab_size() > 261
    assert ours.token_to_id("[PAD]") == 0 and ours.token_to_id("[MASK]") == 4
    tokenizers = pytest.importorskip("tokenizers")
    hf = tokenizers.ByteLevelBPETokenizer(vocab_json, merges,
                                          lowercase=lowercase)
    for text in texts:
        if lowercase and text in HF_LOWERCASE_APART:
            continue
        want = hf.encode(text)
        got = ours.encode(text)
        assert (got.tokens, got.ids) == (want.tokens, want.ids), repr(text)


def _digest(path) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


@pytest.mark.parametrize("lowercase", [True, False])
def test_trainers_write_byte_equal_files(tmp_path, lowercase):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(spec.SENTENCES + spec.BPE_SENTENCES) * 20
                      + "\n" + "the cat sat on the mat\n" * 50)
    files = [str(corpus)]
    ours = tokenizer_cpp.train_wordpiece_vocab(
        files, 120, str(tmp_path / "ours.txt"), lowercase=lowercase)
    theirs = jax_cpp.train_wordpiece_vocab(
        files, 120, str(tmp_path / "theirs.txt"), lowercase=lowercase)
    assert _digest(ours) == _digest(theirs)
    ours = tokenizer_cpp.train_bpe_vocab(
        files, 330, str(tmp_path / "ours_bpe"), min_frequency=1,
        lowercase=lowercase)
    theirs = jax_cpp.train_bpe_vocab(
        files, 330, str(tmp_path / "theirs_bpe"), min_frequency=1,
        lowercase=lowercase)
    for name in ("vocab.json", "merges.txt"):
        assert _digest(tmp_path / "ours_bpe" / name) == _digest(
            tmp_path / "theirs_bpe" / name), name
    assert len(json.load(open(ours))) > 261


def test_concurrent_encode_matches_serial(vocab_file, bpe_files):
    texts = [spec.SENTENCES[i % len(spec.SENTENCES)] + f" tail{i}"
             for i in range(64)]
    for tok in (tokenization.get_wordpiece_tokenizer(vocab_file),
                tokenization.get_bpe_tokenizer(bpe_files[0])):
        serial = [(e.ids, e.tokens) for e in map(tok.encode, texts)]
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
            parallel = list(pool.map(
                lambda t: (tok.encode(t).ids, tok.encode(t).tokens), texts))
        assert parallel == serial


def _native_state() -> dict:
    native = os.path.join(REPO, "native")
    return {name: os.stat(os.path.join(native, name)).st_mtime_ns
            for name in sorted(os.listdir(native))}


BUILD_CHILD = """
import json, sys
from bert_pytorch_tpu_torch.ops.kernels import build
from bert_pytorch_tpu_torch.telemetry.compile_events import CompileMonitor
from bert_pytorch_tpu_torch.tools import tokenizer_cpp
build.set_build_dir(sys.argv[1])
with CompileMonitor().installed() as monitor:
    tok = tokenizer_cpp.CppWordPieceTokenizer(sys.argv[2])
print(json.dumps({"events": monitor.events,
                  "library": str(build.host_library_path("tokenizer")),
                  "ids": tok.encode("hello world").ids}))
"""


def test_library_builds_into_the_build_dir_and_leaves_native_alone(
        vocab_file, tmp_path):
    """A cold build in a fresh build directory: one ``compile`` miss for
    ``tokenizer``, the library under that directory, nothing under
    ``native/`` touched; a second process finds it built (a hit)."""
    before = _native_state()
    records = []
    for _ in range(2):
        out = subprocess.run(
            [sys.executable, "-c", BUILD_CHILD, str(tmp_path / "build"),
             vocab_file], cwd=REPO, capture_output=True, text=True,
            timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        records.append(json.loads(out.stdout.splitlines()[-1]))
    assert [[(e["fn"], e["cache"]) for e in r["events"]] for r in records
            ] == [[("tokenizer", "miss")], [("tokenizer", "hit")]]
    assert records[0]["events"][0]["compile_s"] > 0
    library = records[0]["library"]
    assert os.path.dirname(library) == str(tmp_path / "build")
    assert os.path.exists(library)
    assert records[0]["ids"] == records[1]["ids"] == [19, 20]
    assert _native_state() == before
    assert os.path.dirname(str(build.host_library_path("tokenizer"))) == str(
        build.build_dir())
