"""The kernel build directory and its per-library build lock, on the CPU
with a stand-in ``nvcc``: processes that share one ``--compile_cache_dir``
run the compiler once between them (one miss, the rest hits);
``run_server --compile_cache_dir`` routes ``ops/kernels/build.py`` there;
the default stays ``bert_pytorch_tpu_torch/build/``."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

from bert_pytorch_tpu_torch import run_server
from bert_pytorch_tpu_torch.ops.kernels import build
from bert_pytorch_tpu_torch.tools import make_synthetic_data as synth

REPO = Path(__file__).resolve().parents[1]

# One process's build, as a replica's start runs it: the stand-in
# compiler on PATH, the shared directory, a monitor collecting the
# compile records; prints them.
CHILD = """
import json, sys
from bert_pytorch_tpu_torch.ops.kernels import build
from bert_pytorch_tpu_torch.telemetry.compile_events import CompileMonitor
build.set_build_dir(sys.argv[1])
records = []
with CompileMonitor(emit=records.append).installed():
    build.build(["layer_norm_fwd"])
print(json.dumps([(r["fn"], r["cache"]) for r in records]))
"""


def _stub_nvcc(root: Path) -> Path:
    """A compiler that sleeps (so the processes overlap), counts its runs
    in ``runs.txt`` and writes its ``-o`` target."""
    bin_dir = root / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo run >> {root / 'runs.txt'}\n"
        "sleep 1\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then echo lib > \"$2\"; fi\n"
        "  shift\ndone\n")
    nvcc.chmod(0o755)
    return bin_dir


def test_processes_sharing_a_build_dir_compile_once(tmp_path):
    bin_dir = _stub_nvcc(tmp_path)
    shared = tmp_path / "compile_cache"
    env = {"PATH": f"{bin_dir}:/usr/bin:/bin", "PYTHONPATH": str(REPO),
           "HOME": str(tmp_path)}
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(shared)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert (tmp_path / "runs.txt").read_text().count("run") == 1
    caches = sorted(cache for records in outs for _, cache in records)
    assert caches == ["hit", "hit", "miss"]
    assert all(records[0][0] == "layer_norm_fwd" for records in outs)
    built = list(shared.glob("liblayer_norm_fwd-*.so"))
    assert len(built) == 1 and built[0].read_text() == "lib\n"
    assert not list(shared.glob("*.tmp*"))


def test_build_lock_is_released_when_the_compiler_fails(tmp_path,
                                                         monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: bad kernel'\nexit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "_build_dir", None)
    build.set_build_dir(tmp_path / "cache")
    try:
        for _ in range(2):   # a held lock would block the second build
            try:
                build.build(["layer_norm_fwd"])
            except RuntimeError as exc:
                assert "bad kernel" in str(exc)
            else:
                raise AssertionError("the failed build did not raise")
    finally:
        build.set_build_dir(None)


def _server_args(tmp_path, *extra):
    vocab = synth.write_trace_vocab(str(tmp_path / "vocab.txt"))
    config = tmp_path / "config.json"
    config.write_text(json.dumps({
        "vocab_size": 40, "hidden_size": 16, "num_hidden_layers": 1,
        "num_attention_heads": 2, "intermediate_size": 32,
        "max_position_embeddings": 32, "next_sentence": True}))
    return run_server.parse_arguments([
        "--model_config_file", str(config), "--vocab_file", vocab,
        "--device", "cpu", "--dtype", "float32", "--tasks", "classify",
        "--buckets", "16", *extra])


def test_run_server_compile_cache_dir_routes_the_build(tmp_path):
    cache = tmp_path / "kernels"
    args = _server_args(tmp_path, "--compile_cache_dir", str(cache))
    assert args.compile_cache_dir == str(cache)
    try:
        run_server.build_service(args)
        assert build.build_dir() == cache.resolve()
        assert build.library_path("flash_attention_infer").parent == \
            cache.resolve()
        # A service built without the flag is back on the default.
        run_server.build_service(_server_args(tmp_path))
        assert build.build_dir() == build.BUILD_DIR
    finally:
        build.set_build_dir(None)


def test_default_build_dir_is_the_packages(tmp_path):
    assert _server_args(tmp_path).compile_cache_dir == ""
    assert build.BUILD_DIR == REPO / "bert_pytorch_tpu_torch" / "build"
    assert build.build_dir() == build.BUILD_DIR
    assert build.library_path("layer_norm_fwd").parent == build.BUILD_DIR
    assert build.set_build_dir("") == build.BUILD_DIR
