"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source under ``bert_pytorch_tpu_torch/csrc/`` with a
plain C interface. ``nvcc`` compiles it for Hopper (``sm_90a``) into a
shared library, and ``ctypes`` loads it: no PyTorch headers are involved,
so a build takes seconds. Libraries are built at first use into
``bert_pytorch_tpu_torch/build/`` (listed in ``.gitignore``), named by a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source or header is rebuilt and never served stale. A missing compiler or a failed build raises: there is no
fallback to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
# One entry per kernel source (csrc/<name>.cu -> build/lib<name>-<hash>.so).
KERNEL_SOURCES = ("flash_attention_infer", "flash_attention_infer_int8",
                  "flash_attention_fwd", "flash_attention_bwd",
                  "layer_norm_fwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on ``PATH``, else
    ``$CUDA_HOME/bin/nvcc`` (default CUDA_HOME ``/usr/local/cuda``)."""
    candidates = [shutil.which("nvcc"),
                  os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                               "bin", "nvcc")]
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (put nvcc on PATH or set CUDA_HOME): the "
        "CUDA kernels are compiled from bert_pytorch_tpu_torch/csrc at "
        "first use")


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def library_digest(name: str) -> str:
    """The hash that names a library: its source, the shared headers and
    the flags."""
    text = source_path(name).read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    return hashlib.sha256(
        text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{library_digest(name)}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    process per source, all started together. Returns seconds per built
    kernel, from the common start to that compiler's exit (0.0 for one
    already built). The compiler's resource report (``-Xptxas -v``:
    registers, shared memory, spills) is kept beside each library as
    ``<library>.log``. Each name is reported to the installed compile
    monitors."""
    from bert_pytorch_tpu_torch.telemetry.compile_events import report_build

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc: Optional[str] = None
    running = {}
    seconds: Dict[str, float] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        nvcc = nvcc or find_nvcc()
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
        log = out.with_name(out.name + ".log")
        with open(log, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        running[name] = (proc, tmp, out, log, time.perf_counter())
    failures = []
    pending = dict(running)
    while pending:
        # Each compiler's seconds end at its own exit, whatever order
        # the compilers finish in.
        for name, (proc, tmp, out, log, t0) in list(pending.items()):
            if proc.poll() is None:
                continue
            seconds[name] = time.perf_counter() - t0
            del pending[name]
            if proc.returncode != 0:
                failures.append(
                    f"{name} (rc {proc.returncode}):\n{log.read_text()}")
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, out)
        if pending:
            time.sleep(0.05)
    if failures:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failures))
    for name, secs in seconds.items():
        report_build(name, library_digest(name), secs, name in running)
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libraries[name] = lib
        return lib


def ensure(names: Iterable[str]) -> None:
    """Load each named library (built first if needed), reporting every
    one to the installed compile monitors: a library this process loaded
    before reports a hit, the others through :func:`build`. A start-up
    (``InferenceEngine.warmup``) calls it so its compile records name
    every library it runs, whatever the process ran before."""
    from bert_pytorch_tpu_torch.telemetry.compile_events import report_build

    for name in names:
        with _lock:
            loaded = name in _libraries
        if loaded:
            report_build(name, library_digest(name), 0.0, False)
        else:
            load(name)


def load_bound(name: str, entry_points: Dict[str, List]) -> ctypes.CDLL:
    """:func:`load`, with ``argtypes`` set on each named entry point (each
    returns a cudaError_t as an ``int``) and on ``<name>_error``, which
    maps a cudaError_t to its message."""
    lib = load(name)
    for entry, argtypes in entry_points.items():
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error")
    if err.argtypes is None:
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def raise_on(rc: int, lib: ctypes.CDLL, lib_name: str, name: str) -> None:
    """Raise if a C entry point of ``lib_name`` returned a cudaError_t
    other than 0 for the wrapper ``name``."""
    if rc != 0:
        message = getattr(lib, f"{lib_name}_error")(rc).decode()
        raise RuntimeError(
            f"{name}: kernel launch failed: {message} (cudaError {rc})")
