"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source under ``bert_pytorch_tpu_torch/csrc/`` with a
plain C interface. ``nvcc`` compiles it for Hopper (``sm_90a``) into a
shared library, and ``ctypes`` loads it: no PyTorch headers are involved,
so a build takes seconds. Libraries are built at first use into the build
directory — ``bert_pytorch_tpu_torch/build/`` (listed in ``.gitignore``)
unless :func:`set_build_dir` names another (``run_server
--compile_cache_dir``) — named by a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header is
rebuilt and never served stale. A missing compiler or a failed build
raises: there is no fallback to another implementation.

The tokenizer core (``csrc/tokenizer/tokenizer.cpp``, C++ for the host,
also with a plain C interface) is built the same way by the host C++
compiler (:func:`find_cxx`): :func:`load_host`.

Processes that share a build directory (a fleet of replicas started
together) build each library once: an advisory ``fcntl.flock`` on
``<library>.lock`` is held around "built? else compile", so one process
runs ``nvcc`` and reports a miss, and the others wait for it and report
a hit. The kernel releases the lock when its holder exits, so a process
killed mid-build leaves no stale lock.
"""

from __future__ import annotations

import ctypes
import fcntl
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

# Host libraries: name -> (source, the files it includes), under csrc/.
HOST_SOURCES = {"tokenizer": ("tokenizer/tokenizer.cpp",
                              ("tokenizer/unicode_tables.inc",))}
HOST_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}
# The build directory an entry point named (set_build_dir); None means
# BUILD_DIR.
_build_dir: Optional[Path] = None


def set_build_dir(path) -> Path:
    """Build and find the kernel libraries in ``path`` from now on (None
    or empty: back to :data:`BUILD_DIR`); returns the directory.
    Libraries this process already loaded stay loaded."""
    global _build_dir
    _build_dir = Path(path).resolve() if path else None
    return build_dir()


def build_dir() -> Path:
    """The directory the kernel libraries are built into and found in."""
    return _build_dir or BUILD_DIR


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
    return build_dir() / f"lib{name}-{library_digest(name)}.so"


def _lock_library(out: Path):
    """Open ``<library>.lock`` beside ``out`` and take its exclusive
    advisory lock, waiting for another process's build; returns the open
    file (closing it releases the lock)."""
    handle = open(out.with_name(out.name + ".lock"), "a")
    try:
        fcntl.flock(handle, fcntl.LOCK_EX)
    except BaseException:
        handle.close()
        raise
    return handle


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    process per source, all started together. Returns seconds per built
    kernel, from the common start to that compiler's exit (0.0 for one
    already built). The compiler's resource report (``-Xptxas -v``:
    registers, shared memory, spills) is kept beside each library as
    ``<library>.log``. Each name is reported to the installed compile
    monitors."""
    from bert_pytorch_tpu_torch.telemetry.compile_events import report_build

    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc: Optional[str] = None
    running = {}
    seconds: Dict[str, float] = {}
    locks = {}
    try:
        # Locks are taken in name order, so two processes building
        # overlapping sets never wait on each other in a cycle.
        for name in sorted(set(names)):
            out = library_path(name)
            if out.exists():
                seconds[name] = 0.0
                continue
            locks[name] = _lock_library(out)
            if out.exists():
                # Another process built it while this one waited.
                locks.pop(name).close()
                seconds[name] = 0.0
                continue
            nvcc = nvcc or find_nvcc()
            tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
            log = out.with_name(out.name + ".log")
            with open(log, "w") as f:
                proc = subprocess.Popen(cmd, stdout=f,
                                        stderr=subprocess.STDOUT)
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
                else:
                    os.replace(tmp, out)
                locks.pop(name).close()
            if pending:
                time.sleep(0.05)
    finally:
        for handle in locks.values():
            handle.close()
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


def find_cxx() -> str:
    """The host C++ compiler: ``g++`` on ``PATH`` (the host compiler
    ``nvcc`` takes), else ``$CXX``. ``$CXX`` comes second: a compiler
    wrapper that links its own ``libstdc++`` into the library makes the
    BPE trainer crash once ``torch`` (with its ``libstdc++``) is loaded."""
    for name in ("g++", os.environ.get("CXX")):
        path = shutil.which(name) if name else None
        if path:
            return path
    raise RuntimeError(
        "no host C++ compiler (g++ on PATH, or CXX): the tokenizer core is "
        "compiled from bert_pytorch_tpu_torch/csrc/tokenizer at first use")


def host_digest(name: str) -> str:
    """The hash that names a host library: its source, what it includes
    and the flags."""
    source, includes = HOST_SOURCES[name]
    text = b"".join((CSRC_DIR / f).read_bytes() for f in (source, *includes))
    return hashlib.sha256(
        text + " ".join(HOST_FLAGS).encode()).hexdigest()[:16]


def host_library_path(name: str) -> Path:
    return build_dir() / f"lib{name}-{host_digest(name)}.so"


def build_host(name: str) -> float:
    """Compile the host library ``name`` unless it is built, under the
    same per-library lock as :func:`build`; returns the compiler's seconds
    (0.0 when it was built) and reports the outcome to the installed
    compile monitors. A failed build raises with the compiler's output."""
    from bert_pytorch_tpu_torch.telemetry.compile_events import report_build

    out = host_library_path(name)
    seconds, built = 0.0, False
    if not out.exists():
        build_dir().mkdir(parents=True, exist_ok=True)
        with _lock_library(out):
            if not out.exists():
                tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
                cmd = [find_cxx(), *HOST_FLAGS, "-o", str(tmp),
                       str(CSRC_DIR / HOST_SOURCES[name][0])]
                t0 = time.perf_counter()
                proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                seconds = time.perf_counter() - t0
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(
                        f"host library build failed: {name} (rc "
                        f"{proc.returncode}):\n{proc.stdout}")
                os.replace(tmp, out)
                built = True
    report_build(name, host_digest(name), seconds, built)
    return seconds


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library ``name``, built first if needed; once
    loaded it stays loaded for the process, whatever directory
    :func:`set_build_dir` names later."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            build_host(name)
            lib = ctypes.CDLL(str(host_library_path(name)))
            _libraries[name] = lib
        return lib


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
