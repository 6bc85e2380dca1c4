"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source under ``bert_pytorch_tpu_torch/csrc/`` with a
plain C interface. ``nvcc`` compiles it for Hopper (``sm_90a``) into a
shared library, and ``ctypes`` loads it: no PyTorch headers are involved,
so a build takes seconds. Libraries are built at first use into
``bert_pytorch_tpu_torch/build/`` (listed in ``.gitignore``), named by a
hash of the source and flags, so an edited source is rebuilt and never
served stale. A missing compiler or a failed build raises: there is no
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
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
# One entry per kernel source (csrc/<name>.cu -> build/lib<name>-<hash>.so).
KERNEL_SOURCES = ("flash_attention_infer",)
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


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        source_path(name).read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    process per source, all started together. Returns seconds per built
    kernel (0.0 for one already built). The compiler's resource report
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside
    each library as ``<library>.log``."""
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
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_name(out.name + ".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name} (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failures))
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
