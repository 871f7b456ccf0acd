"""Build ``csrc/<name>.cu`` with ``nvcc`` (or ``csrc/<name>.cpp`` with the
host's ``g++``) at first use and load it with ctypes.

Each source compiles alone into a shared library with a plain C interface
(no PyTorch headers), which takes seconds; the library lands in the
package's ``_build/`` directory (ignored by git) under a name that carries
a hash of the source and the flags, so an edited source builds anew and an
unchanged one is reused. ``-fmad=false`` keeps nvcc from contracting a
multiply and an add into an FMA, so that the kernels round as their plain
PyTorch versions do; ``-ffp-contract=off`` does the same for g++, so that
the host library rounds as its plain numpy version does. ``build_all`` runs
one compiler per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
CXX_FLAGS = ("-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` under PyTorch's CUDA_HOME, else the first one on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found under CUDA_HOME or on PATH; the "
                           "CUDA kernels of this package need the CUDA toolkit")
    return found


def find_cxx() -> str:
    """The host C++ compiler: ``g++`` on PATH."""
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH; the host library of this package "
                           "(csrc/*.cpp) needs a C++ compiler")
    return found


def source_path(name: str) -> Path:
    """``csrc/<name>.cu``, else ``csrc/<name>.cpp``."""
    src = CSRC_DIR / f"{name}.cu"
    return src if src.exists() else CSRC_DIR / f"{name}.cpp"


def _flags(src: Path) -> tuple:
    return NVCC_FLAGS if src.suffix == ".cu" else CXX_FLAGS


def library_path(name: str) -> Path:
    src = source_path(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(src)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (nvcc) or ``csrc/<name>.cpp`` (g++) unless a
    library of the same hash exists; a failed compile raises."""
    out = library_path(name)
    if out.exists():
        return out
    src = source_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Write under a temporary name and rename, so that a concurrent build or
    # a build cut short never leaves a partial library under the final name.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    compiler = find_nvcc() if src.suffix == ".cu" else find_cxx()
    cmd = [compiler, *_flags(src), "-o", tmp, str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(compiler).name} failed ({proc.returncode}) on "
                               f"{src.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library(name: str) -> ctypes.CDLL:
    """Build (once) and load ``csrc/<name>.cu`` or ``.cpp``; the handle is
    cached."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib


def build_all(names) -> dict[str, float]:
    """Build the given sources in parallel; returns each one's seconds."""
    def timed(name):
        t0 = time.perf_counter()
        build(name)
        return time.perf_counter() - t0

    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(timed, names)))
