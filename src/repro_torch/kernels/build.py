"""Build the port's CUDA sources at first use and load them with ctypes.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface — no PyTorch
headers, so a build takes seconds — under ``build/kernels/`` at the root
of the checkout (listed in ``.gitignore``).  A library's file name carries
a digest of its source and flags, so an edited source is rebuilt and an
unchanged one is reused.  Nothing is prebuilt or downloaded.

    lib = load("tree_predict", {"tp_seg_packed": ([ctypes.c_void_p, ...],
                                                  ctypes.c_int)})
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
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"

#: Source of each kernel library, by name.
SOURCES = {
    "tree_predict": _PKG / "tree_predict" / "csrc" / "tree_predict.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: Per library: the compiler's output of its last build (``-Xptxas -v``
#: register and shared-memory report).
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    """The ``nvcc`` on ``PATH``, else the one under PyTorch's CUDA home."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library for ``name`` lives once built."""
    src = SOURCES[name]
    digest = hashlib.sha256(
        src.read_bytes() + "\0".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> dict[str, float]:
    """Compile each named source whose library is missing, one ``nvcc``
    process per source, all started together.  Returns the build seconds
    of the libraries compiled now; raises ``RuntimeError`` with the
    compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = []
    for name in names:
        dst = library_path(name)
        if dst.exists():
            continue
        nvcc = nvcc or nvcc_path()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((name, dst, tmp, proc, time.perf_counter()))
    done: dict[str, float] = {}
    failures = []
    for name, dst, tmp, proc, t0 in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, dst)  # atomic: a concurrent loader sees all or none
        done[name] = time.perf_counter() - t0
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return done


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``name`` (built first if needed), with each
    function of ``signatures`` (``{fn: (argtypes, restype)}``) declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _libs[name] = lib
        return lib
