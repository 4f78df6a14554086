"""Build the hand-written CUDA kernels with ``nvcc`` and bind them with
``ctypes``.

Each ``csrc/*.cu`` file compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).  The
library lands in ``build/kernels/`` at the repository root under a name
that carries a digest of its source and flags, so an edited source is
rebuilt and a built one is reused.  :func:`build` starts one ``nvcc`` per
source, all at once, and returns each one's output and seconds.  Nothing is
built or loaded at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("embedding_bag.cu", "dot_interaction.cu", "flash_attention.cu",
           "rwkv6_wkv.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when the toolkit is missing."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return path


def target(source: str) -> Path:
    """The shared library ``source`` builds into."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build(sources=SOURCES) -> dict[str, tuple[str, float]]:
    """Compile every source whose library is missing, one ``nvcc`` process
    per source, all started together.  Returns, per source built, the
    compiler's output (``ptxas`` register and shared-memory report) and
    the wall seconds its ``nvcc`` took; raises with that output if any
    build fails."""
    todo = [s for s in sources if not target(s).exists()]
    if not todo:
        return {}
    cc = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def compile_one(src):
        tmp = target(src).with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [cc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return tmp, proc, time.perf_counter() - t0

    with ThreadPoolExecutor(len(todo)) as pool:
        done = dict(zip(todo, pool.map(compile_one, todo)))
    logs, failed = {}, []
    for src, (tmp, proc, secs) in done.items():
        logs[src] = (proc.stdout, secs)
        if proc.returncode:
            failed.append(f"{src}: nvcc exited {proc.returncode}\n"
                          f"{proc.stdout}")
        else:
            os.replace(tmp, target(src))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    lib = _LIBS.get(source)
    if lib is None:
        build((source,))
        lib = ctypes.CDLL(str(target(source)))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _LIBS[source] = lib
    return lib


class Kernel:
    """One C entry point of a hand-written CUDA kernel.  The entry point
    launches on the stream it is given and returns ``cudaGetLastError()``;
    a call raises when that is not 0, and counts one launch otherwise —
    ``launches`` is how a run shows that its path went through the
    kernel.  A call given a ``key`` (the wrapper's shape or variant) also
    counts it in ``by_key``, so a run can tell which shapes it launched."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source, self.symbol, self.argtypes = source, symbol, argtypes
        self.launches = 0
        self.by_key: Counter = Counter()
        self._fn = None

    def reset(self) -> None:
        self.launches = 0
        self.by_key.clear()

    def __call__(self, *args, key=None) -> None:
        if self._fn is None:
            fn = getattr(library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err:
            msg = library(self.source).cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1
        if key is not None:
            self.by_key[key] += 1
