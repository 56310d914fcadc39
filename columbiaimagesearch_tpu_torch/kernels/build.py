"""Build-on-first-use loader for the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/`` at the root of the
checkout, keyed by a hash of its source, the flags and ``nvcc --version``,
and loaded with ctypes. The pattern is columbiaimagesearch_tpu/native/
build.py's, with one change: a failed build or load raises instead of
returning None, because a kernel the main path needs has no fallback on
the card. Each kernel has its own lock, so several kernels can be built
at once from several threads (one nvcc each).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()      # guards _LOCKS
_LOCKS = {}                   # name -> lock held while building/loading it
_CACHE = {}
#: name -> (build seconds, compiler output incl. ptxas register/smem
#: report); seconds is 0.0 when a cached library was loaded
BUILD_LOGS = {}


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def _build_key(nvcc: str, src: str) -> str:
    """Cache key of a built library: the source, the flags and the
    compiler's version, so a change to any of them rebuilds."""
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update("\0".join(NVCC_FLAGS).encode())
    h.update(version.encode())
    return h.hexdigest()[:16]


def source_path(name: str) -> str:
    return os.path.join(_CSRC_DIR, f"{name}.cu")


def load_library(name: str) -> ctypes.CDLL:
    """Compile (if needed) and dlopen ``csrc/<name>.cu``.

    :raises RuntimeError: when nvcc is missing or the build fails
    :raises OSError: when the built library cannot be loaded
    """
    with _LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _CACHE:
            return _CACHE[name]
        src = source_path(name)
        nvcc = _nvcc()
        so = os.path.join(BUILD_DIR, f"lib{name}-{_build_key(nvcc, src)}.so")
        seconds, log = 0.0, ""
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [nvcc] + NVCC_FLAGS + ["-o", tmp, src]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src} (exit {proc.returncode}):\n{log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        BUILD_LOGS[name] = (seconds, log)
        _CACHE[name] = lib
        return lib
