"""Build-on-first-use loader for the native host libraries (port of
columbiaimagesearch_tpu/native/build.py:1-41).

``native/<name>.cpp`` at the root of the checkout, or the port's own
``native/csrc/<name>.cpp`` (the JPEG coefficient reader), is compiled with
g++ into ``build/native/lib<name>-<key>.so``, keyed by a hash of the source
and the flags, and loaded with ctypes. The JAX loader builds next to the
sources; the port never writes into ``native/``. As in the JAX package, a
missing toolchain or library returns None (:func:`build_error` then says
why): the image decoder then takes its per-image PIL path, ``CodeStore``
raises, and so does the device JPEG decode. These are host libraries, not
device kernels.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_ROOT, "native")
PORT_SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "csrc")
#: libraries whose source is in the port's tree
_PORT_SOURCES = ("jpegcoef",)
BUILD_DIR = os.path.join(_ROOT, "build", "native")
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"]
_LINK = {"imgpipe": ["-ljpeg", "-lpng", "-lpthread"],
         "jpegcoef": ["-lpthread"]}
_LOCK = threading.Lock()
_CACHE = {}
_ERRORS = {}


def load_library(name: str):
    """Compile (if needed) and dlopen ``native/<name>.cpp`` (or the port's
    ``native/csrc/<name>.cpp``).

    :returns: the ctypes CDLL, or None when g++ or a library is missing
    """
    with _LOCK:
        if name in _CACHE:
            return _CACHE[name]
        src_dir = PORT_SRC_DIR if name in _PORT_SOURCES else NATIVE_DIR
        src = os.path.join(src_dir, f"{name}.cpp")
        flags = CXX_FLAGS + _LINK.get(name, [])
        try:
            h = hashlib.sha256()
            with open(src, "rb") as f:
                h.update(f.read())
            h.update("\0".join(flags).encode())
            so = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
            if not os.path.exists(so):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                subprocess.run(["g++"] + CXX_FLAGS + ["-o", tmp, src]
                               + _LINK.get(name, []), check=True,
                               capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
        except subprocess.CalledProcessError as e:
            lib = None
            _ERRORS[name] = (e.stderr or b"").decode(errors="replace") \
                or str(e)
        except OSError as e:
            lib = None
            _ERRORS[name] = str(e)
        _CACHE[name] = lib
        return lib


def build_error(name: str):
    """Why :func:`load_library` returned None for ``name`` (the compiler's
    message or the OS error), or None when it built or was not tried."""
    return _ERRORS.get(name)
