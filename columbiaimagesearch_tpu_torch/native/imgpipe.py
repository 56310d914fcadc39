"""Parallel native decode + resize with a per-image PIL path, and the
JPEG coefficient reader of the device decode (port of
columbiaimagesearch_tpu/native/imgpipe.py:1-198: ``jpeg_dims`` :58,
``coeffs_available`` :88, ``read_coeffs_batch`` :93,
``imgpipe_available`` :146, ``decode_resize_batch`` :150).

The pixel path builds ``native/imgpipe.cpp``, which needs libjpeg and
libpng headers; without them every image takes the per-image PIL path.
The coefficient reader is the port's own ``native/csrc/jpegcoef.cpp``: an
entropy decoder that needs no library, bit-equal to the JAX package's
libjpeg reader (``imgpipe_read_coeffs_batch``) with the same contract.
"""

import ctypes

import numpy as np

from columbiaimagesearch_tpu_torch.native.build import build_error, load_library

_lib = None
_coef_lib = None


def _get():
    global _lib
    if _lib is None:
        lib = load_library("imgpipe")
        if lib is not None:
            lib.imgpipe_process_batch_v2.restype = ctypes.c_int
            lib.imgpipe_process_batch_v2.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int, ctypes.c_int,
            ]
        _lib = lib if lib is not None else False
    return _lib or None


def jpeg_dims(buf):
    """(height, width) from a JPEG SOF marker without decoding, or None
    for non-JPEG/corrupt buffers (imgpipe.py:58-86)."""
    b = bytes(buf[:65536]) if not isinstance(buf, (bytes, bytearray)) \
        else bytes(buf)
    if len(b) < 4 or b[0] != 0xFF or b[1] != 0xD8:
        return None
    i = 2
    n = len(b)
    while i + 9 < n:
        if b[i] != 0xFF:
            i += 1
            continue
        marker = b[i + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        if i + 3 >= n:
            return None
        seglen = (b[i + 2] << 8) | b[i + 3]
        # SOF0..SOF15 except DHT(C4)/JPG(C8)/DAC(CC)
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if i + 9 >= n:
                return None
            h = (b[i + 5] << 8) | b[i + 6]
            w = (b[i + 7] << 8) | b[i + 8]
            return (h, w) if h > 0 and w > 0 else None
        i += 2 + seglen
    return None


def _get_coeffs():
    global _coef_lib
    if _coef_lib is None:
        lib = load_library("jpegcoef")
        if lib is not None:
            lib.jpegcoef_read_coeffs_batch.restype = ctypes.c_int
            lib.jpegcoef_read_coeffs_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int16),
                ctypes.POINTER(ctypes.c_int16),
                ctypes.POINTER(ctypes.c_uint16),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int,
            ]
        _coef_lib = lib if lib is not None else False
    return _coef_lib or None


def coeffs_available() -> bool:
    """Whether the coefficient reader built (g++ is all it needs)."""
    return _get_coeffs() is not None


def coeffs_build_error():
    """The reason the coefficient reader did not build, or None."""
    _get_coeffs()
    return build_error("jpegcoef")


def read_coeffs_batch(buffers, msub: int, max_bh: int, max_bw: int,
                      n_threads: int = 0):
    """Entropy-decode a batch of JPEGs to quantized DCT coefficients: the
    host half of the device decode (imgpipe.py:93-143). Only 3-component
    YCbCr 4:2:0 JPEGs whose block grid fits [max_bh, max_bw] are read;
    other statuses go to :func:`decode_resize_batch`.

    :param msub: side of the low-frequency corner kept per block (1..8)
    :param n_threads: reader threads; 0 takes every host core
    :returns: (ycoef [n, max_bh, max_bw, msub*msub] int16,
        ccoef [n, 2, max_bh//2, max_bw//2, msub*msub] int16,
        qtab [n, 2, msub*msub] uint16, dims [n, 6] int32
        (h, w, bh, bw, cbh, cbw), status [n] int32: 0 ok, -1 decode
        failure, -2 empty, -3 unsupported, -4 grid exceeds the bucket)
    :raises RuntimeError: the reader did not build (with the reason)
    """
    n = len(buffers)
    m2 = msub * msub
    ycoef = np.zeros((n, max_bh, max_bw, m2), dtype=np.int16)
    ccoef = np.zeros((n, 2, max_bh // 2, max_bw // 2, m2), dtype=np.int16)
    qtab = np.zeros((n, 2, m2), dtype=np.uint16)
    dims = np.zeros((n, 6), dtype=np.int32)
    status = np.full(n, -3, dtype=np.int32)
    if n == 0:
        return ycoef, ccoef, qtab, dims, status
    lib = _get_coeffs()
    if lib is None:
        raise RuntimeError("the JPEG coefficient reader did not build: "
                           f"{coeffs_build_error()}")
    raw = [bytes(b) for b in buffers]
    arr = (ctypes.c_char_p * n)(*raw)
    lens = np.asarray([len(b) for b in raw], dtype=np.int64)
    lib.jpegcoef_read_coeffs_batch(
        arr, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, msub, max_bh, max_bw,
        ycoef.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ccoef.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        qtab.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads)
    return ycoef, ccoef, qtab, dims, status


def imgpipe_available() -> bool:
    return _get() is not None


def decode_resize_batch(buffers, target: int = 256, n_threads: int = 0,
                        dct_scale: bool = True):
    """Decode + Lanczos-resize a batch of encoded images.

    :param buffers: list of bytes (JPEG/PNG encoded)
    :param target: output side length
    :param dct_scale: decode JPEGs DCT-scaled to a short side >= target
        before the Lanczos pass (native path only); False keeps the
        full-resolution decode, bit-identical to the reference preprocess
    :returns: ([n, target, target, 3] uint8 RGB, status int32 [n] — 0 ok)
    """
    n = len(buffers)
    out = np.zeros((n, target, target, 3), dtype=np.uint8)
    status = np.zeros(n, dtype=np.int32)
    if n == 0:
        return out, status

    lib = _get()
    if lib is not None:
        raw = [bytes(b) for b in buffers]
        arr = (ctypes.c_char_p * n)(*raw)
        lens = np.asarray([len(b) for b in raw], dtype=np.int64)
        lib.imgpipe_process_batch_v2(
            arr, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, target,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n_threads, target if dct_scale else 0)
        return out, status

    # PIL path (per image, single-threaded)
    import io

    from PIL import Image

    from columbiaimagesearch_tpu_torch.models.preprocess import resize_host

    for i, b in enumerate(buffers):
        try:
            img = np.asarray(Image.open(io.BytesIO(bytes(b))).convert("RGB"))
            out[i] = resize_host(img) if target == 256 else np.asarray(
                Image.fromarray(img).resize((target, target), Image.LANCZOS))
        except Exception:  # noqa: BLE001 — any undecodable input
            status[i] = -1
    return out, status
