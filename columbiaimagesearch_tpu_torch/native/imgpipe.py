"""Parallel native decode + resize with a per-image PIL path (port of
columbiaimagesearch_tpu/native/imgpipe.py:1-198: ``jpeg_dims`` :58,
``imgpipe_available`` :146, ``decode_resize_batch`` :150).

The coefficient readers (``coeffs_available``, ``read_coeffs_batch``) feed
the device JPEG decode, which is not ported yet (ROADMAP.md, still to
port #10).
"""

import ctypes

import numpy as np

from columbiaimagesearch_tpu_torch.native.build import load_library

_lib = None


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
