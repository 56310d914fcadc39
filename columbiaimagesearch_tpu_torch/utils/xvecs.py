"""TexMex .fvecs/.ivecs/.bvecs dataset I/O (http://corpus-texmex.irisa.fr/);
copy of columbiaimagesearch_tpu/utils/xvecs.py:1-44 (numpy only), with
``save_xvecs`` writing all rows at once.

Same binary format as the reference's helpers
(reference: lopq/lopq/utils.py:64-131 ``load_xvecs``/``save_xvecs``) but
vectorized with numpy instead of per-value struct unpacking, so SIFT1M loads
in milliseconds.
"""

import numpy as np

_TYPES = {
    "f": (np.float32, 4),
    "i": (np.uint32, 4),
    "b": (np.uint8, 1),
}


def load_xvecs(filename, base_type="f", max_num=None):
    """Load an .xvecs file -> [N, D] array."""
    dtype, size = _TYPES[base_type]
    raw = np.fromfile(filename, dtype=np.uint8)
    if raw.size == 0:
        return np.zeros((0, 0), dtype=dtype)
    D = int(np.frombuffer(raw[:4].tobytes(), dtype=np.uint32)[0])
    record = 4 + D * size
    N = raw.size // record
    if max_num is not None:
        N = min(N, max_num)
    body = raw[: N * record].reshape(N, record)[:, 4:]
    out = np.frombuffer(body.tobytes(), dtype=dtype).reshape(N, D)
    return np.squeeze(np.array(out))


def save_xvecs(data, filename, base_type="f"):
    """Save rows of ``data`` in .xvecs format: each row a uint32 ``D``
    and its ``D`` values, the bytes of utils/xvecs.py:35-44 written in one
    call (the copy's per-row writes take seconds at 500,000 rows)."""
    dtype, size = _TYPES[base_type]
    data = np.atleast_2d(np.asarray(data))
    N, D = data.shape
    out = np.empty((N, 4 + D * size), dtype=np.uint8)
    out[:, :4] = np.frombuffer(np.uint32(D).tobytes(), dtype=np.uint8)
    out[:, 4:] = np.ascontiguousarray(data.astype(dtype)).view(
        np.uint8).reshape(N, D * size)
    out.tofile(filename)
