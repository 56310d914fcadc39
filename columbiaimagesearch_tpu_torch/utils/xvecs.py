"""TexMex .fvecs/.ivecs/.bvecs dataset I/O (http://corpus-texmex.irisa.fr/);
copy of columbiaimagesearch_tpu/utils/xvecs.py:1-44 (numpy only).

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
    """Save rows of ``data`` in .xvecs format."""
    dtype, _ = _TYPES[base_type]
    data = np.atleast_2d(np.asarray(data))
    N, D = data.shape
    dim_col = np.full((N, 1), D, dtype=np.uint32)
    with open(filename, "wb") as f:
        for i in range(N):
            f.write(dim_col[i].tobytes())
            f.write(data[i].astype(dtype).tobytes())
