"""Integer shape helpers (copy of columbiaimagesearch_tpu/utils/chunking.py:7-23,
plus the searchers' store capacity plan).

``pad_rows`` is not copied: it bounded jit recompiles, and PyTorch runs
eagerly. ``wave_bucket`` stays because ``prewarm_serving`` and
``prewarm_ladder`` report and drive the serving wave sizes by bucket.
"""


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


#: the single-device searcher's append pad (LOPQSearcherTorch.CHUNK_QUANTUM)
STORE_CHUNK = 8192


def store_capacity(n: int, pad: int, hint: int = 0) -> int:
    """Rows a searcher's device store holds for ``n`` occupied rows: at
    least ``n + pad`` and ``hint``, rounded up to 1 Mi rows from 1 Mi rows
    on, else to 16 Ki. The brute plan scans all of them."""
    quantum = (1 << 20) if n >= (1 << 20) else 16384
    return round_up(max(n + pad, hint), quantum)


def wave_bucket(n: int) -> int:
    """Quantized serving-wave batch size: next power of two up to 128, then
    multiples of 128 (chunking.py:15-23)."""
    if n <= 128:
        return 1 << max(0, int(n - 1).bit_length())
    return round_up(n, 128)
