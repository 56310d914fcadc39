"""Persistent mmap'd PQ-code store (the LMDB-index role), ctypes-bound
(copy of columbiaimagesearch_tpu/native/codestore.py:1-108).

The library is the repository's ``native/codestore.cpp``, built by the
port's loader (``native/build.py``) into ``build/native/``, keyed by a hash
of the source and flags; it links no libraries. The file format is the C++
source's, so a store that either package writes opens in the other. A
build that fails raises here: there is no fallback without persistence.
One difference: the ids are split from one copy of the id buffer
(``_split_ids``).
"""

import ctypes

import numpy as np

from columbiaimagesearch_tpu_torch.native.build import load_library

ID_LEN = 64


def _split_ids(ids_buf, n):
    """The ``n`` zero-padded ``ID_LEN``-byte ids of a ctypes buffer.
    ``ids_buf.raw`` copies the whole buffer, so it is read once: the JAX
    binding reads it once per id (codestore.py:85-86, 97-98), which is
    quadratic in the row count (hours at 1M rows)."""
    raw = ids_buf.raw
    return [raw[i * ID_LEN:(i + 1) * ID_LEN].split(b"\0")[0].decode()
            for i in range(n)]


class CodeStore:
    """Durable (cell, codes, id) store with cell-sorted bulk export.

    Plays the role of the reference's LOPQSearcherLMDB persistence
    (reference: lopq/lopq/search.py:385-499): incremental appends survive
    restarts, and ``read_all`` hands back the cell-sorted arrays from which
    the device CSR index is built in one pass.
    """

    def __init__(self, path: str, m: int):
        lib = load_library("codestore")
        if lib is None:
            raise RuntimeError(
                "codestore native library unavailable: g++ could not build "
                "native/codestore.cpp into build/native/")
        lib.cs_open.restype = ctypes.c_void_p
        lib.cs_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
        lib.cs_count.restype = ctypes.c_uint64
        lib.cs_count.argtypes = [ctypes.c_void_p]
        lib.cs_append.restype = ctypes.c_uint64
        lib.cs_append.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_char_p]
        lib.cs_sync.argtypes = [ctypes.c_void_p]
        lib.cs_read_all.restype = ctypes.c_uint64
        lib.cs_read_all.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p]
        lib.cs_query_cell.restype = ctypes.c_uint64
        lib.cs_query_cell.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_char_p, ctypes.c_uint64]
        lib.cs_close.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self.m = m
        self.path = path
        self._h = lib.cs_open(path.encode(), m)
        if not self._h:
            raise RuntimeError(f"could not open codestore at {path}")

    def __len__(self):
        return int(self._lib.cs_count(self._h))

    def append(self, cells, codes, ids):
        """Append a batch: cells [n] ints, codes [n, m] uint8, ids strings."""
        cells = np.ascontiguousarray(cells, dtype=np.uint32)
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        n = len(cells)
        id_block = bytearray(n * ID_LEN)
        for i, s in enumerate(ids):
            b = str(s).encode()[:ID_LEN]
            id_block[i * ID_LEN:i * ID_LEN + len(b)] = b
        out = self._lib.cs_append(
            self._h, n,
            cells.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            bytes(id_block))
        if out == 2**64 - 1:
            raise RuntimeError("codestore append failed (remap)")
        return int(out)

    def sync(self):
        self._lib.cs_sync(self._h)

    def read_all(self):
        """-> (cells [n] uint32 sorted, codes [n, m] uint8, ids list[str])."""
        n = len(self)
        cells = np.zeros(n, dtype=np.uint32)
        codes = np.zeros((n, self.m), dtype=np.uint8)
        ids_buf = ctypes.create_string_buffer(max(n, 1) * ID_LEN)
        self._lib.cs_read_all(
            self._h, cells.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ids_buf)
        return cells, codes, _split_ids(ids_buf, n)

    def query_cell(self, cell, max_items=100000):
        codes = np.zeros((max_items, self.m), dtype=np.uint8)
        ids_buf = ctypes.create_string_buffer(max_items * ID_LEN)
        n = int(self._lib.cs_query_cell(
            self._h, int(cell),
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ids_buf, max_items))
        return codes[:n], _split_ids(ids_buf, n)

    def close(self):
        if self._h:
            self._lib.cs_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
