"""Exhaustive exact-ADC search: every indexed code is scored, no cell
probing (port of columbiaimagesearch_tpu/index/pallas_adc.py, whose
``_adc_kernel`` becomes ``csrc/adc_scan.cu``).

Index layout (:func:`build_padded_layout`): codes sorted by cell id, every
cell's run padded to BLK=128 rows, so each 128-row block belongs to one
cell. Per batch of queries, :func:`build_query_luts` builds the ADC tables
of all V clusters of both halves, and :func:`adc_scan_all` scores every
padded row: ``sum_m lut_half(m)[cell half, m, code[r, m], q]``, ``+inf``
on padding. Intended for N / V^2 >= ~128, e.g. face indexes (V=64..256
over millions of faces), or wherever exact recall is worth the padding.

:func:`adc_scan_all` launches the kernel for CUDA tensors and uses
:func:`adc_scan_all_plain` for CPU tensors; on a CUDA tensor it launches or
raises, never falls back. ``adc_scan_all.launches`` counts kernel launches.

The kernel reads the tables in a query-tiled layout ``[V, T, F, Sp, QT]``
and walks work items, runs of at most ``ITEM_BLOCKS`` blocks of one cell
(:func:`scan_items`; ``ExhaustiveADC.build`` computes them once per
layout). :func:`adc_scan_all` keeps the JAX layout ``[V, F, S, NQ]`` at its
interface and tiles the tables itself (:func:`tile_luts`: a view at NQ=8,
a copy otherwise, timed as part of the call); ``ExhaustiveADC`` builds
them tiled (:func:`build_query_luts_tiled`) and calls
:func:`adc_scan_tiled`. On the CPU both take the tiled tables back to the
JAX layout and run :func:`adc_scan_all_plain`, so the CPU tests reach the
tiling.

Differences from the JAX module: no ``interpret`` mode; the layout's block
count is not rounded up to a multiple of the Pallas grid step (so ``NB`` is
the JAX ``NB`` or one less); the last query chunk is not padded (nothing is
compiled per shape).
"""

import ctypes
import threading

import numpy as np
import torch

from columbiaimagesearch_tpu_torch.device import sm_count
from columbiaimagesearch_tpu_torch.index.lut import (
    _check,
    build_luts_all_clusters,
)
from columbiaimagesearch_tpu_torch.index.model import LOPQModelPCA
from columbiaimagesearch_tpu_torch.index.searcher import (
    Result,
    ResultDist,
    _pyid,
)
from columbiaimagesearch_tpu_torch.kernels.build import load_library

BLK = 128    # rows per cell block; also the per-cell padding quantum
ITEM_BLOCKS = 4   # most blocks of one scan work item (one table fill)
#: shared memory a block may opt into on the H100 (sm_90)
MAX_SMEM = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int


def build_padded_layout(cells, fine):
    """Host-side packing: cell-major order with per-cell BLK padding
    (pallas_adc.py:129-166, vectorised; same outputs on the first NB
    blocks).

    :param cells: [N] int cell ids
    :param fine: [N, M] uint8 fine codes
    :returns: (codes_padded [NB*BLK, M] uint8, block_cell [NB] int32,
        block_count [NB] int32, row_of [N] int64 -- padded position of each
        input row)
    """
    cells = np.asarray(cells)
    fine = np.asarray(fine, dtype=np.uint8)
    order = np.argsort(cells, kind="stable")
    uniq, counts = np.unique(cells, return_counts=True)
    nblocks = (counts + BLK - 1) // BLK
    bstart = np.zeros(len(uniq) + 1, dtype=np.int64)
    np.cumsum(nblocks, out=bstart[1:])
    NB = int(bstart[-1])
    cstart = np.zeros(len(uniq) + 1, dtype=np.int64)
    np.cumsum(counts, out=cstart[1:])

    # Sorted row j belongs to cell u = u_of[j] at rank j - cstart[u].
    u_of = np.repeat(np.arange(len(uniq)), counts)
    pos = bstart[u_of] * BLK + (np.arange(len(cells)) - cstart[u_of])
    row_of = np.empty(len(cells), dtype=np.int64)
    row_of[order] = pos
    codes_padded = np.zeros((NB * BLK, fine.shape[1]), dtype=np.uint8)
    codes_padded[pos] = fine[order]

    u_blk = np.repeat(np.arange(len(uniq)), nblocks)
    block_cell = uniq[u_blk].astype(np.int32)
    rank = np.arange(NB) - bstart[u_blk]
    block_count = np.minimum(BLK, counts[u_blk] - rank * BLK).astype(np.int32)
    return codes_padded, block_cell, block_count, row_of


def _all_v_luts(X, Cs, Rs, mus, subs):
    """[NQ, 2, V, F, S] tables of every cluster, from
    :func:`index.lut.build_luts_all_clusters` (the LUT kernel on the card,
    its plain version on the CPU)."""
    NQ, Dh = X.shape[0], Cs.shape[2]
    return build_luts_all_clusters(X.reshape(NQ, 2, Dh).contiguous(), Cs,
                                   Rs, mus, subs)


def build_query_luts(X, Cs, Rs, mus, subs):
    """Per-split ADC tables for ALL V clusters for a batch of NQ queries
    (pallas_adc.py:169-186): ``(lut0, lut1)``, each [V, F, S, NQ] float32.
    """
    t = _all_v_luts(X, Cs, Rs, mus, subs)
    return (t[:, 0].permute(1, 2, 3, 0).contiguous(),
            t[:, 1].permute(1, 2, 3, 0).contiguous())


def build_query_luts_tiled(X, Cs, Rs, mus, subs):
    """The tables of :func:`build_query_luts` in the scan kernel's layout
    (:func:`tile_luts`), one copy a half from the LUT kernel's output:
    ``(lut0t, lut1t)``, each [V, T, F, Sp, QT] float32."""
    t = _all_v_luts(X, Cs, Rs, mus, subs)
    NQ, _, _, F, S = t.shape
    QT, Sp, _ = _scan_tiling(NQ, 2 * F, S)
    return _tile(t[:, 0], QT, Sp), _tile(t[:, 1], QT, Sp)


def adc_scan_all_plain(codes_padded, block_cell, block_count, lut0, lut1, *,
                       V):
    """Plain PyTorch version of :func:`adc_scan_all`: per-row gathers of
    the M table entries, summed in m order, ``+inf`` on padding. The
    kernel's rules for bad input: a valid row of an out-of-range cell, or
    with a code byte >= S, is NaN."""
    F, S = codes_padded.shape[1] // 2, lut0.shape[2]
    cell = block_cell.long().repeat_interleave(BLK)             # [Npad]
    good = (cell >= 0) & (cell < V * V)
    cell = torch.where(good, cell, torch.zeros_like(cell))
    halves = (cell // V, cell % V)
    bad = ~good
    acc = None
    for m in range(2 * F):        # one [Npad, NQ] gather live at a time
        h, f = divmod(m, F)
        code = codes_padded[:, m].long()
        bad |= code >= S
        g = (lut0, lut1)[h][halves[h], f, code.clamp(max=S - 1)]
        acc = g if acc is None else acc.add_(g)
    acc = torch.where(bad[:, None], torch.full_like(acc, np.nan), acc)
    valid = (torch.arange(BLK, device=block_count.device)[None, :]
             < block_count[:, None]).reshape(-1)
    acc = torch.where(valid[:, None], acc, torch.full_like(acc, np.inf))
    return acc.T.contiguous()


def scan_items(block_cell, cap=ITEM_BLOCKS):
    """Work items of the scan kernel: the first block of each run of
    consecutive blocks of one cell, a run longer than ``cap`` blocks split
    every ``cap`` blocks, then ``NB``.

    :param block_cell: [NB] int cell id per block (any device)
    :returns: [n_items + 1] int32, ascending, on the same device
    """
    bc = torch.as_tensor(block_cell)
    NB, dev = bc.shape[0], bc.device
    new = torch.ones(NB, dtype=torch.bool, device=dev)
    new[1:] = bc[1:] != bc[:-1]
    run_start = torch.nonzero(new).flatten()
    lens = torch.diff(run_start, append=torch.tensor([NB], device=dev))
    n_it = (lens + cap - 1) // cap
    first = torch.repeat_interleave(run_start, n_it)
    k = torch.arange(first.shape[0], device=dev) - torch.repeat_interleave(
        torch.cumsum(n_it, 0) - n_it, n_it)
    return torch.cat([first + k * cap, torch.tensor([NB], device=dev)]).to(
        torch.int32)


def _scan_smem(M, Sp, QT):
    """Shared bytes of a scan block: barriers, the resident lut0 half and
    two buffers of (lut1 half, an item's codes)."""
    half = (M // 2) * Sp * QT * 4
    codes = -(-(ITEM_BLOCKS * BLK * M) // 16) * 16
    return 128 + 3 * half + 2 * codes


def _scan_tiling(NQ, M, S):
    """(QT, Sp, shared bytes) of a launch: QT the smallest power of two >=
    min(NQ, 8), halved until a block's shared memory fits ``MAX_SMEM``."""
    Sp = -(-S // 4) * 4
    qt = 1
    while qt < min(NQ, 8):
        qt *= 2
    while _scan_smem(M, Sp, qt) > MAX_SMEM and qt > 1:
        qt //= 2
    return qt, Sp, _scan_smem(M, Sp, qt)


def _tile(t, QT, Sp):
    """[NQ, V, F, S] -> [V, T, F, Sp, QT] (T = ceil(NQ / QT)); the padded
    queries and entries are 0. One copy (two where it pads)."""
    NQ, V, F, S = t.shape
    T = -(-NQ // QT)
    if T * QT != NQ or Sp != S:
        t = torch.nn.functional.pad(t, (0, Sp - S, 0, 0, 0, 0, 0,
                                        T * QT - NQ))
    out = t.new_empty((V, T, F, Sp, QT))
    out.permute(1, 4, 0, 2, 3).copy_(t.reshape(T, QT, V, F, Sp))
    return out


def tile_luts(lut, QT, Sp):
    """[V, F, S, NQ] tables -> the kernel's query-tiled ``[V, T, F, Sp,
    QT]`` (T = ceil(NQ / QT); the padded entries are 0): the half of one
    cluster for one query tile is contiguous. Where the two layouts
    coincide (NQ == QT, Sp == S) this is a view, not a copy."""
    V, F, S, NQ = lut.shape
    if NQ == QT and Sp == S and lut.is_contiguous():
        return lut.view(V, 1, F, S, NQ)
    return _tile(lut.permute(3, 0, 1, 2), QT, Sp)


def _library():
    lib = load_library("adc_scan")
    fn = lib.adc_scan
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I] * 9 + [ctypes.c_longlong, _I, _P]
        fn.restype = _I
    return lib


def adc_scan_all(codes_padded, block_cell, block_count, lut0, lut1, *, V,
                 items=None):
    """Exhaustive ADC distances for NQ queries over every padded row.

    :param codes_padded: [NB*BLK, M] uint8, cell-major, per-cell padded
    :param block_cell: [NB] int32 cell id per block
    :param block_count: [NB] int32 valid rows per block
    :param lut0/lut1: [V, F, S, NQ] float32 per-split tables (F = M/2)
    :param items: :func:`scan_items` of ``block_cell`` (computed here when
        not given; it depends on the layout only)
    :returns: [NQ, NB*BLK] float32 distances (+inf on padding)
    """
    dev = codes_padded.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"adc_scan_all: unsupported device {dev}")
    M = codes_padded.shape[1]
    F, S, NQ = lut0.shape[1], lut0.shape[2], lut0.shape[3]
    if M % 2 or F != M // 2:
        raise ValueError(f"codes have M={M}; the tables need M even and "
                         f"F = M/2, got F={F}")
    if not 1 <= S <= 256:
        raise ValueError(f"S={S}: uint8 codes need 1 <= S <= 256")
    if dev.type == "cuda":
        _check("lut0", lut0, torch.float32, (V, F, S, NQ), dev)
        _check("lut1", lut1, torch.float32, (V, F, S, NQ), dev)
    QT, Sp, _ = _scan_tiling(NQ, M, S)
    return adc_scan_tiled(codes_padded, block_cell, block_count,
                          tile_luts(lut0, QT, Sp), tile_luts(lut1, QT, Sp),
                          V=V, NQ=NQ, S=S, items=items)


def adc_scan_tiled(codes_padded, block_cell, block_count, lut0t, lut1t, *,
                   V, NQ, S, items=None):
    """:func:`adc_scan_all` on tables already in the kernel's layout
    ``[V, T, F, Sp, QT]`` (:func:`tile_luts`, :func:`build_query_luts_tiled`):
    the launch itself, or on the CPU :func:`adc_scan_all_plain` on the
    tables taken back to the JAX layout."""
    dev = codes_padded.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"adc_scan_tiled: unsupported device {dev}")
    NB = block_cell.shape[0]
    M = codes_padded.shape[1]
    _, T, F, Sp, QT = lut0t.shape
    if dev.type == "cpu":
        untiled = [t.permute(0, 2, 3, 1, 4).reshape(V, F, Sp, T * QT)[
            :, :, :S, :NQ] for t in (lut0t, lut1t)]
        return adc_scan_all_plain(codes_padded, block_cell, block_count,
                                  *untiled, V=V)
    if items is None:
        items = scan_items(block_cell)
    if (M % 2 or F != M // 2 or not 1 <= S <= Sp or Sp % 4
            or QT not in (1, 2, 4, 8) or T != -(-NQ // QT)):
        raise ValueError(f"tiled tables {tuple(lut0t.shape)} do not fit "
                         f"M={M}, S={S}, NQ={NQ}")
    smem = _scan_smem(M, Sp, QT)
    if smem > MAX_SMEM:
        raise ValueError(f"QT={QT}: {smem} bytes of shared memory a block")
    _check("codes_padded", codes_padded, torch.uint8, (NB * BLK, M), dev,
           aligned=True)
    _check("block_cell", block_cell, torch.int32, (NB,), dev)
    _check("block_count", block_count, torch.int32, (NB,), dev)
    _check("lut0t", lut0t, torch.float32, (V, T, F, Sp, QT), dev,
           aligned=True)
    _check("lut1t", lut1t, torch.float32, (V, T, F, Sp, QT), dev,
           aligned=True)
    _check("items", items, torch.int32, (items.shape[0],), dev)
    if items.shape[0] < 1:
        raise ValueError("items must end with NB")
    out = torch.empty((NQ, NB * BLK), dtype=torch.float32, device=dev)
    lib = _library()
    # Launched under the inputs' device: the library takes the calling
    # thread's current device.
    with torch.cuda.device(dev):
        sms = sm_count(dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.adc_scan(codes_padded.data_ptr(), block_cell.data_ptr(),
                           block_count.data_ptr(), items.data_ptr(),
                           lut0t.data_ptr(), lut1t.data_ptr(),
                           out.data_ptr(), NB, items.shape[0] - 1, M, V, S,
                           Sp, NQ, QT, ITEM_BLOCKS, smem, sms, stream)
    if err != 0:
        raise RuntimeError(f"adc_scan launch failed: CUDA error {err}")
    adc_scan_all.launches += 1        # the one count of scan launches
    return out


adc_scan_all.launches = 0


def _topk_ascending(d, k):
    """The k smallest entries per row of ``d`` [n, N], ascending, lower
    index first on ties: the order of ``lax.top_k(-d, k)``.

    ``torch.topk`` promises no tie order. Its selection holds every entry
    below the k-th value; where entries equal to the k-th value were left
    out, the row takes the lowest-index ones instead. The selection is
    then ordered by (value, index). Rows whose k-th value is not finite
    keep ``torch.topk``'s choice among those entries (callers drop them).
    """
    vals, idx = torch.topk(d, k, dim=1, largest=False, sorted=True)
    kth = vals[:, -1:]
    short = torch.isfinite(kth[:, 0]) & ((d == kth).sum(1)
                                         > (vals == kth).sum(1))
    for r in torch.nonzero(short).flatten().tolist():
        below = idx[r][vals[r] < kth[r]]
        ties = torch.nonzero(d[r] == kth[r]).flatten()[:k - len(below)]
        idx[r] = torch.cat([below, ties])
    idx = torch.sort(idx, dim=1).values
    vals, o = torch.sort(torch.gather(d, 1, idx), dim=1, stable=True)
    return vals, torch.gather(idx, 1, o)


class ExhaustiveADC:
    """Exact-search facade over the scan kernel (pallas_adc.py:189-279).

    >>> ex = ExhaustiveADC(model)
    >>> ex.build(coarse, fine, ids)
    >>> ids, dists = ex.search(q, k=10)
    """

    def __init__(self, model, nq=8):
        """:param nq: queries per kernel launch"""
        self.model = model
        self.device = model.device
        self.NQ = int(nq)
        self._dev = None
        self._ids = None
        self.n_blocks = 0

    def build(self, coarse, fine, ids=None):
        coarse = np.asarray(coarse)
        cells = (coarse[:, 0].astype(np.int64) * self.model.V
                 + coarse[:, 1].astype(np.int64))
        codes_padded, block_cell, block_count, row_of = \
            build_padded_layout(cells, fine)
        ratio = len(codes_padded) / max(len(cells), 1)
        if ratio > 8 and len(codes_padded) > (1 << 22):
            # Only a real-memory problem at scale; tiny test indexes pad
            # heavily by construction and are fine.
            raise ValueError(
                f"exhaustive layout would pad {len(cells)} rows to "
                f"{len(codes_padded)} ({ratio:.0f}x): cells average far "
                f"fewer than BLK={BLK} rows at V={self.model.V}. Use the "
                "probed searcher, or a smaller coarse codebook (the kernel "
                "is intended for N/V^2 >= ~128, e.g. face indexes)")
        n = len(cells)
        if ids is None:
            # Identity ids stay an int64 arange (no object boxing).
            by_row = np.full(len(codes_padded), -1, dtype=np.int64)
            by_row[row_of] = np.arange(n)
        else:
            ids_arr = np.empty(n, dtype=object)
            ids_arr[:] = list(ids)
            by_row = np.empty(len(codes_padded), dtype=object)
            by_row[row_of] = ids_arr
        self._ids = by_row
        dev, m = self.device, self.model
        self._dev = {
            "codes": torch.from_numpy(codes_padded).to(dev),
            "block_cell": torch.from_numpy(block_cell).to(dev),
            "block_count": torch.from_numpy(block_count).to(dev),
            "Cs": m.Cs, "Rs": m.Rs, "mus": m.mus, "subs": m.subs,
        }
        self._dev["items"] = scan_items(self._dev["block_cell"])
        self.n_blocks = len(block_cell)

    def search(self, x, k=10):
        """Single query convenience -> (ids, dists)."""
        x = torch.as_tensor(x, dtype=torch.float32)
        return self.search_batch(x[None], k=k)[0]

    def search_batch(self, X, k=10):
        """Exact top-k for a batch of queries; one kernel launch per
        ``nq`` queries.

        :returns: list of (ids, dists) per query: ids a list, dists a
            float32 numpy array, finite rows only, ascending, lower padded
            position first on ties
        """
        X = torch.as_tensor(X, dtype=torch.float32).to(self.device)
        if isinstance(self.model, LOPQModelPCA):
            X = self.model.apply_PCA(X)
        d = self._dev
        results = []
        for b in range(0, X.shape[0], self.NQ):
            Xb = X[b:b + self.NQ]
            lut0, lut1 = build_query_luts_tiled(Xb, d["Cs"], d["Rs"],
                                                d["mus"], d["subs"])
            dists = adc_scan_tiled(d["codes"], d["block_cell"],
                                   d["block_count"], lut0, lut1,
                                   V=self.model.V, NQ=Xb.shape[0],
                                   S=d["subs"].shape[2], items=d["items"])
            del lut0, lut1
            kk = min(k, dists.shape[1])
            vals, idx = _topk_ascending(dists, kk)
            del dists
            out_d, idx = vals.cpu().numpy(), idx.cpu().numpy()
            for q in range(len(out_d)):
                keep = np.isfinite(out_d[q])
                sel = self._ids[idx[q][keep]]
                results.append((sel.tolist() if sel.dtype != object
                                else [_pyid(i) for i in sel], out_d[q][keep]))
        return results


class ExhaustiveADCSearcher:
    """LOPQSearcher-compatible facade over :class:`ExhaustiveADC`
    (pallas_adc.py:282-347).

    Backend of SearcherLOPQ(exact=True): accumulates code dicts, rebuilds
    the padded layout lazily (first insertion of each (cell, id) wins),
    returns Result tuples. ``quota`` is ignored: every indexed item is
    scored.
    """

    def __init__(self, model):
        self.model = model
        self.index = ExhaustiveADC(model)
        self._coarse, self._fine, self._ids2 = [], [], []
        self._dirty = False
        self._mutlock = threading.RLock()
        self.nb_indexed = 0

    def add_codes_from_dict(self, codes_dict):
        with self._mutlock:
            for sid, (coarse, fine) in codes_dict.items():
                self._coarse.append(coarse)
                self._fine.append(fine)
                self._ids2.append(sid)
            self._dirty = True

    def get_nb_indexed(self):
        self._maybe_build()
        return self.nb_indexed

    def _maybe_build(self):
        with self._mutlock:
            self._maybe_build_locked()

    def _maybe_build_locked(self):
        if self._dirty and self._ids2:
            seen = set()
            coarse, fine, ids = [], [], []
            for c, f, i in zip(self._coarse, self._fine, self._ids2):
                key = (tuple(int(x) for x in c), i)
                if key in seen:
                    continue
                seen.add(key)
                coarse.append(c)
                fine.append(f)
                ids.append(i)
            self.index.build(np.asarray(coarse, dtype=np.int32),
                             np.asarray(fine, dtype=np.uint8), ids)
            self.nb_indexed = len(ids)
            self._dirty = False

    def search(self, x, quota=10, limit=None, with_dists=False):
        self._maybe_build()
        if self.nb_indexed == 0:
            return [], 0
        k = limit if limit is not None else quota
        ids, dists = self.index.search(x, k=k)
        if with_dists:
            out = [ResultDist(rid, None, float(d))
                   for rid, d in zip(ids, dists)]
        else:
            out = [Result(rid, None) for rid in ids]
        # visited = all cells, by construction
        return out, self.model.V * self.model.V
