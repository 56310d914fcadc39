"""Probed LOPQ query in PyTorch, batched over queries (port of
columbiaimagesearch_tpu/index/tpu_query.py:146-618, 621-665, 693-779,
971-1071).

The JAX ``lopq_query`` is a single-query program that the searcher vmaps;
the port's functions take a wave ``X [NQ, D]`` and return per-query rows.
Per query:

1. coarse distances per half, top-B (plus the ranks the ``grid_ok``
   certificate prices);
2. the probed cell region in multisequence visit order: the B x B square
   (sorted when B*B <= 16384), or the square plus SB-deep edge strips;
   a wider square without strips takes the sort-free threshold path
   (:func:`_wide_square_slots`);
3. the quota prefix over the CSR buckets, resolved to Q candidate slots;
4. ADC tables for the 2B probed clusters (the LUT kernel, index/lut.py),
   and per-candidate ADC as a gather-and-sum over them — on square rungs
   with Q <= 16384; strip rungs and larger Q compute candidate distances
   from rotated residuals directly, without tables (index/cand_adc.py, one
   kernel on the card);
5. masked top-K.

Ties: ``lax.top_k`` keeps the lower index first; every selection here is a
stable ascending sort, which orders ties the same way. The grid's visit
order decides ``n_cells``, ``total`` and ``grid_ok``.

The serving fast path takes raw features: :func:`fused_feat_query` and
:func:`fused_feat_brute` L2-normalize, PCA-project (and renormalize) a
wave on the device, every norm guarded by ``max(norm, 1e-30)`` so the
zero rows of a padded wave stay finite, then run the functions above.

Wide-V mode (tpu_query.py:257-270, 332-336, 392-396, 511-513): with
``cell_start=None`` there is no dense ``[V^2 + 1]`` offsets table, and a
probed cell's bucket is the ``torch.searchsorted`` range of its id in the
cell-sorted ``cells_sorted`` (left for its start, right for its end). The
sentinel ``V*V`` of the capacity-padded tail sorts after every real cell
and never matches one. Only the source of the bucket bounds differs, so
both modes return the same rows and distances.
"""

import numpy as np
import torch

from columbiaimagesearch_tpu_torch.index.cand_adc import cand_dists
from columbiaimagesearch_tpu_torch.index.lut import build_luts

#: square rungs up to this many cells sort their grid (tpu_query.py:244)
SORT_GRID_MAX_CELLS = 16384
#: candidate budgets up to this size use LUTs (tpu_query.py:540)
LUT_MAX_Q = 16384
#: queries a brute chunk scores against the whole store at once, at the
#: least (tpu_query.py:695): a wave over a large store runs in chunks of
#: this many queries
BRUTE_QCH = 16
#: bytes a brute chunk's transients may take, counted as its [QCH, cap]
#: float32 preselect scores plus its [QCH, K_pre, D] float32 survivors
#: (the pass's peak is ~2.5x that count). Within this bound a wave runs
#: as one chunk (:func:`brute_chunk`): a chunk is 64 launches, ~0.8 ms of
#: host time, more than the card spends on it below ~1M rows, where JAX
#: runs every chunk in one program (tpu_query.py:758). 512 MiB is the
#: largest power of two that keeps the headline's 10,485,760 rows
#: (capacity 11,534,336, 46 MB of scores a query) at BRUTE_QCH queries a
#: chunk, its memory unchanged; at 1,048,576 rows it gives 100 queries two
#: chunks of 57 (PERF.md, "Plan costs").
BRUTE_CHUNK_BYTES = 512 << 20


def uses_lut(B, SB, V, Q):
    """True when a rung builds ADC tables (the LUT kernel): a sorted square
    grid without strips and a candidate budget of at most LUT_MAX_Q.
    Otherwise candidate distances come from rotated residuals."""
    strips = min(SB, B) > 0 and B < V
    return not strips and B * B <= SORT_GRID_MAX_CELLS and Q <= LUT_MAX_Q


def brute_chunk(nq, cap, K_pre, D):
    """Queries a brute chunk scores at once over a store of ``cap`` rows
    of width ``D`` with ``K_pre`` survivors a query: as many as the wave
    holds while the chunk's transients stay within BRUTE_CHUNK_BYTES, and
    never fewer than BRUTE_QCH (or the wave)."""
    per_query = 4 * (cap + min(K_pre, cap) * D)
    return min(max(nq, 1), max(BRUTE_QCH, BRUTE_CHUNK_BYTES // per_query))


def _ascending(d, n):
    """The n smallest entries per row, ascending, lower index first on
    ties (``lax.top_k`` order)."""
    vals, idx = torch.sort(d, dim=1, stable=True)
    return vals[:, :n], idx[:, :n]


def _coarse_dists(x_s, C_s):
    """[NQ, V] squared distances ||x_s - C_s[v]||^2, difference form like
    tpu_query.py:204-206 (no expansion: the top-B order must match)."""
    diff = x_s[:, None, :] - C_s[None, :, :]
    return (diff * diff).sum(dim=-1)


def _strip_region(B, SB, SL, device):
    """Rank coordinates (rg, cg) of the square-plus-strips region cells,
    in the layout of tpu_query.py:319-329."""
    s1 = SB * SL
    s2 = s1 + (B - SB) * B
    G = s2 + (SL - B) * SB
    g = torch.arange(G, device=device)
    rg = torch.where(g < s1, g // SL,
                     torch.where(g < s2, SB + (g - s1) // B,
                                 B + (g - s2) // SB))
    cg = torch.where(g < s1, g % SL,
                     torch.where(g < s2, (g - s1) % B, (g - s2) % SB))
    return rg, cg


def _bucket_bounds(cell_start, cells_sorted, cells):
    """(start, count) int64 of each cell id in ``cells``: from the dense
    offsets table, or in wide-V mode (``cell_start`` None) from the
    searchsorted range over ``cells_sorted``."""
    if cell_start is not None:
        start = cell_start[cells].long()
        return start, cell_start[cells + 1].long() - start
    c = cells.to(cells_sorted.dtype)
    start = torch.searchsorted(cells_sorted, c, right=False)
    return start, torch.searchsorted(cells_sorted, c, right=True) - start


def _bucket_start(cell_start, cells_sorted, cells):
    if cell_start is not None:
        return cell_start[cells].long()
    return torch.searchsorted(cells_sorted, cells.to(cells_sorted.dtype),
                              right=False)


def _wide_square_slots(td0, td1, isel0, isel1, cell_start, quota, V, Q,
                       cells_sorted=None):
    """Candidate slots of a B x B square too wide to sort per query, the
    sort-free quota prefix of tpu_query.py:372-518.

    theta is the smallest grid distance whose <=-weighted candidate count
    reaches ``min(quota, total in the square)``: the distance of the
    reference walk's quota-crossing cell, ties at theta included whole.
    The JAX code finds it by a 31-step bisection on the f32 bit patterns;
    here one sort of each query's grid values, with the cell counts
    carried along, gives the same value (the first sorted position whose
    cumulative count reaches the quota). Every grid row ``td0[a] + td1[:]``
    is ascending, so per-row counts below and at theta are batched
    ``searchsorted`` calls, and so is the slot -> (row, cell) map.

    Slot layout as in the JAX path: interior cells (grid < theta) row-major
    first, then the boundary cells (grid == theta) row-major, so the Q clip
    can only drop boundary candidates and distance ties break the same way.

    Region-sized tensors are dropped as soon as they are used, so the peak
    stays within the searcher's wave memory model (``_bytes_per_query``).

    :returns: (rows [NQ, Q] sorted-row ids, slot0/slot1 [NQ, Q] probed
        ranks, total [NQ], n_cells [NQ], d_stop [NQ] = theta)
    """
    NQ, B = td0.shape
    dev = td0.device
    grid = td0[:, :, None] + td1[:, None, :]             # [NQ, B, B], rows up
    cells = isel0[:, :, None] * V + isel1[:, None, :]
    cnt = _bucket_bounds(cell_start, cells_sorted, cells)[1]
    del cells
    # Candidates up to and including each cell of a row, plus the rows
    # before it: one globally ascending table (int64), [NQ, B * B].
    rowsum = cnt.sum(dim=2)                              # [NQ, B]
    rowbase = rowsum.cumsum(dim=1) - rowsum              # exclusive
    Pg = (cnt.cumsum(dim=2) + rowbase[:, :, None]).reshape(NQ, B * B)
    quota_eff = torch.clamp(rowsum.sum(dim=1), max=int(quota))
    gs, perm = torch.sort(grid.reshape(NQ, B * B), dim=1)
    csum = cnt.reshape(NQ, B * B).gather(1, perm).cumsum(dim=1)
    del cnt, perm
    first = (csum < quota_eff[:, None]).sum(dim=1, keepdim=True)
    d_stop = gs.gather(1, first.clamp(max=B * B - 1))    # [NQ, 1]
    del gs, csum
    theta = d_stop[:, :, None].expand(NQ, B, 1).contiguous()
    kr = torch.searchsorted(grid, theta, right=True)[..., 0]    # <= theta
    kl = torch.searchsorted(grid, theta, right=False)[..., 0]   # <  theta
    del grid, theta
    rowa = torch.arange(B, device=dev) * B

    def prefix(k):
        """Candidates in the first ``k`` cells of each row ([NQ, B])."""
        at = Pg.gather(1, rowa + (k - 1).clamp(min=0))
        return torch.where(k > 0, at - rowbase, 0)

    c_all, c_int = prefix(kr), prefix(kl)
    c_bnd = c_all - c_int
    total = c_all.sum(dim=1)
    n_cells = kr.sum(dim=1)
    int_begin = c_int.cumsum(dim=1) - c_int
    bnd_begin = (c_int.sum(dim=1, keepdim=True) + c_bnd.cumsum(dim=1)
                 - c_bnd)
    begins = torch.cat([int_begin, bnd_begin], dim=1)    # [NQ, 2B] ascending
    j = torch.arange(Q, device=dev).expand(NQ, Q).contiguous()
    # Virtual row (interior rows, then boundary rows): the last begin <= j;
    # zero-count rows share their successor's begin and are skipped.
    v_j = (torch.searchsorted(begins, j, right=True) - 1).clamp(min=0)
    is_bnd = v_j >= B
    a_j = torch.where(is_bnd, v_j - B, v_j).clamp(max=B - 1)
    # Offset within row a_j's candidates: interior slots count from the
    # row's first cell, boundary slots after its interior candidates.
    base_off = (torch.where(is_bnd, c_int.gather(1, a_j), 0)
                + (j - begins.gather(1, v_j)))
    # Containing cell: the first b with P[a_j, b] > base_off, searched in
    # the global table (rows before a_j never exceed rowbase[a_j]).
    flat = torch.searchsorted(Pg, rowbase.gather(1, a_j) + base_off,
                              right=True)
    b_j = (flat - a_j * B).clamp(min=0, max=B - 1)
    before = torch.where(
        b_j > 0, Pg.gather(1, a_j * B + (b_j - 1).clamp(min=0))
        - rowbase.gather(1, a_j), 0)
    cid = isel0.gather(1, a_j) * V + isel1.gather(1, b_j)
    rows = _bucket_start(cell_start, cells_sorted, cid) + (base_off - before)
    return rows, a_j, b_j, total, n_cells, d_stop[:, 0]


def lopq_query(X, Cs, Rs, mus, subs, codes, cell_start, quota, *, V, B, Q,
               K, SB=0, cells_sorted=None):
    """Probed ADC top-K for a wave of queries.

    :param X: [NQ, D] float32 queries
    :param Cs/Rs/mus/subs: model tables (see index/model.py)
    :param codes: [N, M] uint8 PQ codes, rows sorted by cell id
    :param cell_start: [V^2 + 1] int32 CSR offsets, or None in wide-V mode
    :param quota: stop probing cells once this many candidates are covered
    :param cells_sorted: [N] int32 cell id of each sorted row (sentinel
        ``V*V`` on capacity pads); read only in wide-V mode
    :param B: probed clusters per split; Q: candidate budget; K: results
    :param SB: edge-strip depth (0 = square-only grid)
    :returns: (rows [NQ, K] int64 sorted-row indices, -1 when invalid;
        dists [NQ, K] float32, +inf when invalid; total [NQ];
        n_cells [NQ]; grid_ok [NQ] bool)
    """
    if cell_start is None and cells_sorted is None:
        raise ValueError("wide-V mode (cell_start=None) needs cells_sorted")
    NQ = X.shape[0]
    F, S, Dsub = subs.shape[1], subs.shape[2], subs.shape[3]
    Dh = Cs.shape[2]
    dev = X.device
    x2 = X.to(torch.float32).reshape(NQ, 2, Dh)
    lut = uses_lut(B, SB, V, Q)
    if B >= V:
        SB = 0  # full square grid: strips are redundant
    SB = min(SB, B)
    strips = SB > 0
    G = B * B
    sort_grid = G <= SORT_GRID_MAX_CELLS and not strips

    # --- 1. coarse distances, top-B per split ------------------------------
    d0 = _coarse_dists(x2[:, 0], Cs[0])
    d1 = _coarse_dists(x2[:, 1], Cs[1])
    if strips:
        SL = min(8 * B, V)
        Bf = min(SL + 1, V)
        td0f, i0f = _ascending(d0, Bf)
        td1f, i1f = _ascending(d1, Bf)
        # Cheapest cell outside the square-plus-strips region.
        out_grid_min = torch.minimum(td0f[:, B] + td1f[:, SB],
                                     td0f[:, SB] + td1f[:, B])
        if SL < V:
            out_grid_min = torch.minimum(
                out_grid_min, torch.minimum(td0f[:, 0] + td1f[:, SL],
                                            td0f[:, SL] + td1f[:, 0]))
        isel0, isel1 = i0f, i1f
    else:
        Bx = min(B + 1, V)
        t0x, i0x = _ascending(d0, Bx)
        t1x, i1x = _ascending(d1, Bx)
        td0, td1 = t0x[:, :B], t1x[:, :B]
        if Bx > B:
            out_grid_min = torch.minimum(t0x[:, B] + td1[:, 0],
                                         td0[:, 0] + t1x[:, B])
        else:
            out_grid_min = torch.full((NQ,), float("inf"), device=dev)
        isel0, isel1 = i0x[:, :B], i1x[:, :B]

    # --- 2+3. probed cell region -> fixed Q candidate slots ----------------
    j = torch.arange(Q, device=dev)[None, :]
    if sort_grid or strips:
        if sort_grid:
            grid = (td0[:, :, None] + td1[:, None, :]).reshape(NQ, G)
            gsorted, perm = torch.sort(grid, dim=1, stable=True)
            a_idx, b_idx = perm // B, perm % B      # slots into isel0/isel1
            cells = isel0.gather(1, a_idx) * V + isel1.gather(1, b_idx)
            starts, counts = _bucket_bounds(cell_start, cells_sorted, cells)
        else:
            rg, cg = _strip_region(B, SB, SL, dev)
            G = rg.shape[0]
            gridf = td0f[:, rg] + td1f[:, cg]                 # [NQ, G]
            cidf = i0f[:, rg] * V + i1f[:, cg]
            startsf, cntf = _bucket_bounds(cell_start, cells_sorted, cidf)
            # Stable sort of the key plus payload gathers == the stable
            # multi-payload lax.sort of tpu_query.py:356.
            gsorted, perm = torch.sort(gridf, dim=1, stable=True)
            counts = cntf.gather(1, perm)
            starts = startsf.gather(1, perm)
            a_idx, b_idx = rg[perm], cg[perm]       # ranks into i0f/i1f
        csum = counts.cumsum(dim=1)
        # Visit cells in order until the quota is covered; the crossing
        # cell is included whole (reference get_result_quota semantics).
        selected = (csum - counts) < quota
        sel_counts = torch.where(selected, counts, 0)
        scs = sel_counts.cumsum(dim=1)
        total = scs[:, -1]
        n_cells = selected.sum(dim=1)
        d_stop = gsorted.gather(1, (n_cells - 1).clamp(min=0)[:, None])[:, 0]
        # Slot j belongs to the cell whose cumulative range covers j:
        # #{cells i with scs[i] <= j}, as an integer scatter-add of
        # cell-end markers plus a cumsum (deterministic on integers).
        markers = torch.zeros((NQ, Q + 1), dtype=torch.int64, device=dev)
        markers.scatter_add_(1, scs.clamp(max=Q), torch.ones_like(scs))
        b_for_j = markers.cumsum(dim=1)[:, :Q].clamp(max=G - 1)
        bucket_begin = scs.gather(1, b_for_j) - sel_counts.gather(1, b_for_j)
        rows = starts.gather(1, b_for_j) + (j - bucket_begin)
        slot0 = a_idx.gather(1, b_for_j)
        slot1 = b_idx.gather(1, b_for_j)
    else:
        rows, slot0, slot1, total, n_cells, d_stop = _wide_square_slots(
            td0, td1, isel0, isel1, cell_start, quota, V, Q, cells_sorted)
    grid_ok = d_stop <= out_grid_min
    n_valid = total.clamp(max=Q)
    valid = j < n_valid[:, None]
    rows = torch.where(valid, rows, 0)

    # --- 4+5. per-candidate ADC distances ----------------------------------
    if lut:
        cand = codes[rows].long()                             # [NQ, Q, M]
        isel = torch.stack([isel0, isel1], dim=1).to(torch.int32)
        luts = build_luts(x2.contiguous(), isel.contiguous(), Cs, Rs, mus,
                          subs)
        flat = luts.reshape(NQ, -1)                 # [NQ, 2*B*F*S]
        f_off = torch.arange(F, device=dev) * S
        idx0 = slot0[:, :, None] * (F * S) + f_off + cand[:, :, :F]
        idx1 = (B + slot1)[:, :, None] * (F * S) + f_off + cand[:, :, F:]
        dists = (flat.gather(1, idx0.reshape(NQ, -1)).reshape(NQ, Q, F)
                 .sum(dim=-1)
                 + flat.gather(1, idx1.reshape(NQ, -1)).reshape(NQ, Q, F)
                 .sum(dim=-1))
        dists = torch.where(valid, dists, float("inf"))
    else:
        dists = cand_dists(x2, Cs, Rs, mus, subs, codes, rows, isel0, isel1,
                           slot0, slot1, n_valid)
    top, ti = _ascending(dists, K)
    top_rows = torch.where(torch.isfinite(top), rows.gather(1, ti), -1)
    return top_rows, top, total, n_cells, grid_ok


def _to_insertion_rows(rows, order):
    return torch.where(rows >= 0, order[rows.clamp(min=0)].long(), -1)


def lopq_query_orig(X, Cs, Rs, mus, subs, codes, cell_start, order, quota,
                    *, V, B, Q, K, SB=0, cells_sorted=None):
    """:func:`lopq_query` with rows mapped back to insertion order through
    the CSR ``order`` permutation."""
    rows, dists, total, n_cells, grid_ok = lopq_query(
        X, Cs, Rs, mus, subs, codes, cell_start, quota, V=V, B=B, Q=Q, K=K,
        SB=SB, cells_sorted=cells_sorted)
    return _to_insertion_rows(rows, order), dists, total, n_cells, grid_ok


def lopq_query_rerank(X, feats, Cs, Rs, mus, subs, codes, cell_start, order,
                      quota, *, V, B, Q, K, R, K_out=0, SB=0,
                      cells_sorted=None):
    """Probed ADC query plus exact rerank over the resident feature store:
    the top ``R`` ADC candidates are re-scored by true L2 distance (not
    squared, like the reference's ``np.linalg.norm``) and re-sorted
    (reference: searcher_lopqhbase.py:862-912).

    :param feats: [cap, D] insertion-order feature rows
    :param K_out: rows emitted after the re-sort (0 = all R)
    :returns: (rows [NQ, K_out or R] insertion-order, exact dists, total,
        n_cells, grid_ok)
    """
    rows, _, total, n_cells, grid_ok = lopq_query_orig(
        X, Cs, Rs, mus, subs, codes, cell_start, order, quota, V=V, B=B, Q=Q,
        K=K, SB=SB, cells_sorted=cells_sorted)
    rR = rows[:, :R]
    cand = feats[rR.clamp(min=0)].to(torch.float32)           # [NQ, R, D]
    diff = cand - X.to(torch.float32)[:, None, :]
    exact = torch.sqrt((diff * diff).sum(dim=-1))
    exact = torch.where(rR >= 0, exact, float("inf"))
    top, idx = _ascending(exact, min(K_out, R) if K_out else R)
    top_rows = torch.where(torch.isfinite(top), rR.gather(1, idx), -1)
    return top_rows, top, total, n_cells, grid_ok


def brute_query_batch(X, feats, feats_sq, nb, n_occ, *, K_pre, K_out,
                      QCH=None):
    """Exact top-``K_out`` by true L2 over the resident feature store.

    Two stages, like tpu_query.py:693-759: a preselect of ``K_pre`` rows
    per query by ``||f||^2 - 2 f.x`` (one matmul), then an exact re-score
    of the survivors. On a float32 store the preselect runs in fp32 with
    TF32 off (the JAX package used the TPU's default bf16 passes there);
    on a bfloat16 store it runs in bfloat16, as JAX's does.

    :param X: [NQ, D] queries
    :param feats: [cap, D] insertion-order feature store (float32 or
        bfloat16)
    :param feats_sq: [cap] float32 row norms squared
    :param nb: occupied rows (rows >= nb are capacity pads)
    :param n_occ: occupied cells, reported as ``visited``
    :param QCH: queries a chunk (None: :func:`brute_chunk`'s width); a
        query's result does not depend on it
    :returns: packed [NQ, 2*K_out + 3] int32 (see pack_query_out); rows
        are insertion-order, dists true L2 norms
    """
    NQ = X.shape[0]
    cap = feats.shape[0]
    K_pre = min(K_pre, cap)
    K_out = min(K_out, K_pre)
    QCH = min(QCH or brute_chunk(NQ, cap, K_pre, feats.shape[1]),
              max(NQ, 1))
    out = []
    for lo in range(0, NQ, QCH):
        Xc = X[lo:lo + QCH].to(torch.float32)
        # The preselect reads the store in its own dtype (the queries are
        # cast, not the store: tpu_query.py:725-729); the survivors are
        # re-scored in float32.
        pre = feats_sq[None, :] - 2.0 * (Xc.to(feats.dtype) @ feats.T).to(
            torch.float32)
        pre[:, nb:] = float("inf")
        vals, rows_pre = torch.topk(pre, K_pre, dim=1, largest=False,
                                    sorted=True)
        finite = torch.isfinite(vals)
        rows_pre = torch.where(finite, rows_pre, 0)
        cand = feats[rows_pre].to(torch.float32)          # [QCH, K_pre, D]
        diff = cand - Xc[:, None, :]
        exact = torch.sqrt((diff * diff).sum(dim=-1))
        exact = torch.where(finite, exact, float("inf"))
        top, ti = _ascending(exact, K_out)
        top_rows = torch.where(torch.isfinite(top), rows_pre.gather(1, ti),
                               -1)
        n = Xc.shape[0]
        out.append(pack_query_out(
            top_rows, top, torch.full((n,), int(nb), device=X.device),
            torch.full((n,), int(n_occ), device=X.device),
            torch.ones(n, dtype=torch.bool, device=X.device)))
    return torch.cat(out)


def _unit_rows(X):
    return X / torch.linalg.vector_norm(X, dim=1, keepdim=True).clamp(
        min=1e-30)


def normalize_project(X, pca_P=None, pca_mu=None, renorm=False):
    """Raw features -> index-space queries: L2-normalize each row, then
    with a PCA model project (one fp32 matmul, TF32 off) and optionally
    renormalize; every norm is guarded by 1e-30 (tpu_query.py:770-777,
    :1033-1040). ``LOPQModelPCA.apply_PCA`` is the unguarded form."""
    Xn = _unit_rows(X.to(torch.float32))
    if pca_P is None:
        return Xn
    Xp = torch.matmul(Xn - pca_mu[None, :], pca_P)
    return _unit_rows(Xp) if renorm else Xp


def fused_feat_query(X, pca_P, pca_mu, Cs, Rs, mus, subs, codes, cell_start,
                     order, quota, feats=None, *, V, B, Q, K, R=0, K_out=0,
                     renorm=False, SB=0, cells_sorted=None):
    """Raw features -> packed results of one rung (tpu_query.py:1005-1055):
    :func:`normalize_project`, then :func:`lopq_query_rerank` (``R > 0``,
    over ``feats``) or :func:`lopq_query_orig`, then
    :func:`pack_query_out`. ``pca_P`` None is a plain LOPQ model.

    :returns: [NQ, 2*K+3] int32, or [NQ, 2*(K_out or R)+3] when R > 0
    """
    Xn = normalize_project(X, pca_P, pca_mu, renorm)
    tables = (Cs, Rs, mus, subs, codes, cell_start, order)
    if R > 0:
        out = lopq_query_rerank(Xn, feats, *tables, quota, V=V, B=B, Q=Q,
                                K=K, R=R, K_out=K_out, SB=SB,
                                cells_sorted=cells_sorted)
    else:
        out = lopq_query_orig(Xn, *tables, quota, V=V, B=B, Q=Q, K=K, SB=SB,
                              cells_sorted=cells_sorted)
    return pack_query_out(*out)


def fused_feat_brute(X, pca_P, pca_mu, feats, feats_sq, nb, n_occ, *,
                     K_pre, K_out, QCH=None, renorm=False):
    """Raw features -> exact brute search (tpu_query.py:762-779):
    :func:`normalize_project`, then :func:`brute_query_batch`."""
    return brute_query_batch(normalize_project(X, pca_P, pca_mu, renorm),
                             feats, feats_sq, nb, n_occ, K_pre=K_pre,
                             K_out=K_out, QCH=QCH)


def pack_query_out(rows, dists, total, n_cells, grid_ok):
    """Pack a wave's outputs into one int32 tensor ([NQ, K] rows, [NQ, K]
    bitcast dists, then candidates-found, visited-cells and grid-ok), so
    the host reads one device-to-host copy per tier."""
    return torch.cat([
        rows.to(torch.int32),
        dists.to(torch.float32).contiguous().view(torch.int32),
        total.to(torch.int32)[:, None],
        n_cells.to(torch.int32)[:, None],
        grid_ok.to(torch.int32)[:, None]], dim=1)


def unpack_query_out(packed, K_pad):
    """Host-side inverse of :func:`pack_query_out` (numpy).

    :returns: (rows [.., K], dists [.., K] f32, total [..],
        n_cells [..], grid_ok [..])
    """
    rows = packed[..., :K_pad]
    dists = np.ascontiguousarray(
        packed[..., K_pad:2 * K_pad]).view(np.float32)
    return (rows, dists, packed[..., 2 * K_pad],
            packed[..., 2 * K_pad + 1], packed[..., 2 * K_pad + 2])
