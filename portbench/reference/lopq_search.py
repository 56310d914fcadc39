"""Plain reference of a probed LOPQ search with exact rerank, for the
benchmark's correctness check. Plain PyTorch; it imports nothing of the
program and takes nothing the program made: it is given the model tables,
the corpus rows and the queries that the benchmark made from the seed,
and works out the cells, the fine codes and the candidates itself.

The semantics, for one query ``q`` (a ``lopq_pca`` model projects it
first: ``(q - mu) @ P``), of the multi-index walk of the upstream
``LOPQSearcher.get_result_quota`` (lopq/lopq/search.py:110-135):

1. every corpus row's coarse cell, the nearest centroid of each half;
2. the occupied cells in ascending ``d0[c0] + d1[c1]`` (squared distance of
   each query half to its centroid), rows of a cell in corpus order, taken
   cell by cell until ``quota`` rows are covered, the crossing cell whole,
   then the first ``Q`` of them: the candidate budget,
   ``min(ceil((quota + 1024) / 1024) * 1024, ceil(N / 256) * 256)``;
3. each candidate's fine codes (its residual in its cells' local frames,
   the nearest subquantizer centroid a subvector) and its ADC distance
   ``sum ||R (q_h - C - mu) - sub[code]||^2`` over both halves;
4. the ``rerank_nb`` lowest by ADC (earlier candidate first on a tie),
   re-scored by the true L2 distance ``||q - x||``, the ``limit`` nearest in
   ascending order.

``precision="float64"`` computes all of it in float64. ``"tf32"`` is the
control: float32 whose matrix products round their inputs to TF32 (10
mantissa bits, as the card's TF32 mode does), the step below the float32
with TF32 off that the configuration states.
"""

import torch

#: rows a coarse-assignment product (float64 [CHUNK, V] at most 2 GiB)
CHUNK = 65536
#: candidates a rotation gather
CAND_CHUNK = 4096


def round_tf32(x):
    """float32 ``x`` with its mantissa rounded to TF32's 10 bits (to
    nearest, ties to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + (0xFFF + ((i >> 13) & 1))) & ~0x1FFF
    return i.view(torch.float32)


class Arith:
    """The reference's arithmetic at one precision."""

    def __init__(self, precision):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64

    def cast(self, x):
        return x.to(self.dtype)

    def mm(self, a, b):
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return a @ b

    def bmm(self, a, b):
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return torch.bmm(a, b)


def round_up(n, m):
    return -(-int(n) // m) * m


def candidate_budget(quota, n):
    return min(round_up(int(quota) + 1024, 1024), round_up(n, 256))


def project(queries, pca, ar):
    """Index-space queries: PCA-projected for a ``lopq_pca`` model."""
    q = ar.cast(queries)
    if pca is None:
        return q
    return ar.mm(q - ar.cast(pca["mu"]), ar.cast(pca["P"]))


def coarse_cells(rows, Cs, ar):
    """Every row's cell ``c0 * V + c1`` (int64)."""
    V, Dh = Cs.shape[1], Cs.shape[2]
    C = ar.cast(Cs)
    c2 = (C * C).sum(dim=2)
    cells = torch.empty(rows.shape[0], dtype=torch.int64, device=rows.device)
    for lo in range(0, rows.shape[0], CHUNK):
        x = ar.cast(rows[lo:lo + CHUNK])
        a = [torch.argmin(c2[h][None] - 2.0 * ar.mm(x[:, h * Dh:(h + 1) * Dh],
                                                   C[h].T), dim=1)
             for h in range(2)]
        cells[lo:lo + CHUNK] = a[0] * V + a[1]
    return cells


class Index:
    """The corpus as the reference walks it: rows in cell order."""

    def __init__(self, tables, rows, ar):
        self.ar = ar
        self.t = {k: ar.cast(v) for k, v in tables.items()}
        self.rows = rows
        self.V = tables["Cs"].shape[1]
        self.cells = coarse_cells(rows, tables["Cs"], ar)
        self.order = torch.argsort(self.cells, stable=True)
        self.ucells, self.counts = torch.unique_consecutive(
            self.cells[self.order], return_counts=True)
        self.starts = torch.cumsum(self.counts, 0) - self.counts

    def candidates(self, q, quota, Q):
        """Candidate row ids of one index-space query, in walk order."""
        ar, C, V = self.ar, self.t["Cs"], self.V
        Dh = C.shape[2]
        d = [((q[h * Dh:(h + 1) * Dh] ** 2).sum() + (C[h] * C[h]).sum(1)
              - 2.0 * ar.mm(C[h], q[h * Dh:(h + 1) * Dh, None])[:, 0])
             for h in range(2)]
        dist = d[0][self.ucells // V] + d[1][self.ucells % V]
        walk = torch.argsort(dist, stable=True)
        cnt = self.counts[walk]
        before = torch.cumsum(cnt, 0) - cnt
        sel = walk[before < quota]
        counts = self.counts[sel]
        first = torch.repeat_interleave(self.starts[sel], counts)
        within = torch.arange(int(counts.sum()), device=q.device) \
            - torch.repeat_interleave(torch.cumsum(counts, 0) - counts,
                                      counts)
        return self.order[first + within][:Q]

    def adc(self, q, cand):
        """ADC distances of one query to its candidates."""
        ar, t, V = self.ar, self.t, self.V
        Dh = t["Cs"].shape[2]
        F, S, Dsub = t["subs"].shape[1:]
        out = torch.zeros(cand.shape[0], dtype=ar.dtype, device=q.device)
        for lo in range(0, cand.shape[0], CAND_CHUNK):
            c = cand[lo:lo + CAND_CHUNK]
            x = ar.cast(self.rows[c])
            cells = self.cells[c]
            for h, a in enumerate((cells // V, cells % V)):
                base = t["Cs"][h][a] + t["mus"][h][a]
                both = torch.stack([x[:, h * Dh:(h + 1) * Dh] - base,
                                    q[None, h * Dh:(h + 1) * Dh] - base], 2)
                p = ar.bmm(t["Rs"][h][a], both)        # [n, Dh, 2]
                for f in range(F):
                    sub = t["subs"][h, f]               # [S, Dsub]
                    pr = p[:, f * Dsub:(f + 1) * Dsub, 0]
                    code = torch.argmin((sub * sub).sum(1)[None]
                                        - 2.0 * ar.mm(pr, sub.T), dim=1)
                    diff = p[:, f * Dsub:(f + 1) * Dsub, 1] - sub[code]
                    out[lo:lo + CAND_CHUNK] += (diff * diff).sum(1)
        return out

    def exact(self, q, ids):
        """True L2 distances ``||q - x||`` of the rows ``ids``, in the
        expanded form a matrix product gives."""
        x = self.ar.cast(self.rows[ids])
        d2 = (q * q).sum() + (x * x).sum(1) - 2.0 * self.ar.mm(
            x, q[:, None])[:, 0]
        return torch.sqrt(d2.clamp(min=0.0))


def search(tables, pca, rows, queries, *, quota, limit, rerank_nb,
           precision="float64"):
    """The reference's answers to ``queries`` over ``rows``.

    :param tables: dict of Cs, Rs, mus, subs (the model's tables)
    :param pca: dict of P [raw, D] and mu [raw], or None
    :param rows: [N, D] corpus; row ``i`` has id ``i``
    :param queries: [n, raw or D] as the program receives them
    :returns: list of (ids int64 [k], dists [k]) a query, nearest first
    """
    ar = Arith(precision)
    n = rows.shape[0]
    index = Index(tables, rows, ar)
    Q = candidate_budget(quota, n)
    out = []
    for q in project(queries, pca, ar):
        cand = index.candidates(q, quota, Q)
        keep = torch.argsort(index.adc(q, cand), stable=True)[:rerank_nb]
        ids = cand[keep]
        d = index.exact(q, ids)
        top = torch.argsort(d, stable=True)[:min(limit, n)]
        out.append((ids[top], d[top]))
    return out


def exact64(pca, rows, queries, ids):
    """float64 ``||q - x||`` of each query to each of its ``ids`` (a list
    of id tensors), in the difference form: the yardstick of the
    distances a run returns."""
    q = project(queries, pca, Arith("float64"))
    return [torch.linalg.vector_norm(rows[i].to(torch.float64) - qi[None],
                                     dim=1) for qi, i in zip(q, ids)]

