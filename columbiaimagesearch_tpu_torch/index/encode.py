"""Batched LOPQ encoding in PyTorch.

``lopq_encode`` (port of columbiaimagesearch_tpu/index/tpu_encode.py:17-60):
coarse argmin per half, residual, local rotation, fine argmin per
subvector, chunked over rows. The rotation gathers ``Rs[s][a]`` per row of a
chunk, so a chunk costs ``chunk * Dh * Dh * 4`` bytes of transient
(268 MB at 4096 rows and Dh=128): chunks stay small instead of the JAX
package's 64k-row ``lax.map`` steps.

``lopq_encode_blocked`` and ``blocks_needed`` (port of
columbiaimagesearch_tpu/index/tpu_encode_blocked.py:29-114): the
cluster-blocked encoder. Per half, rows are sorted by coarse cluster and
each cluster's run is padded to ``BLK``-row blocks (``ops/rotations.py``
``blocked_layout``), so one rotation is gathered a block instead of a row
and the projection is one batched ``bmm``. The JAX function builds the
whole padded buffer, its ``[N, V]`` coarse product and its ``[N, F, S]``
fine table at once (172 GB and 43 GB at 10,485,760 rows, V=4096); here
the coarse product is chunked by rows and the layout is walked in windows
of whole blocks, each window's codes scattered back to input order (the
fine argmin is row-local, so projections never are). One deliberate
difference: given fewer blocks than the layout needs, JAX drops the rows
past its buffer and returns wrong codes; this raises ``ValueError``.
"""

import torch

from columbiaimagesearch_tpu_torch.ops.kmeans import _pick_chunk
from columbiaimagesearch_tpu_torch.ops.rotations import blocked_layout
from columbiaimagesearch_tpu_torch.utils.chunking import round_up

#: rows a block of the cluster-blocked layout (tpu_encode_blocked.py:26)
BLK = 256


def lopq_encode(Cs, Rs, mus, subs, X, chunk: int = 4096):
    """Encode a batch of vectors.

    :param Cs: [2, V, Dh] coarse codebooks
    :param Rs: [2, V, Dh, Dh] local rotations (apply as R @ r)
    :param mus: [2, V, Dh] residual means
    :param subs: [2, F, S, Dsub] subquantizer codebooks
    :param X: [N, D] float32 on the same device as the tables (any N)
    :returns: (coarse [N, 2] int32, fine [N, M] int32) on that device
    """
    N, _D = X.shape
    F, Dsub = subs.shape[1], subs.shape[3]
    Dh = Cs.shape[2]
    c2 = (Cs * Cs).sum(dim=2)          # [2, V]
    s2 = (subs * subs).sum(dim=3)      # [2, F, S]
    coarse = torch.empty((N, 2), dtype=torch.int32, device=X.device)
    fine = torch.empty((N, 2 * F), dtype=torch.int32, device=X.device)
    for lo in range(0, N, chunk):
        xh = X[lo:lo + chunk].to(torch.float32).reshape(-1, 2, Dh)
        for s in range(2):
            xs = xh[:, s, :]
            a = torch.argmin(c2[s][None, :] - 2.0 * (xs @ Cs[s].T), dim=1)
            coarse[lo:lo + chunk, s] = a.to(torch.int32)
            r = xs - Cs[s][a] - mus[s][a]
            pr = torch.bmm(Rs[s][a], r[:, :, None])[:, :, 0]
            prod = torch.einsum("nfd,fsd->nfs", pr.reshape(-1, F, Dsub),
                                subs[s])
            d2 = s2[s][None, :, :] - 2.0 * prod
            fine[lo:lo + chunk, s * F:(s + 1) * F] = torch.argmin(
                d2, dim=2).to(torch.int32)
    return coarse, fine


def blocks_needed(n: int, V: int) -> int:
    """Blocks that cover ``n`` rows of any assignment over ``V`` clusters
    (each cluster pads at most one block; tpu_encode_blocked.py:112)."""
    return round_up(n, BLK) // BLK + V


def coarse_assign(xh, C, c2, chunk: int):
    """Nearest centroid of each row of ``xh`` [N, Dh] (int64): the argmin
    of ``c2 - 2 (x @ C.T)`` (tpu_encode_blocked.py:38-41), ``chunk`` rows
    a product."""
    a = torch.empty(xh.shape[0], dtype=torch.int64, device=xh.device)
    for lo in range(0, xh.shape[0], chunk):
        prod = xh[lo:lo + chunk] @ C.T
        # c2 - 2 prod in one pass over the product, in place
        a[lo:lo + chunk] = torch.argmin(
            torch.add(c2, prod, alpha=-2.0, out=prod), dim=1)
    return a


def lopq_encode_blocked(Cs, Rs, mus, subs, X, V: int, n_blocks: int, *,
                        chunk=None):
    """Cluster-blocked encode: :func:`lopq_encode`'s codes but for float32
    near-ties (the residual is rounded in another order).

    Per half, in the JAX function's arithmetic and order: the coarse
    argmin of ``c2 - 2 (x @ C.T)``, the residual ``(x - mu[a]) - C[a]``,
    ``R[a] @ r`` a block at a time, the fine argmin of
    ``s2 - 2 (pr . sub)`` per subvector.

    :param Cs, Rs, mus, subs: the tables, as for :func:`lopq_encode`
    :param X: [N, D] float32 on the tables' device
    :param V: coarse clusters a half
    :param n_blocks: the block budget (:func:`blocks_needed`); blocks past
        the layout change nothing
    :param chunk: rows a coarse-assignment step (default: a [chunk, V]
        product of at most 2^26 elements, as ``ops/kmeans.py``); a window
        of the layout takes the whole blocks whose [rows, F, S] fine table
        holds no more elements than that product
    :returns: (coarse [N, 2] int32, fine [N, M] int32) on that device
    :raises ValueError: when X lies on another device, or a half's layout
        needs more than ``n_blocks`` blocks
    """
    dev = Cs.device
    if X.device != dev:
        raise ValueError(f"X lies on {X.device}, the tables on {dev}")
    N, D = X.shape
    F, Dsub = subs.shape[1], subs.shape[3]
    Dh = D // 2
    X = X.to(torch.float32)
    chunk = chunk or _pick_chunk(N, V)
    window = max(1, chunk * V // (BLK * F * subs.shape[2]))
    c2 = (Cs * Cs).sum(dim=2)           # [2, V]
    s2 = (subs * subs).sum(dim=3)       # [2, F, S]
    coarse = torch.empty((N, 2), dtype=torch.int32, device=dev)
    fine = torch.empty((N, 2 * F), dtype=torch.int32, device=dev)
    for s in range(2):
        xh = X[:, s * Dh:(s + 1) * Dh]
        a = coarse_assign(xh, Cs[s], c2[s], chunk)
        coarse[:, s] = a.to(torch.int32)
        _, order, ppos, bcluster = blocked_layout(a, V, BLK)
        used = bcluster.shape[0]
        if used > n_blocks:
            raise ValueError(f"half {s}: the layout needs {used} blocks of "
                             f"{BLK} rows, n_blocks is {n_blocks} "
                             f"(blocks_needed({N}, {V}) = "
                             f"{blocks_needed(N, V)})")
        # input row at each padded position; padding points at row N, a
        # spare output row that is dropped
        src = torch.full((used * BLK,), N, dtype=torch.int64,
                         device=dev).index_copy_(0, ppos, order)
        out = torch.empty((N + 1, F), dtype=torch.int32, device=dev)
        for b0 in range(0, used, window):
            bc = bcluster[b0:b0 + window]
            rows = src[b0 * BLK:(b0 + bc.shape[0]) * BLK]
            r = xh.index_select(0, rows.clamp(max=N - 1)).view(-1, BLK, Dh)
            r.sub_(mus[s][bc][:, None, :]).sub_(Cs[s][bc][:, None, :])
            pr = torch.bmm(r, Rs[s][bc].transpose(1, 2))
            prod = torch.einsum("nfd,fsd->nfs", pr.view(-1, F, Dsub), subs[s])
            codes = torch.argmin(torch.add(s2[s], prod, alpha=-2.0,
                                           out=prod), dim=2)
            out.index_copy_(0, rows, codes.to(torch.int32))
        fine[:, s * F:(s + 1) * F] = out[:N]
    return coarse, fine
