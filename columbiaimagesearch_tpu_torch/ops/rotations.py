"""Per-cluster covariance accumulation and local rotation fitting
(port of columbiaimagesearch_tpu/ops/rotations.py:1-299).

- Assignment is the chunked matmul of ``ops/kmeans.py``.
- The covariance accumulators take one path for every V (the JAX package
  splits at V = 32 between V masked matmuls and a blocked layout, a TPU
  choice): rows are sorted by cluster once, each cluster's run is padded
  to a multiple of 128 rows (``blocked_layout``, which
  ``index/encode.py`` ``lopq_encode_blocked`` shares at 256 rows), every
  128-row block's Gram is one batched ``bmm``, and the block Grams are
  ``index_add_``-ed into ``[V, D, D]``.
  Per-row outer products would be ``N * D^2`` scattered adds (~33 G a
  half at 2,000,000 rows and D = 128).
- The eigendecompositions are one batched ``torch.linalg.eigh`` on the
  device; the balanced eigenvalue allocation runs on the host over the
  ``[V, D]`` eigenvalues (``eigenvalue_allocation_batch``), and the
  eigenvector permutation ``R[v] = eigvecs[v][:, perm[v]].T`` on the
  device.
- Projection into the local frames is a chunked per-row ``bmm`` against
  the gathered rotations.

The estimator, the ``count < D`` identity fallback and the rotation layout
(applied as ``R @ r``) match the reference. Data above
``STREAMING_THRESHOLD_ELEMENTS`` that is not on the device is streamed to
it in chunks, and the per-row outputs stay on the host.
"""

import torch

from columbiaimagesearch_tpu_torch.device import compute_device
from columbiaimagesearch_tpu_torch.ops.eigen_alloc import (
    eigenvalue_allocation_batch,
)
from columbiaimagesearch_tpu_torch.ops.kmeans import (
    STREAMING_THRESHOLD_ELEMENTS,
    _numel,
    assign_clusters,
)

#: rows a block of the cluster-blocked layout
_BLK = 128
#: bytes of gathered rotations a projection chunk holds
_GATHER_BYTES = 1 << 28
#: rows a chunk of the streaming paths
_STREAM_CHUNK = 131072


def _streams(x, dev):
    """True when ``x`` is too large to move to ``dev`` whole and lies
    elsewhere: it is then processed in chunks and its outputs stay on its
    own device."""
    on_dev = isinstance(x, torch.Tensor) and x.device == dev
    return not on_dev and _numel(x) > STREAMING_THRESHOLD_ELEMENTS


def blocked_layout(a, V: int, blk: int):
    """The cluster-blocked layout of assignments ``a`` [N] (int64): rows
    sorted by cluster (stable), each cluster's run padded to whole
    ``blk``-row blocks, clusters in order.

    :returns: (counts [V] rows a cluster, order [N] the input row at each
        sorted position, ppos [N] the padded position of each sorted row,
        bcluster [n_blocks] the cluster of each block); one host read a
        call (the block count)
    """
    N = a.shape[0]
    dev = a.device
    counts = torch.zeros(V, dtype=torch.int64, device=dev).index_add_(
        0, a, torch.ones_like(a))
    nblk = (counts + blk - 1) // blk
    pstart = (torch.cumsum(nblk, 0) - nblk) * blk
    cstart = torch.cumsum(counts, 0) - counts
    order = torch.argsort(a, stable=True)
    a_sorted = a[order]
    ppos = (pstart[a_sorted] + torch.arange(N, device=dev)
            - cstart[a_sorted])
    n_blocks = int(nblk.sum())
    bcluster = torch.repeat_interleave(torch.arange(V, device=dev), nblk,
                                       output_size=n_blocks)
    return counts, order, ppos, bcluster


def _accumulate(r, a, V: int):
    """Covariance accumulators of residuals ``r`` [N, D] assigned ``a``
    [N]: (A [V, D, D] outer-product sums, mu [V, D] sums, count [V])."""
    D = r.shape[1]
    dev = r.device
    counts, order, ppos, bcluster = blocked_layout(a, V, _BLK)
    n_blocks = bcluster.shape[0]
    xb = torch.zeros((n_blocks * _BLK, D), dtype=torch.float32,
                     device=dev).index_copy_(0, ppos, r[order])
    xb = xb.view(n_blocks, _BLK, D)
    A = torch.zeros((V, D, D), dtype=torch.float32, device=dev).index_add_(
        0, bcluster, torch.bmm(xb.transpose(1, 2), xb))
    mu = torch.zeros((V, D), dtype=torch.float32, device=dev).index_add_(
        0, a, r)
    return A, mu, counts.to(torch.float32)


def accumulate_covariance_estimators(data, C, *, device=None):
    """Single pass: per-cluster residual outer-product sums
    (rotations.py:136-166).

    :returns: (A [V, D, D] outer-product sums, mu [V, D] residual sums,
        count [V], assignments [N] int64, residuals [N, D])
    """
    dev = compute_device(data, device)
    C = torch.as_tensor(C, dtype=torch.float32, device=dev)
    if _streams(data, dev):
        return _accumulate_streaming(data, C, dev)
    X = torch.as_tensor(data, dtype=torch.float32, device=dev)
    a, _ = assign_clusters(X, C)
    r = X - C[a]
    A, mu, cnt = _accumulate(r, a, C.shape[0])
    return A, mu, cnt, a, r


def _accumulate_streaming(data, C, dev):
    """Chunked accumulation for data too large for the device
    (rotations.py:169-198): the accumulators live on the device, the
    assignments and residuals on the host."""
    V, D = C.shape
    N = data.shape[0]
    A = torch.zeros((V, D, D), dtype=torch.float32, device=dev)
    mu = torch.zeros((V, D), dtype=torch.float32, device=dev)
    cnt = torch.zeros(V, dtype=torch.float32, device=dev)
    assignments = torch.empty(N, dtype=torch.int64)
    residuals = torch.empty((N, D), dtype=torch.float32)
    for lo in range(0, N, _STREAM_CHUNK):
        x = torch.as_tensor(data[lo:lo + _STREAM_CHUNK], dtype=torch.float32,
                            device=dev)
        a, _ = assign_clusters(x, C)
        r = x - C[a]
        dA, dmu, dcnt = _accumulate(r, a, V)
        A += dA
        mu += dmu
        cnt += dcnt
        assignments[lo:lo + len(x)] = a.cpu()
        residuals[lo:lo + len(x)] = r.cpu()
    return A, mu, cnt, assignments, residuals


def _eigh(cov):
    """Batched symmetric eigendecomposition (ascending eigenvalues); a
    function of its own so that chip_smoke.py's stage clock times it
    alone."""
    return torch.linalg.eigh(cov)


def compute_rotations_from_accumulators(A, mu, count, num_buckets: int, *,
                                        device=None):
    """Batched rotation fitting from accumulators (rotations.py:201-239):
    ``cov = (A + A^T) / (2 (n - 1)) - outer(mu, mu)``, the identity where
    a cluster has fewer points than dimensions, eigenvectors permuted by
    balanced eigenvalue allocation and stored as rows.

    :returns: (R [V, D, D] rotations, mu [V, D] mean residuals)
    """
    dev = compute_device(A, device)
    A = torch.as_tensor(A, dtype=torch.float32, device=dev)
    mu = torch.as_tensor(mu, dtype=torch.float32, device=dev)
    count = torch.as_tensor(count, dtype=torch.float32, device=dev)
    V, D = mu.shape
    mu = mu / count.clamp_min(1.0)[:, None]
    denom = (2.0 * (count - 1.0)).clamp_min(1.0)[:, None, None]
    cov = (A + A.transpose(1, 2)) / denom - mu[:, :, None] * mu[:, None, :]
    eigvals, eigvecs = _eigh(cov)
    degenerate = count < D
    eigvals = torch.where(degenerate[:, None], 1.0, eigvals)
    eigvecs = torch.where(degenerate[:, None, None],
                          torch.eye(D, dtype=torch.float32, device=dev),
                          eigvecs)
    perms = eigenvalue_allocation_batch(num_buckets, eigvals.cpu().numpy())
    perms = torch.from_numpy(perms).to(dev)
    R = torch.take_along_dim(eigvecs, perms[:, None, :], dim=2)
    return R.transpose(1, 2).contiguous(), mu


def compute_local_rotations(data, C, num_buckets: int, *, device=None):
    """Fit per-cluster rotations (rotations.py:242-250).

    :returns: (R [V, D, D], mu [V, D], assignments [N], residuals [N, D])
    """
    A, mu_sum, count, assignments, residuals = \
        accumulate_covariance_estimators(data, C, device=device)
    R, mu = compute_rotations_from_accumulators(A, mu_sum, count,
                                                num_buckets)
    return R, mu, assignments, residuals


def project_residuals_to_local(residuals, assignments, Rs, mus, *,
                               device=None):
    """Local-frame projection ``out[n] = R[a[n]] @ (r[n] - mu[a[n]])``
    (rotations.py:263-289), a per-row ``bmm`` over row chunks."""
    dev = compute_device(residuals, device)
    Rs = torch.as_tensor(Rs, dtype=torch.float32, device=dev)
    mus = torch.as_tensor(mus, dtype=torch.float32, device=dev)
    N, D = residuals.shape
    stream = _streams(residuals, dev)
    out = torch.empty((N, D), dtype=torch.float32,
                      device="cpu" if stream else dev)
    chunk = max(1, _GATHER_BYTES // (4 * D * D))
    for lo in range(0, N, chunk):
        r = torch.as_tensor(residuals[lo:lo + chunk], dtype=torch.float32,
                            device=dev)
        a = torch.as_tensor(assignments[lo:lo + chunk], device=dev).long()
        out[lo:lo + chunk] = torch.bmm(Rs[a], (r - mus[a])[:, :, None])[..., 0]
    return out


def compute_residuals(data, C, *, device=None):
    """Residuals to the nearest centroid (rotations.py:292-299).

    :returns: (residuals [N, D], assignments [N] int64)
    """
    dev = compute_device(data, device)
    X = torch.as_tensor(data, dtype=torch.float32, device=dev)
    C = torch.as_tensor(C, dtype=torch.float32, device=dev)
    assignments, _ = assign_clusters(X, C)
    return X - C[assignments], assignments
