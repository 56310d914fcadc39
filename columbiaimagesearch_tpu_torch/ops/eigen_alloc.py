"""Balanced eigenvalue allocation (OPQ, Ge et al. CVPR'13 section 3.2.4);
copy of columbiaimagesearch_tpu/ops/eigen_alloc.py:1-87 (numpy only).

Greedy assignment of eigenvalues (descending) to the not-yet-full bucket with
the smallest log-eigenvalue product, yielding a permutation of dimensions that
balances variance across subquantizer buckets.

Semantics match the reference implementation
(reference: lopq/lopq/model.py:19-71 ``eigenvalue_allocation``), including the
min-nonzero-eigenvalue scaling trick and first-eligible-bucket tie-breaking.

The per-call algorithm is inherently sequential and tiny (D steps), so it runs
host-side in numpy; ``eigenvalue_allocation_batch`` vectorizes the D-step loop
across all V clusters at once, which is how the training path consumes it
(one call for all local rotations instead of V Python calls).
"""

import numpy as np


def _scaled_log2(eigenvalues: np.ndarray) -> np.ndarray:
    """Scale by the smallest nonzero |eigenvalue| and return log2|.|.

    The scaling protects the greedy log-product accumulation from eigenvalues
    < 1 (reference: lopq/lopq/model.py:46-54).
    """
    eigenvalues = np.asarray(eigenvalues, dtype=np.float64)
    nonzero = eigenvalues[np.nonzero(eigenvalues)]
    if nonzero.size == 0:
        # All-zero spectrum: any permutation is balanced; avoid div-by-zero.
        return np.zeros_like(eigenvalues)
    min_nonzero = np.min(np.abs(nonzero))
    scaled = eigenvalues / min_nonzero
    with np.errstate(divide="ignore"):
        out = np.log2(np.abs(scaled))
    # NB: zero eigenvalues yield -inf, which the greedy sums propagate (a
    # bucket holding a zero eigenvalue keeps winning argmin until full) —
    # intentionally identical to the reference behavior.
    return out


def eigenvalue_allocation(num_buckets: int, eigenvalues: np.ndarray) -> np.ndarray:
    """Return a permutation of dimension indices balancing variance.

    :param num_buckets: number of buckets (subquantizers) to balance across
    :param eigenvalues: (D,) vector of eigenvalues
    :returns: (D,) int array: permutation of eigenvector indices
    """
    perms = eigenvalue_allocation_batch(num_buckets, np.asarray(eigenvalues)[None, :])
    return perms[0]


def eigenvalue_allocation_batch(num_buckets: int, eigenvalues: np.ndarray) -> np.ndarray:
    """Vectorized eigenvalue allocation over a batch of spectra.

    :param num_buckets: number of buckets to balance across
    :param eigenvalues: (V, D) array, one spectrum per cluster
    :returns: (V, D) int64 array of permutations, row ``v`` equals
        ``eigenvalue_allocation(num_buckets, eigenvalues[v])``
    """
    eigs = np.asarray(eigenvalues, dtype=np.float64)
    V, D = eigs.shape
    if D % num_buckets != 0:
        raise ValueError(f"D={D} not divisible by num_buckets={num_buckets}")
    dims_per_bucket = D // num_buckets

    log_eigs = np.stack([_scaled_log2(eigs[v]) for v in range(V)])  # (V, D)

    # Descending order per cluster. np.argsort is stable ascending; reversing
    # reproduces the reference's tie order (argsort(x)[::-1]).
    order = np.argsort(eigs, axis=1, kind="stable")[:, ::-1]  # (V, D)

    bucket_product = np.zeros((V, num_buckets), dtype=np.float64)
    bucket_size = np.zeros((V, num_buckets), dtype=np.int64)
    permutation = np.zeros((V, num_buckets, dims_per_bucket), dtype=np.int64)
    rows = np.arange(V)

    for step in range(D):
        ind = order[:, step]  # (V,) dimension index being placed
        eligible = bucket_size < dims_per_bucket  # (V, B)
        masked = np.where(eligible, bucket_product, np.inf)
        bucket = np.argmin(masked, axis=1)  # first minimum among eligible
        bucket_product[rows, bucket] += log_eigs[rows, ind]
        slot = bucket_size[rows, bucket]
        permutation[rows, bucket, slot] = ind
        bucket_size[rows, bucket] += 1

    return permutation.reshape(V, D)
