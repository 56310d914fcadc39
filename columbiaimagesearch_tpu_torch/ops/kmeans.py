"""Batched k-means: k-means++ seeding + full-batch Lloyd iterations
(port of columbiaimagesearch_tpu/ops/kmeans.py:1-271).

Exact Lloyd, as in the JAX package: the assignment step is one fp32
matmul per row chunk (TF32 off, device.py), the update one ``index_add_``
of the rows into their centroids; an empty cluster keeps its centroid.
k-means++ is the greedy variant (``2 + log k`` candidates a step, the best
kept) with its ``k - 1`` dependent steps free of host syncs. Seeding draws
from a ``torch.Generator`` with ``torch.multinomial`` over ``d2 * w``
where JAX draws ``categorical(log d2)`` from a ``jax.random`` key: the
same distribution, another stream, so seeded runs of the two packages
pick other seeds and agree in inertia, not in centroids (Lloyd from one
``C_init`` agrees exactly). Every function returns tensors on its device:
``device`` when given, else the data's for a tensor, else the first card.
"""

import numpy as np
import torch

from columbiaimagesearch_tpu_torch.device import compute_device

#: elements of one chunk's [chunk, k] distance buffer (256 MB in fp32)
_CHUNK_ELEMENTS = 1 << 26


def _pick_chunk(n_rows: int, k: int) -> int:
    """Rows a chunk such that its [chunk, k] distance buffer stays
    bounded."""
    return max(1, min(n_rows, max(256, _CHUNK_ELEMENTS // max(k, 1))))


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else np.asarray(x).size


def _generator(seed, device):
    if seed is None:
        seed = np.random.randint(0, 2**31 - 1)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _assign_rows(xc, C, c2):
    """Nearest centroid of each row: (ids int64, squared distance). The
    matmul identity as in kmeans.py:43-49; ``x^2`` is added back for the
    distance's value (the argmin does not need it)."""
    d2 = torch.addmm(c2[None, :], xc, C.T, alpha=-2.0)
    md, a = torch.min(d2, dim=1)
    return a, (md + (xc * xc).sum(dim=1)).clamp_min_(0.0)


def _assign_chunked(X, C, chunk):
    N = X.shape[0]
    a = torch.empty(N, dtype=torch.int64, device=X.device)
    md = torch.empty(N, dtype=torch.float32, device=X.device)
    c2 = (C * C).sum(dim=1)
    for lo in range(0, N, chunk):
        a[lo:lo + chunk], md[lo:lo + chunk] = _assign_rows(
            X[lo:lo + chunk], C, c2)
    return a, md


def assign_clusters(X, C, *, device=None):
    """Nearest centroid ids (int64) + squared distances (kmeans.py:56)."""
    dev = compute_device(X, device)
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    C = torch.as_tensor(C, dtype=torch.float32, device=dev)
    return _assign_chunked(X, C, _pick_chunk(X.shape[0], C.shape[0]))


def kmeans_plusplus_init(generator, X, w, k: int, n_local_trials: int = 0):
    """Greedy k-means++ seeding on the device (kmeans.py:67-120).

    :param generator: ``torch.Generator`` on ``X``'s device
    :param X: [N, D] float32 tensor
    :param w: [N] validity weights (1 valid / 0 ignored), or None for all
    :param k: number of centers
    :param n_local_trials: candidates per step (0 -> 2 + log(k))
    :returns: [k, D] initial centroids
    """
    N, D = X.shape
    T = n_local_trials if n_local_trials > 0 else 2 + int(np.log(max(k, 2)))
    w = (torch.ones(N, dtype=torch.float32, device=X.device) if w is None
         else torch.as_tensor(w, dtype=torch.float32, device=X.device))
    x2 = (X * X).sum(dim=1)
    first = torch.multinomial(w, 1, generator=generator)
    c = X.index_select(0, first)                       # [1, D]
    C = torch.zeros((k, D), dtype=torch.float32, device=X.device)
    C[0] = c[0]
    d2 = ((x2 - 2.0 * (X @ c[0])) + (c * c).sum()).clamp_min_(0.0) * w
    for i in range(1, k):
        # D^2 sampling; when every distance is 0, uniform over valid rows
        # (a device-side select: no host sync in the loop).
        p = torch.where((d2 > 0).any(), d2, w)
        idx = torch.multinomial(p, T, replacement=True, generator=generator)
        cand = X.index_select(0, idx)                  # [T, D]
        dist = torch.addmm(x2[None, :], cand, X.T, alpha=-2.0)
        dist.add_((cand * cand).sum(dim=1)[:, None]).clamp_min_(0.0)
        dist.mul_(w[None, :])
        torch.minimum(d2[None, :], dist, out=dist)     # [T, N]
        best = dist.sum(dim=1).argmin().view(1)
        C[i] = cand.index_select(0, best)[0]
        d2 = dist.index_select(0, best)[0]
    return C


def _lloyd_sums(chunks, C, chunk):
    """One full-batch Lloyd update's accumulators over ``chunks`` (each a
    [n, D] device tensor): (sums [k, D], counts [k], summed distance)."""
    k, D = C.shape
    sums = torch.zeros((k, D), dtype=torch.float32, device=C.device)
    counts = torch.zeros(k, dtype=torch.float32, device=C.device)
    total = torch.zeros((), dtype=torch.float32, device=C.device)
    c2 = (C * C).sum(dim=1)
    for xs in chunks:
        ones = torch.ones(min(chunk, xs.shape[0]), dtype=torch.float32,
                          device=C.device)
        for lo in range(0, xs.shape[0], chunk):
            xc = xs[lo:lo + chunk]
            a, md = _assign_rows(xc, C, c2)
            sums.index_add_(0, a, xc)
            counts.index_add_(0, a, ones[:xc.shape[0]])
            total += md.sum()
    return sums, counts, total


def _update(C, sums, counts):
    """New centroids; an empty cluster keeps its old one."""
    return torch.where(counts[:, None] > 0,
                       sums / counts.clamp_min(1.0)[:, None], C)


def _lloyd(X, C_init, iters: int, chunk: int):
    """Full-batch Lloyd iterations (kmeans.py:123-140); returns (C,
    assignments, inertia as a 0-d tensor)."""
    C = C_init
    for _ in range(iters):
        sums, counts, _ = _lloyd_sums([X], C, chunk)
        C = _update(C, sums, counts)
    a, md = _assign_chunked(X, C, chunk)
    return C, a, md.sum()


def lloyd_kmeans(X, C_init, iters: int = 10, *, device=None):
    """Lloyd iterations from given initial centroids (kmeans.py:143-154).

    :returns: (centroids [k, D], assignments [N] int64, inertia float)
    """
    dev = compute_device(X, device)
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    C_init = torch.as_tensor(C_init, dtype=torch.float32, device=dev)
    C, a, inertia = _lloyd(X, C_init, iters,
                           _pick_chunk(X.shape[0], C_init.shape[0]))
    return C, a, float(inertia)


def fit_kmeans_streaming(X, k: int, iters: int = 10, n_init: int = 1,
                         seed: int | None = None, device_chunk: int = 262144,
                         init_subsample: int = 500_000, *, device=None,
                         generator=None):
    """Exact Lloyd over data that stays where it lives (kmeans.py:173-221):
    each iteration moves ``device_chunk`` rows at a time to the device and
    accumulates the same full-batch update as :func:`fit_kmeans`;
    k-means++ seeds on the first ``init_subsample`` rows. With
    ``init_subsample >= N`` and the same seed it starts from the same
    centroids as :func:`fit_kmeans`.

    :param X: [N, D] array or tensor (a host array stays on the host)
    :returns: [k, D] float32 centroids on the device
    """
    dev = compute_device(X, device)
    N = X.shape[0]
    g = generator if generator is not None else _generator(seed, dev)
    sub = torch.as_tensor(X[: min(init_subsample, N)], dtype=torch.float32,
                          device=dev)
    chunk = _pick_chunk(device_chunk, k)
    best_C, best_inertia = None, np.inf
    for _ in range(max(1, n_init)):
        C = kmeans_plusplus_init(g, sub, None, k)
        inertia = np.inf
        for _ in range(iters):
            chunks = (torch.as_tensor(X[lo:lo + device_chunk],
                                      dtype=torch.float32, device=dev)
                      for lo in range(0, N, device_chunk))
            sums, counts, total = _lloyd_sums(chunks, C, chunk)
            C = _update(C, sums, counts)
            inertia = float(total)
        if inertia < best_inertia:
            best_C, best_inertia = C, inertia
    return best_C


#: Above this many elements the data are streamed to the device in
#: chunks (kmeans.py:224; the same data-size rule as the JAX package).
STREAMING_THRESHOLD_ELEMENTS = 1 << 29


def fit_kmeans_auto(X, k: int, iters: int = 10, n_init: int = 1,
                    seed: int | None = None, *, device=None, generator=None):
    """Dispatch between on-device and streaming exact Lloyd by data size
    (kmeans.py:227-239)."""
    if _numel(X) > STREAMING_THRESHOLD_ELEMENTS:
        return fit_kmeans_streaming(X, k, iters, n_init, seed, device=device,
                                    generator=generator)
    return fit_kmeans(X, k, iters, n_init, seed, device=device,
                      generator=generator)


def fit_kmeans(X, k: int, iters: int = 10, n_init: int = 1,
               seed: int | None = None, *, device=None, generator=None):
    """k-means++ seeding + Lloyd, best of ``n_init`` runs
    (kmeans.py:242-271). The draws come from ``generator`` when given,
    else from a generator seeded with ``seed`` (random when None).

    :returns: [k, D] float32 centroids on the device
    """
    dev = compute_device(X, device)
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    g = generator if generator is not None else _generator(seed, dev)
    chunk = _pick_chunk(X.shape[0], k)
    best_C, best_inertia = None, np.inf
    for _ in range(max(1, n_init)):
        C0 = kmeans_plusplus_init(g, X, None, k)
        C, _, inertia = _lloyd(X, C0, iters, chunk)
        inertia = float(inertia)
        if inertia < best_inertia:
            best_C, best_inertia = C, inertia
    return best_C
