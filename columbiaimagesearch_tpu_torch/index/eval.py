"""Model-quality evaluation: recall@k, cell balance, subquantizer
distortion (port of columbiaimagesearch_tpu/index/eval.py:1-127).

Brute-force neighbours are chunked fp32 matmuls on the device; coarse
codes are the nearest centroid of each half on the model's tables. Results
are numpy, as in the JAX package.
"""

import time

import numpy as np
import torch

from columbiaimagesearch_tpu_torch.device import compute_device
from columbiaimagesearch_tpu_torch.ops.kmeans import assign_clusters
from columbiaimagesearch_tpu_torch.ops.rotations import (
    compute_residuals,
    project_residuals_to_local,
)

#: elements of one [chunk, N2] distance block
_NN_ELEMENTS = 1 << 26


def compute_all_neighbors(data1, data2=None, just_nn=True, *, device=None):
    """Nearest (or all ranked) neighbour indices of ``data1`` rows within
    ``data2`` (eval.py:17-38), as numpy."""
    dev = compute_device(data1, device)
    d1 = torch.as_tensor(data1, dtype=torch.float32, device=dev)
    d2 = d1 if data2 is None else torch.as_tensor(
        data2, dtype=torch.float32, device=dev)
    n2 = (d2 * d2).sum(dim=1)
    chunk = max(1, _NN_ELEMENTS // max(1, d2.shape[0]))
    out = []
    for lo in range(0, d1.shape[0], chunk):
        d2m = torch.addmm(n2[None, :], d1[lo:lo + chunk], d2.T, alpha=-2.0)
        out.append(d2m.argmin(dim=1) if just_nn
                   else torch.argsort(d2m, dim=1, stable=True))
    return torch.cat(out).cpu().numpy()


def _coarse_codes(data, model):
    """[N, 2] nearest coarse centroid of each half on the model's tables
    (the JAX ``_predict_coarse_batch``: no PCA is applied)."""
    X = torch.as_tensor(data, dtype=torch.float32, device=model.device)
    Dh = model.Cs.shape[2]
    return torch.stack([assign_clusters(X[:, s * Dh:(s + 1) * Dh],
                                        model.Cs[s])[0] for s in range(2)],
                       dim=1).cpu().numpy()


def get_proportion_nns_with_same_coarse_codes(data, model, nns=None):
    """Fraction of points sharing coarse codes with their true NN
    (eval.py:41-49)."""
    if nns is None:
        nns = compute_all_neighbors(data, device=model.device)
    coarse = _coarse_codes(data, model)
    same = np.all(coarse == coarse[np.asarray(nns)], axis=1)
    return float(np.mean(same))


def get_subquantizer_distortion(data, model):
    """Mean per-subquantizer squared distortion over locally projected
    residuals (eval.py:52-75): an [M] numpy array."""
    X = torch.as_tensor(data, dtype=torch.float32, device=model.device)
    Dh = model.Cs.shape[2]
    projected = []
    for s in range(2):
        r, a = compute_residuals(X[:, s * Dh:(s + 1) * Dh], model.Cs[s])
        projected.append(project_residuals_to_local(r, a, model.Rs[s],
                                                    model.mus[s]))
    pall = torch.cat(projected, dim=1)
    F, Dsub = model.subs.shape[1], model.subs.shape[3]
    dists = []
    for m in range(2 * F):
        _, md = assign_clusters(pall[:, m * Dsub:(m + 1) * Dsub].contiguous(),
                                model.subs[m // F, m % F])
        dists.append(float(md.sum()))
    return np.asarray(dists) / X.shape[0]


def get_cell_histogram(data, model):
    """Histogram of points per multi-index cell (eval.py:78-82)."""
    coarse = _coarse_codes(data, model)
    cells = coarse[:, 0].astype(np.int64) * model.V + coarse[:, 1]
    return np.histogram(cells, bins=range(model.V ** 2))[0]


def get_proportion_of_reconstructions_with_same_codes(data, model):
    """Fraction of points whose reconstruction re-encodes to the same code
    (eval.py:85-94), batched."""
    coarse, fine = model.predict_batch(data)
    recon = model.reconstruct_batch(coarse, fine)
    coarse2, fine2 = model.predict_batch(recon)
    same = np.all(coarse == coarse2, axis=1) & np.all(fine == fine2, axis=1)
    return float(np.mean(same))


def get_recall(searcher, queries, nns, thresholds=(1, 10, 100, 1000),
               normalize=True, verbose=False):
    """Recall@thresholds + mean query time (eval.py:97-127);
    ``thresholds[-1]`` is the retrieval quota, as in the reference."""
    thresholds = list(thresholds)
    recall = np.zeros(len(thresholds))
    query_time = 0.0
    queries = np.asarray(queries, dtype=np.float32)
    for i, q in enumerate(queries):
        nn = nns[i]
        start = time.perf_counter()
        results, cells_visited = searcher.search(q, thresholds[-1])
        query_time += time.perf_counter() - start
        if verbose and i % 50 == 0:
            print(f"{cells_visited} cells visited for query {i}")
        for j, res in enumerate(results):
            if res.id == nn:
                for k, t in enumerate(thresholds):
                    if j < t:
                        recall[k] += 1
    if normalize:
        n = queries.shape[0]
        return recall / n, query_time / n
    return recall, query_time
