"""Multi-sequence traversal of the inverted multi-index (Babenko & Lempitsky).

Copied from columbiaimagesearch_tpu/index/multisequence.py (numpy and
heapq only); the host reference searcher (index/searcher.py
``LOPQSearcherBase.get_result_quota``) walks it.

Host-side generator yielding cells of the V x V multi-index grid in increasing
approximate distance, identical in semantics to the reference
(reference: lopq/lopq/search.py:13-82 ``multisequence``). The traversal is an
inherently sequential tiny heap (a few hundred pops per query), so it stays on
the host; the device query path (index/query.py) instead sorts a top-B x top-B cell
grid on device, which visits the same cells in the same distance order for any
B >= the deepest per-split rank reached.
"""

import heapq

import numpy as np


def multisequence(x, centroids):
    """Yield ``(approx_dist, cell)`` pairs in increasing distance order.

    :param x: query vector (D,)
    :param centroids: list of per-split coarse codebooks [V, D/2]
    """
    splits = len(centroids)
    V = centroids[0].shape[0]

    x = np.asarray(x)
    subvecs = np.split(x, splits)

    cluster_dists = []
    sorted_inds = []
    for split in range(splits):
        dists = ((subvecs[split][None, :] - centroids[split]) ** 2).sum(axis=1)
        inds = np.argsort(dists)
        cluster_dists.append(dists)
        sorted_inds.append(inds)

    def cell_for_inds(inds):
        return tuple(sorted_inds[s][i] for s, i in enumerate(inds))

    def dist_for_inds(inds):
        return sum(cluster_dists[s][sorted_inds[s][i]] for s, i in enumerate(inds))

    h = []
    traversed = set()
    start = (0,) * splits
    heapq.heappush(h, (dist_for_inds(start), start))

    while h:
        d, inds = heapq.heappop(h)
        yield d, cell_for_inds(inds)
        traversed.add(inds)

        # Expand the two grid neighbors, gated so each cell enters the heap
        # exactly once (the staircase condition from the paper).
        if inds[1] == 0 or (inds[0] + 1, inds[1] - 1) in traversed:
            c = (inds[0] + 1, inds[1])
            if c[0] < V and c[1] < V:
                heapq.heappush(h, (dist_for_inds(c), c))
        if inds[0] == 0 or (inds[0] - 1, inds[1] + 1) in traversed:
            c = (inds[0], inds[1] + 1)
            if c[0] < V and c[1] < V:
                heapq.heappush(h, (dist_for_inds(c), c))
