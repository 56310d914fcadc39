"""The comparison that decides ``correct``: the program's answers to the
sampled queries against the plain reference's, by two numbers, each held
to its limit (``limits/<cell>.json``):

- ``dist_gap``: the widest relative gap between a distance the program
  returned and the float64 distance of the same query to the same row.
  It catches a wrong distance and an id altered on its way out, and reads
  the precision of the distances.
- ``list_miss``: the share of the queries, in %, whose list lies farther
  than the reference's: at some rank k < limit the program's k-th nearest
  answer (by the float64 distance of the row it named) is farther than
  the reference's k-th by more than ``LIST_RTOL``. It catches what the
  probe, the tables, the ADC ranking and the rerank lose; a list as good
  as the reference's, or better (an exact brute pass), is no miss. A
  share and not a widest gap: a row whose two nearest coarse centroids
  tie to float32 rounding lands in another cell in the program than in
  the float64 reference, and where that cell lies inside the walk and the
  count sits at the quota, the walk crosses the quota one cell earlier or
  later, a whole cell of candidates apart (PERF.md: ~1 query in 1,000).
  A missing answer, an id out of range or repeated reads ``INVALID``.
"""

import numpy as np
import torch

from portbench.reference import lopq_search

#: the reading of an answer that cannot be compared (JSON has no inf)
INVALID = 1e30
#: relative distance by which a list's k-th answer may lie farther than
#: the reference's: float64 sums of the same row in two orders
LIST_RTOL = 1e-9


def judge(got, ref, pca, rows, X):
    """The two numbers for ``got`` [(ids, dists)] a query, against the
    reference's ``ref`` [(ids, dists)] on the same queries ``X``."""
    n = rows.shape[0]
    dist_gap, misses = 0.0, 0
    for (ids, dists), (rid, rd), x in zip(got, ref, X):
        ids = np.asarray(ids, dtype=np.int64)
        if (len(ids) < len(rid) or (ids < 0).any() or (ids >= n).any()
                or len(np.unique(ids)) != len(ids)):
            return {"dist_gap": INVALID, "list_miss": INVALID}
        yard = lopq_search.exact64(pca, rows, x[None],
                                   [torch.as_tensor(ids, device=rows.device)]
                                   )[0].cpu().numpy()
        d = np.asarray(dists, dtype=np.float64)
        dist_gap = max(dist_gap, float((np.abs(d - yard) / yard).max()))
        want = rd.to(torch.float64).cpu().numpy()
        have = np.sort(yard)[:len(want)]
        gap = float(((have - want) / want).max())
        if gap > LIST_RTOL:
            misses += 1
    return {"dist_gap": dist_gap, "list_miss": 100.0 * misses / len(got)}


def compare(numbers, limits):
    """({number: {"value", "limit"}}, correct): each number held to its
    limit, and whether every one is within it."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())
