"""The yardstick of the per-layer shares: the card's peaks and the bytes and
operations that a kernel call or a search wave needs, computed from its
shapes alone, whatever implements it.

``peak_seconds`` and ``lut_work`` are copies of ``chip_smoke.py``'s
``bound_of`` and ``lut_work``.
"""

import torch

#: NVIDIA H100 SXM's published peaks at its full 700 W (NVIDIA's data
#: sheet): HBM3 bytes/s and float32 FLOP/s outside the tensor cores. The
#: port computes in float32 with TF32 off.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def peak_seconds(nbytes, flops):
    """(least seconds, which binds): the larger of the bytes over the
    card's memory rate and the operations over its float32 rate."""
    t_b = nbytes / PEAK_BYTES_PER_S
    t_f = flops / PEAK_FP32_FLOPS
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def lut_work(isel, V, Dh, F, S, Dsub):
    """Bytes and FLOPs of one ``build_luts`` call on these probed cluster
    ids ``isel`` [NQ, 2, B]: each distinct probed (split, cluster) matrix,
    centroid and mean read once, the queries, the ids, the subquantizers
    and the tables written; per valid slot a residual, a rotation and
    F*S*Dsub (sub, square, add). Returns (bytes, flops)."""
    NQ, _, B = isel.shape
    s = torch.arange(2, device=isel.device).view(1, 2, 1)
    valid = (isel >= 0) & (isel < V)
    distinct = int(torch.unique((s * V + isel.long())[valid]).numel())
    slots = int(valid.sum())
    nbytes = (distinct * (Dh * Dh + 2 * Dh) * 4 + NQ * 2 * Dh * 4
              + isel.numel() * 4 + 2 * F * S * Dsub * 4
              + NQ * 2 * B * F * S * 4)
    flops = slots * (2 * Dh * Dh + 2 * Dh + 3 * F * S * Dsub)
    return nbytes, flops


#: probed clusters a half whose tables every probed query is counted to
#: build: the narrowest square rung of the ladder (index/probe.py
#: PROBE_LADDER), the least a query's quota region needs at the sizes here
TABLE_CLUSTERS = 64


def wave_work(cfg, nq, quota, limit, rerank_nb, itemsize=4):
    """Bytes and FLOPs that one probed search wave of ``nq`` queries with
    exact rerank needs, from the configuration's shapes (``cfg``: the
    configuration file's dict):

    - bytes: the model's coarse centroids (and the PCA matrix of a
      ``lopq_pca`` model) once a wave; a query, its features, the codes of
      ``quota`` candidates, ``rerank_nb`` rerank rows of the store and the
      ids and distances of ``limit`` results;
    - FLOPs, a query: the PCA projection, the coarse distances of both
      halves, ``TABLE_CLUSTERS`` ADC tables a half (the rotation of the
      residual and F*S*Dsub sub, square, add), an add a candidate code and
      the ``rerank_nb`` exact distances.

    Returns (bytes, flops)."""
    D, V, M, S = cfg["dim"], cfg["V"], cfg["M"], cfg["subq"]
    Dh, F = D // 2, M // 2
    Dsub = Dh // F
    raw = cfg.get("raw_dim", D) if cfg["model_type"] == "lopq_pca" else D
    nbytes = 2 * V * Dh * 4 + nq * (raw * 4 + quota * M
                                    + rerank_nb * D * itemsize + limit * 8)
    flops = nq * (3 * 2 * V * Dh + quota * (M - 1) + rerank_nb * 3 * D
                  + 2 * min(V, TABLE_CLUSTERS)
                  * (2 * Dh * Dh + 2 * Dh + 3 * F * S * Dsub))
    if raw != D:
        nbytes += raw * D * 4
        flops += nq * 2 * raw * D
    return nbytes, flops
