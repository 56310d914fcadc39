"""Wide-V mode of the port (index/csr.py ``wide``, index/query.py's
searchsorted buckets, ``LOPQSearcherTorch`` at V >= WIDE_V_THRESHOLD).

- JAX's tests/test_wide_v.py setup (V=16384, D=32, 4,000 rows, all in
  cells of the query's 32 nearest clusters a split) through the port,
  against ``LOPQSearcherTPU`` and the host ``LOPQSearcher``: ids equal
  except float-rounding ties, distances rtol 1e-4, atol 1e-5 (the JAX test
  holds its own searchers to rtol 1e-3, atol 1e-4);
- wide against dense on one index, with the threshold lowered on the
  instance: rows, distances, totals, cell counts and ``grid_ok`` **exactly
  equal** at the sorted square, a strip rung and the sort-free wide square,
  since only the source of the bucket bounds differs;
- incremental adds, the exact rerank, ``n_occ`` and a sentinel-padded
  capacity.
"""

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch.index.csr import append_and_build_csr
from columbiaimagesearch_tpu_torch.index.model import LOPQModel
from columbiaimagesearch_tpu_torch.index.query import lopq_query_orig
from columbiaimagesearch_tpu_torch.index.searcher import (
    LOPQSearcher,
    LOPQSearcherTorch,
)

from tests.oracle_lopq import random_params


@pytest.fixture(scope="module")
def wide_setup():
    """The setup of tests/test_wide_v.py:21-43, draw for draw."""
    rng = np.random.RandomState(21)
    V, M, S, D = 16384, 4, 16, 32
    params = random_params(rng, V=V, M=M, S=S, D=D)
    q = rng.randn(D).astype(np.float32)
    Cs = params[0]
    h0, h1 = np.split(q, 2)
    pool0 = np.argsort(((h0[None] - Cs[0]) ** 2).sum(1))[:32]
    pool1 = np.argsort(((h1[None] - Cs[1]) ** 2).sum(1))[:32]
    n = 4000
    coarse = np.stack([rng.choice(pool0, n), rng.choice(pool1, n)], axis=1)
    fine = rng.randint(0, S, (n, M))
    ids = [f"w_{i}" for i in range(n)]
    feats = np.random.RandomState(23).randn(n, D).astype(np.float32)
    return params, q, coarse, fine, ids, feats


def _match(want, got, rtol=1e-4, atol=1e-5):
    dw = np.array([r.dist for r in want])
    dg = np.array([r.dist for r in got])
    assert len(dg) == len(dw)
    np.testing.assert_allclose(dg, dw, rtol=rtol, atol=atol)
    for a, b, d in zip(want, got, dw):
        if a.id != b.id:                       # float-rounding ties only
            assert abs(float(d) - float(b.dist)) <= 1e-4 * max(1.0, abs(d))


def test_wide_v_matches_jax_and_host(wide_setup):
    from columbiaimagesearch_tpu.index.model import LOPQModel as JaxModel
    from columbiaimagesearch_tpu.index.searcher import LOPQSearcherTPU

    params, q, coarse, fine, ids, _ = wide_setup
    ts = LOPQSearcherTorch(LOPQModel.from_numpy(*params, device="cpu"))
    assert ts.model.V >= ts.WIDE_V_THRESHOLD
    ts.add_codes((coarse, fine), ids)
    assert ts.get_nb_indexed() == len(ids)
    assert ts._dev["cell_start"] is None     # no dense table resident
    js = LOPQSearcherTPU(JaxModel(parameters=params))
    js.add_codes((coarse, fine), ids)
    hs = LOPQSearcher(LOPQModel.from_numpy(*params, device="cpu"))
    hs.add_codes((coarse, fine), ids)
    got, visited = ts.search(q, quota=50, limit=10, with_dists=True)
    want, jvisited = js.search(q, quota=50, limit=10, with_dists=True)
    host, _ = hs.search(q, quota=50, limit=10, with_dists=True)
    assert visited == jvisited
    _match(want, got)
    _match(host, got, rtol=1e-3, atol=1e-4)


def test_wide_v_incremental_and_rerank(wide_setup):
    params, q, coarse, fine, ids, feats = wide_setup
    model = LOPQModel.from_numpy(*params, device="cpu")
    s = LOPQSearcherTorch(model)
    s.add_codes((coarse[:3000], fine[:3000]), ids[:3000],
                feats=feats[:3000])
    assert s.get_nb_indexed() == 3000
    s.add_codes((coarse[3000:], fine[3000:]), ids[3000:],
                feats=feats[3000:])               # an in-place append
    assert s.get_nb_indexed() == len(ids)
    hs = LOPQSearcher(model)
    hs.add_codes((coarse, fine), ids)
    (results, visited), = s.search_batch(q[None], quota=50, limit=5,
                                         with_dists=True)
    _match(hs.search(q, quota=50, limit=5, with_dists=True)[0], results,
           rtol=1e-3, atol=1e-4)
    assert visited >= 1
    reranked, _ = s.search(q, quota=50, limit=5, with_dists=True,
                           rerank_nb=5)
    for r in reranked:                 # exact in feature space, ascending
        row = int(str(r.id).split("_")[1])
        np.testing.assert_allclose(r.dist, np.linalg.norm(feats[row] - q),
                                   rtol=1e-4, atol=1e-5)
    assert [r.dist for r in reranked] == sorted(r.dist for r in reranked)
    cells = {tuple(c) for c in coarse.tolist()}
    assert s._dev["n_occ"] == len(cells)


def _pair(V, M, S, D, n, seed, feats=True):
    """One dense and one wide searcher (threshold lowered on the
    instance) over the same rows, both with a sentinel-padded tail."""
    rng = np.random.RandomState(seed)
    params = random_params(rng, V=V, M=M, S=S, D=D)
    model = LOPQModel.from_numpy(*params, device="cpu")
    coarse = rng.randint(0, V, (n, 2))
    coarse[: n // 4] = coarse[0]            # one crowded cell
    fine = rng.randint(0, S, (n, M))
    ids = [f"r{i}" for i in range(n)]
    X = rng.randn(n, D).astype(np.float32) if feats else None
    out = []
    for wide in (False, True):
        s = LOPQSearcherTorch(model)
        if wide:
            s.WIDE_V_THRESHOLD = V
        s.add_codes((coarse[: n // 2], fine[: n // 2]), ids[: n // 2],
                    feats=None if X is None else X[: n // 2])
        s.get_nb_indexed()
        s.add_codes((coarse[n // 2:], fine[n // 2:]), ids[n // 2:],
                    feats=None if X is None else X[n // 2:])
        s.get_nb_indexed()
        out.append(s)
    queries = rng.randn(6, D).astype(np.float32)
    queries[0] = X[0] if X is not None else queries[0]
    return out, queries, coarse


@pytest.mark.parametrize("B,SB", [pytest.param(8, 0, id="sorted-square"),
                                  pytest.param(8, 2, id="strip"),
                                  pytest.param(4, 1, id="strip-B4")])
def test_wide_equals_dense_searcher_rungs(B, SB):
    (dense, wide), queries, coarse = _pair(64, 8, 32, 64, 6000, 31)
    dd, dw = dense._dev, wide._dev
    assert dd["cell_start"] is not None and dw["cell_start"] is None
    cap = dw["cells_sorted"].shape[0]
    assert cap > 6000 and int(dw["cells_sorted"][-1]) == 64 * 64
    assert dw["n_occ"] == dd["n_occ"] == len({tuple(c) for c in
                                              coarse.tolist()})
    X = torch.from_numpy(queries)
    tabs = lambda d: (d["Cs"], d["Rs"], d["mus"], d["subs"], d["codes"])
    for quota in (10, 400):
        a = lopq_query_orig(X, *tabs(dd), dd["cell_start"], dd["order"],
                            quota, V=64, B=B, Q=1024, K=32, SB=SB)
        b = lopq_query_orig(X, *tabs(dw), None, dw["order"], quota, V=64,
                            B=B, Q=1024, K=32, SB=SB,
                            cells_sorted=dw["cells_sorted"])
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    # the searchers' own ladders and reranks agree exactly too
    for R in (None, 20):
        wa = dense.search_batch(queries, quota=100, limit=10,
                                with_dists=True, rerank_nb=R)
        wb = wide.search_batch(queries, quota=100, limit=10,
                               with_dists=True, rerank_nb=R)
        for (ra, va), (rb, vb) in zip(wa, wb):
            assert va == vb
            assert [(r.id, r.dist) for r in ra] == [(r.id, r.dist)
                                                    for r in rb]


def test_wide_equals_dense_on_the_sort_free_square():
    """B*B > 16384 without strips: the sort-free wide square's counts and
    starts from searchsorted (tpu_query.py:392-396, 511-513)."""
    V = 136
    rng = np.random.RandomState(41)
    params = random_params(rng, V=V, M=4, S=16, D=32)
    model = LOPQModel.from_numpy(*params, device="cpu")
    n = 20000
    cells = torch.from_numpy((rng.randint(0, V, n) * V
                              + rng.randint(0, V, n)).astype(np.int32))
    fine = torch.from_numpy(rng.randint(0, 16, (n, 4)).astype(np.uint8))
    cap = n + 4096
    views = []
    for wide in (False, True):
        buf_c = torch.full((cap,), V * V, dtype=torch.int32)
        buf_f = torch.zeros((cap, 4), dtype=torch.uint8)
        views.append(append_and_build_csr(buf_c, buf_f, cells, fine, 0, V,
                                          wide=wide))
    (cs_d, codes_d, start_d, order_d), (cs_w, codes_w, start_w, order_w) = \
        views
    assert start_w is None and torch.equal(cs_d, cs_w)
    assert torch.equal(codes_d, codes_w) and torch.equal(order_d, order_w)
    X = torch.from_numpy(rng.randn(4, 32).astype(np.float32))
    tabs = (model.Cs, model.Rs, model.mus, model.subs, codes_d)
    for quota in (50, 3000):
        a = lopq_query_orig(X, *tabs, start_d, order_d, quota, V=V, B=V,
                            Q=4096, K=64)
        b = lopq_query_orig(X, *tabs, None, order_w, quota, V=V, B=V,
                            Q=4096, K=64, cells_sorted=cs_w)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_v_past_int32_cell_ids_raises():
    rng = np.random.RandomState(5)
    params = random_params(rng, V=4, M=2, S=4, D=8)
    model = LOPQModel.from_numpy(*params, device="cpu")
    model.V = 46341
    s = LOPQSearcherTorch(model)
    s.add_codes((np.zeros((2, 2), np.int64), np.zeros((2, 2), np.int64)),
                ["a", "b"])
    with pytest.raises(ValueError, match="46340"):
        s.get_nb_indexed()
