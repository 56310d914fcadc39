"""The port's row-sharded index and searcher (``parallel/sharded.py``)
against the JAX package's on the same models, codes, ids and features: the
JAX side on the 8-device CPU mesh of tests/conftest.py, the port on 8
logical CPU shards. Mirrors tests/test_sharded_searcher.py, the sharded
cases of tests/test_device_rerank.py and tests/test_probe_escalation.py,
and the mesh case of tests/test_rerank_store_economics.py.

Ranked results: ids equal (except swaps of tied distances) and distances
within rtol 1e-5. Plan choices that the two packages' cost constants would
make differently (brute vs probe ladder) are pinned in both.
"""

import threading
import time

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch import device as device_mod
from columbiaimagesearch_tpu_torch.index import searcher as searcher_mod
from columbiaimagesearch_tpu_torch.index.model import LOPQModel, LOPQModelPCA
from columbiaimagesearch_tpu_torch.index.probe import probe_ladder
from columbiaimagesearch_tpu_torch.index.searcher import LOPQSearcher
from columbiaimagesearch_tpu_torch.parallel.mesh import SHARD_AXIS, make_mesh
from columbiaimagesearch_tpu_torch.parallel.sharded import (
    ShardedLOPQIndex,
    ShardedLOPQSearcher,
)

from tests.oracle_lopq import adc_distance, random_params
from tests.test_torch_parallel import assert_pairs_match

MESH8 = dict(axis=SHARD_AXIS, devices=["cpu"] * 8)


def _models(seed, V=8, M=4, S=16, D=32):
    from columbiaimagesearch_tpu.index.model import LOPQModel as JaxModel

    rs = np.random.RandomState(seed)
    params = random_params(rs, V=V, M=M, S=S, D=D)
    return (rs, params, JaxModel(parameters=params),
            LOPQModel.from_numpy(*params, device="cpu"))


def _index_pair(jm, tm, **kw):
    from columbiaimagesearch_tpu.parallel.sharded import (
        ShardedLOPQIndex as JaxIndex,
    )

    return JaxIndex(jm, **kw), ShardedLOPQIndex(tm, mesh=make_mesh(**MESH8),
                                                **kw)


@pytest.fixture
def pin_plan(monkeypatch):
    """Pin the brute-vs-ladder choice in both packages (the port's sharded
    index makes it in the wave code it shares with the single device)."""
    from columbiaimagesearch_tpu.index import tpu_query

    def pin(brute):
        monkeypatch.setattr(tpu_query, "prefer_brute",
                            lambda *a, **k: brute)
        monkeypatch.setattr(searcher_mod, "prefer_brute",
                            lambda *a, **k: brute)
    return pin


# ------------------------------------------------------------ the facade


def _fill(kv, feats, sha1s, extr="sentibank_feat_full_image", batch=200):
    """Rows and update rows as tests/test_store_searcher.py:11-37 writes
    them, through either package's KVIndexer."""
    from columbiaimagesearch_tpu_torch.extraction.featsio import (
        normfeatB64encode,
    )

    kv.batch_update_size = batch
    for b in range(0, len(sha1s), batch):
        chunk = list(range(b, min(b + batch, len(sha1s))))
        kv.push_dict_rows({sha1s[i]: {
            f"ext:{extr}": normfeatB64encode(feats[i]),
            f"ext:{extr}_processed": "1",
            "info:s3_url": f"http://imgs/{sha1s[i]}.jpg"} for i in chunk},
            kv.table_sha1infos_name)
        update_id, _ = kv.get_next_update_id(extr_type=extr)
        kv.push_dict_rows(
            {update_id: {kv.get_col_listsha1s():
                         ",".join(sha1s[i] for i in chunk),
                         kv.get_col_upcreate(): "now"}},
            kv.table_updateinfos_name)


def test_sharded_facade_end_to_end():
    """SearcherLOPQ(sharded=True) on both packages over the same store and
    model (test_sharded_searcher.py:11-28): the query image first, at
    exact distance ~0 (host rerank), and the same answers."""
    from columbiaimagesearch_tpu.index.model import LOPQModel as JaxModel
    from columbiaimagesearch_tpu.parallel.sharded import (
        ShardedLOPQSearcher as JaxSharded,
    )
    from columbiaimagesearch_tpu.searcher.searcher_lopq import (
        SearcherLOPQ as JaxSearcherLOPQ,
    )
    from columbiaimagesearch_tpu.store import KVIndexer as JaxKVIndexer

    from columbiaimagesearch_tpu_torch.searcher.searcher_lopq import (
        SearcherLOPQ,
    )
    from columbiaimagesearch_tpu_torch.store import KVIndexer

    rng = np.random.RandomState(0)
    centers = rng.randn(24, 64).astype(np.float32) * 3
    feats = (centers[rng.randint(0, 24, 400)]
             + 0.2 * rng.randn(400, 64).astype(np.float32))
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    sha1s = [f"{i:040X}" for i in range(400)]
    tm = LOPQModel.fit(feats, n_init=1, random_state=0, V=8, M=4,
                       subquantizer_clusters=32, device="cpu")
    jm = JaxModel(parameters=(
        tuple(c.numpy() for c in tm.Cs), tuple(r.numpy() for r in tm.Rs),
        tuple(m.numpy() for m in tm.mus),
        tuple([s.numpy() for s in half] for half in tm.subs)))
    out = []
    for cls, kv_cls, model in ((JaxSearcherLOPQ, JaxKVIndexer, jm),
                               (SearcherLOPQ, KVIndexer, tm)):
        kv = kv_cls(path=":memory:")
        _fill(kv, feats, sha1s)
        kw = dict(model_type="lopq", V=8, M=4, subquantizer_clusters=32,
                  model=model, detector_type="full",
                  featurizer_type="sentibank", indexer=kv, storer=None,
                  sharded=True, reranking=True, rerank_nb=200)
        if cls is SearcherLOPQ:
            kw["device"] = "cpu"
        fac = cls(**kw)
        assert fac.get_nb_indexed() == 400
        out.append(fac)
    jfac, fac = out
    assert isinstance(jfac.searcher, JaxSharded)
    assert isinstance(fac.searcher, ShardedLOPQSearcher)
    assert list(fac.searcher.index.devices) == [torch.device("cpu")]
    for i in (55, 3, 301):
        got = fac.search_from_feats([(sha1s[i], None)], [feats[i]],
                                    {"max_returned": 5})
        want = jfac.search_from_feats([(sha1s[i], None)], [feats[i]],
                                      {"max_returned": 5})
        g = got["AllSimilarImages"][0]["SimilarImages"]
        w = want["AllSimilarImages"][0]["SimilarImages"]
        assert g["ImageSha1s"][0] == sha1s[i] and g["Distances"][0] < 1e-3
        assert g["ImageSha1s"] == w["ImageSha1s"]
        np.testing.assert_allclose(g["Distances"], w["Distances"],
                                   rtol=1e-5, atol=1e-6)


# -------------------------------------------- indexing and the probed path


def test_sharded_incremental_append_matches_host_and_jax():
    """Three refresh rounds with duplicate re-insertions
    (test_sharded_searcher.py:61-93): the port's sharded searcher equals
    the port's host LOPQSearcher and JAX's sharded searcher."""
    from columbiaimagesearch_tpu.parallel.sharded import (
        ShardedLOPQSearcher as JaxSharded,
    )

    rs, _, jm, tm = _models(11)
    X = rs.randn(480, 32).astype(np.float32)
    coarse, fine = jm.predict_batch(X)
    ids = np.asarray([f"s{i}" for i in range(480)], dtype=object)

    sharded = ShardedLOPQSearcher(tm, mesh=make_mesh(**MESH8))
    jsharded = JaxSharded(jm)
    host = LOPQSearcher(tm)
    for a, b in [(0, 200), (200, 400), (400, 480)]:
        for s in (sharded, jsharded, host):
            s.add_codes((coarse[a:b], fine[a:b]), ids[a:b])
            s.add_codes((coarse[:50], fine[:50]), ids[:50])
        assert (sharded.get_nb_indexed() == host.get_nb_indexed()
                == jsharded.get_nb_indexed() == b)
        for q in (1, 7):
            res_s, vis = sharded.search(X[q], quota=480, limit=5,
                                        with_dists=True)
            res_h, _ = host.search(X[q], quota=480, limit=5,
                                   with_dists=True)
            res_j, jvis = jsharded.search(X[q], quota=480, limit=5,
                                          with_dists=True)
            assert [r.id for r in res_s] == [r.id for r in res_h], (a, b, q)
            np.testing.assert_allclose([r.dist for r in res_s],
                                       [r.dist for r in res_h], rtol=1e-5)
            assert vis == jvis
            assert_pairs_match([(r.id, r.dist) for r in res_j],
                               [(r.id, r.dist) for r in res_s])


@pytest.fixture(scope="module")
def hard_setup():
    """tests/test_probe_escalation.py:15-35: every row in cells of the 64
    farthest coarse clusters per split, so B=64 finds nothing."""
    rng = np.random.RandomState(7)
    V, M, S, D = 128, 4, 16, 32
    params = random_params(rng, V=V, M=M, S=S, D=D)
    q = rng.randn(D).astype(np.float32)
    Cs = params[0]
    h0, h1 = np.split(q, 2)
    far0 = np.argsort(((h0[None] - Cs[0]) ** 2).sum(1))[64:]
    far1 = np.argsort(((h1[None] - Cs[1]) ** 2).sum(1))[64:]
    n = 500
    coarse = np.stack([rng.choice(far0, n), rng.choice(far1, n)], axis=1)
    fine = rng.randint(0, S, (n, M))
    ids = [f"hard_{i}" for i in range(n)]
    return params, q, coarse, fine, ids


def test_sharded_batch_escalates(hard_setup):
    """test_probe_escalation.py:100-119: each shard probes until its own
    count covers the quota; results are oracle-exact, nearer-or-equal to
    the host searcher's, and equal to JAX's sharded fan-out."""
    from columbiaimagesearch_tpu.index.model import LOPQModel as JaxModel

    params, q, coarse, fine, ids = hard_setup
    jm = JaxModel(parameters=params)
    tm = LOPQModel.from_numpy(*params, device="cpu")
    jidx, idx = _index_pair(jm, tm)
    for i in (jidx, idx):
        i.build(coarse, fine, ids)
    Q = np.stack([q, q * 0.5])
    waves = idx.search_batch(Q, quota=50, limit=10)
    jwaves = jidx.search_batch(Q, quota=50, limit=10)
    code_of = {ids[i]: (coarse[i], fine[i]) for i in range(len(ids))}
    pairs, visited = waves[0]
    assert len(pairs) == 10
    for rid, d in pairs[:5]:
        co, fi = code_of[rid]
        want = adc_distance(q, tuple(co), tuple(fi), *params)
        np.testing.assert_allclose(d, want, rtol=1e-3, atol=1e-4)
    host = LOPQSearcher(tm)
    host.add_codes((coarse, fine), ids)
    r_host, _ = host.search(q, quota=50, limit=10, with_dists=True)
    assert np.all(np.asarray([d for _, d in pairs])
                  <= np.asarray([r.dist for r in r_host]) + 1e-3)
    for (g, gv), (w, wv) in zip(waves, jwaves):
        assert gv == wv
        assert_pairs_match(w, g)
    assert idx.probe_stats["escalated_queries"] == \
        jidx.probe_stats["escalated_queries"] > 0


# ------------------------------------------------------------ the rerank


def _rerank_corpus(seed, n):
    rs, _, jm, tm = _models(seed, V=16, M=4, S=16, D=32)
    X = rs.randn(n, 32).astype(np.float32)
    coarse, fine = jm.predict_batch(X)
    return rs, jm, tm, X, coarse, fine


def test_sharded_rerank_matches_exact_order_and_jax(pin_plan):
    """test_device_rerank.py:190-217: the planted row first at distance
    ~0, exact distances in order, and JAX's mesh rerank's answers."""
    pin_plan(False)
    _, jm, tm, X, coarse, fine = _rerank_corpus(5, 2000)
    ids = [f"sh_{i}" for i in range(2000)]
    jidx, idx = _index_pair(jm, tm)
    for i in (jidx, idx):
        i.build(coarse, fine, ids, feats=X)
    assert idx.has_rerank_feats
    Q = np.stack([X[777], X[12] + 0.01])
    waves = idx.search_batch(Q, quota=300, limit=20, rerank_nb=20)
    jwaves = jidx.search_batch(Q, quota=300, limit=20, rerank_nb=20)
    pairs, _ = waves[0]
    assert pairs and pairs[0][0] == ids[777]
    np.testing.assert_allclose(pairs[0][1], 0.0, atol=1e-4)
    d = np.asarray([p[1] for p in pairs])
    assert np.all(np.diff(d) >= -1e-6)
    for rid, dist in pairs[:5]:
        np.testing.assert_allclose(
            dist, np.linalg.norm(X[int(rid[3:])] - X[777]), rtol=1e-5,
            atol=1e-6)
    for (g, gv), (w, wv) in zip(waves, jwaves):
        assert gv == wv
        assert_pairs_match(w, g)


def test_sharded_incremental_feats_append():
    """test_device_rerank.py:220-242: an append with features keeps the
    store (planted row first); a featureless append drops it."""
    _, jm, tm, X, coarse, fine = _rerank_corpus(6, 1500)
    ids = [f"in_{i}" for i in range(len(X))]
    idx = ShardedLOPQIndex(tm, mesh=make_mesh(**MESH8))
    idx.build(coarse[:1000], fine[:1000], ids[:1000], feats=X[:1000])
    idx.append(coarse[1000:], fine[1000:], ids[1000:], feats=X[1000:])
    assert idx.has_rerank_feats and idx.nb_indexed == 1500
    pairs, _ = idx.search(X[1234], quota=300, limit=10, rerank_nb=10)
    assert pairs[0][0] == ids[1234]
    np.testing.assert_allclose(pairs[0][1], 0.0, atol=1e-4)
    idx.append(coarse[:1], fine[:1], ["extra_0"])
    assert not idx.has_rerank_feats
    assert idx._shards[0]["feats"] is None
    with pytest.raises(ValueError, match="resident feature store"):
        idx.search(X[0], quota=300, limit=10, rerank_nb=10)


def test_sharded_rerank_depth_decoupled(pin_plan):
    """test_device_rerank.py:274-299: limit < rerank_nb emits only the
    first rows of the full-depth answer."""
    pin_plan(False)
    _, jm, tm, X, coarse, fine = _rerank_corpus(11, 2000)
    ids = [f"sd_{i}" for i in range(2000)]
    idx = ShardedLOPQIndex(tm, mesh=make_mesh(**MESH8))
    idx.build(coarse, fine, ids, feats=X)
    q = X[321]
    pairs_f, _ = idx.search_batch(q[None], quota=400, limit=80,
                                  rerank_nb=80)[0]
    pairs_s, _ = idx.search_batch(q[None], quota=400, limit=8,
                                  rerank_nb=80)[0]
    assert len(pairs_s) == 8
    assert [p[0] for p in pairs_s] == [p[0] for p in pairs_f][:8]
    np.testing.assert_allclose([p[1] for p in pairs_s],
                               [p[1] for p in pairs_f][:8], rtol=1e-5,
                               atol=1e-6)
    assert pairs_s[0][0] == ids[321]


def test_sharded_brute_plan_exact(pin_plan):
    """test_sharded_searcher.py:96-150: the brute plan across shards is
    exact (numpy oracle, JAX's mesh brute); the grid + rerank plan reports
    true L2 for whatever it ranks."""
    rs, _, jm, tm = _models(13)
    X = rs.randn(500, 32).astype(np.float32)
    coarse, fine = jm.predict_batch(X)
    ids = np.asarray([f"s{i}" for i in range(500)], dtype=object)
    jidx, idx = _index_pair(jm, tm)
    for i in (jidx, idx):
        i.build(np.asarray(coarse, np.int32).reshape(500, 2),
                np.asarray(fine, np.int32), ids=ids, feats=X)
    Q = X[[3, 77, 411]] + 0.05 * rs.randn(3, 32).astype(np.float32)
    pin_plan(True)
    out = idx.search_batch(Q, quota=500, limit=5, rerank_nb=64)
    jout = jidx.search_batch(Q, quota=500, limit=5, rerank_nb=64)
    assert idx.probe_stats.get("brute_waves", 0) == 1
    for qi, (pairs, cells) in enumerate(out):
        d = np.linalg.norm(X - Q[qi][None, :], axis=1)
        want = np.argsort(d, kind="stable")[:5]
        assert [p[0] for p in pairs] == [f"s{i}" for i in want]
        np.testing.assert_allclose([p[1] for p in pairs], d[want],
                                   rtol=1e-5)
        assert [p[0] for p in pairs] == [p[0] for p in jout[qi][0]]
        assert cells == jout[qi][1]
    pin_plan(False)
    out_grid = idx.search_batch(Q, quota=500, limit=5, rerank_nb=64)
    assert idx.probe_stats.get("brute_waves", 0) == 1
    for qi, (pg, _cells) in enumerate(out_grid):
        rows = [int(p[0][1:]) for p in pg]
        want = np.linalg.norm(X[rows] - Q[qi][None, :], axis=1)
        np.testing.assert_allclose([p[1] for p in pg], want, rtol=1e-5)


def test_sharded_brute_after_append(pin_plan):
    """test_sharded_searcher.py:153-182: the per-shard row norms follow
    an incremental append."""
    pin_plan(True)
    rs, _, jm, tm = _models(14)
    X = rs.randn(300, 32).astype(np.float32)
    coarse, fine = jm.predict_batch(X)
    co = np.asarray(coarse, np.int32).reshape(-1, 2)
    fi = np.asarray(fine, np.int32)
    idx = ShardedLOPQIndex(tm, mesh=make_mesh(**MESH8))
    idx.build(co[:200], fi[:200],
              ids=np.asarray([f"a{i}" for i in range(200)], dtype=object),
              feats=X[:200])
    idx.search_batch(X[[5]], quota=300, limit=3, rerank_nb=32)
    idx.append(co[200:], fi[200:],
               ids=np.asarray([f"a{i}" for i in range(200, 300)],
                              dtype=object), feats=X[200:])
    pairs, _ = idx.search_batch(X[[250]], quota=300, limit=3,
                                rerank_nb=32)[0]
    assert pairs[0][0] == "a250" and pairs[0][1] < 1e-3


# --------------------------------------------------- refresh and serving


def test_sharded_query_blocks_on_inflight_upload():
    """test_sharded_searcher.py:185-220: a query snapshots under the swap
    lock, which an upload holds for its whole mutation."""
    rs, _, jm, tm = _models(5)
    X = rs.randn(400, 32).astype(np.float32)
    coarse, fine = jm.predict_batch(X)
    idx = ShardedLOPQIndex(tm, mesh=make_mesh(**MESH8))
    idx.build(np.asarray(coarse, np.int32).reshape(-1, 2),
              np.asarray(fine, np.int32), feats=X)
    idx.search_batch(X[:2], quota=50, limit=3)
    got = {}

    def query():
        got["out"] = idx.search_batch(X[:2], quota=50, limit=3)
        got["t"] = time.perf_counter()

    with idx._swaplock:
        t = threading.Thread(target=query)
        t.start()
        time.sleep(0.3)
        assert "out" not in got, "query must block on the swap lock"
        released = time.perf_counter()
    t.join(10)
    assert got["t"] >= released
    assert len(got["out"]) == 2 and len(got["out"][0][0]) == 3


def test_sharded_capacity_plan_amortizes_appends():
    """test_sharded_searcher.py:223-256: 8k-row appends on a sized index
    grow neither the host mirror nor the shard buffers, which are written
    in place."""
    rs, _, jm, tm = _models(6)
    from columbiaimagesearch_tpu.parallel.sharded import (
        ShardedLOPQIndex as JaxIndex,
    )

    idx = ShardedLOPQIndex(tm, mesh=make_mesh(**MESH8),
                           capacity_hint=200_000)
    X = rs.randn(4096, 32).astype(np.float32)
    coarse, fine = jm.predict_batch(X)
    idx.build(np.asarray(coarse, np.int32).reshape(-1, 2),
              np.asarray(fine, np.int32), feats=X)
    jidx = JaxIndex(jm, capacity_hint=200_000)
    jidx.build(np.asarray(coarse, np.int32).reshape(-1, 2),
               np.asarray(fine, np.int32), feats=X)
    cap_host0, cap_per0 = idx._host_capn, idx._cap_per
    assert cap_host0 >= 200_000
    assert (cap_host0, cap_per0) == (jidx._host_capn, jidx._cap_per)
    base_c, base_f = idx._cells_host, idx._shards[0]["feats"]
    for _ in range(3):
        Y = rs.randn(8192, 32).astype(np.float32)
        c2, f2 = jm.predict_batch(Y)
        idx.append(np.asarray(c2, np.int32).reshape(-1, 2),
                   np.asarray(f2, np.int32), feats=Y)
    assert idx._host_capn == cap_host0 and idx._cap_per == cap_per0
    assert idx._cells_host is base_c
    assert idx._shards[0]["feats"] is base_f


def test_sharded_prewarm_ladder_leaves_no_state():
    """test_sharded_searcher.py:259-284: every rung and the brute plan at
    each wave bucket; stats, hint and EMA untouched."""
    rs, _, jm, tm = _models(9)
    X = rs.randn(300, 32).astype(np.float32)
    coarse, fine = jm.predict_batch(X)
    s = ShardedLOPQSearcher(tm, mesh=make_mesh(**MESH8))
    s.add_codes((np.asarray(coarse, np.int32).reshape(-1, 2),
                 np.asarray(fine, np.int32)),
                ids=[f"p{i}" for i in range(300)], feats=X)
    n = s.prewarm_ladder(quota=50, limit=5, rerank_nb=10, waves=(1, 3))
    assert n == 2 * (len(probe_ladder(tm.V, None)) + 1)
    assert s.index.probe_stats["waves"] == 0
    assert s.index._tier_hint == 0 and s.index._yield_ema is None
    res, _vis = s.search(X[11], quota=100, limit=3, with_dists=True,
                         rerank_nb=16)
    assert res[0].id == "p11"


def test_sharded_prewarm_ladder_pca_model():
    """test_sharded_searcher.py:287-301: prewarm feeds raw-width zeros to
    a PCA model; a raw query finds its own row."""
    rng = np.random.RandomState(21)
    raw = rng.rand(400, 48).astype(np.float32)
    raw /= np.linalg.norm(raw, axis=1, keepdims=True)
    pm = LOPQModelPCA.fit(raw, pca_dims=16, kmeans_coarse_iters=2,
                          kmeans_local_iters=2, n_init=1, random_state=0,
                          V=8, M=4, subquantizer_clusters=16, device="cpu")
    coarse, fine = pm.predict_batch(raw)
    s = ShardedLOPQSearcher(pm, mesh=make_mesh(**MESH8))
    s.add_codes((coarse, fine), ids=[f"p{i}" for i in range(400)])
    n = s.prewarm_ladder(quota=20, limit=5, waves=(1,))
    assert n == len(probe_ladder(pm.V, s.index.probe_width))
    assert s.index.probe_stats["waves"] == 0
    res, _vis = s.search(raw[7], quota=400, limit=3, with_dists=True)
    assert any(r.id == "p7" for r in res)


def test_sharded_waves_split_by_the_wave_cap(monkeypatch):
    """A wave larger than the per-launch cap runs in parts with the same
    answers as one launch."""
    rs, _, jm, tm = _models(17)
    X = rs.randn(600, 32).astype(np.float32)
    coarse, fine = jm.predict_batch(X)
    idx = ShardedLOPQIndex(tm, mesh=make_mesh(**MESH8))
    idx.build(coarse, fine)
    Q = rs.randn(7, 32).astype(np.float32)
    whole = idx.search_batch(Q, quota=60, limit=5)
    calls = []
    real = idx._run_shards

    def counted(Xi, *a):
        calls.append(Xi.shape[0])
        return real(Xi, *a)

    monkeypatch.setattr(idx, "_run_shards", counted)
    monkeypatch.setattr(idx, "_wave_cap", lambda Q, K: lambda rung: 3)
    parts = idx.search_batch(Q, quota=60, limit=5)
    assert max(calls) <= 3 and sum(calls) >= 7
    assert parts == whole


# --------------------------------------------------- the bfloat16 store


@pytest.fixture
def budgets(monkeypatch):
    """Set the device size both packages' store plans read."""
    import columbiaimagesearch_tpu.index.searcher as jsearcher

    def set_bytes(v):
        monkeypatch.setattr(jsearcher, "_HBM_LIMIT", v)
        monkeypatch.setattr(device_mod, "CPU_DEVICE_BYTES", v)
    yield set_bytes


def test_mesh_store_dtype_plan_and_bfloat16_parity(budgets, pin_plan):
    """test_rerank_store_economics.py:140-166: a budget the shard slices
    exceed gives bfloat16 shards, a roomy one float32; the bfloat16 mesh
    rerank equals JAX's on the same rounding (round to nearest even)."""
    import jax.numpy as jnp

    pin_plan(False)
    _, jm, tm, X, coarse, fine = _rerank_corpus(1, 512)
    jidx, idx = _index_pair(jm, tm)
    budgets(2.25e9 + 1000.0)
    for i in (jidx, idx):
        i.build(coarse, fine, feats=X[:, :32])
    assert jidx._buf_feats.dtype == jnp.bfloat16
    assert all(sh["feats"].dtype == torch.bfloat16 for sh in idx._shards)
    Q = X[[2, 100, 300]]
    got = idx.search_batch(Q, quota=50, limit=5, rerank_nb=8)
    want = jidx.search_batch(Q, quota=50, limit=5, rerank_nb=8)
    Xb = torch.from_numpy(X).to(torch.bfloat16).float().numpy()
    for qi, ((g, gv), (w, wv)) in enumerate(zip(got, want)):
        assert gv == wv and len(g) > 0
        assert_pairs_match(w, g)
        rows = [int(r) for r, _ in g]
        np.testing.assert_allclose(
            [d for _, d in g], np.linalg.norm(Xb[rows] - Q[qi], axis=1),
            rtol=1e-5)
    budgets(15.75e9)
    idx2 = ShardedLOPQIndex(tm, mesh=make_mesh(**MESH8))
    idx2.build(coarse, fine, feats=X)
    assert idx2._shards[0]["feats"].dtype == torch.float32
    # Logical shards share their device's budget: eight float32 slices
    # that one device cannot hold make every slice bfloat16.
    cap8 = 8 * 4 * idx2._cap_per * 32
    budgets(2.25e9 + cap8 - 1.0)
    idx3 = ShardedLOPQIndex(tm, mesh=make_mesh(**MESH8))
    idx3.build(coarse, fine, feats=X)
    assert idx3._shards[0]["feats"].dtype == torch.bfloat16
