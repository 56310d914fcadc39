"""The port's host reference path and the searcher pieces the mesh layer
stands on, against the JAX package's on the same model: the single-vector
``LOPQModel`` API, ``multisequence``, ``LOPQSearcherBase``/``LOPQSearcher``,
``LOPQSearcherTorch.get_cell``, the rerank store's dtype plan and the
bfloat16 store.

Tolerances: codes and cells equal; vectors and ADC tables within rtol 1e-5
(fp32 on both sides, sums in another order); the host searcher's ids equal
and distances within rtol 1e-5; the bfloat16 store's ids equal to JAX's
(both round to nearest even) and its distances within rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch import device as device_mod
from columbiaimagesearch_tpu_torch.index.model import LOPQModel, LOPQModelPCA
from columbiaimagesearch_tpu_torch.index.multisequence import multisequence
from columbiaimagesearch_tpu_torch.index.searcher import (
    LOPQSearcher,
    LOPQSearcherTorch,
)

from tests.oracle_lopq import random_params

V, M, S, D = 8, 4, 16, 32


@pytest.fixture(scope="module")
def models():
    from columbiaimagesearch_tpu.index.model import (
        LOPQModel as JaxModel,
        LOPQModelPCA as JaxPCA,
    )

    rng = np.random.RandomState(4)
    params = random_params(rng, V=V, M=M, S=S, D=D)
    P = np.linalg.qr(rng.randn(48, D))[0].astype(np.float32)
    mu = rng.randn(48).astype(np.float32) * 0.1
    X = rng.randn(600, D).astype(np.float32)
    return dict(
        params=params, X=X, raw=rng.randn(50, 48).astype(np.float32),
        jm=JaxModel(parameters=params),
        tm=LOPQModel.from_numpy(*params, device="cpu"),
        jpca=JaxPCA(parameters=params + (P, mu)),
        tpca=LOPQModelPCA.from_numpy(*params, P, mu, device="cpu"))


def test_single_vector_model_api_matches_jax(models):
    jm, tm, X = models["jm"], models["tm"], models["X"]
    coarse, fine = jm.predict_batch(X)
    for i in (0, 17, 333):
        x = X[i]
        jc, tc = jm.predict(x), tm.predict(x)
        assert tc == jc
        assert [type(v) for v in tc.coarse] == [type(v) for v in jc.coarse]
        assert tm.predict_coarse(x) == jm.predict_coarse(x)
        assert tm.predict_fine(x) == jm.predict_fine(x)
        other = (int(coarse[i + 1][0]), int(coarse[i + 1][1]))
        assert tm.predict_fine(x, other) == jm.predict_fine(x, other)
        for split in (None, 0, 1):
            np.testing.assert_allclose(
                tm.project(x, jc.coarse, coarse_split=split),
                jm.project(x, jc.coarse, coarse_split=split), rtol=1e-5,
                atol=1e-6)
        np.testing.assert_allclose(tm.reconstruct(jc), jm.reconstruct(jc),
                                   rtol=1e-5, atol=1e-6)
        for split in (None, 0, 1):
            for a, b in zip(
                    tm.get_subquantizer_distances(x, jc.coarse, split),
                    jm.get_subquantizer_distances(x, jc.coarse, split)):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        cell = tm.get_cell_id_for_coarse_codes(jc.coarse)
        assert cell == jm.get_cell_id_for_coarse_codes(jc.coarse)
        assert tm.get_coarse_codes_for_cell_id(cell) == \
            jm.get_coarse_codes_for_cell_id(cell)
    np.testing.assert_allclose(tm.project_batch(X, coarse),
                               jm.project_batch(X, coarse), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tm.reconstruct_batch(coarse, fine),
                               jm.reconstruct_batch(coarse, fine),
                               rtol=1e-5, atol=1e-6)
    for r in models["raw"][:3]:
        assert models["tpca"].predict(r) == models["jpca"].predict(r)


def test_multisequence_matches_jax(models):
    from columbiaimagesearch_tpu.index.multisequence import (
        multisequence as jax_multisequence,
    )

    Cs = [c for c in models["params"][0]]
    for x in models["X"][:4]:
        want = [c for _, c in zip(range(40), jax_multisequence(x, Cs))]
        got = [c for _, c in zip(range(40), multisequence(x, Cs))]
        assert got == want


@pytest.mark.parametrize("pca", [False, True])
def test_host_searcher_matches_jax(models, pca):
    from columbiaimagesearch_tpu.index.searcher import (
        LOPQSearcher as JaxSearcher,
    )

    jm, tm = (models["jpca"], models["tpca"]) if pca else (models["jm"],
                                                           models["tm"])
    X = models["X"]
    coarse, fine = models["jm"].predict_batch(X)
    ids = [f"h{i}" for i in range(len(X))]
    js, ts = JaxSearcher(jm), LOPQSearcher(tm)
    for s in (js, ts):
        s.add_codes((coarse, fine), ids)
        s.add_codes((coarse[:20], fine[:20]), ids[:20])   # skipped again
    assert ts.get_nb_indexed() == js.get_nb_indexed() == len(X)
    queries = models["raw"][:4] if pca else X[:4] + 0.1
    for q in queries:
        for quota, limit in ((50, 10), (300, None)):
            (rw, vw), (rg, vg) = (js.search(q, quota, limit, True),
                                  ts.search(q, quota, limit, True))
            assert vg == vw
            assert [r.id for r in rg] == [r.id for r in rw]
            assert [tuple(map(int, r.code.fine)) for r in rg] == \
                [tuple(map(int, r.code.fine)) for r in rw]
            np.testing.assert_allclose([r.dist for r in rg],
                                       [r.dist for r in rw], rtol=1e-5)
        cell = tuple(int(c) for c in coarse[0])
        assert ts.get_cell(cell) == js.get_cell(cell)


def test_host_searcher_from_dict_and_data(models):
    from columbiaimagesearch_tpu.index.searcher import (
        LOPQSearcher as JaxSearcher,
    )

    jm, tm, X = models["jm"], models["tm"], models["X"]
    js, ts = JaxSearcher(jm), LOPQSearcher(tm)
    for s in (js, ts):
        s.add_data(X[:100], num_procs=4)
    codes = {f"d{i}": tm.predict(X[i]) for i in range(100, 150)}
    for s in (js, ts):
        s.add_codes_from_dict(codes)
    assert ts.nb_indexed == js.nb_indexed == 150
    (rw, _), (rg, _) = (js.search(X[120], 500, 5, True),
                        ts.search(X[120], 500, 5, True))
    assert [r.id for r in rg] == [r.id for r in rw] and rg[0].id == "d120"


def test_get_cell_matches_jax(models):
    from columbiaimagesearch_tpu.index.searcher import LOPQSearcherTPU

    jm, tm, X = models["jm"], models["tm"], models["X"]
    coarse, fine = jm.predict_batch(X)
    ids = [f"g{i}" for i in range(len(X))]
    js, ts = LOPQSearcherTPU(jm), LOPQSearcherTorch(tm)
    for s in (js, ts):
        s.add_codes((coarse, fine), ids)
    for i in (0, 5, 99):
        cell = tuple(int(c) for c in coarse[i])
        got, want = ts.get_cell(cell), js.get_cell(cell)
        assert got == want and (ids[i], tm.predict(X[i])) in got
    # The base-class query path runs over get_cell on the device searcher.
    (rw, vw), (rg, vg) = (js.get_result_quota(X[3], 40),
                          ts.get_result_quota(X[3], 40))
    assert vg == vw and rg == rw
    assert LOPQSearcherTorch(tm).get_cell((0, 0)) == []


# ------------------------------------------------------ the dtype plan


@pytest.fixture
def budgets(monkeypatch):
    """Set the device size both packages' store plans read."""
    import columbiaimagesearch_tpu.index.searcher as jsearcher

    def set_bytes(v):
        monkeypatch.setattr(jsearcher, "_HBM_LIMIT", v)
        monkeypatch.setattr(device_mod, "CPU_DEVICE_BYTES", v)
    yield set_bytes


@pytest.mark.parametrize("hbm", [15.75e9, 80e9, 2.25e9 + 1e6])
def test_plan_rerank_dtype_matches_jax(budgets, hbm):
    """test_rerank_store_economics.py:31-63 at the same budgets: the same
    decision for every (rerank_dtype, capacity, width)."""
    import jax.numpy as jnp

    from columbiaimagesearch_tpu.index.searcher import LOPQSearcherTPU

    budgets(hbm)
    plan = LOPQSearcherTorch._plan_rerank_dtype
    names = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    assert LOPQSearcherTorch.rerank_f32_budget("cpu") == pytest.approx(
        LOPQSearcherTPU.rerank_f32_budget())
    for kind in ("auto", "float32", "bfloat16"):
        for cap in (8, 1 << 10, 1 << 20, 11534336, 4 * 11534336, 1 << 26):
            for Dr in (128, 256):
                want = LOPQSearcherTPU._plan_rerank_dtype(kind, cap, Dr)
                assert plan(kind, cap, Dr, device="cpu") == names[want]


def test_searcher_store_follows_the_plan(budgets, models):
    tm, X = models["tm"], models["X"]
    budgets(2.25e9 + 1000.0)        # no float32 store fits
    s = LOPQSearcherTorch(tm)
    s.add_data(X, store_feats=True)
    assert s._snapshot()[0]["feats"].dtype == torch.bfloat16
    budgets(15.75e9)
    s = LOPQSearcherTorch(tm)
    s.add_data(X, store_feats=True)
    assert s._snapshot()[0]["feats"].dtype == torch.float32
    f32 = s._bytes_per_query(1024, 64, 100)
    s = LOPQSearcherTorch(tm, rerank_dtype="bfloat16")
    s.add_data(X, store_feats=True)
    s._pack()
    # The rerank's transients count the store's element size: the gather
    # in bfloat16 plus its float32 upcast.
    assert s._bytes_per_query(1024, 64, 100) == f32 + 100 * D * 2


@pytest.fixture(scope="module")
def bf16_pair():
    from columbiaimagesearch_tpu.index.model import LOPQModel as JaxModel
    from columbiaimagesearch_tpu.index.searcher import LOPQSearcherTPU

    rng = np.random.RandomState(3)
    params = random_params(rng, V=16, M=4, S=16, D=32)
    jm = JaxModel(parameters=params)
    tm = LOPQModel.from_numpy(*params, device="cpu")
    X = rng.randn(3000, 32).astype(np.float32)
    coarse, fine = jm.predict_batch(X)
    ids = [f"b{i}" for i in range(len(X))]
    out = []
    for cls, model in ((LOPQSearcherTPU, jm), (LOPQSearcherTorch, tm)):
        s = cls(model, probe_width=16, rerank_dtype="bfloat16")
        s.add_codes((coarse, fine), ids, feats=X)
        out.append(s)
    Q = np.concatenate([X[[7, 1500]], rng.randn(3, 32).astype(np.float32)])
    return out, X, Q


@pytest.mark.parametrize("route", ["search_batch", "device_feats"])
def test_bfloat16_store_matches_jax(bf16_pair, route):
    """The bfloat16 store (tpu_query.py:659, :744): candidates gathered in
    bfloat16 and upcast before the exact distance, on the probed rerank
    and on the fused raw-feature route; each distance equals a float32
    recompute from the bfloat16-rounded rows."""
    import jax.numpy as jnp

    (js, ts), X, Q = bf16_pair
    assert js._snapshot()[0]["feats"].dtype == jnp.bfloat16
    assert ts._snapshot()[0]["feats"].dtype == torch.bfloat16
    kw = dict(quota=300, limit=10, rerank_nb=50)
    want = js.search_batch(Q, with_dists=True, **kw)
    if route == "search_batch":
        got = ts.search_batch(Q, with_dists=True, **kw)
    else:
        Qn = Q / np.linalg.norm(Q, axis=1, keepdims=True)
        want = js.search_batch(Qn, with_dists=True, **kw)
        got = ts.search_device_feats(torch.from_numpy(Q), **kw)
        Q = Qn
    Xb = torch.from_numpy(X).to(torch.bfloat16).float().numpy()
    for qi, ((rw, vw), (rg, vg)) in enumerate(zip(want, got)):
        assert vg == vw
        assert [r.id for r in rg] == [r.id for r in rw]
        dg = np.array([r.dist for r in rg])
        np.testing.assert_allclose(dg, [r.dist for r in rw], rtol=1e-5)
        rows = [int(r.id[1:]) for r in rg]
        np.testing.assert_allclose(
            dg, np.linalg.norm(Xb[rows] - Q[qi], axis=1), rtol=1e-5)


def test_bfloat16_brute_plan_matches_jax(bf16_pair, monkeypatch):
    from columbiaimagesearch_tpu.index import tpu_query

    from columbiaimagesearch_tpu_torch.index import searcher as smod

    (js, ts), X, Q = bf16_pair
    for s, mod in ((js, tpu_query), (ts, smod)):
        monkeypatch.setattr(mod, "prefer_brute", lambda *a, **k: True)
        monkeypatch.setattr(s, "probe_width", None)
    want = js.search_batch(Q, quota=300, limit=10, with_dists=True,
                           rerank_nb=50)
    got = ts.search_batch(Q, quota=300, limit=10, with_dists=True,
                          rerank_nb=50)
    assert ts.probe_stats["brute_waves"] == 1
    Xb = torch.from_numpy(X).to(torch.bfloat16).float().numpy()
    for qi, ((rw, _), (rg, _)) in enumerate(zip(want, got)):
        assert [r.id for r in rg] == [r.id for r in rw]
        d = np.linalg.norm(Xb - Q[qi], axis=1)
        np.testing.assert_allclose([r.dist for r in rg],
                                   np.sort(d)[:10], rtol=1e-5)


def test_facade_passes_dtype_and_capacity(models):
    """test_rerank_store_economics.py:169-186: the conf's rerank_dtype and
    capacity_hint reach the probed searcher (and the sharded one)."""
    from columbiaimagesearch_tpu_torch.common.factory import build_searcher
    from columbiaimagesearch_tpu_torch.parallel.sharded import (
        ShardedLOPQSearcher,
    )
    from columbiaimagesearch_tpu_torch.store import KVIndexer, MemoryStorer

    tm, X = models["tm"], models["X"]
    conf = {"SEARCHLOPQ_model_type": "lopq", "SEARCHLOPQ_lopq_V": tm.V,
            "SEARCHLOPQ_lopq_M": tm.M,
            "SEARCHLOPQ_store_rerank_feats": True,
            "SEARCHLOPQ_rerank_dtype": "bfloat16",
            "SEARCHLOPQ_capacity_hint": 4096}
    for sharded in (False, True):
        fac = build_searcher(dict(conf, SEARCHLOPQ_sharded=sharded),
                             indexer=KVIndexer(":memory:"),
                             storer=MemoryStorer(), device="cpu")
        assert (fac.rerank_dtype, fac.capacity_hint) == ("bfloat16", 4096)
        fac.model = tm
        fac._init_device_searcher()
        assert isinstance(fac.searcher, ShardedLOPQSearcher) == sharded
        assert fac.searcher.rerank_dtype == "bfloat16"
        assert fac.searcher.capacity_hint == 4096
        if not sharded:
            fac.searcher.add_data(X[:300], store_feats=True)
            assert fac.searcher._snapshot()[0]["feats"].dtype == \
                torch.bfloat16
