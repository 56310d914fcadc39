"""The serving fast path from raw features (port: ``query.fused_feat_query``,
``query.fused_feat_brute``, ``LOPQSearcherTorch.search_device_feats`` and
``prewarm_ladder``) against the JAX package on the same models, codes,
ids, features and raw queries.

Two kinds of input, as in tests/test_torch_exhaustive.py:

- ``random``: gaussian tables, orthogonal rotations and PCA; ids equal
  except swaps between float-rounding ties, distances at rtol/atol 1e-5.
- ``integer``: integer tables, signed-permutation rotations and PCA, zero
  means, integer features and one-hot raw queries (unit norm, so the
  normalization is exact). Every distance is exact in fp32 on both sides
  and ties are everywhere: ids must come back equal, in order.

Waves arrive padded with zero rows and ``n_valid``, as the featurizer's
wave route hands them over; the fused functions' norms are guarded, so the
zero rows stay finite.
"""

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch.index.model import LOPQModel, LOPQModelPCA
from columbiaimagesearch_tpu_torch.index.query import (
    fused_feat_brute,
    fused_feat_query,
    normalize_project,
    unpack_query_out,
)
from columbiaimagesearch_tpu_torch.index.searcher import LOPQSearcherTorch

V, M, S, D, D_RAW = 8, 4, 16, 32, 48
N = 1500
QUOTA, LIMIT, RNB = 200, 10, 40


def _setup(kind, pca, seed=0):
    """(JAX searcher, port searcher, raw queries [6, D_in] with 2 zero pad
    rows at the end), both indexed with the same codes, ids and
    index-space features."""
    from columbiaimagesearch_tpu.index.model import (
        LOPQModel as JaxModel,
        LOPQModelPCA as JaxPCA,
    )
    from columbiaimagesearch_tpu.index.searcher import LOPQSearcherTPU

    from tests.test_torch_exhaustive import _params

    rng = np.random.RandomState(seed)
    params = _params(rng, kind, V=V, M=M, S=S, D=D)
    D_in = D_RAW if pca else D
    if kind == "integer":
        P = np.zeros((D_RAW, D), np.float32)
        P[rng.choice(D_RAW, D, replace=False), np.arange(D)] = rng.choice(
            [-1.0, 1.0], D)
        mu = np.zeros(D_RAW, np.float32)
        feats = rng.randint(-3, 4, (N, D)).astype(np.float32)
        Q = np.zeros((4, D_in), np.float32)
        Q[np.arange(4), rng.choice(D_in, 4, replace=False)] = \
            rng.choice([-1.0, 1.0], 4)
    else:
        P = np.linalg.qr(rng.randn(D_RAW, D))[0].astype(np.float32)
        mu = 0.01 * rng.randn(D_RAW).astype(np.float32)
        feats = rng.randn(N, D).astype(np.float32)
        Q = rng.randn(4, D_in).astype(np.float32) * 3.0
    if pca:
        jm = JaxPCA(parameters=params + (P, mu))
        tm = LOPQModelPCA.from_numpy(*params, P, mu, device="cpu")
    else:
        jm = JaxModel(parameters=params)
        tm = LOPQModel.from_numpy(*params, device="cpu")
    coarse = rng.randint(0, V, (N, 2))
    fine = rng.randint(0, S, (N, M))
    ids = [f"img{i}" for i in range(N)]
    js, ts = LOPQSearcherTPU(jm), LOPQSearcherTorch(tm)
    for s in (js, ts):
        s.add_codes((coarse, fine), ids, feats=feats)
    X = np.concatenate([Q, np.zeros((2, D_in), np.float32)])
    return js, ts, X


def _assert_same(want, got, exact):
    assert len(got) == len(want)
    for (rw, vw), (rg, vg) in zip(want, got):
        assert vg == vw
        ig, iw = [r.id for r in rg], [r.id for r in rw]
        dg = np.array([r.dist for r in rg])
        dw = np.array([r.dist for r in rw])
        assert len(ig) == len(iw)
        if exact:
            assert ig == iw
            np.testing.assert_array_equal(dg, dw)
        else:
            np.testing.assert_allclose(dg, dw, rtol=1e-5, atol=1e-5)
            for a, b, d in zip(iw, ig, dw):
                assert a == b or any(
                    abs(dw[j] - d) <= 1e-5 * max(1.0, abs(d))
                    for j in range(len(iw)) if iw[j] == b), (iw, ig)


@pytest.mark.parametrize("rerank", [None, RNB])
@pytest.mark.parametrize("pca", [False, True])
@pytest.mark.parametrize("kind", ["random", "integer"])
def test_search_device_feats_matches_jax(kind, pca, rerank):
    """A padded wave with ``n_valid`` through both packages' fast path
    (pinned rung: no brute plan, whose cost constants differ)."""
    import jax.numpy as jnp

    js, ts, X = _setup(kind, pca)
    js.probe_width = ts.probe_width = 4
    want = js.search_device_feats(jnp.asarray(X), quota=QUOTA, limit=LIMIT,
                                  rerank_nb=rerank, n_valid=4)
    got = ts.search_device_feats(torch.from_numpy(X), quota=QUOTA,
                                 limit=LIMIT, rerank_nb=rerank, n_valid=4)
    assert len(got) == 4 and all(r.code is None for r in got[0][0])
    _assert_same(want, got, exact=kind == "integer")


@pytest.mark.parametrize("pca", [False, True])
def test_search_device_feats_default_ladder_matches_jax(pca):
    """The adaptive ladder (escalation, tier hint) on the fast path."""
    import jax.numpy as jnp

    js, ts, X = _setup("random", pca, seed=1)
    for rep in range(2):
        want = js.search_device_feats(jnp.asarray(X[:4]), quota=QUOTA,
                                      limit=LIMIT)
        got = ts.search_device_feats(torch.from_numpy(X[:4]), quota=QUOTA,
                                     limit=LIMIT)
        _assert_same(want, got, exact=False)
    assert ts.probe_stats["waves"] == js.probe_stats["waves"] == 2


def test_search_device_feats_equals_host_route():
    """Raw features on the fast path equal ``search_batch`` on the same
    rows normalized on the host (the JAX contract of
    tests/test_fused_serving.py:58)."""
    _, ts, X = _setup("random", True, seed=2)
    got = ts.search_device_feats(torch.from_numpy(X[:4]), quota=QUOTA,
                                 limit=LIMIT, rerank_nb=RNB)
    Xn = X[:4] / np.linalg.norm(X[:4], axis=1, keepdims=True)
    want = ts.search_batch(Xn, quota=QUOTA, limit=LIMIT, with_dists=True,
                           with_codes=False, rerank_nb=RNB)
    _assert_same(want, got, exact=False)


@pytest.mark.parametrize("kind", ["random", "integer"])
@pytest.mark.parametrize("rerank", [0, RNB])
def test_fused_feat_query_matches_jax(kind, rerank):
    """``fused_feat_query`` on the whole padded wave, zero rows included:
    the guarded norms keep them finite, and every output equals the JAX
    program's (rows are insertion-order in both, whatever the layout)."""
    import jax.numpy as jnp

    from columbiaimagesearch_tpu.index.searcher import _query_geometry
    from columbiaimagesearch_tpu.index.tpu_query import (
        fused_feat_query as jax_ffq,
    )

    js, ts, X = _setup(kind, True, seed=3)
    ts.get_nb_indexed()
    js.get_nb_indexed()
    dj, dt = js._dev, ts._dev
    _K, Q, K, R, K_emit = _query_geometry(QUOTA, LIMIT, N, rerank or None)
    want = np.asarray(jax_ffq(
        jnp.asarray(X), dj["pca_P"], dj["pca_mu"], dj["Cs"], dj["Rs"],
        dj["mus"], dj["subs"], dj["codes"], dj["cell_start"], dj["order"],
        jnp.int32(QUOTA), dj["feats"], None, V=V, B=4, Q=Q, K=K, R=R,
        K_out=K_emit, SB=0))
    tm = ts.model
    got = fused_feat_query(
        torch.from_numpy(X), tm.pca_P, tm.pca_mu, dt["Cs"], dt["Rs"],
        dt["mus"], dt["subs"], dt["codes"], dt["cell_start"], dt["order"],
        QUOTA, dt["feats"], V=V, B=4, Q=Q, K=K, R=R, K_out=K_emit).numpy()
    assert got.shape == want.shape
    gr, gd, gt, gn, gok = unpack_query_out(got, K_emit)
    wr, wd, wt, wn, wok = unpack_query_out(want, K_emit)
    for a, b in ((gt, wt), (gn, wn), (gok, wok)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.isfinite(gd), np.isfinite(wd))
    fin = np.isfinite(wd)
    assert fin[4:].any()                       # the zero rows answered too
    if kind == "integer":
        np.testing.assert_array_equal(gr, wr)
        np.testing.assert_array_equal(gd, wd)
    else:
        np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("renorm", [False, True])
def test_fused_feat_brute_matches_jax(renorm):
    import jax.numpy as jnp

    from columbiaimagesearch_tpu.index.tpu_query import (
        fused_feat_brute as jax_ffb,
    )

    js, ts, X = _setup("random", True, seed=4)
    js.model.renorm = ts.model.renorm = renorm
    js.get_nb_indexed()
    ts.get_nb_indexed()
    dj, dt = js._dev, ts._dev
    want = np.asarray(jax_ffb(
        jnp.asarray(X), dj["pca_P"], dj["pca_mu"], dj["feats"],
        dj["feats_sq"], jnp.int32(N), dj["n_occ"], K_pre=RNB, K_out=16,
        renorm=renorm))
    got = fused_feat_brute(
        torch.from_numpy(X), ts.model.pca_P, ts.model.pca_mu, dt["feats"],
        dt["feats_sq"], N, dt["n_occ"], K_pre=RNB, K_out=16,
        renorm=renorm).numpy()
    gr, gd, *g_rest = unpack_query_out(got, 16)
    wr, wd, *w_rest = unpack_query_out(want, 16)
    for a, b in zip(g_rest, w_rest):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(gr, wr)


def test_normalize_project_guards_zero_rows():
    X = torch.zeros(3, D_RAW)
    X[0, 1] = 2.0
    P = torch.from_numpy(np.linalg.qr(np.random.RandomState(0).randn(
        D_RAW, D))[0].astype(np.float32))
    mu = torch.zeros(D_RAW)
    for renorm in (False, True):
        out = normalize_project(X, P, mu, renorm)
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out[1:], torch.zeros(2, D))
    torch.testing.assert_close(normalize_project(X)[0],
                               X[0] / 2.0)


def test_prewarm_ladder_leaves_policy_state_and_results():
    """Every rung plus the brute plan at each wave bucket; the yield EMA,
    the tier hint and the probe stats are untouched, and results after
    equal results before."""
    import jax.numpy as jnp

    js, ts, X = _setup("random", True, seed=5)
    before = ts.search_device_feats(torch.from_numpy(X[:4]), quota=QUOTA,
                                    limit=LIMIT, rerank_nb=RNB)
    state = (ts._tier_hint, ts._yield_ema, dict(ts.probe_stats),
             ts._wave_i)
    n = ts.prewarm_ladder(quota=QUOTA, limit=LIMIT, rerank_nb=RNB,
                          waves=(1, 3, 4))
    js.search_device_feats(jnp.asarray(X[:4]), quota=QUOTA, limit=LIMIT,
                           rerank_nb=RNB)
    assert n == js.prewarm_ladder(quota=QUOTA, limit=LIMIT, rerank_nb=RNB,
                                  waves=(1, 3, 4))
    assert n == 2 * (len(ts._probe_ladder()) + 1)
    assert (ts._tier_hint, ts._yield_ema, ts.probe_stats, ts._wave_i) \
        == state
    after = ts.search_device_feats(torch.from_numpy(X[:4]), quota=QUOTA,
                                   limit=LIMIT, rerank_nb=RNB)
    _assert_same(before, after, exact=True)
    assert LOPQSearcherTorch(ts.model).prewarm_ladder() == 0


def test_search_device_feats_rejects_rerank_without_store():
    _, ts, X = _setup("random", False, seed=6)
    plain = LOPQSearcherTorch(ts.model)
    plain.add_codes((np.zeros((5, 2), np.int64), np.zeros((5, M), np.uint8)))
    with pytest.raises(ValueError, match="resident feature store"):
        plain.search_device_feats(torch.from_numpy(X[:1]), rerank_nb=5)
    assert LOPQSearcherTorch(ts.model).search_device_feats(
        torch.from_numpy(X), n_valid=3) == [([], 0)] * 3


# ------------------------------------------------------------------- card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_search_device_feats_on_card_matches_search_batch(cuda_device):
    """On the card (LUT kernel on the square rung): the fast path equals
    ``search_batch`` on the rows normalized on the host."""
    rng = np.random.RandomState(7)
    Dh, F = D // 2, M // 2
    Rs = np.stack([np.stack([np.linalg.qr(rng.randn(Dh, Dh))[0]
                             for _ in range(V)]) for _ in range(2)])
    P = np.linalg.qr(rng.randn(D_RAW, D))[0]
    m = LOPQModelPCA(rng.randn(2, V, Dh), Rs, 0.1 * rng.randn(2, V, Dh),
                     rng.randn(2, F, S, Dh // F), P, np.zeros(D_RAW),
                     device=cuda_device)
    s = LOPQSearcherTorch(m, probe_width=4)
    raw = rng.randn(N, D_RAW).astype(np.float32)
    s.add_data(raw, store_feats=True)
    X = rng.randn(5, D_RAW).astype(np.float32)
    got = s.search_device_feats(torch.from_numpy(X).to(cuda_device),
                                quota=QUOTA, limit=LIMIT, rerank_nb=RNB)
    Xn = X / np.linalg.norm(X, axis=1, keepdims=True)
    want = s.search_batch(Xn, quota=QUOTA, limit=LIMIT, with_dists=True,
                          with_codes=False, rerank_nb=RNB)
    _assert_same(want, got, exact=False)
