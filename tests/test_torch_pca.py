"""``LOPQModelPCA`` (port: index/model.py) and the PCA branches of
``LOPQSearcherTorch`` and ``ExhaustiveADC`` against the JAX package, on the
same weights carried over with ``from_numpy``.

Tolerances: ``apply_PCA`` rtol 1e-5, atol 1e-5 (fp32 matmul, blocked in
another order than numpy's). Codes equal the JAX codes except fp32 argmin
near-ties (tests/test_torch_model_encode.py's rule, applied in the PCA
space). Search results as tests/test_torch_searcher.py holds them: ids
equal except swaps of float-rounding ties, distances at rtol 1e-4, atol
1e-5.
"""

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch.index.exhaustive_adc import ExhaustiveADC
from columbiaimagesearch_tpu_torch.index.model import LOPQModelPCA
from columbiaimagesearch_tpu_torch.index.searcher import LOPQSearcherTorch

from tests.oracle_lopq import random_params
from tests.test_torch_model_encode import _assert_codes_match
from tests.test_torch_searcher import _assert_results_match

V, M, S, D, D_RAW = 16, 4, 16, 32, 48
N = 1500


def _pca(rng):
    P = np.linalg.qr(rng.randn(D_RAW, D))[0].astype(np.float32)
    mu = rng.randn(D_RAW).astype(np.float32)
    return P, mu


def _pair(renorm=False, seed=11):
    from columbiaimagesearch_tpu.index.model import LOPQModelPCA as JaxPCA

    rng = np.random.RandomState(seed)
    params = random_params(rng, V=V, M=M, S=S, D=D)
    P, mu = _pca(rng)
    jm = JaxPCA(renorm=renorm, parameters=params + (P, mu))
    tm = LOPQModelPCA.from_numpy(*params, P, mu, renorm, device="cpu")
    # Raw rows whose projection lands on the model's scale.
    X = (rng.randn(N, D).astype(np.float32) @ P.T + mu
         + 0.05 * rng.randn(N, D_RAW).astype(np.float32))
    return jm, tm, X, rng


def test_from_numpy_carries_pca_weights():
    jm, tm, _, _ = _pair(renorm=True)
    np.testing.assert_array_equal(tm.pca_P.numpy(), jm.pca_P)
    np.testing.assert_array_equal(tm.pca_mu.numpy(), jm.pca_mu)
    assert tm.renorm is True and tm.pca_P.device.type == "cpu"
    np.testing.assert_array_equal(tm.Rs.numpy(), np.stack(jm.Rs))
    with pytest.raises(ValueError, match="do not map onto D=32"):
        LOPQModelPCA(tm.Cs, tm.Rs, tm.mus, tm.subs, tm.pca_P[:, :8],
                     tm.pca_mu, device="cpu")


@pytest.mark.parametrize("renorm", [False, True])
def test_apply_pca_matches_jax(renorm):
    jm, tm, X, _ = _pair(renorm=renorm)
    got = tm.apply_PCA(X)
    assert got.dtype == torch.float32 and got.shape == (N, D)
    np.testing.assert_allclose(got.numpy(), jm.apply_PCA(X), rtol=1e-5,
                               atol=1e-5)
    if renorm:
        np.testing.assert_allclose(got.norm(dim=1).numpy(), 1.0, rtol=1e-5)


def test_predict_batch_applies_pca_like_jax():
    jm, tm, X, _ = _pair()
    jc, jf = jm.predict_batch(X)
    tc, tf = tm.predict_batch(torch.from_numpy(X))
    assert tc.dtype == jc.dtype and tf.dtype == jf.dtype
    _assert_codes_match(jm, jm.apply_PCA(X), jc, jf, tc, tf)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_npz_roundtrip_with_jax(tmp_path, writer):
    from columbiaimagesearch_tpu.index.model import LOPQModelPCA as JaxPCA

    jm, tm, X, _ = _pair(renorm=True)
    path = str(tmp_path / "model_pca.npz")
    if writer == "jax":
        jm.export_npz(path)
        back = LOPQModelPCA.load_npz(path, device="cpu")
        for a, b in ((back.Cs, tm.Cs), (back.Rs, tm.Rs), (back.mus, tm.mus),
                     (back.subs, tm.subs), (back.pca_P, tm.pca_P),
                     (back.pca_mu, tm.pca_mu)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert back.renorm is True
    else:
        tm.export_npz(path)
        back = JaxPCA.load_npz(path)
        assert back.V == V and back.M == M and back.renorm is True
        np.testing.assert_array_equal(back.pca_P, jm.pca_P)
        np.testing.assert_array_equal(back.pca_mu, jm.pca_mu)
        np.testing.assert_array_equal(
            np.stack([np.stack(h) for h in back.subquantizers]),
            np.stack([np.stack(h) for h in jm.subquantizers]))
        np.testing.assert_array_equal(back.apply_PCA(X), jm.apply_PCA(X))


def test_searcher_projects_raw_queries_like_jax():
    """Same codes and ids in both searchers; raw queries through
    ``search_batch`` and ``search`` (default ladder)."""
    from columbiaimagesearch_tpu.index.searcher import LOPQSearcherTPU

    jm, tm, X, rng = _pair()
    coarse, fine = jm.predict_batch(X)
    ids = [f"img{i}" for i in range(N)]
    js, ts = LOPQSearcherTPU(jm), LOPQSearcherTorch(tm)
    for s in (js, ts):
        s.add_codes((coarse, fine), ids)
    Q = X[rng.choice(N, 5, replace=False)] + 0.1 * rng.randn(
        5, D_RAW).astype(np.float32)
    want = js.search_batch(Q, quota=200, limit=10, with_dists=True)
    got = ts.search_batch(Q, quota=200, limit=10, with_dists=True)
    for w, g in zip(want, got):
        _assert_results_match(w, g)
    _assert_results_match(js.search(Q[1], quota=200, limit=10,
                                    with_dists=True),
                          ts.search(Q[1], quota=200, limit=10,
                                    with_dists=True))


def test_add_data_stores_pca_features_like_jax():
    """``add_data(store_feats=True)`` keeps the PCA projection: a pinned
    rerank wave gives exact index-space distances, and an indexed raw row
    comes back first at distance 0 from both searchers."""
    from columbiaimagesearch_tpu.index.searcher import LOPQSearcherTPU

    jm, tm, X, rng = _pair(seed=12)
    js = LOPQSearcherTPU(jm, probe_width=8)
    ts = LOPQSearcherTorch(tm, probe_width=8)
    for s in (js, ts):
        s.add_data(X[:1000], list(range(1000)), store_feats=True)
        s.add_data(X[1000:], list(range(1000, N)), store_feats=True)
    assert ts.has_rerank_feats and js.has_rerank_feats
    np.testing.assert_allclose(ts._dev["feats"][:N].numpy(),
                               jm.apply_PCA(X), rtol=1e-5, atol=1e-5)
    Q = np.concatenate([X[[42]], X[rng.choice(N, 4, replace=False)]
                        + 0.1 * rng.randn(4, D_RAW).astype(np.float32)])
    want = js.search_batch(Q, quota=200, limit=10, with_dists=True,
                           rerank_nb=30)
    got = ts.search_batch(Q, quota=200, limit=10, with_dists=True,
                          rerank_nb=30)
    for w, g in zip(want, got):
        _assert_results_match(w, g)
    assert got[0][0][0].id == 42 and got[0][0][0].dist <= 1e-6


def test_exhaustive_projects_raw_queries_like_jax():
    from columbiaimagesearch_tpu.index import pallas_adc as jpa

    jm, tm, X, rng = _pair(seed=13)
    coarse, fine = jm.predict_batch(X)
    jex = jpa.ExhaustiveADC(jm, interpret=True)
    tex = ExhaustiveADC(tm)
    for ex in (jex, tex):
        ex.build(coarse, fine)
    Q = X[:3] + 0.1 * rng.randn(3, D_RAW).astype(np.float32)
    for (wi, wd), (gi, gd) in zip(jex.search_batch(Q, k=10),
                                  tex.search_batch(Q, k=10)):
        assert gi == wi
        np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-4)
