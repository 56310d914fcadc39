"""LOPQ training in the port (ops/kmeans.py, ops/pca.py, ops/rotations.py,
ops/eigen_alloc.py, index/model.py ``train``/``fit``, index/eval.py,
searcher/searcher_lopq.py ``train_index``) against the JAX package on the
CPU, on the same numpy inputs.

k-means++ draws from ``jax.random`` in JAX and from a ``torch.Generator``
in the port, so parity is held at three levels:

- exactly, from shared inputs: ``assign_clusters`` (ids equal, distances
  rtol 1e-5), Lloyd from one ``C_init`` on separated blobs (assignments
  equal, centroids and inertia rtol 1e-5), the covariance accumulators and
  the local projection (rtol 1e-5 of each array's scale);
- up to eigenvector sign, on spectra with distinct eigenvalues:
  ``train_pca`` (``mu``, ``A`` rtol 1e-5; ``E`` rtol 1e-4; ``P`` columns
  equal up to sign within 1e-4; the same permutation) and
  ``compute_rotations_from_accumulators`` fed JAX's own accumulators
  (``R`` rows equal up to sign within 1e-4, ``mu`` equal);
- by quality, for seeded end-to-end runs: ``fit_kmeans`` inertia within
  5%; ``LOPQModel.fit`` and ``LOPQModelPCA.fit`` per-subquantizer
  distortion within 10% and recall@10 of each package's searcher on its
  own model within 0.05, with the same subsample rows.
"""

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch.index import eval as teval
from columbiaimagesearch_tpu_torch.index.model import LOPQModel, LOPQModelPCA
from columbiaimagesearch_tpu_torch.index.searcher import LOPQSearcherTorch
from columbiaimagesearch_tpu_torch.ops import kmeans as tk
from columbiaimagesearch_tpu_torch.ops import pca as tp
from columbiaimagesearch_tpu_torch.ops import rotations as tr
from columbiaimagesearch_tpu_torch.ops.eigen_alloc import (
    eigenvalue_allocation,
    eigenvalue_allocation_batch,
)

CPU = dict(device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _blobs(seed, n=4096, d=32, k=64, spread=8.0):
    """``n`` rows of ``k`` separated unit-variance blobs."""
    rng = np.random.RandomState(seed)
    centers = spread * rng.randn(k, d)
    X = centers[rng.randint(0, k, n)] + rng.randn(n, d)
    return X.astype(np.float32), centers.astype(np.float32), rng


def _anisotropic(seed, n, d, scale_hi=3.0, scale_lo=0.3):
    """Rows with distinct, well-separated covariance eigenvalues in a
    random basis, plus an offset."""
    rng = np.random.RandomState(seed)
    Q = np.linalg.qr(rng.randn(d, d))[0]
    X = rng.randn(n, d) @ np.diag(np.linspace(scale_hi, scale_lo, d)) @ Q.T
    return (X + rng.randn(d)).astype(np.float32), rng


def _assert_cols_up_to_sign(got, want, atol):
    """Columns of ``got`` equal those of ``want`` up to each column's
    sign."""
    sign = np.sign(np.sum(got * want, axis=0))
    np.testing.assert_allclose(got * sign, want, atol=atol)


# ------------------------------------------------------------- k-means


def test_assign_clusters_matches_jax():
    from columbiaimagesearch_tpu.ops.kmeans import assign_clusters

    # Centred near the origin: the distances' fp32 rounding scales with
    # |x|^2 + |c|^2, not with the distance itself.
    X, centers, _ = _blobs(0, d=16, spread=2.5)
    ja, jd = assign_clusters(X, centers)
    ta, td = tk.assign_clusters(X, centers, **CPU)
    assert ta.dtype == torch.int64 and ta.shape == (len(X),)
    np.testing.assert_array_equal(_np(ta), np.asarray(ja))
    np.testing.assert_allclose(_np(td), np.asarray(jd), rtol=1e-5)


def test_lloyd_from_same_init_matches_jax():
    from columbiaimagesearch_tpu.ops.kmeans import lloyd_kmeans

    X, centers, rng = _blobs(1)
    C_init = X[rng.choice(len(X), 64, replace=False)]
    jC, ja, ji = lloyd_kmeans(X, C_init, iters=8)
    tC, ta, ti = tk.lloyd_kmeans(X, C_init, iters=8, **CPU)
    np.testing.assert_array_equal(_np(ta), np.asarray(ja))
    np.testing.assert_allclose(_np(tC), np.asarray(jC), rtol=1e-5,
                               atol=1e-5)
    assert ti == pytest.approx(ji, rel=1e-5)


def test_lloyd_keeps_empty_cluster_centroid():
    X, _, _ = _blobs(2, n=512, k=4)
    far = np.full((1, X.shape[1]), 1e3, np.float32)
    C_init = np.concatenate([X[:3], far])
    C, a, _ = tk.lloyd_kmeans(X, C_init, iters=3, **CPU)
    assert not (_np(a) == 3).any()
    np.testing.assert_array_equal(_np(C)[3], far[0])


def test_fit_kmeans_inertia_matches_jax():
    from columbiaimagesearch_tpu.ops.kmeans import (
        assign_clusters,
        fit_kmeans,
    )

    X, _, _ = _blobs(3, n=8192, k=32)       # as many blobs as centroids
    jC = np.asarray(fit_kmeans(X, 32, iters=10, n_init=1, seed=5))
    tC = tk.fit_kmeans(X, 32, iters=10, n_init=1, seed=5, **CPU)
    assert tC.shape == (32, 32) and tC.dtype == torch.float32
    j_inertia = float(np.sum(np.asarray(assign_clusters(X, jC)[1])))
    t_inertia = float(tk.assign_clusters(X, tC, **CPU)[1].sum())
    assert t_inertia == pytest.approx(j_inertia, rel=0.05)
    # seeded: the same seed gives the same centroids
    np.testing.assert_array_equal(
        _np(tk.fit_kmeans(X, 32, iters=10, n_init=1, seed=5, **CPU)),
        _np(tC))


def test_kmeans_plusplus_uniform_fallback_when_all_distances_vanish():
    X = np.repeat(np.eye(3, 8, dtype=np.float32), 50, axis=0)
    g = torch.Generator().manual_seed(0)
    C = tk.kmeans_plusplus_init(g, torch.from_numpy(X), None, 5)
    assert C.shape == (5, 8)
    # three distinct rows exist: they are all seeded before any repeat
    assert len({tuple(r) for r in _np(C)[:3]}) == 3


def test_fit_kmeans_streaming_matches_fit_kmeans():
    X, _, _ = _blobs(4, n=3000, d=24, k=16)
    full = tk.fit_kmeans(X, 8, iters=6, n_init=1, seed=3, **CPU)
    stream = tk.fit_kmeans_streaming(X, 8, iters=6, n_init=1, seed=3,
                                     device_chunk=700, init_subsample=3000,
                                     **CPU)
    np.testing.assert_allclose(_np(stream), _np(full), rtol=1e-4, atol=1e-4)


def test_fit_kmeans_auto_dispatches_by_size(monkeypatch):
    import columbiaimagesearch_tpu.ops.kmeans as jk

    assert tk.STREAMING_THRESHOLD_ELEMENTS == jk.STREAMING_THRESHOLD_ELEMENTS
    X, _, _ = _blobs(5, n=1000, d=8, k=8)
    calls = []
    real = tk.fit_kmeans_streaming
    monkeypatch.setattr(tk, "fit_kmeans_streaming",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tk.fit_kmeans_auto(X, 4, iters=2, seed=0, **CPU)
    assert not calls
    monkeypatch.setattr(tk, "STREAMING_THRESHOLD_ELEMENTS", X.size - 1)
    tk.fit_kmeans_auto(X, 4, iters=2, seed=0, **CPU)
    assert calls == [1]


# ------------------------------------------------------------------ PCA


def test_train_pca_matches_jax():
    from columbiaimagesearch_tpu.ops.pca import train_pca

    X, _ = _anisotropic(6, 8192, 32)
    jp, jdims = train_pca(X, pca_dims=16, pca_subsample=6000)
    tparams, tdims = tp.train_pca(X, pca_dims=16, pca_subsample=6000, **CPU)
    assert tdims == jdims == 16 and tparams["c"] == jp["c"] == 6000
    scale = np.abs(jp["A"]).max()
    np.testing.assert_allclose(_np(tparams["mu"]), jp["mu"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(tparams["A"]), jp["A"], rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(_np(tparams["E"]), jp["E"], rtol=1e-4)
    # the same permutation: the port's columns are JAX's up to sign
    np.testing.assert_array_equal(eigenvalue_allocation(2, _np(tparams["E"])),
                                  eigenvalue_allocation(2, jp["E"]))
    _assert_cols_up_to_sign(_np(tparams["P"]), jp["P"], atol=1e-4)


# ------------------------------------------------------------ rotations


@pytest.mark.parametrize("V", [8, 40])
def test_accumulators_and_projection_match_jax(V):
    """One port path against JAX's masked (V <= 32) and blocked (V > 32)
    branches."""
    from columbiaimagesearch_tpu.ops.rotations import (
        accumulate_covariance_estimators,
        project_residuals_to_local,
    )

    X, _, rng = _blobs(7, n=4096, d=16, k=V)
    C = X[rng.choice(len(X), V, replace=False)]
    want = accumulate_covariance_estimators(X, C)
    got = tr.accumulate_covariance_estimators(X, C, **CPU)
    for name, w, g in zip(("A", "mu", "count", "assign", "residuals"),
                          want, got):
        w, g = np.asarray(w), _np(g)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)
    Rs = np.stack([np.linalg.qr(rng.randn(16, 16))[0]
                   for _ in range(V)]).astype(np.float32)
    mus = rng.randn(V, 16).astype(np.float32)
    res, assign = np.asarray(want[4]), np.asarray(want[3])
    jproj = np.asarray(project_residuals_to_local(res, assign, Rs, mus))
    tproj = _np(tr.project_residuals_to_local(res, assign, Rs, mus, **CPU))
    np.testing.assert_allclose(tproj, jproj, rtol=1e-5,
                               atol=1e-5 * np.abs(jproj).max())


def _rotation_data(D=16, V=40):
    """Clusters with distinct spectra, one below the ``count < D``
    fallback (10 rows) and one empty (its centroid far from every row)."""
    rng = np.random.RandomState(8)
    C = 20.0 * rng.randn(V, D).astype(np.float32)
    C[0] = 1e4
    rows, counts = [], [0, 10] + [150] * (V - 2)
    for v, n in enumerate(counts):
        Q = np.linalg.qr(rng.randn(D, D))[0]
        rows.append(C[v] + rng.randn(n, D) @ np.diag(
            np.linspace(3.0, 0.3, D)) @ Q.T)
    return np.concatenate(rows).astype(np.float32), C


def test_rotations_from_jax_accumulators_match_up_to_sign():
    from columbiaimagesearch_tpu.ops.rotations import (
        accumulate_covariance_estimators,
        compute_rotations_from_accumulators,
    )

    X, C = _rotation_data()
    A, mu, count = (np.asarray(t) for t in
                    accumulate_covariance_estimators(X, C)[:3])
    assert count[0] == 0 and count[1] == 10
    jR, jmu = (np.asarray(t) for t in
               compute_rotations_from_accumulators(A, mu, count, 4))
    tR, tmu = (_np(t) for t in
               tr.compute_rotations_from_accumulators(A, mu, count, 4,
                                                      **CPU))
    np.testing.assert_allclose(tmu, jmu, rtol=1e-5, atol=1e-6)
    for v in (0, 1):    # the identity fallback, permuted by the allocation
        np.testing.assert_array_equal(tR[v], jR[v])
        np.testing.assert_array_equal(np.sort(tR[v], axis=0)[-1], 1.0)
    for v in range(len(C)):               # rows equal up to sign
        _assert_cols_up_to_sign(tR[v].T, jR[v].T, atol=1e-4)


def test_compute_local_rotations_and_residuals_match_jax():
    from columbiaimagesearch_tpu.ops.rotations import (
        compute_local_rotations,
        compute_residuals,
    )

    X, C = _rotation_data()
    jR, jmu, ja, jr = (np.asarray(t) for t in compute_local_rotations(X, C, 4))
    tR, tmu, ta, tres = (_np(t) for t in
                         tr.compute_local_rotations(X, C, 4, **CPU))
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(tres, jr, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tmu, jmu, rtol=1e-5, atol=1e-5)
    for v in range(len(C)):
        _assert_cols_up_to_sign(tR[v].T, jR[v].T, atol=1e-4)
    wr, wa = compute_residuals(X, C)
    gr, ga = tr.compute_residuals(X, C, **CPU)
    np.testing.assert_array_equal(_np(ga), np.asarray(wa))
    np.testing.assert_allclose(_np(gr), np.asarray(wr), rtol=1e-5, atol=1e-4)


def test_eigenvalue_allocation_is_the_jax_copy():
    from columbiaimagesearch_tpu.ops.eigen_alloc import (
        eigenvalue_allocation_batch as jax_batch,
    )

    E = np.abs(np.random.RandomState(9).randn(12, 32)) + 1e-3
    E[3, :4] = 0.0
    np.testing.assert_array_equal(eigenvalue_allocation_batch(4, E),
                                  jax_batch(4, E))


# ------------------------------------------------------------ end to end

N_FIT, D_FIT, V_FIT, M_FIT, S_FIT = 6144, 32, 16, 4, 32


def _fit_data(seed, d=D_FIT):
    """Training rows with cluster structure in each half, and 300 queries
    that are indexed rows plus a little noise (their true NN is known)."""
    rng = np.random.RandomState(seed)
    centers = 4.0 * rng.randn(48, d)
    X = centers[rng.randint(0, 48, N_FIT)] + rng.randn(N_FIT, d)
    X = X.astype(np.float32)
    picks = rng.choice(N_FIT, 300, replace=False)
    Q = (X[picks] + 0.05 * rng.randn(300, d)).astype(np.float32)
    return X, Q, rng


def _recall(searcher_j, searcher_t, X, Q):
    from columbiaimagesearch_tpu.index.eval import (
        compute_all_neighbors,
        get_recall,
    )

    nns = teval.compute_all_neighbors(Q, X, **CPU)
    np.testing.assert_array_equal(nns, compute_all_neighbors(Q, X))
    searcher_j.add_data(X)
    searcher_t.add_data(X)
    jr, _ = get_recall(searcher_j, Q, nns, thresholds=(1, 10, 100))
    tr_, _ = teval.get_recall(searcher_t, Q, nns, thresholds=(1, 10, 100))
    return jr, tr_


class _RecordingRandomState(np.random.RandomState):
    """Records every ``choice`` draw: the subsample rows of ``train``."""

    draws = []

    def choice(self, *a, **k):
        out = super().choice(*a, **k)
        self.draws.append(np.array(out))
        return out


def test_lopq_fit_matches_jax_quality_and_subsample(monkeypatch):
    from columbiaimagesearch_tpu.index.eval import get_subquantizer_distortion
    from columbiaimagesearch_tpu.index.model import LOPQModel as JaxModel
    from columbiaimagesearch_tpu.index.searcher import LOPQSearcherTPU

    import columbiaimagesearch_tpu_torch.index.model as tmod

    X, Q, _ = _fit_data(10)
    monkeypatch.setattr(np.random, "RandomState", _RecordingRandomState)
    _RecordingRandomState.draws = []
    sub_rows = []
    real = tmod.fit_kmeans_auto
    monkeypatch.setattr(tmod, "fit_kmeans_auto", lambda X, *a, **k: (
        sub_rows.append(X.shape[0]), real(X, *a, **k))[1])
    jm = JaxModel(V=V_FIT, M=M_FIT, subquantizer_clusters=S_FIT)
    assert jm.fit(X, n_init=1, random_state=0,
                  subquantizer_sample_ratio=0.5) is None   # JAX: in place
    tm = LOPQModel.fit(X, n_init=1, random_state=0,
                       subquantizer_sample_ratio=0.5, V=V_FIT, M=M_FIT,
                       subquantizer_clusters=S_FIT, **CPU)
    # the same subsample rows, and the port's subquantizers trained on them
    jdraw, tdraw = _RecordingRandomState.draws
    np.testing.assert_array_equal(tdraw, jdraw)
    assert len(tdraw) == N_FIT // 2
    assert sub_rows == [N_FIT] * 2 + [N_FIT // 2] * M_FIT
    assert isinstance(tm, LOPQModel) and tm.device.type == "cpu"
    assert (tm.V, tm.M, tm.subquantizer_clusters) == (V_FIT, M_FIT, S_FIT)
    assert tuple(tm.Rs.shape) == (2, V_FIT, D_FIT // 2, D_FIT // 2)
    eye = np.eye(D_FIT // 2)
    np.testing.assert_allclose(_np(tm.Rs @ tm.Rs.transpose(-1, -2)),
                               np.broadcast_to(eye, tm.Rs.shape), atol=1e-4)
    jd = get_subquantizer_distortion(X, jm)
    td = teval.get_subquantizer_distortion(X, tm)
    assert td.shape == (M_FIT,)
    np.testing.assert_allclose(td, jd, rtol=0.10)
    jrec, trec = _recall(LOPQSearcherTPU(jm), LOPQSearcherTorch(tm), X, Q)
    assert abs(trec[1] - jrec[1]) <= 0.05, (jrec, trec)
    assert trec[1] > 0.5, trec


def test_fit_draws_from_a_given_generator():
    """``generator=``: every k-means run draws from it (``random_state``
    still seeds the subsample), so two fits from equally seeded generators
    give the same model and another seed another."""
    X, _, _ = _fit_data(14)
    X = X[:2048]
    models = [LOPQModel.fit(X, n_init=1, random_state=1, V=8, M=M_FIT,
                            subquantizer_clusters=16,
                            generator=torch.Generator().manual_seed(seed),
                            **CPU) for seed in (5, 5, 6)]
    for name in ("Cs", "Rs", "mus", "subs"):
        np.testing.assert_array_equal(_np(getattr(models[0], name)),
                                      _np(getattr(models[1], name)))
    assert not np.array_equal(_np(models[0].Cs), _np(models[2].Cs))


def test_lopq_pca_fit_matches_jax():
    from columbiaimagesearch_tpu.index.eval import get_subquantizer_distortion
    from columbiaimagesearch_tpu.index.model import LOPQModelPCA as JaxPCA
    from columbiaimagesearch_tpu.index.searcher import LOPQSearcherTPU

    Z, Qz, rng = _fit_data(11)
    basis = np.linalg.qr(rng.randn(48, D_FIT))[0].astype(np.float32)
    X = Z @ basis.T + 0.01 * rng.randn(N_FIT, 48).astype(np.float32)
    Q = Qz @ basis.T
    jm = JaxPCA(V=V_FIT, M=M_FIT, subquantizer_clusters=S_FIT)
    jm.fit(X, pca_dims=D_FIT, n_init=1, random_state=0, pca_subsample=4000)
    tm = LOPQModelPCA.fit(X, pca_dims=D_FIT, n_init=1, random_state=0,
                          pca_subsample=4000, V=V_FIT, M=M_FIT,
                          subquantizer_clusters=S_FIT, **CPU)
    assert isinstance(tm, LOPQModelPCA)
    # the same PCA subspace, columns up to sign
    _assert_cols_up_to_sign(_np(tm.pca_P), jm.pca_P, atol=1e-3)
    np.testing.assert_allclose(_np(tm.pca_mu), jm.pca_mu, atol=1e-5)
    jd = get_subquantizer_distortion(jm.apply_PCA(X), jm)
    td = teval.get_subquantizer_distortion(tm.apply_PCA(X), tm)
    np.testing.assert_allclose(td, jd, rtol=0.10)
    jrec, trec = _recall(LOPQSearcherTPU(jm), LOPQSearcherTorch(tm), X, Q)
    assert abs(trec[1] - jrec[1]) <= 0.05, (jrec, trec)
    with pytest.raises(ValueError, match="retrain PCA"):
        LOPQModelPCA.fit(X, pca_dims=D_FIT, parameters=(
            None, None, None, None, tm.pca_P, tm.pca_mu), **CPU)


def test_eval_helpers_match_jax_on_one_model():
    from columbiaimagesearch_tpu.index import eval as jeval
    from columbiaimagesearch_tpu.index.model import LOPQModel as JaxModel

    from tests.oracle_lopq import random_params

    rng = np.random.RandomState(12)
    params = random_params(rng, V=8, M=4, S=16, D=16)
    jm = JaxModel(parameters=params)
    tm = LOPQModel.from_numpy(*params, **CPU)
    X = rng.randn(600, 16).astype(np.float32)
    np.testing.assert_array_equal(teval.get_cell_histogram(X, tm),
                                  jeval.get_cell_histogram(X, jm))
    assert teval.get_proportion_nns_with_same_coarse_codes(X, tm) == \
        jeval.get_proportion_nns_with_same_coarse_codes(X, jm)
    np.testing.assert_allclose(teval.get_subquantizer_distortion(X, tm),
                               jeval.get_subquantizer_distortion(X, jm),
                               rtol=1e-4)
    np.testing.assert_array_equal(
        teval.compute_all_neighbors(X[:50], X, just_nn=False, **CPU)[:, :5],
        jeval.compute_all_neighbors(X[:50], X, just_nn=False)[:, :5])
    # Ported with LOPQModel.reconstruct_batch: the same fraction.
    assert teval.get_proportion_of_reconstructions_with_same_codes(X, tm) \
        == jeval.get_proportion_of_reconstructions_with_same_codes(X, jm)


# ------------------------------------------------------------ the facade


def test_train_index_on_both_facades(tmp_path):
    """Both facades train at init over the same KVIndexer rows (at the
    end-to-end tests' shapes); the port's model is saved by its storer and
    a second facade loads it; the port's ``lopq_pca`` branch trains too."""
    from columbiaimagesearch_tpu.searcher.searcher_lopq import (
        SearcherLOPQ as JaxSearcherLOPQ,
    )
    from columbiaimagesearch_tpu.store import (
        KVIndexer as JaxKVIndexer,
        MemoryStorer as JaxMemoryStorer,
    )

    from columbiaimagesearch_tpu_torch.searcher.searcher_lopq import (
        SearcherLOPQ,
    )
    from columbiaimagesearch_tpu_torch.store import KVIndexer, LocalStorer

    from tests.test_torch_facade import _fill, _NoFeaturizer

    feats, _, _ = _fit_data(13)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    sha1s = [f"{i:040X}" for i in range(N_FIT)]
    kw = dict(model_type="lopq", V=V_FIT, M=M_FIT,
              subquantizer_clusters=S_FIT, nb_train=N_FIT, nb_min_train=100,
              detector_type="full", featurizer_type="sentibank",
              featurizer=_NoFeaturizer(), reranking=True, rerank_nb=50,
              sim_limit=5)
    facades = []
    for name, cls, kv_cls, storer, extra in (
            ("jax", JaxSearcherLOPQ, JaxKVIndexer, JaxMemoryStorer(), {}),
            ("port", SearcherLOPQ, KVIndexer,
             LocalStorer(str(tmp_path / "storer")), CPU)):
        kv = kv_cls(path=str(tmp_path / f"{name}.db"))
        kv.batch_update_size = 2048
        _fill(kv, feats, sha1s, batch=2048)
        facades.append(cls(indexer=kv, storer=storer, train_at_init=True,
                           **kw, **extra))
    js, ts = facades
    assert len(ts.get_train_features(2500)) == 2500
    for s in (js, ts):
        assert s.model is not None and s.get_nb_indexed() == N_FIT
    assert isinstance(ts.model, LOPQModel) and ts.model.V == V_FIT
    # saved by the storer; a second facade loads it instead of training
    again = SearcherLOPQ(indexer=KVIndexer(path=str(tmp_path / "port.db")),
                         storer=LocalStorer(str(tmp_path / "storer")),
                         **dict(kw, train_at_init=False), **CPU)
    np.testing.assert_array_equal(_np(again.model.Rs), _np(ts.model.Rs))
    assert again.get_nb_indexed() == N_FIT
    for s in (js, ts, again):
        out = s.search_from_feats([(sha1s[42], None)], [feats[42]],
                                  {"max_returned": 3})
        assert out["AllSimilarImages"][0]["SimilarImages"][
            "ImageSha1s"][0] == sha1s[42]
    pca = SearcherLOPQ(indexer=KVIndexer(path=str(tmp_path / "port.db")),
                       storer=None, **dict(kw, model_type="lopq_pca",
                                           pca_dims=16, nb_train_pca=3000,
                                           nb_train=4000), **CPU)
    pca.train_index()
    assert isinstance(pca.model, LOPQModelPCA)
    assert tuple(pca.model.pca_P.shape) == (D_FIT, 16)
