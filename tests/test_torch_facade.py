"""The ``SearcherLOPQ`` facade (port: searcher/, store/, common/,
extraction/) against the JAX package's on copies of one sqlite KVIndexer
and on storers holding the same model.

Each package's storer holds its own pickled model (the JAX model pickles
JAX objects; the port's pickles numpy in the npz layout), made from the
same parameters. Output dicts must be equal, with distances allclose
(rtol 1e-4, atol 1e-5: fp32 sums in another order) and ids equal except
swaps between rounding ties.
"""

import copy
import pickle
import shutil

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch.common.factory import (
    build_searcher,
    generate_conf_searcher,
)
from columbiaimagesearch_tpu_torch.extraction.featsio import normfeatB64encode
from columbiaimagesearch_tpu_torch.index.model import LOPQModel, LOPQModelPCA
from columbiaimagesearch_tpu_torch.index.searcher import LOPQSearcherTorch
from columbiaimagesearch_tpu_torch.searcher.searcher_lopq import SearcherLOPQ
from columbiaimagesearch_tpu_torch.store import KVIndexer, LocalStorer

EXTR = "sentibank_feat_full_image"
V, M, S, DIM = 8, 4, 32, 64
N_IMGS = 400


class _NoFeaturizer:
    """The facade tests that inject features need no image featurizer."""


def _params(rng, feats, V=V, M=M, S=S):
    """LOPQ parameters on the feature scale: coarse centroids sampled from
    the rows, orthogonal rotations, small residual codebooks."""
    D = feats.shape[1]
    Dh, F = D // 2, M // 2
    pick = feats[rng.choice(len(feats), V, replace=False)]
    Cs = (pick[:, :Dh].copy(), pick[:, Dh:].copy())
    Rs = tuple(np.stack([np.linalg.qr(rng.randn(Dh, Dh))[0]
                         for _ in range(V)]).astype(np.float32)
               for _ in range(2))
    mus = tuple(np.zeros((V, Dh), np.float32) for _ in range(2))
    subs = tuple([0.1 * rng.randn(S, Dh // F).astype(np.float32)
                  for _ in range(F)] for _ in range(2))
    return Cs, Rs, mus, subs


def _fill(kv, feats, sha1s, batch=200):
    """Rows and update rows like the extraction pipeline writes them
    (tests/test_store_searcher.py:11-37)."""
    for b in range(0, len(sha1s), batch):
        rows = {}
        chunk = list(range(b, min(b + batch, len(sha1s))))
        for i in chunk:
            rows[sha1s[i]] = {
                f"ext:{EXTR}": normfeatB64encode(feats[i].astype(np.float32)),
                f"ext:{EXTR}_processed": "1",
                "info:s3_url": f"http://imgs/{sha1s[i]}.jpg",
            }
        kv.push_dict_rows(rows, kv.table_sha1infos_name)
        update_id, _ = kv.get_next_update_id(extr_type=EXTR)
        kv.push_dict_rows(
            {update_id: {kv.get_col_listsha1s():
                         ",".join(sha1s[i] for i in chunk),
                         kv.get_col_upcreate(): "now"}},
            kv.table_updateinfos_name)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """One sqlite db of 400 normalized 64-d features in 24 clusters, the
    model parameters, the features and the sha1s."""
    root = tmp_path_factory.mktemp("facade")
    rng = np.random.RandomState(2)
    centers = rng.randn(24, DIM).astype(np.float32) * 3
    feats = (centers[rng.randint(0, 24, N_IMGS)]
             + 0.2 * rng.randn(N_IMGS, DIM).astype(np.float32))
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    sha1s = [f"{i:040X}" for i in range(N_IMGS)]
    db = str(root / "base.db")
    kv = KVIndexer(path=db)
    kv.batch_update_size = 200
    _fill(kv, feats, sha1s)
    kv._shared.close()
    return root, db, _params(rng, feats), feats, sha1s


_N_PAIRS = [0]


def _pair(store, facade_kw=None, pca=None, featurizers=None):
    """(JAX facade, port facade) over copies of the db and their own
    storers, each loading its package's pickled model from the storer."""
    from columbiaimagesearch_tpu.index.model import (
        LOPQModel as JaxModel,
        LOPQModelPCA as JaxPCA,
    )
    from columbiaimagesearch_tpu.searcher.searcher_lopq import (
        SearcherLOPQ as JaxSearcherLOPQ,
    )
    from columbiaimagesearch_tpu.store import (
        KVIndexer as JaxKVIndexer,
        LocalStorer as JaxLocalStorer,
    )

    root, db, params, _, _ = store
    _N_PAIRS[0] += 1
    tag = f"p{_N_PAIRS[0]}"
    kw = dict(model_type="lopq_pca" if pca else "lopq", V=V, M=M,
              subquantizer_clusters=S, detector_type="full",
              featurizer_type="sentibank", sim_limit=10)
    if pca:
        kw["pca_dims"] = pca[0].shape[1]
    kw.update(facade_kw or {})
    if pca:
        jm = JaxPCA(parameters=params + pca)
        tm = LOPQModelPCA.from_numpy(*params, *pca, device="cpu")
    else:
        jm = JaxModel(parameters=params)
        tm = LOPQModel.from_numpy(*params, device="cpu")
    out = []
    for name, kv_cls, st_cls, cls, model, fz in (
            ("jax", JaxKVIndexer, JaxLocalStorer, JaxSearcherLOPQ, jm,
             featurizers[0] if featurizers else _NoFeaturizer()),
            ("port", KVIndexer, LocalStorer, SearcherLOPQ, tm,
             featurizers[1] if featurizers else _NoFeaturizer())):
        path = str(root / f"{tag}_{name}.db")
        shutil.copy(db, path)
        storer = st_cls(str(root / f"{tag}_{name}_storer"))
        probe = cls.__new__(cls)
        probe.__dict__.update(kw, featurizer_type="sentibank",
                              detector_type="full", input_type="image")
        storer.save(cls.build_model_str(probe), model)
        dev = {"device": "cpu"} if name == "port" else {}
        out.append(cls(indexer=kv_cls(path=path), storer=storer,
                       featurizer=fz, **kw, **dev))
    return out


def _assert_outputs_equal(want, got):
    """Output dicts equal; distances allclose; ids equal except rounding
    ties."""
    want, got = copy.deepcopy(want), copy.deepcopy(got)
    for w, g in zip(want["AllSimilarImages"], got["AllSimilarImages"]):
        bw, bg = w.pop("SimilarImages"), g.pop("SimilarImages")
        dw, dg = bw.pop("Distances"), bg.pop("Distances")
        np.testing.assert_allclose(dg, dw, rtol=1e-4, atol=1e-5)
        iw, ig = bw.pop("ImageSha1s"), bg.pop("ImageSha1s")
        uw, ug = bw.pop("CachedImageURLs"), bg.pop("CachedImageURLs")
        assert len(iw) == len(ig)
        for j, (a, b) in enumerate(zip(iw, ig)):
            if a != b:      # a rounding tie: b has a's distance in want
                assert b in iw and abs(dw[iw.index(b)] - dw[j]) <= 1e-4
        assert [u for _, u in sorted(zip(ig, ug))] == \
            [u for _, u in sorted(zip(iw, uw))]
        assert bg == bw and g == w
    assert {k: v for k, v in got.items() if k != "AllSimilarImages"} == \
        {k: v for k, v in want.items() if k != "AllSimilarImages"}


@pytest.mark.parametrize("mode", ["adc", "host_rerank", "device_rerank"])
def test_search_from_feats_matches_jax(store, mode):
    kw = {"adc": dict(reranking=False),
          "host_rerank": dict(reranking=True, rerank_nb=50),
          "device_rerank": dict(reranking=True, rerank_nb=50,
                                store_rerank_feats=True)}[mode]
    js, ts = _pair(store, kw)
    _, _, _, feats, sha1s = store
    assert ts.get_nb_indexed() == js.get_nb_indexed() == N_IMGS
    assert ts.searcher.has_rerank_feats == js.searcher.has_rerank_feats \
        == (mode == "device_rerank")
    rng = np.random.RandomState(3)
    for qi in (5, 123):
        q = feats[qi] + 0.001 * rng.randn(DIM).astype(np.float32)
        opts = {"max_returned": 8}
        want = js.search_from_feats([(sha1s[qi], None)], [q], dict(opts))
        got = ts.search_from_feats([(sha1s[qi], None)], [q], dict(opts))
        _assert_outputs_equal(want, got)
        if mode != "adc":
            assert got["AllSimilarImages"][0]["SimilarImages"][
                "ImageSha1s"][0] == sha1s[qi]
    # a multi-feature request rides one search_batch wave
    qs = [feats[i] for i in (7, 8, 9)]
    dets = [(sha1s[i], None) for i in (7, 8, 9)]
    want = js.search_from_feats(dets, qs, {})
    _assert_outputs_equal(want, ts.search_from_feats(dets, qs, {}))
    # The same rows as tensors, as the featurizer's device route hands
    # them over: search_device_feats where the mode allows it.
    _assert_outputs_equal(want, ts.search_from_feats(
        dets, [torch.from_numpy(q) for q in qs], {}))


def test_search_from_feats_multi_matches_jax(store):
    js, ts = _pair(store, dict(reranking=True, rerank_nb=50,
                               store_rerank_feats=True))
    _, _, _, feats, sha1s = store
    reqs = [([(sha1s[i], None)], [feats[i]], {"max_returned": n})
            for i, n in ((11, 3), (12, 5), (13, 3))]
    want = js.search_from_feats_multi(reqs)
    got = ts.search_from_feats_multi(reqs)
    assert len(got) == 3
    for w, g in zip(want, got):
        _assert_outputs_equal(w, g)


def test_load_codes_refresh_and_resume_match_jax(store):
    from columbiaimagesearch_tpu.searcher.searcher_lopq import (
        SearcherLOPQ as JaxSearcherLOPQ,
    )

    js, ts = _pair(store, dict(reranking=True, rerank_nb=50,
                               store_rerank_feats=True))
    _, _, _, feats, _ = store
    rng = np.random.RandomState(4)
    new = feats[:5] + 0.001 * rng.randn(5, DIM).astype(np.float32)
    new_sha1s = [f"NEW{i:037X}" for i in range(5)]
    for f in (js, ts):
        _fill(f.indexer, new, new_sha1s)
    assert ts.load_codes() == js.load_codes() == 5
    assert ts.get_nb_indexed() == js.get_nb_indexed() == N_IMGS + 5
    assert ts.searcher.has_rerank_feats
    assert sorted(ts.indexed_updates) == sorted(js.indexed_updates)
    q = new[2]
    _assert_outputs_equal(
        js.search_from_feats([("q", None)], [q], {"max_returned": 4}),
        ts.search_from_feats([("q", None)], [q], {"max_returned": 4}))
    # the cached codes dicts are the same
    for uid in ts.indexed_updates:
        assert ts.storer.load(ts._codes_key(uid)) == \
            js.storer.load(js._codes_key(uid))
    # a new facade resumes from the storer without the indexer's updates
    for f, cls, dev in ((js, JaxSearcherLOPQ, {}),
                        (ts, SearcherLOPQ, {"device": "cpu"})):
        again = cls(model_type="lopq", V=V, M=M, subquantizer_clusters=S,
                    detector_type="full", featurizer=_NoFeaturizer(),
                    indexer=None, storer=f.storer, **dev)
        assert again.get_nb_indexed() == N_IMGS + 5
    assert ts.status()["nb_indexed"] == js.status()["nb_indexed"]


def test_exact_facade_matches_jax():
    """``SearcherLOPQ(exact=True)`` runs the exhaustive backend (the scan
    kernel's plain version on the CPU) over injected 128-d features."""
    rng = np.random.RandomState(9)
    feats = rng.randn(300, 128).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    sha1s = [f"{i:040X}" for i in range(300)]
    kv = KVIndexer(path=":memory:")
    _fill(kv, feats, sha1s)
    params = _params(rng, feats, V=4, M=4, S=16)
    from columbiaimagesearch_tpu.index.model import LOPQModel as JaxModel
    from columbiaimagesearch_tpu.searcher.searcher_lopq import (
        SearcherLOPQ as JaxSearcherLOPQ,
    )
    from columbiaimagesearch_tpu.store import (
        KVIndexer as JaxKVIndexer,
        MemoryStorer as JaxMemoryStorer,
    )
    from columbiaimagesearch_tpu_torch.store import MemoryStorer

    jkv = JaxKVIndexer(path=":memory:")
    _fill(jkv, feats, sha1s)
    kw = dict(model_type="lopq", V=4, M=4, subquantizer_clusters=16,
              detector_type="full", featurizer=_NoFeaturizer(), exact=True)
    js = JaxSearcherLOPQ(model=JaxModel(parameters=params), indexer=jkv,
                         storer=JaxMemoryStorer(), **kw)
    ts = SearcherLOPQ(model=LOPQModel.from_numpy(*params, device="cpu"),
                      indexer=kv, storer=MemoryStorer(), device="cpu", **kw)
    assert type(ts.searcher).__name__ == "ExhaustiveADCSearcher"
    assert ts.get_nb_indexed() == js.get_nb_indexed() == 300
    for qi in (3, 77):
        opts = {"max_returned": 6, "reranking": False}
        want = js.search_from_feats([(sha1s[qi], None)], [feats[qi]],
                                    dict(opts))
        got = ts.search_from_feats([(sha1s[qi], None)], [feats[qi]],
                                   dict(opts))
        _assert_outputs_equal(want, got)


def test_unported_options_raise(store):
    base = dict(model_type="lopq", V=V, M=M, subquantizer_clusters=S,
                detector_type="full", featurizer=_NoFeaturizer(),
                device="cpu")
    # Ported since: sharded=True builds the JAX facade's sharded searcher
    # (one shard on a CPU facade) and the bfloat16 store reaches the
    # probed searcher, with exact=True still winning.
    from columbiaimagesearch_tpu_torch.index.exhaustive_adc import (
        ExhaustiveADCSearcher,
    )
    from columbiaimagesearch_tpu_torch.parallel.sharded import (
        ShardedLOPQSearcher,
    )

    model = LOPQModel.from_numpy(*store[2], device="cpu")
    for kw, cls in ((dict(sharded=True), ShardedLOPQSearcher),
                    (dict(rerank_dtype="bfloat16"), LOPQSearcherTorch),
                    (dict(sharded=True, exact=True), ExhaustiveADCSearcher)):
        fac = SearcherLOPQ(**base, **kw, model=model, storer=None,
                           indexer=None)
        assert type(fac.searcher) is cls
        if cls is not ExhaustiveADCSearcher:
            assert fac.searcher.rerank_dtype == fac.rerank_dtype
        if cls is ShardedLOPQSearcher:
            assert fac.searcher.index.devices == [torch.device("cpu")]
    # Training is ported (tests/test_torch_train.py): with no features to
    # harvest, train_at_init fails as the JAX facade does.
    with pytest.raises(RuntimeError, match="Not enough features"):
        SearcherLOPQ(**base, train_at_init=True, storer=None,
                     indexer=KVIndexer())
    # Faces are ported: detector_type="face" builds the conv-HOG detector
    # on the facade's device.
    from columbiaimagesearch_tpu_torch.extraction.detector import (
        FaceDetector,
    )

    face = SearcherLOPQ(**dict(base, detector_type="face"))
    assert isinstance(face.detector, FaceDetector)
    assert face.detector.model.device.type == "cpu"
    assert SearcherLOPQ(**base, rerank_dtype="auto").searcher is None


@pytest.mark.parametrize("pca", [False, True])
def test_model_pickles_as_npz_fields(pca):
    rng = np.random.RandomState(1)
    params = _params(rng, rng.randn(50, DIM).astype(np.float32))
    if pca:
        P = np.linalg.qr(rng.randn(96, DIM))[0].astype(np.float32)
        m = LOPQModelPCA.from_numpy(*params, P, rng.randn(96), True,
                                    device="cpu")
    else:
        m = LOPQModel.from_numpy(*params, device="cpu")
    blob = pickle.dumps(m)
    assert b"_rebuild_tensor" not in blob    # numpy arrays, not tensors
    back = pickle.loads(blob)
    assert type(back) is type(m) and back.device.type == "cpu"
    for k, v in m._npz_fields().items():
        np.testing.assert_array_equal(back._npz_fields()[k], v)


def test_factory_builds_the_facade_from_a_conf(store, tmp_path):
    """``build_searcher`` wires KVI_/ST_/SEARCHLOPQ_ keys like the JAX
    factory; the facade loads its model from the storer."""
    from columbiaimagesearch_tpu.common.factory import (
        generate_conf_searcher as jax_generate,
    )

    root, db, params, _, _ = store
    path = str(tmp_path / "kv.db")
    shutil.copy(db, path)
    conf = {"SEARCHLOPQ_model_type": "lopq", "SEARCHLOPQ_lopq_V": V,
            "SEARCHLOPQ_lopq_M": M, "SEARCHLOPQ_lopq_subq": S,
            "SEARCHLOPQ_reranking": True, "SEARCHLOPQ_rerank_nb": 40,
            "SEARCHLOPQ_store_rerank_feats": True,
            "SEARCHLOPQ_coalesce_window_ms": 2,
            "KVI_db_path": path, "ST_storer_type": "local",
            "ST_base_path": str(tmp_path / "storer")}
    storer = LocalStorer(conf["ST_base_path"])
    storer.save("sentibank_feat_full_image_lopq-subq32-V8-M4",
                LOPQModel.from_numpy(*params, device="cpu"))
    conf_path = str(tmp_path / "conf.json")
    with open(conf_path, "w") as f:
        __import__("json").dump(conf, f)
    import columbiaimagesearch_tpu_torch.searcher.searcher_lopq as sl

    orig = sl.GenericSearcher.__init__

    def no_featurizer(self, **kw):   # keep the test off the 4096-d net
        kw["featurizer"] = _NoFeaturizer()
        orig(self, **kw)

    sl.GenericSearcher.__init__ = no_featurizer
    try:
        s = build_searcher(conf_path, device="cpu")
    finally:
        sl.GenericSearcher.__init__ = orig
    try:
        assert s.build_model_str() == \
            "sentibank_feat_full_image_lopq-subq32-V8-M4"
        assert isinstance(s.searcher, LOPQSearcherTorch)
        assert s.get_nb_indexed() == N_IMGS and s.searcher.has_rerank_feats
        assert s.request_batcher is not None and s.rerank_nb == 40
    finally:
        s.request_batcher.close()
    env = {"model_type": "lopq_pca", "LOPQ_V": "4096", "db_path": "x.db",
           "coalesce_window_ms": "4"}
    assert generate_conf_searcher(env) == jax_generate(env)
    assert torch.get_num_threads() >= 1
