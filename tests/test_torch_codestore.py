"""The port's native code store (``native/codestore.py``, the repository's
``native/codestore.cpp`` built into ``build/native/``) and
``codestore_path`` on ``LOPQSearcherTorch`` and the ``SearcherLOPQ``
facade, against the JAX package's.

The file format is the C++ source's: a store either package writes opens
in the other, and the two packages write byte-identical files from the
same appends. A restarted searcher reloads ``read_all()``'s rows, which
are sorted by cell, so its insertion order differs from the searcher's
before the restart: a restarted port searcher is held to a restarted JAX
searcher (ids equal except swaps between rounding ties, distances rtol
1e-4, atol 1e-5, as tests/test_torch_searcher.py holds them).
"""

import time

import numpy as np
import pytest

from columbiaimagesearch_tpu_torch.index.model import LOPQModel
from columbiaimagesearch_tpu_torch.index.searcher import LOPQSearcherTorch
from columbiaimagesearch_tpu_torch.native.codestore import ID_LEN, CodeStore
from columbiaimagesearch_tpu_torch.searcher.searcher_lopq import SearcherLOPQ
from columbiaimagesearch_tpu_torch.store import KVIndexer, MemoryStorer

from tests.oracle_lopq import random_params
from tests.test_torch_facade import _fill
from tests.test_torch_searcher import _assert_results_match

V, M, S, D = 8, 4, 16, 32


def steady_jax_codestore(timeout_s=60.0):
    """The JAX package's ``CodeStore`` class once its library has loaded
    for certain. The JAX loader compiles ``native/libcodestore.so`` straight
    onto the library's path when it is missing or older than its source;
    test workers that start together can then load a file another worker
    is still writing, get ``OSError`` and cache None. This clears the
    cache and retries until the file is whole (the pattern of
    tests/test_torch_sentibank.py ``steady_jax_imgpipe``)."""
    from columbiaimagesearch_tpu.native import build
    from columbiaimagesearch_tpu.native.codestore import (
        CodeStore as JaxCodeStore,
    )

    deadline = time.monotonic() + timeout_s
    while True:
        with build._LOCK:
            build._CACHE.pop("codestore", None)
        if build.load_library("codestore") is not None:
            return JaxCodeStore
        if time.monotonic() > deadline:
            pytest.fail(f"the JAX package's native/libcodestore.so did not "
                        f"load within {timeout_s:.0f} s")
        time.sleep(0.5)


def _rows(rng, n, m=8, first=0):
    cells = rng.randint(0, 50, n)
    codes = rng.randint(0, 256, (n, m))
    ids = [f"id{first + i}" for i in range(n)]
    return cells, codes, ids


def _same(a, b):
    (ca, fa, ia), (cb, fb, ib) = a, b
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(fa, fb)
    assert ia == ib


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_written_by_one_package_reads_in_the_other(tmp_path, writer):
    JaxCodeStore = steady_jax_codestore()
    classes = {"jax": JaxCodeStore, "port": CodeStore}
    reader = "port" if writer == "jax" else "jax"
    rng = np.random.RandomState(0)
    path = str(tmp_path / "codes.cs")
    w = classes[writer](path, m=8)
    batches = [_rows(rng, 700), _rows(rng, 900, first=700)]
    for cells, codes, ids in batches:
        w.append(cells, codes, ids)
    w.sync()
    want = w.read_all()
    w.close()
    r = classes[reader](path, m=8)
    assert len(r) == 1600
    got = r.read_all()
    _same(got, want)
    assert (np.diff(got[0].astype(np.int64)) >= 0).all()
    cells = np.concatenate([b[0] for b in batches])
    order = np.argsort(cells, kind="stable")      # cs_sync's stable sort
    all_ids = [i for b in batches for i in b[2]]
    assert got[2] == [all_ids[k] for k in order]
    codes, ids = r.query_cell(int(cells[3]))
    assert ids == [all_ids[k] for k in order if cells[k] == cells[3]]
    r.close()


def test_both_packages_write_the_same_file(tmp_path):
    JaxCodeStore = steady_jax_codestore()
    rng = np.random.RandomState(1)
    batches = [_rows(rng, 1500), _rows(rng, 40, first=1500)]
    for name, cls in (("jax", JaxCodeStore), ("port", CodeStore)):
        cs = cls(str(tmp_path / f"{name}.cs"), m=8)
        for b in batches:
            cs.append(*b)
            cs.sync()
        cs.close()
    assert (tmp_path / "port.cs").read_bytes() == \
        (tmp_path / "jax.cs").read_bytes()


def test_ids_are_split_from_one_copy_of_the_buffer():
    """``read_all`` and ``query_cell`` copy the ctypes id buffer once
    (``_split_ids``); the JAX binding copies it once per id, which is
    quadratic in the row count."""
    from columbiaimagesearch_tpu_torch.native import codestore

    class Buf:
        reads = 0

        @property
        def raw(self):
            Buf.reads += 1
            return b"".join(s.encode().ljust(ID_LEN, b"\0")
                            for s in ("a", "bb", "c" * ID_LEN))

    assert codestore._split_ids(Buf(), 3) == ["a", "bb", "c" * ID_LEN]
    assert Buf.reads == 1


def test_mismatched_m_is_rejected_and_face_ids_fit(tmp_path):
    path = str(tmp_path / "codes.cs")
    cs = CodeStore(path, m=8)
    # A face id <sha1>_<left>_<top>_<right>_<bottom> fits the 64-byte id.
    face_id = "F" * 40 + "_1024_2048_4095_3071"
    assert len(face_id) <= ID_LEN
    cs.append(np.array([7]), np.zeros((1, 8), np.uint8), [face_id])
    cs.sync()
    cs.close()
    with pytest.raises(RuntimeError):
        CodeStore(path, m=16)
    again = CodeStore(path, m=8)
    assert again.read_all()[2] == [face_id]
    again.close()


def test_restarted_searcher_matches_restarted_jax(tmp_path):
    from columbiaimagesearch_tpu.index.searcher import LOPQSearcherTPU

    steady_jax_codestore()
    rng = np.random.RandomState(3)
    params = random_params(rng, V=V, M=M, S=S, D=D)
    from columbiaimagesearch_tpu.index.model import LOPQModel as JaxModel

    jm, tm = JaxModel(parameters=params), LOPQModel.from_numpy(
        *params, device="cpu")
    X = rng.randn(3000, D).astype(np.float32)
    coarse, fine = jm.predict_batch(X)
    ids = np.asarray([f"img{i}" for i in range(3000)], dtype=object)
    paths = {n: str(tmp_path / f"{n}.cs") for n in ("jax", "port")}
    first = {"jax": LOPQSearcherTPU(jm, None, paths["jax"]),
             "port": LOPQSearcherTorch(tm, None, paths["port"])}
    for a, b in ((0, 1000), (1000, 2500), (2500, 3000), (0, 10)):
        for s in first.values():
            s.add_codes((coarse[a:b], fine[a:b]), ids[a:b])
    assert first["port"].get_nb_indexed() == 3000
    for s in first.values():
        s._codestore.close()
    # 3,010 records: the store keeps the duplicate add; the restarted
    # searchers' dedup drops it again.
    again = {"jax": LOPQSearcherTPU(jm, codestore_path=paths["jax"]),
             "port": LOPQSearcherTorch(tm, codestore_path=paths["port"])}
    assert len(again["port"]._codestore) == 3010
    assert again["port"].get_nb_indexed() == \
        again["jax"].get_nb_indexed() == 3000
    Q = X[[5, 1700, 2999]] + 0.01 * rng.randn(3, D).astype(np.float32)
    want = again["jax"].search_batch(Q, quota=200, limit=20,
                                     with_dists=True)
    got = again["port"].search_batch(Q, quota=200, limit=20,
                                     with_dists=True)
    for w, g in zip(want, got):
        _assert_results_match(w, g)
    assert {r.id for r in got[0][0]} >= {"img5"}
    # Appends after the restart persist too.
    extra = rng.randn(50, D).astype(np.float32)
    c2, f2 = jm.predict_batch(extra)
    again["port"].add_codes((c2, f2), [f"new{i}" for i in range(50)])
    again["port"]._codestore.close()
    third = LOPQSearcherTorch(tm, codestore_path=paths["port"])
    assert third.get_nb_indexed() == 3050
    third._codestore.close()
    again["jax"]._codestore.close()


def test_facade_restarts_from_its_codestore(tmp_path):
    """tests/test_sharded_searcher.py::test_codestore_backed_searcher_restart
    on the port, without sharding: a second facade with no indexer and no
    storer rebuilds its index from the code store alone."""
    rng = np.random.RandomState(1)
    feats = rng.randn(300, 64).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    sha1s = [f"{i:040X}" for i in range(300)]
    kv = KVIndexer(path=":memory:")
    _fill(kv, feats, sha1s)
    storer = MemoryStorer()
    cs_path = str(tmp_path / "codes.cs")
    kw = dict(model_type="lopq", V=8, M=4, subquantizer_clusters=32,
              nb_train=300, nb_min_train=100, detector_type="full",
              featurizer_type="sentibank", featurizer=object(),
              codestore_path=cs_path, device="cpu")
    s1 = SearcherLOPQ(train_at_init=True, indexer=kv, storer=storer, **kw)
    assert s1.get_nb_indexed() == 300
    s1.searcher._codestore.close()
    s2 = SearcherLOPQ(train_at_init=False,
                      model=storer.load(s1.build_model_str()),
                      indexer=None, storer=None, **kw)
    assert s2.get_nb_indexed() == 300
    out = s2.search_from_feats([(sha1s[9], None)], [feats[9]],
                               {"max_returned": 3, "reranking": False})
    assert sha1s[9] in out["AllSimilarImages"][0]["SimilarImages"][
        "ImageSha1s"]
    s2.searcher._codestore.close()
