"""The port's offline index build (``index/build_index.py``), conf
generator (``common/generate_conf.py``) and ``LOPQModel.
get_split_parameters`` against the JAX package's scripts and model, on
the CPU.

Both ``build_index`` entry points run on one 2,000-row ``.npy`` and the
``.fvecs`` of it (dim 32, V=8, M=4); each package's code store reads the
other's file, and the JAX-trained model carried across encodes to JAX's
cells, fine codes and ids exactly. The JAX scripts are called as
tests/test_torch_config_scripts.py calls them (``sys.argv`` patched).
"""

import os
import sys

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch.common import generate_conf
from columbiaimagesearch_tpu_torch.index import build_index
from columbiaimagesearch_tpu_torch.index.model import LOPQModel, LOPQModelPCA
from columbiaimagesearch_tpu_torch.index.searcher import LOPQSearcherTorch
from columbiaimagesearch_tpu_torch.native.codestore import CodeStore
from columbiaimagesearch_tpu_torch.store.storer import LocalStorer
from columbiaimagesearch_tpu_torch.utils.xvecs import save_xvecs

from tests.test_torch_codestore import steady_jax_codestore

N, D, V, M = 2000, 32, 8, 4


def _features(tmp_path):
    X = np.random.RandomState(0).randn(N, D).astype(np.float32)
    npy = str(tmp_path / "feats.npy")
    np.save(npy, X)
    fvecs = str(tmp_path / "feats.fvecs")
    save_xvecs(X, fvecs)
    return X, npy, fvecs


def _jax_build(monkeypatch, features, out, *extra):
    from scripts import build_index as jax_build_index

    monkeypatch.setattr(sys, "argv", [
        "build_index.py", "--features", features, "--out", out, "--V",
        str(V), "--M", str(M), *extra])
    jax_build_index.main()


def _port_args(features, out, *extra):
    return ["--features", features, "--out", out, "--V", str(V), "--M",
            str(M), "--cpu", *extra]


def test_load_features_reads_npy_npz_and_fvecs(tmp_path):
    from scripts.build_index import load_features as jax_load

    X, npy, fvecs = _features(tmp_path)
    npz = str(tmp_path / "feats.npz")
    np.savez(npz, feats=X)
    for path in (npy, npz, fvecs):
        got = build_index.load_features(path)
        np.testing.assert_array_equal(got, jax_load(path))
        np.testing.assert_array_equal(got, X)
    with pytest.raises(ValueError, match="unsupported"):
        build_index.load_features(str(tmp_path / "feats.txt"))


@pytest.mark.parametrize("base_type", ["f", "i", "b"])
def test_save_xvecs_writes_the_jax_bytes(tmp_path, base_type):
    """The port's one-write ``save_xvecs`` against the JAX package's
    row-by-row writer, and back through ``load_xvecs``."""
    from columbiaimagesearch_tpu.utils.xvecs import save_xvecs as jax_save

    from columbiaimagesearch_tpu_torch.utils.xvecs import load_xvecs

    rng = np.random.RandomState(3)
    data = {"f": rng.randn(7, 5), "i": rng.randint(0, 1 << 20, (4, 3)),
            "b": rng.randint(0, 256, (6, 9))}[base_type]
    got, want = tmp_path / "port", tmp_path / "jax"
    save_xvecs(data, str(got), base_type)
    jax_save(data, str(want), base_type)
    assert got.read_bytes() == want.read_bytes()
    back = load_xvecs(str(got), base_type)
    np.testing.assert_array_equal(back, data.astype(back.dtype))


@pytest.mark.parametrize("which", ["npy", "fvecs"])
def test_build_index_matches_jax_script(tmp_path, monkeypatch, which):
    """Both scripts build from one file; each code store reads the other's
    file; the JAX model carried across encodes to JAX's codes exactly; the
    port's build loads into ``LOPQSearcherTorch``, whose answers equal a
    searcher fed the same codes in memory."""
    JaxCodeStore = steady_jax_codestore()
    X, npy, fvecs = _features(tmp_path)
    features = {"npy": npy, "fvecs": fvecs}[which]
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_build(monkeypatch, features, jax_out)
    res = build_index.main(_port_args(features, port_out))
    model_str = "offline_lopq-V8-M4"
    assert res["model_str"] == model_str
    assert set(res["stages"]) == {"load", "train", "save", "encode",
                                  "append", "sync"}
    jax_codes = os.path.join(jax_out, f"{model_str}.codes")
    port_codes = os.path.join(port_out, f"{model_str}.codes")
    assert res["codes"] == port_codes

    # Each package's code store reads the other's file.
    for cls, path, other in ((CodeStore, jax_codes, JaxCodeStore),
                             (JaxCodeStore, port_codes, CodeStore)):
        a, b = cls(path, m=M), other(path, m=M)
        try:
            ca, fa, ia = a.read_all()
            cb, fb, ib = b.read_all()
        finally:
            a.close()
            b.close()
        np.testing.assert_array_equal(ca, cb)
        np.testing.assert_array_equal(fa, fb)
        assert ia == ib and len(ia) == N

    # The JAX-trained model carried across encodes to JAX's codes.
    from columbiaimagesearch_tpu.store.storer import (
        LocalStorer as JaxLocalStorer,
    )

    jm = JaxLocalStorer(os.path.join(jax_out, "storer")).load(model_str)
    carried = LOPQModel.from_numpy(jm.Cs, jm.Rs, jm.mus, jm.subquantizers,
                                   device="cpu")
    cells, fine = build_index.encode_rows(carried, X)
    again = str(tmp_path / "carried.codes")
    laps = []
    build_index.write_codes(again, cells, fine, [str(i) for i in range(N)],
                            laps.append)
    assert laps == ["append", "sync"]
    js, ps = JaxCodeStore(jax_codes, m=M), CodeStore(again, m=M)
    try:
        want, got = js.read_all(), ps.read_all()
    finally:
        js.close()
        ps.close()
    for w, g in zip(want[:2], got[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]

    # The port's build serves: model from the storer, codes from the file.
    model = LocalStorer(os.path.join(port_out, "storer")).load(model_str)
    assert isinstance(model, LOPQModel) and model.V == V and model.M == M
    s = LOPQSearcherTorch(model, codestore_path=port_codes)
    mem = LOPQSearcherTorch(model)
    mem.add_codes(model.predict_batch(X), [str(i) for i in range(N)])
    assert s.get_nb_indexed() == N
    for q in X[:5]:
        a = s.search(q, quota=200, limit=10, with_dists=True)[0]
        b = mem.search(q, quota=200, limit=10, with_dists=True)[0]
        assert sorted((r.dist, r.id) for r in a) == \
            sorted((r.dist, r.id) for r in b)
    s._codestore.close()


def test_build_index_pca_and_ids(tmp_path):
    """``--model-type lopq_pca`` with ``--ids``: a ``LOPQModelPCA`` in the
    storer and the given ids in the code store."""
    rng = np.random.RandomState(1)
    X = rng.randn(1500, 48).astype(np.float32)
    np.save(tmp_path / "f.npy", X)
    ids = [f"img{i}" for i in range(len(X))]
    (tmp_path / "ids.txt").write_text("\n".join(ids) + "\n")
    out = str(tmp_path / "out")
    res = build_index.main(["--features", str(tmp_path / "f.npy"), "--ids",
                            str(tmp_path / "ids.txt"), "--out", out,
                            "--model-type", "lopq_pca", "--V", "4", "--M",
                            "4", "--subq", "16", "--pca-dims", "16",
                            "--nb-train", "1000", "--cpu"])
    model = LocalStorer(os.path.join(out, "storer")).load(res["model_str"])
    assert res["model_str"] == "offline_lopq_pca-V4-M4"
    assert isinstance(model, LOPQModelPCA)
    assert tuple(model.pca_P.shape) == (48, 16)
    cs = CodeStore(res["codes"], m=4)
    try:
        cells, fine, got_ids = cs.read_all()
    finally:
        cs.close()
    want_cells, want_fine = build_index.encode_rows(model, X)
    order = np.argsort(want_cells, kind="stable")
    np.testing.assert_array_equal(cells, want_cells[order])
    np.testing.assert_array_equal(fine, want_fine[order])
    assert got_ids == [ids[i] for i in order]


def test_get_split_parameters_matches_jax():
    from columbiaimagesearch_tpu.index.model import LOPQModel as JaxModel

    rng = np.random.RandomState(2)
    Vs, Dh, F, S = 4, 8, 2, 8
    jm = JaxModel(parameters=(
        tuple(rng.randn(Vs, Dh) for _ in range(2)),
        tuple(rng.randn(Vs, Dh, Dh) for _ in range(2)),
        tuple(rng.randn(Vs, Dh) for _ in range(2)),
        tuple([rng.randn(S, Dh // F) for _ in range(F)] for _ in range(2))))
    pm = LOPQModel.from_numpy(jm.Cs, jm.Rs, jm.mus, jm.subquantizers,
                              device="cpu")
    for split in (0, 1):
        want = jm.get_split_parameters(split)
        got = pm.get_split_parameters(split)
        assert all(isinstance(t, torch.Tensor) and t.device == pm.device
                   for t in got)
        for w, g in zip(want[:3], got[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(got[3].numpy(), np.stack(want[3]))


def test_generate_conf_writes_the_jax_scripts_bytes(tmp_path, monkeypatch):
    from scripts import generate_conf as jax_generate_conf

    env = {"lopq_V": "4096", "SEARCHLOPQ_lopq_M": "8", "model_type":
           "lopq_pca", "input_type": "kafka", "input_topic": "imgs",
           "input_consumer_group": "g", "KAFKA_SERVERS": "k0:9093",
           "extr_type": "sbpycaffe", "batch_update_size": "1000",
           "db_path": "/data/kv.db", "storer_base_path": "/data/st",
           "image_pushing_type": "kinesis", "images_stream": "s",
           "region_name": "us-east-1", "nb_shards": "2"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for roles in (["searcher"], ["extractor", "ingester"],
                  ["searcher", "extractor", "ingester"]):
        want, got = tmp_path / "jax.json", tmp_path / "port.json"
        monkeypatch.setattr(sys, "argv", ["generate_conf.py", *roles, "-o",
                                          str(want)])
        jax_generate_conf.main()
        assert generate_conf.main([*roles, "-o", str(got)]) == str(got)
        assert got.read_bytes() == want.read_bytes()
        assert len(got.read_bytes()) > 10
    # The default path names the roles, under conf/generated/.
    monkeypatch.chdir(tmp_path)
    out = generate_conf.main(["extractor", "ingester"])
    assert out == os.path.join("conf", "generated",
                               "conf_extractor_ingester.json")
    assert (tmp_path / out).exists()
