"""Model ``.mat`` and protobuf I/O of the port (index/model.py,
index/proto.py) against the JAX package: files written by either package
read by the other with equal tables, proto files byte-identical both ways,
a PCA model writing its LOPQ tables only, and the raises that name a
missing package."""

import sys

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch.index.model import LOPQModel, LOPQModelPCA

from tests.oracle_lopq import random_params


@pytest.fixture(scope="module")
def models():
    from columbiaimagesearch_tpu.index.model import LOPQModel as JaxModel

    params = random_params(np.random.RandomState(3), V=12, M=4, S=16, D=24)
    return JaxModel(parameters=params), LOPQModel.from_numpy(*params,
                                                             device="cpu")


def _assert_tables(jm, tm):
    np.testing.assert_array_equal(tm.Cs.numpy(), np.stack(jm.Cs))
    np.testing.assert_array_equal(tm.Rs.numpy(), np.stack(jm.Rs))
    np.testing.assert_array_equal(tm.mus.numpy(), np.stack(jm.mus))
    np.testing.assert_array_equal(
        tm.subs.numpy(), np.stack([np.stack(h) for h in jm.subquantizers]))
    assert (tm.V, tm.M, tm.subquantizer_clusters) == (
        jm.V, jm.M, jm.subquantizer_clusters)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_mat_round_trip_across_packages(models, tmp_path, writer):
    from columbiaimagesearch_tpu.index.model import LOPQModel as JaxModel

    jm, tm = models
    path = str(tmp_path / "m.mat")
    (jm if writer == "jax" else tm).export_mat(path)
    got = LOPQModel.load_mat(path, device="cpu")
    assert got.device == torch.device("cpu")
    _assert_tables(jm, got)
    _assert_tables(JaxModel.load_mat(path), tm)
    X = np.random.RandomState(4).randn(50, 24).astype(np.float32)
    want = tm.predict_batch(torch.from_numpy(X))
    for a, b in zip(got.predict_batch(torch.from_numpy(X)), want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_proto_byte_identical_across_packages(models, tmp_path, writer):
    from columbiaimagesearch_tpu.index.model import LOPQModel as JaxModel

    jm, tm = models
    pj, pt = str(tmp_path / "j.pb"), str(tmp_path / "t.pb")
    jm.export_proto(pj)
    with open(pt, "wb") as f:              # a file object works too
        tm.export_proto(f)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    path = pj if writer == "jax" else pt
    _assert_tables(jm, LOPQModel.load_proto(path, device="cpu"))
    _assert_tables(JaxModel.load_proto(path), tm)


def test_pca_model_writes_its_lopq_tables(models, tmp_path):
    jm, tm = models
    rng = np.random.RandomState(5)
    pca = LOPQModelPCA(tm.Cs, tm.Rs, tm.mus, tm.subs,
                       rng.randn(40, 24).astype(np.float32),
                       rng.randn(40).astype(np.float32), device="cpu")
    pca.export_mat(str(tmp_path / "p.mat"))
    pca.export_proto(str(tmp_path / "p.pb"))
    tm.export_proto(str(tmp_path / "t.pb"))
    for back in (LOPQModel.load_mat(str(tmp_path / "p.mat"), device="cpu"),
                 LOPQModelPCA.load_proto(str(tmp_path / "p.pb"),
                                         device="cpu")):
        assert type(back) is LOPQModel
        _assert_tables(jm, back)
    assert (tmp_path / "p.pb").read_bytes() == (tmp_path / "t.pb").read_bytes()


def test_missing_packages_raise_naming_them(models, tmp_path, monkeypatch):
    _, tm = models
    monkeypatch.setitem(sys.modules, "scipy.io", None)
    with pytest.raises(ImportError, match="scipy"):
        tm.export_mat(str(tmp_path / "x.mat"))
    with pytest.raises(ImportError, match="scipy"):
        LOPQModel.load_mat(str(tmp_path / "x.mat"), device="cpu")
    from columbiaimagesearch_tpu_torch.index import protos

    monkeypatch.delitem(
        sys.modules, "columbiaimagesearch_tpu_torch.index.protos."
        "lopq_model_pb2", raising=False)
    monkeypatch.delattr(protos, "lopq_model_pb2", raising=False)
    monkeypatch.setitem(sys.modules, "google.protobuf", None)
    with pytest.raises(ImportError, match="protobuf"):
        tm.export_proto(str(tmp_path / "x.pb"))
    with pytest.raises(ImportError, match="protobuf"):
        LOPQModel.load_proto(str(tmp_path / "x.pb"), device="cpu")
