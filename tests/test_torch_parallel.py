"""The port's mesh layer (``parallel/``) against the JAX package's on the
same inputs: the JAX functions run on the 8-device CPU mesh of
tests/conftest.py, the port's on 8 logical CPU shards (one device named 8
times, parallel/mesh.py). Mirrors tests/test_parallel.py.

Tolerances: ``dp_encode`` codes equal; ``dp_lloyd_step`` centroids and
inertia within rtol 1e-5; sharded ranked results with ids equal (the
inputs have no ADC ties) and distances within rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch.index.model import LOPQModel
from columbiaimagesearch_tpu_torch.ops.kmeans import _lloyd_sums, _update
from columbiaimagesearch_tpu_torch.parallel import (
    DATA_AXIS,
    SHARD_AXIS,
    ShardedLOPQIndex,
    dp_encode,
    dp_lloyd_step,
    make_mesh,
    shard_rows,
)

from tests.oracle_lopq import random_params

CPU8 = ["cpu"] * 8


def test_mesh_of_logical_shards():
    mesh = make_mesh(devices=CPU8)
    assert mesh.size == len(mesh) == 8 and mesh.axis_name == DATA_AXIS
    assert all(d == torch.device("cpu") for d in mesh)
    assert make_mesh(3, SHARD_AXIS, CPU8).size == 3
    assert make_mesh(axis=SHARD_AXIS, devices=CPU8).axis_name == SHARD_AXIS
    X = np.arange(30, dtype=np.float32).reshape(10, 3)
    shards, n = shard_rows(mesh, X)
    assert n == 10 and [s.shape[0] for s in shards] == [2] * 8
    np.testing.assert_array_equal(torch.cat(shards)[:10].numpy(), X)
    assert float(torch.cat(shards)[10:].abs().sum()) == 0.0


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(devices=["cuda"])


def test_dp_lloyd_step_matches_jax_and_single_device():
    import jax

    from columbiaimagesearch_tpu.parallel.mesh import make_mesh as jmesh
    from columbiaimagesearch_tpu.parallel.mesh import shard_rows as jshard
    from columbiaimagesearch_tpu.parallel.sharded import (
        dp_lloyd_step as jax_step,
    )

    rng = np.random.RandomState(0)
    X = rng.randn(1000, 16).astype(np.float32)
    C = rng.randn(8, 16).astype(np.float32)

    jm = jmesh()
    Xs, n = jshard(jm, X)
    w = np.zeros(Xs.shape[0], dtype=np.float32)
    w[:n] = 1.0
    ws, _ = jshard(jm, w)
    C_jax, in_jax = jax_step(Xs, ws, jax.device_put(C), 8)

    mesh = make_mesh(devices=CPU8)
    Xt, n = shard_rows(mesh, X)
    wt, _ = shard_rows(mesh, np.ones(n, np.float32))
    C_new, inertia = dp_lloyd_step(Xt, wt, torch.from_numpy(C), 8)
    np.testing.assert_allclose(C_new.numpy(), np.asarray(C_jax), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(inertia), float(in_jax), rtol=1e-5)

    # The port's single-device Lloyd step on the same rows.
    Ct = torch.from_numpy(C)
    sums, counts, total = _lloyd_sums([torch.from_numpy(X)], Ct, 256)
    np.testing.assert_allclose(C_new.numpy(),
                               _update(Ct, sums, counts).numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(inertia), float(total), rtol=1e-5)


@pytest.fixture(scope="module")
def model_and_data():
    from columbiaimagesearch_tpu.index.model import LOPQModel as JaxModel

    rng = np.random.RandomState(5)
    params = random_params(rng, V=8, M=4, S=16, D=32)
    X = rng.randn(1500, 32).astype(np.float32)
    return (JaxModel(parameters=params),
            LOPQModel.from_numpy(*params, device="cpu"), X)


@pytest.mark.parametrize("n_shards", [1, 8])
def test_dp_encode_matches_jax_and_predict_batch(model_and_data, n_shards):
    from columbiaimagesearch_tpu.parallel.mesh import make_mesh as jmesh
    from columbiaimagesearch_tpu.parallel.sharded import (
        dp_encode as jax_encode,
    )

    jm, tm, X = model_and_data
    tables = (tm.Cs, tm.Rs, tm.mus, tm.subs)
    coarse, fine = dp_encode(make_mesh(devices=["cpu"] * n_shards),
                             *tables, X, chunk=64)
    jc, jf = jax_encode(jmesh(), *(t.numpy() for t in tables), X, chunk=64)
    np.testing.assert_array_equal(coarse, jc)
    np.testing.assert_array_equal(fine, jf)
    pc, pf = tm.predict_batch(X)
    np.testing.assert_array_equal(coarse, pc.astype(np.int32))
    np.testing.assert_array_equal(fine, pf.astype(np.int32))


def assert_pairs_match(want, got, rtol=1e-5):
    """Sharded (id, dist) lists: distances within ``rtol``, and the same
    ids in the same order except where a distance ties its neighbour."""
    assert len(got) == len(want)
    dw = np.array([d for _, d in want])
    dg = np.array([d for _, d in got])
    np.testing.assert_allclose(dg, dw, rtol=rtol, atol=1e-6)
    for i, ((a, _), (b, _)) in enumerate(zip(want, got)):
        if a != b:
            near = dw[max(i - 1, 0):i + 2]
            assert (np.abs(near - dw[i]) <= rtol * abs(dw[i])).sum() > 1


def test_sharded_index_matches_jax_and_host_searcher(model_and_data):
    from columbiaimagesearch_tpu.index.searcher import LOPQSearcher
    from columbiaimagesearch_tpu.parallel.mesh import make_mesh as jmesh
    from columbiaimagesearch_tpu.parallel.sharded import (
        ShardedLOPQIndex as JaxIndex,
    )

    jm, tm, X = model_and_data
    ids = [f"img_{i}" for i in range(len(X))]
    coarse, fine = jm.predict_batch(X)

    jidx = JaxIndex(jm, mesh=jmesh(axis="shard"))
    jidx.build(coarse, fine, ids)
    idx = ShardedLOPQIndex(tm, mesh=make_mesh(axis=SHARD_AXIS, devices=CPU8))
    idx.build(coarse, fine, ids)
    assert idx.nb_indexed == jidx.nb_indexed == len(X)
    assert idx._cap_per == jidx._cap_per

    host = LOPQSearcher(jm)
    host.add_codes((coarse, fine), ids)
    rng = np.random.RandomState(9)
    for q in rng.randn(5, 32).astype(np.float32):
        got, visited = idx.search(q, quota=400, limit=10)
        want, jvisited = jidx.search(q, quota=400, limit=10)
        assert visited == jvisited
        assert_pairs_match(want, got)
        hw, _ = host.search(q, quota=3200, limit=10, with_dists=True)
        assert got[0][0] == hw[0].id
