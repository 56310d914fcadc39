"""The inputs and the sample are the same for the same seed."""

import numpy as np
import pytest
import torch

from portbench import data, spec
from portbench.tests.conftest import tiny_cell


def _inputs(seed, config="release_10Mi"):
    return data.Inputs(tiny_cell(config).cfg, seed, torch.device("cpu"))


def test_queries_follow_the_seed():
    big = 2**33 + 1
    a, b, c = _inputs(big), _inputs(big), _inputs(big + 1)
    assert torch.equal(a.queries(50), b.queries(50))
    assert not torch.equal(a.queries(50), c.queries(50))
    assert a.queries(50).shape == (50, 64)


def test_index_follows_the_configuration():
    a, c = _inputs(5, "face_8Mi"), _inputs(6, "face_8Mi")
    for k in a.tables:
        assert torch.equal(a.tables[k], c.tables[k])
    assert torch.equal(a.rows(), c.rows())
    assert torch.equal(a.rows(), a.rows())
    assert a.pca is None


@pytest.mark.parametrize("config", ["release_10Mi", "face_8Mi"])
def test_features_are_unit_norm(config):
    """Queries are unit-norm, as the facade hands them to the index; the
    corpus is unit-norm features (their PCA image, of norm under 1, for a
    ``lopq_pca`` configuration)."""
    inp = _inputs(2**33 + 5, config)
    q = torch.linalg.vector_norm(inp.queries(40), dim=1)
    assert torch.allclose(q, torch.ones_like(q), atol=1e-5)
    r = torch.linalg.vector_norm(inp.rows(), dim=1)
    if inp.pca is None:
        assert torch.allclose(r, torch.ones_like(r), atol=1e-5)
    else:
        assert (r < 1).all() and (r > 0.5).all()


def test_pca_is_the_basis():
    inp = _inputs(3)
    P = inp.pca["P"]
    assert torch.allclose(P.T @ P, torch.eye(P.shape[1]), atol=1e-5)


def test_waves_and_kept_answers_follow_the_seed(cpu):
    """The pool of waves, which waves keep answers and which of their
    queries, by wave ordinal, are the same for the same seed."""
    cell = tiny_cell()

    def kept(seed):
        load = spec.kind("bulk_waves").Load(cell.cfg, cell.mix, seed, cpu)
        load.setup()
        load.window(0.2, False)
        kept = load.kept
        return load.pool, [(int(k), int(i)) for k, i in kept.where[:kept.n]]

    p1, k1 = kept(2**34)
    p2, k2 = kept(2**34)
    p3, k3 = kept(2**34 + 1)
    np.testing.assert_array_equal(p1, p2)
    assert not np.array_equal(p1, p3)
    n = min(len(k1), len(k2))
    assert n >= 8 and k1[:n] == k2[:n]
    assert k1[:n] != k3[:n]
