"""Probed query, rerank and brute plan of the port (index/query.py) against
the JAX package's ``lopq_query``/``lopq_query_orig``/``lopq_query_rerank``/
``brute_query_batch`` on the same tables, codes and queries.

``total``, ``n_cells`` and ``grid_ok`` must be exact. Rows must be equal
except swaps between float-rounding ties (as test_tpu_query_impls.py:57-59
checks), and distances match at rtol 1e-4, atol 1e-5 (fp32, sums taken in
another order).
"""

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch.index.csr import build_csr
from columbiaimagesearch_tpu_torch.index.model import LOPQModel
from columbiaimagesearch_tpu_torch.index.query import (
    brute_chunk,
    brute_query_batch,
    lopq_query,
    lopq_query_orig,
    lopq_query_rerank,
    pack_query_out,
    unpack_query_out,
)

from tests.oracle_lopq import random_params

V, M, S, D = 16, 8, 32, 64
N, QUOTA, QB, K = 4000, 400, 1024, 32


@pytest.fixture(scope="module")
def setup():
    import jax.numpy as jnp

    from columbiaimagesearch_tpu.index.csr import build_csr_device

    rng = np.random.RandomState(11)
    params = random_params(rng, V=V, M=M, S=S, D=D)
    model = LOPQModel.from_numpy(*params, device="cpu")
    jt = tuple(jnp.asarray(t.numpy())
               for t in (model.Cs, model.Rs, model.mus, model.subs))
    coarse = rng.randint(0, V, (N, 2)).astype(np.int32)
    fine = rng.randint(0, S, (N, M)).astype(np.uint8)
    jcsr = build_csr_device(jnp.asarray(coarse), jnp.asarray(fine), V)
    tcsr = build_csr(torch.from_numpy(coarse), torch.from_numpy(fine), V)
    feats = rng.randn(N, D).astype(np.float32)
    queries = rng.randn(6, D).astype(np.float32)
    return model, jt, jcsr, tcsr, feats, queries


def _assert_rows_match(ra, da, rb, db):
    np.testing.assert_allclose(db, da, rtol=1e-4, atol=1e-5)
    for i in np.nonzero(ra != rb)[0]:     # float-rounding ties only
        assert abs(da[i] - db[i]) <= 1e-4 * max(1.0, abs(da[i]))


RUNGS = [pytest.param(8, 0, id="square-B8"),
         pytest.param(8, 2, id="strip-B8-SB2")]


def _tables(model):
    return model.Cs, model.Rs, model.mus, model.subs


@pytest.mark.parametrize("B,SB", RUNGS)
def test_lopq_query_matches_jax(setup, B, SB):
    import jax.numpy as jnp

    from columbiaimagesearch_tpu.index.tpu_query import lopq_query as jq

    model, jt, (jcodes, jcs, _), (tcodes, tcs, _), _, queries = setup
    got = lopq_query(torch.from_numpy(queries), *_tables(model), tcodes,
                     tcs, QUOTA, V=V, B=B, Q=QB, K=K, SB=SB)
    for i, q in enumerate(queries):
        want = jq(jnp.asarray(q), *jt, jcodes, jcs,
                  jnp.asarray(QUOTA, jnp.int32), V=V, B=B, Q=QB, K=K, SB=SB)
        assert int(got[2][i]) == int(want[2])          # total
        assert int(got[3][i]) == int(want[3])          # n_cells
        assert bool(got[4][i]) == bool(want[4])        # grid_ok
        _assert_rows_match(np.asarray(want[0]), np.asarray(want[1]),
                           got[0][i].numpy(), got[1][i].numpy())


@pytest.mark.parametrize("B,SB", RUNGS)
def test_lopq_query_orig_matches_jax(setup, B, SB):
    import jax.numpy as jnp

    from columbiaimagesearch_tpu.index.tpu_query import lopq_query_orig as jq

    model, jt, (jcodes, jcs, jorder), (tcodes, tcs, torder), _, queries = setup
    got = lopq_query_orig(torch.from_numpy(queries), *_tables(model), tcodes,
                          tcs, torder, QUOTA, V=V, B=B, Q=QB, K=K, SB=SB)
    for i, q in enumerate(queries[:3]):
        want = jq(jnp.asarray(q), *jt, jcodes, jcs, jorder,
                  jnp.asarray(QUOTA, jnp.int32), V=V, B=B, Q=QB, K=K, SB=SB)
        assert int(got[2][i]) == int(want[2])
        assert int(got[3][i]) == int(want[3])
        assert bool(got[4][i]) == bool(want[4])
        _assert_rows_match(np.asarray(want[0]), np.asarray(want[1]),
                           got[0][i].numpy(), got[1][i].numpy())


@pytest.mark.parametrize("B,SB", RUNGS)
def test_lopq_query_rerank_matches_jax(setup, B, SB):
    import jax.numpy as jnp

    from columbiaimagesearch_tpu.index.tpu_query import (
        lopq_query_rerank as jq,
    )

    model, jt, (jcodes, jcs, jorder), (tcodes, tcs, torder), feats, \
        queries = setup
    R, K_out = 24, 16
    got = lopq_query_rerank(
        torch.from_numpy(queries), torch.from_numpy(feats), *_tables(model),
        tcodes, tcs, torder, QUOTA, V=V, B=B, Q=QB, K=K, R=R, K_out=K_out,
        SB=SB)
    assert got[0].shape == (len(queries), K_out)
    for i, q in enumerate(queries[:3]):
        want = jq(jnp.asarray(q), jnp.asarray(feats), *jt, jcodes, jcs,
                  jorder, jnp.asarray(QUOTA, jnp.int32), V=V, B=B, Q=QB, K=K,
                  R=R, K_out=K_out, SB=SB)
        assert int(got[2][i]) == int(want[2])
        assert int(got[3][i]) == int(want[3])
        assert bool(got[4][i]) == bool(want[4])
        _assert_rows_match(np.asarray(want[0]), np.asarray(want[1]),
                           got[0][i].numpy(), got[1][i].numpy())


def test_brute_query_batch_matches_jax(setup):
    import jax.numpy as jnp

    from columbiaimagesearch_tpu.index.tpu_query import (
        brute_query_batch as jb,
        unpack_query_out as junpack,
    )

    _, _, _, _, feats, queries = setup
    cap = N + 96                      # capacity pad rows past nb
    fbuf = np.zeros((cap, D), np.float32)
    fbuf[:N] = feats
    fsq = (fbuf * fbuf).sum(1)
    K_out = 16
    want = junpack(np.asarray(jb(
        jnp.asarray(queries), jnp.asarray(fbuf), jnp.asarray(fsq),
        jnp.int32(N), jnp.int32(77), K_pre=64, K_out=K_out, QCH=4)), K_out)
    got = unpack_query_out(brute_query_batch(
        torch.from_numpy(queries), torch.from_numpy(fbuf),
        torch.from_numpy(fsq), N, 77, K_pre=64, K_out=K_out,
        QCH=4).numpy(), K_out)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [1, 16, None])
def test_brute_result_does_not_depend_on_the_chunk_width(dtype, width):
    """Chunks of 1 and 16 queries and the pass's own width (the whole
    wave, this store being small) give the same packed output, bit for
    bit, on a float32 and a bfloat16 store with capacity pad rows."""
    rng = np.random.RandomState(5)
    nb, cap, nq = 900, 1024, 40
    fbuf = torch.zeros(cap, D, dtype=dtype)
    fbuf[:nb] = torch.from_numpy(rng.randn(nb, D).astype(np.float32)).to(
        dtype)
    fsq = (fbuf.float() ** 2).sum(1)
    X = torch.from_numpy(rng.randn(nq, D).astype(np.float32))
    kw = dict(K_pre=128, K_out=32)
    assert brute_chunk(nq, cap, 128, D) == nq
    want = brute_query_batch(X, fbuf, fsq, nb, 9, QCH=nq, **kw)
    got = brute_query_batch(X, fbuf, fsq, nb, 9, QCH=width, **kw)
    assert got.dtype == torch.int32 and got.shape == (nq, 2 * 32 + 3)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_pack_unpack_roundtrip():
    rng = np.random.RandomState(0)
    rows = rng.randint(-1, 1 << 30, (2, 48))
    dists = rng.rand(2, 48).astype(np.float32) * 1e6
    dists[0, -2:] = [np.inf, 0.0]
    packed = pack_query_out(torch.from_numpy(rows), torch.from_numpy(dists),
                            torch.tensor([321, 5]), torch.tensor([7, 0]),
                            torch.tensor([True, False])).numpy()
    r, d, t, n, ok = unpack_query_out(packed, 48)
    np.testing.assert_array_equal(r, rows)
    np.testing.assert_array_equal(d, dists)   # bit-exact incl. inf
    np.testing.assert_array_equal(t, [321, 5])
    np.testing.assert_array_equal(n, [7, 0])
    np.testing.assert_array_equal(ok, [1, 0])


@pytest.mark.parametrize("what", ["wide-square", "wide-V"])
def test_unported_paths_raise(setup, what):
    """Both paths that once raised are ported. Wide-V mode
    (``cell_start=None``) looks buckets up in the sorted cell ids and
    returns exactly the dense table's results at every rung kind
    (tests/test_torch_wide_v.py holds it against JAX). The wide square
    (B*B > 16384 without strips) at V=B=130 matches the JAX sort-free path
    (tests/test_torch_wide_probe.py holds it at V=256)."""
    model, _, _, (tcodes, tcs, _), _, queries = setup
    X = torch.from_numpy(queries)
    if what == "wide-V":
        counts = (tcs[1:] - tcs[:-1]).long()
        cells_sorted = torch.repeat_interleave(
            torch.arange(V * V, dtype=torch.int32), counts)
        with pytest.raises(ValueError, match="cells_sorted"):
            lopq_query(X, *_tables(model), tcodes, None, QUOTA, V=V, B=8,
                       Q=QB, K=K)
        for B, SB in ((8, 0), (8, 2), (V, 0)):
            dense = lopq_query(X, *_tables(model), tcodes, tcs, QUOTA, V=V,
                               B=B, Q=QB, K=K, SB=SB)
            wide = lopq_query(X, *_tables(model), tcodes, None, QUOTA, V=V,
                              B=B, Q=QB, K=K, SB=SB,
                              cells_sorted=cells_sorted)
            for a, b in zip(dense, wide):
                assert torch.equal(a, b)
        return
    import jax.numpy as jnp

    from columbiaimagesearch_tpu.index.csr import build_csr_device
    from columbiaimagesearch_tpu.index.tpu_query import lopq_query as jq

    Vw, Mw, Sw, Dw = 130, 4, 16, 32
    rng = np.random.RandomState(12)
    wide = LOPQModel.from_numpy(*random_params(rng, V=Vw, M=Mw, S=Sw,
                                               D=Dw), device="cpu")
    coarse = rng.randint(0, Vw, (N, 2)).astype(np.int32)
    fine = rng.randint(0, Sw, (N, Mw)).astype(np.uint8)
    q = rng.randn(2, Dw).astype(np.float32)
    wcodes, wcs, _ = build_csr(torch.from_numpy(coarse),
                               torch.from_numpy(fine), Vw)
    got = lopq_query(torch.from_numpy(q), *_tables(wide), wcodes, wcs, QUOTA,
                     V=Vw, B=Vw, Q=QB, K=K)
    jcodes, jcs, _ = build_csr_device(jnp.asarray(coarse), jnp.asarray(fine),
                                      Vw)
    for i in range(len(q)):
        want = jq(jnp.asarray(q[i]), *(jnp.asarray(t.numpy())
                                       for t in _tables(wide)),
                  jcodes, jcs, jnp.asarray(QUOTA, jnp.int32), V=Vw, B=Vw,
                  Q=QB, K=K)
        assert int(got[2][i]) == int(want[2])
        assert int(got[3][i]) == int(want[3])
        assert bool(got[4][i]) == bool(want[4])
        _assert_rows_match(np.asarray(want[0]), np.asarray(want[1]),
                           got[0][i].numpy(), got[1][i].numpy())
