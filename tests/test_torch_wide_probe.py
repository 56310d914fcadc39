"""The sort-free wide square path of the port's ``lopq_query`` (square rungs
with B*B > 16384 and no strips) against the JAX ``lopq_query`` on the same
tables, codes and queries, mirroring tests/test_threshold_probe.py at
V=256, M=4, S=16, D=32.

``total``, ``n_cells`` and ``grid_ok`` must be equal, and so must the set
of candidate rows (K = Q emits every valid slot). The slot layout is held
to a numpy transcription of the JAX one (interior cells row-major, then
the cells tied with theta). Top-K rows must be equal except swaps between
equal distances, and distances agree within atol 1e-5 plus rtol 1e-6:
fp32 sums taken in another order differ by a few ulps at the distances
of these random tables (50-100, where one ulp is 7.6e-6).
"""

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch.index.csr import build_csr
from columbiaimagesearch_tpu_torch.index.model import LOPQModel
from columbiaimagesearch_tpu_torch.index.query import (
    _wide_square_slots,
    lopq_query,
)

from tests.oracle_lopq import random_params

V, M, S, D = 256, 4, 16, 32
N = 3000
DIST_ATOL, DIST_RTOL = 1e-5, 1e-6


def _split_ranks(q, Cs):
    h0, h1 = np.split(q, 2)
    d0 = ((h0[None] - Cs[0]) ** 2).sum(1)
    d1 = ((h1[None] - Cs[1]) ** 2).sum(1)
    return np.argsort(d0, kind="stable"), np.argsort(d1, kind="stable")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(3)
    params = random_params(rng, V=V, M=M, S=S, D=D)
    model = LOPQModel.from_numpy(*params, device="cpu")
    coarse = rng.randint(0, V, (N, 2)).astype(np.int32)
    fine = rng.randint(0, S, (N, M)).astype(np.uint8)
    queries = rng.randn(3, D).astype(np.float32)
    return params, model, coarse, fine, queries


def _jax_tables(model):
    import jax.numpy as jnp

    return tuple(jnp.asarray(t.numpy())
                 for t in (model.Cs, model.Rs, model.mus, model.subs))


def _both(model, coarse, fine, queries, quota, B, Q):
    """(port outputs, [JAX outputs per query]) with K = Q."""
    import jax.numpy as jnp

    from columbiaimagesearch_tpu.index.csr import build_csr_device
    from columbiaimagesearch_tpu.index.tpu_query import lopq_query as jq

    jcodes, jcs, _ = build_csr_device(jnp.asarray(coarse), jnp.asarray(fine),
                                      V)
    tcodes, tcs, _ = build_csr(torch.from_numpy(coarse),
                               torch.from_numpy(fine), V)
    got = lopq_query(torch.from_numpy(queries), model.Cs, model.Rs,
                     model.mus, model.subs, tcodes, tcs, quota, V=V, B=B,
                     Q=Q, K=Q)
    jt = _jax_tables(model)
    want = [jq(jnp.asarray(q), *jt, jcodes, jcs,
               jnp.asarray(quota, jnp.int32), V=V, B=B, Q=Q, K=Q,
               lut_impl="stream") for q in queries]
    return got, want


def _assert_equal(got, want):
    for i, w in enumerate(want):
        assert int(got[2][i]) == int(w[2])          # total
        assert int(got[3][i]) == int(w[3])          # n_cells
        assert bool(got[4][i]) == bool(w[4])        # grid_ok
        ra, da = np.asarray(w[0]), np.asarray(w[1])
        rb, db = got[0][i].numpy(), got[1][i].numpy()
        fin = np.isfinite(da)
        np.testing.assert_array_equal(np.isfinite(db), fin)
        # the candidate set: every valid slot's row
        np.testing.assert_array_equal(np.sort(rb[fin]), np.sort(ra[fin]))
        np.testing.assert_allclose(db[fin], da[fin], rtol=DIST_RTOL,
                                   atol=DIST_ATOL)
        for k in np.nonzero(ra != rb)[0]:       # equal-distance swaps only
            assert abs(da[k] - db[k]) <= DIST_ATOL + DIST_RTOL * abs(da[k])


@pytest.mark.parametrize("quota", [0, 10, 300, N, 10 * N],
                         ids=["quota0", "below", "mid", "equal", "above"])
@pytest.mark.parametrize("B", [256, 200], ids=["B=V", "B200"])
def test_wide_square_matches_jax(setup, B, quota):
    """B=V=256 (no grid restriction) and a non-power-of-two B=200 (a
    pinned width below V: grid_ok prices the cells it leaves out); quotas
    0, below, equal to (N rows in the B=V square) and above the total."""
    _, model, coarse, fine, queries = setup
    got, want = _both(model, coarse, fine, queries, quota, B, 4096)
    _assert_equal(got, want)
    if B == V and quota >= N:
        assert (got[2] == N).all()


def test_crossing_cell_clip_matches_jax(setup):
    """total > Q: 200 rows in the nearest cell, 2000 in a farther one,
    quota 250 -> the big cell crosses and overflows Q=1024. Only its
    (boundary) candidates may be clipped, exactly as in the JAX path."""
    params, model, _, _, queries = setup
    q = queries[0]
    r0, r1 = _split_ranks(q, params[0])
    rng = np.random.RandomState(13)
    n_near, n_big = 200, 2000
    coarse = np.concatenate([
        np.tile([[r0[0], r1[0]]], (n_near, 1)),
        np.tile([[r0[5], r1[5]]], (n_big, 1))]).astype(np.int32)
    fine = rng.randint(0, S, (n_near + n_big, M)).astype(np.uint8)
    got, want = _both(model, coarse, fine, q[None], 250, V, 1024)
    _assert_equal(got, want)
    assert int(got[2][0]) == n_near + n_big
    rows = got[0][0][torch.isfinite(got[1][0])]
    assert len(rows) == 1024
    # interior: the near cell's rows sort first in the CSR
    assert set(range(n_near)) <= set(rows.tolist())


def _slots_oracle(td0, td1, isel0, isel1, cell_start, quota, Q):
    """Numpy transcription of tpu_query.py:391-518 for one query: theta
    by scanning the present grid values in ascending order, then slots
    interior row-major, boundary row-major."""
    grid = td0[:, None] + td1[None, :]
    cnt = (cell_start[isel0[:, None] * V + isel1[None, :] + 1]
           - cell_start[isel0[:, None] * V + isel1[None, :]])
    quota_eff = min(quota, int(cnt.sum()))
    theta = None
    for t in np.unique(grid):
        if cnt[grid <= t].sum() >= quota_eff:
            theta = t
            break
    rows, s0, s1 = [], [], []
    for part in (grid < theta, grid == theta):
        for a in range(len(td0)):
            for b in range(len(td1)):
                if part[a, b]:
                    st = cell_start[isel0[a] * V + isel1[b]]
                    for r in range(cnt[a, b]):
                        rows.append(st + r)
                        s0.append(a)
                        s1.append(b)
    n_cells = int((grid <= theta).sum())
    return (np.array(rows[:Q]), np.array(s0[:Q]), np.array(s1[:Q]),
            len(rows), n_cells, theta)


@pytest.mark.parametrize("quota", [0, 1, 40, 400])
def test_slot_layout_matches_transcription(quota):
    """The slot -> (row, cell) map, slot for slot: small B with many
    distance ties (integer-valued grids) and empty cells."""
    rng = np.random.RandomState(quota)
    B, NQ, Q = 12, 3, 512
    td0 = np.sort(rng.randint(0, 6, (NQ, B)).astype(np.float32), axis=1)
    td1 = np.sort(rng.randint(0, 6, (NQ, B)).astype(np.float32), axis=1)
    isel0 = np.stack([rng.permutation(V)[:B] for _ in range(NQ)])
    isel1 = np.stack([rng.permutation(V)[:B] for _ in range(NQ)])
    counts = rng.randint(0, 4, V * V) * (rng.rand(V * V) < 0.5)
    cell_start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    rows, s0, s1, total, n_cells, d_stop = _wide_square_slots(
        *(torch.from_numpy(a) for a in (td0, td1, isel0, isel1, cell_start)),
        quota, V, Q)
    for i in range(NQ):
        w = _slots_oracle(td0[i], td1[i], isel0[i], isel1[i], cell_start,
                          quota, Q)
        n = min(w[3], Q)
        np.testing.assert_array_equal(rows[i, :n].numpy(), w[0])
        np.testing.assert_array_equal(s0[i, :n].numpy(), w[1])
        np.testing.assert_array_equal(s1[i, :n].numpy(), w[2])
        assert (int(total[i]), int(n_cells[i]), float(d_stop[i])) == \
            (w[3], w[4], float(w[5]))


def test_searcher_escalates_into_wide_rung_like_jax():
    """Rows whose cells sit beyond both splits' top-128 ranks: rung 64 and
    the strip rung (128, 8) find nothing, so the default ladder at V=256
    (64, (128, 8), 256) climbs to the full 256 x 256 square. The port's
    searcher must answer as LOPQSearcherTPU does on the same rows."""
    from columbiaimagesearch_tpu.index.model import LOPQModel as JaxModel
    from columbiaimagesearch_tpu.index.searcher import LOPQSearcherTPU

    from columbiaimagesearch_tpu_torch.index.searcher import (
        LOPQSearcherTorch,
    )

    rng = np.random.RandomState(5)
    params = random_params(rng, V=V, M=M, S=S, D=D)
    qs = rng.randn(2, D).astype(np.float32)
    r0, r1 = _split_ranks(qs[0], params[0])
    n = 600
    coarse = np.stack([rng.choice(r0[130:], n), rng.choice(r1[130:], n)], 1)
    fine = rng.randint(0, S, (n, M))
    ids = [f"h_{i}" for i in range(n)]
    js = LOPQSearcherTPU(JaxModel(parameters=params))
    js.add_codes((coarse, fine), ids)
    ts = LOPQSearcherTorch(LOPQModel.from_numpy(*params, device="cpu"))
    ts.add_codes((coarse, fine), ids)
    assert ts._probe_ladder() == (64, (128, 8), 256)
    for q in qs:
        want, wv = js.search(q, quota=80, limit=10, with_dists=True)
        got, gv = ts.search(q, quota=80, limit=10, with_dists=True)
        assert gv == wv
        assert [r.id for r in got] == [r.id for r in want]
        np.testing.assert_allclose([r.dist for r in got],
                                   [r.dist for r in want], rtol=DIST_RTOL,
                                   atol=DIST_ATOL)
    # the first query's wave climbed from rung 0 to rung 2 (256)
    assert ts.probe_stats["wave_log"][0][:3] == [0, 1.0, 2]
