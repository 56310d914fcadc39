"""The result rows of a search wave: ``_wave_results`` (``_WaveDriver``)
against a plain construction, one ``ResultDist(int(id), None, float(d))``
per valid row on the single-device searcher and one ``(id, float(d))``
pair on the sharded index, and the per-query ``_rows_to_results`` seam
that ``portbench``'s fault test patches.
"""

from unittest import mock

import numpy as np
import pytest

from columbiaimagesearch_tpu_torch.index import searcher as searcher_mod
from columbiaimagesearch_tpu_torch.index.model import LOPQModel
from columbiaimagesearch_tpu_torch.index.searcher import (
    LOPQSearcherTorch,
    Result,
    ResultDist,
)
from columbiaimagesearch_tpu_torch.parallel.mesh import SHARD_AXIS, make_mesh
from columbiaimagesearch_tpu_torch.parallel.sharded import ShardedLOPQIndex

from tests.oracle_lopq import random_params

N_IDS, K_EMIT = 40, 6


@pytest.fixture(scope="module")
def searcher():
    rng = np.random.RandomState(7)
    params = random_params(rng, V=4, M=2, S=4, D=8)
    s = LOPQSearcherTorch(LOPQModel.from_numpy(*params, device="cpu"))
    s.add_codes((rng.randint(0, 4, (N_IDS, 2)), rng.randint(0, 4, (N_IDS, 2))),
                [f"img{i}" for i in range(N_IDS)])
    return s


@pytest.fixture(scope="module")
def sharded():
    rng = np.random.RandomState(7)
    params = random_params(rng, V=4, M=2, S=4, D=8)
    idx = ShardedLOPQIndex(LOPQModel.from_numpy(*params, device="cpu"),
                           mesh=make_mesh(axis=SHARD_AXIS,
                                          devices=["cpu"] * 2))
    idx.build(rng.randint(0, 4, (N_IDS, 2)), rng.randint(0, 4, (N_IDS, 2)),
              [f"img{i}" for i in range(N_IDS)])
    return idx


def _wave():
    """Four queries: all rows valid, a -1 tail, an inf tail, none valid."""
    rows = np.array([[3, 1, 4, 15, 9, 2],
                     [5, 35, 8, -1, -1, -1],
                     [9, 7, 12, 0, 33, 21],
                     [-1, -1, -1, -1, -1, -1]], np.int32)
    dists = np.array([[0.5, 0.75, 1.0, 1.25, 2.0, 3.5],
                      [0.1, 0.2, 0.3, np.inf, np.inf, np.inf],
                      [1.5, 1.5, 2.25, np.inf, np.inf, np.inf],
                      [np.inf] * 6], np.float32)
    ncells = np.array([7, 3, 12, 0], np.int32)
    return rows, dists, ncells


def _ids(kind):
    if kind == "int64":
        return np.arange(N_IDS, dtype=np.int64) * 1000 + 17
    ids = np.empty(N_IDS, dtype=object)
    for i in range(N_IDS):
        ids[i] = f"img{i}" if kind == "str" else np.int64(7 * i + 3)
    return ids


def _plain(rows, dists, ncells, ids, K, with_dists):
    """One namedtuple call a valid row, ids and distances unboxed one by
    one."""
    out = []
    for r_q, d_q, n in zip(rows, dists, ncells):
        res = []
        for r, d in zip(r_q[:K], d_q[:K]):
            if r < 0 or not np.isfinite(d):
                continue
            i = ids[r]
            i = i.item() if isinstance(i, np.generic) else i
            res.append(ResultDist(i, None, float(d)) if with_dists
                       else Result(i, None))
        out.append((res, int(n)))
    return out


def _assert_same(got, want, with_dists):
    assert len(got) == len(want)
    id_type = type(want[0][0][0].id)
    for (res, visited), (res_w, visited_w) in zip(got, want):
        assert type(res) is list and type(visited) is int
        assert visited == visited_w
        assert res == res_w
        for r in res:
            assert type(r) is (ResultDist if with_dists else Result)
            assert type(r.id) is id_type and r.code is None
            if with_dists:
                assert type(r.dist) is float
    assert len({id(res) for res, _ in got}) == len(got)


def _assert_pairs(got, want):
    """The sharded index's rows: ([(id, dist)], visited) a query."""
    want = [([(r.id, r.dist) for r in res], n) for res, n in want]
    assert got == want
    for pairs, visited in got:
        assert type(pairs) is list and type(visited) is int
        for pair in pairs:
            assert type(pair) is tuple and type(pair[1]) is float
            assert type(pair[0]) is type(want[0][0][0][0])


@pytest.mark.parametrize("K", [K_EMIT, 4],
                         ids=["K_out=K_emit", "K_out<K_emit"])
@pytest.mark.parametrize("with_dists", [True, False])
@pytest.mark.parametrize("id_kind", ["int64", "str", "np_int64"])
@pytest.mark.parametrize("entry", ["searcher", "sharded"])
def test_wave_results_match_plain_rows(request, entry, id_kind, with_dists,
                                       K):
    s = request.getfixturevalue(entry)
    rows, dists, ncells = _wave()
    ids = _ids(id_kind)
    got = s._wave_results((rows, dists, ncells), K, K_EMIT, with_dists, ids,
                          None, None, False)
    if entry == "sharded":
        want = _plain(rows, dists, ncells, ids, K, True)
        _assert_pairs(got, want)
    else:
        want = _plain(rows, dists, ncells, ids, K, with_dists)
        _assert_same(got, want, with_dists)
    assert [len(res) for res, _ in got] == (
        [6, 3, 3, 0] if K == K_EMIT else [4, 3, 3, 0])
    assert type(want[0][0][0].id) is (str if id_kind == "str" else int)


@pytest.mark.parametrize("field", ["id", "dist"])
def test_rows_to_results_is_the_per_query_seam(searcher, field):
    """The first row of every query, altered inside ``_rows_to_results``
    (as ``portbench/tests/test_pb_reference.py`` alters it), reaches the
    wave's results: the method is still called once a query."""
    live = LOPQSearcherTorch._rows_to_results
    calls = []

    def altered(self, rows, dists, *a, **kw):
        assert rows.ndim == dists.ndim == 1
        calls.append(len(rows))
        rows, dists = np.array(rows), np.array(dists, dtype=np.float32)
        if field == "id":
            rows[0] = (rows[0] + 1) % self.nb_indexed
        else:
            dists[0] *= 1.001
        return live(self, rows, dists, *a, **kw)

    rows, dists, ncells = _wave()
    ids = searcher._snapshot()[1]
    with mock.patch.object(searcher_mod.LOPQSearcherTorch,
                           "_rows_to_results", altered):
        got = searcher._wave_results((rows, dists, ncells), K_EMIT, K_EMIT,
                                     True, ids, None, None, False)
    assert calls == [K_EMIT] * len(rows)
    want_rows, want_dists = rows.copy(), dists.copy()
    if field == "id":
        want_rows[:, 0] = (want_rows[:, 0] + 1) % searcher.nb_indexed
    else:
        for q in range(len(rows)):
            want_dists[q, 0] *= 1.001
    _assert_same(got, _plain(want_rows, want_dists, ncells, ids, K_EMIT, True),
                 True)
    unaltered = searcher._wave_results((rows, dists, ncells), K_EMIT, K_EMIT,
                                       True, ids, None, None, False)
    for (res, _), (res_u, _) in zip(got[:3], unaltered[:3]):
        assert res[0] != res_u[0] and res[1:] == res_u[1:]
