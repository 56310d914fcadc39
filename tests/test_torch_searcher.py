"""The slice as a whole: ``LOPQSearcherTorch`` against the JAX package's
``LOPQSearcherTPU`` on the same model, codes, ids and features, through
``search_batch`` and ``search``; plus the copied probe policy against the
JAX one.

Result ids must be equal except swaps between float-rounding ties, and
distances match at rtol 1e-4, atol 1e-5 (fp32, sums in another order).
Rerank cases pin ``probe_width``, which keeps both searchers off the brute
plan (the two packages' plan cost constants differ: each measured its own
device).
"""

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch.index import probe
from columbiaimagesearch_tpu_torch.index import searcher as searcher_mod
from columbiaimagesearch_tpu_torch.index.model import LOPQModel
from columbiaimagesearch_tpu_torch.index.searcher import LOPQSearcherTorch

from tests.oracle_lopq import random_params

V, M, S, D = 16, 8, 32, 64
N = 4000


@pytest.fixture(scope="module")
def corpus():
    from columbiaimagesearch_tpu.index.model import LOPQModel as JaxModel

    rng = np.random.RandomState(21)
    params = random_params(rng, V=V, M=M, S=S, D=D)
    jm = JaxModel(parameters=params)
    tm = LOPQModel.from_numpy(*params, device="cpu")
    coarse = rng.randint(0, V, (N, 2))
    fine = rng.randint(0, S, (N, M))
    ids = [f"img{i}" for i in range(N)]
    feats = rng.randn(N, D).astype(np.float32)
    queries = rng.randn(5, D).astype(np.float32)
    return jm, tm, coarse, fine, ids, feats, queries


def _assert_results_match(want, got):
    (rw, vw), (rg, vg) = want, got
    assert vg == vw                                   # visited cells
    assert len(rg) == len(rw)
    dw = np.array([r.dist for r in rw])
    dg = np.array([r.dist for r in rg])
    np.testing.assert_allclose(dg, dw, rtol=1e-4, atol=1e-5)
    for i, (a, b) in enumerate(zip(rw, rg)):
        if a.id != b.id:                              # rounding ties only
            assert abs(dw[i] - dg[i]) <= 1e-4 * max(1.0, abs(dw[i]))
        elif a.code is not None:
            assert tuple(map(int, a.code.coarse)) == tuple(
                map(int, b.code.coarse))
            assert tuple(map(int, a.code.fine)) == tuple(map(int, b.code.fine))


def _pair(corpus, probe_width=None, with_feats=False):
    from columbiaimagesearch_tpu.index.searcher import LOPQSearcherTPU

    jm, tm, coarse, fine, ids, feats, _ = corpus
    js = LOPQSearcherTPU(jm, probe_width=probe_width)
    ts = LOPQSearcherTorch(tm, probe_width=probe_width)
    f = feats if with_feats else None
    js.add_codes((coarse, fine), ids, feats=f)
    ts.add_codes((coarse, fine), ids, feats=f)
    return js, ts


def test_search_batch_default_ladder(corpus):
    js, ts = _pair(corpus)
    queries = corpus[-1]
    want = js.search_batch(queries, quota=300, limit=20, with_dists=True)
    got = ts.search_batch(queries, quota=300, limit=20, with_dists=True)
    assert ts.get_nb_indexed() == js.get_nb_indexed() == N
    for w, g in zip(want, got):
        _assert_results_match(w, g)
    assert ts.probe_stats["waves"] == js.probe_stats["waves"] == 1


def test_search_single_default_ladder(corpus):
    js, ts = _pair(corpus)
    q = corpus[-1][2]
    _assert_results_match(js.search(q, quota=300, limit=20, with_dists=True),
                          ts.search(q, quota=300, limit=20, with_dists=True))


def test_search_batch_pinned_rerank(corpus):
    js, ts = _pair(corpus, probe_width=8, with_feats=True)
    queries = corpus[-1]
    want = js.search_batch(queries, quota=300, limit=10, with_dists=True,
                           rerank_nb=40)
    got = ts.search_batch(queries, quota=300, limit=10, with_dists=True,
                          rerank_nb=40)
    for w, g in zip(want, got):
        _assert_results_match(w, g)


def test_search_pinned_rerank_finds_indexed_row(corpus):
    """A query equal to an indexed (encoded) row comes back first at exact
    distance 0 from both searchers."""
    from columbiaimagesearch_tpu.index.searcher import LOPQSearcherTPU

    jm, tm, _, _, ids, feats, _ = corpus
    js = LOPQSearcherTPU(jm, probe_width=8)
    ts = LOPQSearcherTorch(tm, probe_width=8)
    for s in (js, ts):
        s.add_data(feats, ids, store_feats=True)
    q = feats[123]
    want = js.search(q, quota=300, limit=10, with_dists=True, rerank_nb=40)
    got = ts.search(q, quota=300, limit=10, with_dists=True, rerank_nb=40)
    _assert_results_match(want, got)
    assert got[0][0].id == ids[123] and got[0][0].dist == 0.0


def test_add_data_encodes_like_jax(corpus):
    """add_data (device encode + store) then a pinned rerank wave."""
    from columbiaimagesearch_tpu.index.searcher import LOPQSearcherTPU

    jm, tm, _, _, _, feats, queries = corpus
    js = LOPQSearcherTPU(jm, probe_width=8)
    ts = LOPQSearcherTorch(tm, probe_width=8)
    js.add_data(feats[:1500], store_feats=True)
    ts.add_data(feats[:1500], store_feats=True)
    js.add_data(feats[1500:2000], store_feats=True)   # incremental refresh
    ts.add_data(feats[1500:2000], store_feats=True)
    want = js.search_batch(queries, quota=200, limit=10, with_dists=True,
                           rerank_nb=30)
    got = ts.search_batch(queries, quota=200, limit=10, with_dists=True,
                          rerank_nb=30)
    for w, g in zip(want, got):
        _assert_results_match(w, g)


def test_oom_halves_wave_cap_and_keeps_results(corpus, monkeypatch):
    """A launch that runs out of device memory halves the searcher's wave
    cap for good and is retried in smaller launches with the same
    results (up to the rounding of a smaller launch)."""
    _, tm, coarse, fine, ids, _, queries = corpus
    ts = LOPQSearcherTorch(tm, probe_width=8)
    ts.add_codes((coarse, fine), ids)
    want = ts.search_batch(queries, quota=300, limit=10, with_dists=True)
    ts._wave_cap = lambda Q, R: (lambda rung: 4)
    real = searcher_mod.lopq_query_orig
    sizes, raised = [], []

    def flaky(X, *args, **kw):                    # runs out of memory once
        sizes.append(X.shape[0])
        if not raised:
            raised.append(True)
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return real(X, *args, **kw)

    monkeypatch.setattr(searcher_mod, "lopq_query_orig", flaky)
    got = ts.search_batch(queries, quota=300, limit=10, with_dists=True)
    assert ts._wave_oom_shrink == 2
    assert sizes == [4, 2, 2, 1]
    for w, g in zip(want, got):      # launch size changes fp32 rounding
        _assert_results_match(w, g)
    sizes.clear()
    ts.search_batch(queries, quota=300, limit=10, with_dists=True)
    assert sizes == [2, 2, 1]                     # the halved cap persists


def test_escalation_matches_jax():
    """Every row sits in cells of the 64 farthest clusters per split
    (tests/test_probe_escalation.py's hard case): both searchers must
    escalate past the B=64 rung and agree."""
    from columbiaimagesearch_tpu.index.model import LOPQModel as JaxModel
    from columbiaimagesearch_tpu.index.searcher import LOPQSearcherTPU

    rng = np.random.RandomState(7)
    Vh, Mh, Sh, Dh = 128, 4, 16, 32
    params = random_params(rng, V=Vh, M=Mh, S=Sh, D=Dh)
    q = rng.randn(Dh).astype(np.float32)
    h0, h1 = np.split(q, 2)
    far0 = np.argsort(((h0[None] - params[0][0]) ** 2).sum(1))[64:]
    far1 = np.argsort(((h1[None] - params[0][1]) ** 2).sum(1))[64:]
    coarse = np.stack([rng.choice(far0, 500), rng.choice(far1, 500)], 1)
    fine = rng.randint(0, Sh, (500, Mh))
    js = LOPQSearcherTPU(JaxModel(parameters=params))
    ts = LOPQSearcherTorch(LOPQModel.from_numpy(*params, device="cpu"))
    for s in (js, ts):
        s.add_codes((coarse, fine))
    want = js.search_batch(q[None], quota=50, limit=10, with_dists=True)
    got = ts.search_batch(q[None], quota=50, limit=10, with_dists=True)
    _assert_results_match(want[0], got[0])
    assert len(got[0][0]) == 10
    assert ts.probe_stats["escalated_queries"] == 1
    assert ts.probe_stats["wave_log"] == js.probe_stats["wave_log"]
    # The serving form (no codes) returns the same plain-int identity ids.
    lean = ts.search_batch(q[None], quota=50, limit=10, with_dists=True,
                           with_codes=False)
    assert [r.id for r in lean[0][0]] == [r.id for r in got[0][0]]
    assert all(type(r.id) is int and r.code is None for r in lean[0][0])


def test_escalate_probe_matches_jax_with_fake_tiers():
    """One fake ``run_tier`` drives both copies of escalate_probe."""
    from columbiaimagesearch_tpu.index.tpu_query import (
        escalate_probe as jax_escalate,
    )

    rng = np.random.RandomState(5)
    n, K_pad, quota, nb = 40, 8, 100, 10_000
    ladder = (64, (128, 8), (256, 16))
    need = rng.randint(0, 4, n)     # rung index at which query i settles
    calls = []

    def run_tier(idx, rung):
        ti = ladder.index(rung)
        calls.append((ti, tuple(idx)))
        k = len(idx)
        ok_now = need[idx] <= ti
        rows = np.tile(np.arange(K_pad, dtype=np.int32), (k, 1)) + ti
        dists = rng.rand(k, K_pad).astype(np.float32)
        total = np.where(ok_now, quota + 5 * idx, quota // 2)
        ncells = 10 + idx
        grid_ok = (ok_now | (idx % 3 == 0)).astype(np.int32)
        return rows, dists, total, ncells, grid_ok

    rng_state = rng.get_state()
    want = jax_escalate(run_tier, ladder, n, quota, nb, K_pad)
    calls_want, calls[:] = list(calls), []
    rng.set_state(rng_state)
    got = probe.escalate_probe(run_tier, ladder, n, quota, nb, K_pad)
    assert calls == calls_want
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3:] == want[3:]


@pytest.mark.parametrize("Vp", [16, 128, 4096])
def test_probe_policy_matches_jax(Vp):
    from columbiaimagesearch_tpu.index import tpu_query as jq

    assert probe.probe_ladder(Vp) == jq.probe_ladder(Vp)
    assert probe.probe_ladder(Vp, 100) == jq.probe_ladder(Vp, 100)
    for spec in probe.PROBE_LADDER + (64, (512, 32)):
        assert probe.rung_cells(spec, Vp) == jq.rung_cells(spec, Vp)
    ladder = probe.probe_ladder(Vp)
    for quota, nb, y in [(10_000, 10_485_760, None), (10_000, 10**7, 5.0),
                         (100_000, 10**6, 0.5), (50, 0, 1.0)]:
        assert (probe.rung_floor(ladder, quota, nb, Vp, y)
                == jq.rung_floor(ladder, quota, nb, Vp, y))


def test_add_codes_from_dict_matches_jax(corpus):
    """Ids are the dict's keys in order, codes its values
    (searcher.py:195-198); a repeated (cell, id) is dropped by both."""
    from columbiaimagesearch_tpu.index.searcher import LOPQSearcherTPU

    jm, tm, coarse, fine, ids, _, queries = corpus
    js, ts = LOPQSearcherTPU(jm), LOPQSearcherTorch(tm)
    first = {i: (tuple(c), tuple(f))
             for i, c, f in zip(ids[:3000], coarse[:3000], fine[:3000])}
    second = {i: (tuple(c), tuple(f))
              for i, c, f in zip(ids[2500:], coarse[2500:], fine[2500:])}
    for s in (js, ts):
        s.add_codes_from_dict(first)
        s.add_codes_from_dict(second)
    assert ts.get_nb_indexed() == js.get_nb_indexed() == N
    want = js.search_batch(queries, quota=300, limit=20, with_dists=True)
    got = ts.search_batch(queries, quota=300, limit=20, with_dists=True)
    for w, g in zip(want, got):
        _assert_results_match(w, g)


def test_has_rerank_feats_matches_jax(corpus):
    """False while empty, True when every indexed row has a stored
    feature, False for good after a featureless add (searcher.py:507-512)."""
    from columbiaimagesearch_tpu.index.searcher import LOPQSearcherTPU

    jm, tm, coarse, fine, ids, feats, _ = corpus
    js, ts = LOPQSearcherTPU(jm), LOPQSearcherTorch(tm)
    flags = []
    for step in range(4):
        for s in (js, ts):
            if step == 1:
                s.add_codes((coarse[:2000], fine[:2000]), ids[:2000],
                            feats=feats[:2000])
            elif step == 2:
                s.add_codes((coarse[2000:3000], fine[2000:3000]),
                            ids[2000:3000])
            elif step == 3:
                s.add_codes((coarse[3000:], fine[3000:]), ids[3000:],
                            feats=feats[3000:])
        flags.append((js.has_rerank_feats, ts.has_rerank_feats))
    assert flags == [(False, False), (True, True), (False, False),
                     (False, False)]


def test_add_data_takes_jax_positional_order(corpus):
    """``add_data(X, ids, 4)``: the third argument is the reference's
    ``num_procs`` on both searchers (JAX searcher.py:495), so neither keeps
    a rerank store."""
    from columbiaimagesearch_tpu.index.searcher import LOPQSearcherTPU

    jm, tm, _, _, ids, feats, _ = corpus
    js, ts = LOPQSearcherTPU(jm), LOPQSearcherTorch(tm)
    for s in (js, ts):
        s.add_data(feats[:500], ids[:500], 4)
    assert ts.get_nb_indexed() == js.get_nb_indexed() == 500
    assert ts.has_rerank_feats == js.has_rerank_feats is False
    for s in (js, ts):
        s.add_data(feats[500:800], ids[500:800], 1, True)
    assert ts.has_rerank_feats == js.has_rerank_feats is False


def test_init_takes_jax_positional_order(corpus, tmp_path):
    """A third positional argument is ``codestore_path`` on both searchers
    (JAX searcher.py:340) and opens the native code store; the fourth is
    ``rerank_dtype`` (the bfloat16 store is ported) and ``capacity_hint``
    is fifth."""
    import inspect

    from columbiaimagesearch_tpu.index.searcher import LOPQSearcherTPU

    _, tm, _, _, _, _, _ = corpus
    names = list(inspect.signature(LOPQSearcherTorch.__init__).parameters)
    assert names == list(
        inspect.signature(LOPQSearcherTPU.__init__).parameters)
    assert names[3] == "codestore_path"
    cs = LOPQSearcherTorch(tm, None, str(tmp_path / "codes"))
    assert cs._codestore is not None and cs._codestore.m == tm.M
    cs._codestore.close()
    bf = LOPQSearcherTorch(tm, None, None, "bfloat16")
    assert bf.rerank_dtype == "bfloat16" and bf._codestore is None
    s = LOPQSearcherTorch(tm, 8, None, "float32", 50_000)
    assert (s.probe_width, s.capacity_hint) == (8, 50_000)
