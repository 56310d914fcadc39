"""The rerank plan's cost model (``index/probe.py``): brute pass or probe
ladder.

- ``fit_costs`` recovers the constants of points made from known ones,
  for both plans' terms.
- The brute pass's chunk width (``query.brute_chunk``): the whole wave at
  the recall config's capacity, BRUTE_QCH queries at the headline's.
- A store of 512-byte rows costs its brute wave below one of 1 KB rows.
- With the committed constants, ``prefer_brute`` flips from the brute
  pass to the ladder at most once as the index grows, at every rung, at
  three candidate budgets, four stores and waves of 1, 16 and 100
  queries; the crossover table (where each package's constants stop
  picking the brute pass; ``python -m tests.test_torch_plan_choice``
  prints it) brackets each flip.
- At the recall test's configuration (tests/test_torch_eval_recall_scale.py:
  20,000 x 32 rows, V 16, quota 500, the bfloat16 store), on one
  JAX-trained model, the port's searcher and JAX's both take the brute
  pass for a single ``search`` with ``rerank_nb`` and for waves of 48 and
  50 queries (the recall run's wave), and return the same ids; distances
  within rtol 1e-5, the tolerance of
  test_torch_host_searcher.py::test_bfloat16_brute_plan_matches_jax.
"""

import itertools

import numpy as np
import pytest

from columbiaimagesearch_tpu_torch.index import eval_recall, probe, query
from columbiaimagesearch_tpu_torch.index.model import LOPQModel
from columbiaimagesearch_tpu_torch.index.searcher import LOPQSearcherTorch

N, DIM, V, M, TRAIN_N, QUERIES, QUOTA = 20000, 32, 16, 8, 4000, 50, 500
DIST_RTOL = 1e-5
#: the headline's float32 store (D=256) at rerank depth 1,000
HEADLINE = dict(D=256, itemsize=4, K_pre=1000)
#: (D, itemsize): the headline's float32 and bfloat16 stores, the face
#: conf's float32 D=128 store and the recall config's bfloat16 D=32 one
STORES = ((256, 4), (256, 2), (128, 4), (32, 2))


def _grid_points():
    """Grid terms of the headline's rungs at two quotas' budgets (the
    square rung takes the table route at the smaller one)."""
    return [probe.grid_terms(nq, 4096, r, Q) for Q in (11264, 101376)
            for nq in (1, 16, 100) for r in probe.PROBE_LADDER[:4]]


@pytest.mark.parametrize("plan", ["brute", "grid"])
def test_fit_recovers_known_constants(plan):
    rng = np.random.RandomState(0)
    if plan == "brute":
        want = np.array([500e3, 80e3, 1e6, 3e-4, 0.03])
        terms = [probe.brute_terms(nq, nb, D, size, 1000)
                 for nq in (1, 16, 100)
                 for nb in (20000, 262144, 1 << 20, 10485760)
                 for D, size in STORES[:3]]
    else:
        want = np.array([2.0e6, 2.5e6, 4e3, 0.4, 5.5])
        terms = _grid_points()
    assert len(want) == len(terms[0])
    ns = np.asarray(terms, np.float64) @ want
    np.testing.assert_allclose(probe.fit_costs(terms, ns), want, rtol=1e-9)
    # 2% noise: no constant negative, every point within 5%.
    got = probe.fit_costs(terms, ns * (1 + 0.02 * rng.randn(len(ns))))
    assert (got >= 0).all()
    np.testing.assert_allclose(np.asarray(terms, np.float64) @ got, ns,
                               rtol=0.05)


def test_fit_keeps_constants_non_negative():
    """Points an unconstrained fit would give negative constants: the fit
    drops terms instead, and keeps a fixed cost and the store's read."""
    terms = np.asarray([probe.brute_terms(nq, nb, 256, 4, 1000)
                        for nq in (1, 16, 100)
                        for nb in (20000, 1 << 20, 10485760)], np.float64)
    ns = terms @ np.array([0.0, 0.0, 1e5, 3e-4, 0.0])
    ns[-1] *= 0.7
    free = np.linalg.lstsq(terms / ns[:, None], np.ones(len(ns)),
                           rcond=None)[0]
    assert (free < 0).any()
    got = probe.fit_costs(terms, ns)
    assert (got >= 0).all() and (got == 0).any()
    assert got[0] + got[2] > 0 and got[3] > 0


def test_brute_chunk_is_the_wave_on_small_stores_and_bounded_on_large():
    """The recall config's 50-query wave over its 32,768-row capacity
    runs as one chunk; at the headline's 11,534,336-row capacity a chunk
    stays at BRUTE_QCH queries (the width is arithmetic on the shapes:
    nothing is allocated), and one chunk's transients fit the bound."""
    cap = probe.brute_rows(N)
    assert cap == 32768
    assert query.brute_chunk(QUERIES, cap, 1000, DIM) == QUERIES
    assert query.brute_chunk(100, cap, 1000, 256) == 100
    big = probe.brute_rows(10_485_760)
    assert big == 11_534_336
    for nq in (1, 16, 100, 1000):
        w = query.brute_chunk(nq, big, 1000, 256)
        assert w == min(nq, query.BRUTE_QCH)
    for cap_, D in ((cap, DIM), (278_528, 256), (2_097_152, 256)):
        w = query.brute_chunk(10 ** 6, cap_, 1000, D)
        assert query.BRUTE_QCH <= w < 10 ** 6
        assert (w == query.BRUTE_QCH
                or w * 4 * (cap_ + 1000 * D) <= query.BRUTE_CHUNK_BYTES)


@pytest.mark.parametrize("nq", [1, 16, 50, 100])
def test_half_width_rows_cost_less(nq):
    """A brute wave over 512-byte rows (the bfloat16 store at D=256, the
    face conf's float32 D=128) costs less than over 1 KB rows of the same
    count, and takes the brute pass wherever the 1 KB store does."""
    for nb in (20_000, 262_144, 1 << 20, 10_485_760):
        full = probe.brute_wave_ns(nq, nb, 256, 4, 1000)
        for D, size in ((256, 2), (128, 4)):
            assert probe.brute_wave_ns(nq, nb, D, size, 1000) < full
            for spec in probe.PROBE_LADDER[:4]:
                args = ((spec,), nq, nb, 4096, 11264)
                if probe.prefer_brute(*args, **HEADLINE):
                    assert probe.prefer_brute(*args, D=D, itemsize=size,
                                              K_pre=1000)


@pytest.mark.parametrize("nq", [1, 16, 100])
def test_plan_flips_at_most_once_as_the_index_grows(nq):
    """At a fixed candidate budget (above ~quota rows the quota fixes it)
    the brute pass only gets dearer as the store grows, so the plan goes
    from brute to the ladder once at most."""
    nbs = np.unique(np.geomspace(1000, 200_000_000, 400).astype(np.int64))
    for V_ in (16, 256, 4096, 8192):
        for spec, Q, (D, size) in itertools.product(
                probe.probe_ladder(V_), (1536, 11264, 101376), STORES):
            picks = [probe.prefer_brute((spec,), nq, int(nb), V_, Q, D=D,
                                        itemsize=size, K_pre=1000)
                     for nb in nbs]
            flips = sum(a != b for a, b in zip(picks, picks[1:]))
            assert flips <= 1 and (picks[0] or not any(picks)), (
                V_, spec, Q, D, size)


def crossover_nb(prefer, hi=1 << 34):
    """The fewest indexed rows at which ``prefer(nb)`` stops picking the
    brute pass (bisected; ``prefer`` flips at most once), or None."""
    if not prefer(1):
        return 1
    if prefer(hi):
        return None
    lo = 1
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if prefer(mid) else (lo, mid)
    return hi


def crossover_table(quota=10_000, rerank_nb=1000, V_=4096,
                    rungs=(64, (256, 16)), nqs=(1, 16, 100)):
    """(rung, nq, the port's crossover, JAX's) at ``quota``: each
    package's own constants."""
    from columbiaimagesearch_tpu.index import tpu_query

    from columbiaimagesearch_tpu_torch.index.searcher import _query_geometry

    def port(spec, nq):
        return lambda nb: probe.prefer_brute(
            (spec,), nq, nb, V_, _query_geometry(quota, None, nb,
                                                 rerank_nb)[1], D=256,
            itemsize=4, K_pre=rerank_nb)

    def jax(spec, nq):
        return lambda nb: tpu_query.prefer_brute((spec,), nq, nb, V_)

    return [(spec, nq, crossover_nb(port(spec, nq)),
             crossover_nb(jax(spec, nq))) for spec in rungs for nq in nqs]


def test_crossover_table_brackets_each_flip():
    from columbiaimagesearch_tpu.index import tpu_query

    for spec, nq, port_nb, jax_nb in crossover_table():
        for nb, prefer in ((port_nb, lambda n: probe.prefer_brute(
                (spec,), nq, n, 4096, 11264, **HEADLINE)),
                           (jax_nb, lambda n: tpu_query.prefer_brute(
                               (spec,), nq, n, 4096))):
            assert nb is not None and not prefer(nb)
            assert nb == 1 or prefer(nb - 1)


def test_empty_tail_means_brute():
    assert probe.prefer_brute((), 1, 10 ** 9, 4096, 11264, **HEADLINE)


@pytest.fixture(scope="module")
def pair():
    """The JAX searcher and the port's on one JAX-trained model, over
    ``eval_recall``'s rows in a bfloat16 store, and the queries."""
    from columbiaimagesearch_tpu.index.model import LOPQModel as JaxModel
    from columbiaimagesearch_tpu.index.searcher import LOPQSearcherTPU

    data = eval_recall.SynthData(N, DIM, TRAIN_N, QUERIES, 0.25, False,
                                 "cpu")
    jm = JaxModel(V=V, M=M, subquantizer_clusters=256)
    jm.fit(data.train, n_init=1, random_state=0)
    tm = LOPQModel.from_numpy(jm.Cs, jm.Rs, jm.mus, jm.subquantizers,
                              device="cpu")
    # The port's codes equal JAX's
    # (test_torch_model_encode.py::test_predict_batch_matches_jax); its
    # encoder costs no JAX compile.
    coarse, fine = tm.predict_batch(data.X)
    out = []
    for cls, model in ((LOPQSearcherTPU, jm), (LOPQSearcherTorch, tm)):
        s = cls(model, rerank_dtype="bfloat16")
        s.add_codes((coarse, fine), feats=data.X)
        out.append(s)
    return out, data.queries


def _assert_same(want, got):
    assert [r.id for r in got] == [r.id for r in want]
    np.testing.assert_allclose([r.dist for r in got],
                               [r.dist for r in want], rtol=DIST_RTOL)


def _brute_waves(searchers):
    return [s.probe_stats.get("brute_waves", 0) for s in searchers]


@pytest.mark.parametrize("nq", [1, 48, QUERIES])
def test_recall_config_takes_the_brute_plan_in_both(pair, nq):
    (js, ts), queries = pair
    kw = dict(quota=QUOTA, limit=eval_recall.LIMIT, with_dists=True,
              rerank_nb=eval_recall.RERANK_NB)
    before = _brute_waves((js, ts))
    if nq == 1:
        _assert_same(js.search(queries[0], **kw)[0],
                     ts.search(queries[0], **kw)[0])
    else:
        want = js.search_batch(queries[:nq], with_codes=False, **kw)
        got = ts.search_batch(queries[:nq], with_codes=False, **kw)
        assert len(got) == nq
        for (rw, _), (rg, _) in zip(want, got):
            _assert_same(rw, rg)
    assert _brute_waves((js, ts)) == [b + 1 for b in before]


if __name__ == "__main__":
    # The crossover table of PERF.md and ROADMAP.md, from the repo's root:
    # python -m tests.test_torch_plan_choice (JAX on the CPU).
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    print("rung | nq | port: brute below nb | JAX: brute below nb")
    for spec, nq, port_nb, jax_nb in crossover_table():
        print(f"{spec} | {nq} | {port_nb:,} | {jax_nb:,}")
