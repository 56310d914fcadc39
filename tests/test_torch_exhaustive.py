"""The exhaustive exact-ADC path (port: index/exhaustive_adc.py) against the
JAX package's ``pallas_adc``, whose Pallas kernel runs in interpret mode on
the CPU exactly as tests/test_pallas_adc.py runs it.

Inputs are made from numpy seeds and carried to both packages. Two models:

- ``random``: orthogonal rotations and gaussian tables (as
  tests/oracle_lopq.py makes them). Tables and distances match at rtol
  1e-5, atol 1e-4 (fp32; the two sum in other orders).
- ``integer``: small integer tables, zero means and signed-permutation
  rotations, with integer queries. Every table entry and distance is an
  exact small integer in fp32 on both sides, so distances are bit-equal
  and exact ties are everywhere: the ids must come back in the same order,
  lower padded position first on ties (``lax.top_k``'s order).

The scan kernel itself needs the card: its tests are marked ``cuda`` and
skip elsewhere. This module imports no jax and no repo test helper at
import time, so those tests also run where neither exists.
"""

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch.index.exhaustive_adc import (
    BLK,
    ITEM_BLOCKS,
    ExhaustiveADC,
    ExhaustiveADCSearcher,
    _scan_tiling,
    _topk_ascending,
    adc_scan_all,
    adc_scan_all_plain,
    adc_scan_tiled,
    build_padded_layout,
    build_query_luts,
    build_query_luts_tiled,
    scan_items,
    tile_luts,
)
from columbiaimagesearch_tpu_torch.index.model import LOPQModel

V, M, S, D = 8, 4, 16, 32      # Dh=16, F=2, Dsub=8
RTOL, ATOL = 1e-5, 1e-4


def _params(rng, kind, V=V, M=M, S=S, D=D):
    """LOPQ parameter tuples in the JAX package's layout."""
    Dh, F = D // 2, M // 2
    if kind == "random":
        Cs = rng.randn(2, V, Dh)
        Rs = np.stack([np.stack([np.linalg.qr(rng.randn(Dh, Dh))[0]
                                 for _ in range(V)]) for _ in range(2)])
        mus = 0.1 * rng.randn(2, V, Dh)
        subs = rng.randn(2, F, S, Dh // F)
    else:
        Cs = rng.randint(-3, 4, (2, V, Dh))
        Rs = np.zeros((2, V, Dh, Dh))
        for s in range(2):
            for v in range(V):
                Rs[s, v, np.arange(Dh), rng.permutation(Dh)] = \
                    rng.choice([-1.0, 1.0], Dh)
        mus = np.zeros((2, V, Dh))
        subs = rng.randint(-2, 3, (2, F, S, Dh // F))
    f32 = [np.asarray(a, dtype=np.float32) for a in (Cs, Rs, mus, subs)]
    Cs, Rs, mus, subs = f32
    return (tuple(Cs), tuple(Rs), tuple(mus),
            tuple(list(subs[s]) for s in range(2)))


def _queries(rng, kind, n):
    if kind == "random":
        return rng.randn(n, D).astype(np.float32)
    return rng.randint(-3, 4, (n, D)).astype(np.float32)


def _corpus(rng, n, n_dup):
    """Random codes plus ``n_dup`` rows that repeat earlier rows' (cell,
    codes) under new ids: their distances are bit-equal to the originals'."""
    coarse = rng.randint(0, V, (n, 2))
    fine = rng.randint(0, S, (n, M))
    src = rng.randint(0, n, n_dup)
    coarse = np.concatenate([coarse, coarse[src]])
    fine = np.concatenate([fine, fine[src]])
    ids = [f"v{i}" for i in range(n + n_dup)]
    return coarse.astype(np.int32), fine.astype(np.uint8), ids


def _models(params):
    from columbiaimagesearch_tpu.index.model import LOPQModel as JaxModel

    return (JaxModel(parameters=params),
            LOPQModel.from_numpy(*params, device="cpu"))


@pytest.mark.parametrize("layout", ["random-9", "random-64", "full-blocks",
                                    "empty"])
def test_padded_layout_matches_jax(layout):
    """Same arrays on the port's NB blocks; the JAX layout's extra block
    (its grid rounding) has count 0."""
    from columbiaimagesearch_tpu.index import pallas_adc as jpa

    rng = np.random.RandomState(0)
    if layout == "full-blocks":         # every cell exactly one block
        cells = rng.permutation(np.repeat(np.arange(3), BLK))
    elif layout == "empty":
        cells = np.zeros(0, dtype=np.int64)
    else:
        n_cells = int(layout.split("-")[1])
        cells = rng.randint(0, n_cells, 1000 if n_cells == 9 else 3000)
    fine = rng.randint(0, 256, (len(cells), M)).astype(np.uint8)
    got = build_padded_layout(cells, fine)
    want = jpa.build_padded_layout(cells, fine)
    NB = len(got[1])
    assert len(want[1]) in (NB, NB + 1)
    np.testing.assert_array_equal(got[0], want[0][:NB * BLK])
    np.testing.assert_array_equal(got[1], want[1][:NB])
    np.testing.assert_array_equal(got[2], want[2][:NB])
    np.testing.assert_array_equal(got[3], want[3])
    assert (want[2][NB:] == 0).all() and (want[0][NB * BLK:] == 0).all()
    assert got[1].dtype == got[2].dtype == np.int32


def test_build_query_luts_matches_jax():
    import jax.numpy as jnp

    from columbiaimagesearch_tpu.index import pallas_adc as jpa

    rng = np.random.RandomState(1)
    jm, tm = _models(_params(rng, "random"))
    X = _queries(rng, "random", 5)
    want = jpa.build_query_luts(
        jnp.asarray(X), *(jnp.asarray(t.numpy())
                          for t in (tm.Cs, tm.Rs, tm.mus, tm.subs)))
    got = build_query_luts(torch.from_numpy(X), tm.Cs, tm.Rs, tm.mus,
                           tm.subs)
    for g, w in zip(got, want):
        assert g.shape == (V, M // 2, S, 5) and g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("NQ", [1, 5, 8, 13])
def test_build_query_luts_tiled_matches_jax(NQ):
    """The tables ExhaustiveADC hands the kernel, built tiled in one copy
    from the LUT output, hold the JAX tables (rtol 1e-5, atol 1e-4) at
    their tiled positions, and equal tile_luts of the JAX-layout tables."""
    import jax.numpy as jnp

    from columbiaimagesearch_tpu.index import pallas_adc as jpa

    rng = np.random.RandomState(30 + NQ)
    _, tm = _models(_params(rng, "random"))
    X = _queries(rng, "random", NQ)
    want = jpa.build_query_luts(
        jnp.asarray(X), *(jnp.asarray(t.numpy())
                          for t in (tm.Cs, tm.Rs, tm.mus, tm.subs)))
    got = build_query_luts_tiled(torch.from_numpy(X), tm.Cs, tm.Rs, tm.mus,
                                 tm.subs)
    QT, Sp, _ = _scan_tiling(NQ, M, S)
    T = -(-NQ // QT)
    plain = build_query_luts(torch.from_numpy(X), tm.Cs, tm.Rs, tm.mus,
                             tm.subs)
    for g, w, p in zip(got, want, plain):
        assert g.shape == (V, T, M // 2, Sp, QT) and g.is_contiguous()
        back = g.permute(0, 2, 3, 1, 4).reshape(V, M // 2, Sp, T * QT)
        np.testing.assert_allclose(back[:, :, :S, :NQ].numpy(),
                                   np.asarray(w), rtol=RTOL, atol=ATOL)
        assert not back[:, :, :, NQ:].any()
        assert torch.equal(g, tile_luts(p, QT, Sp))
    if NQ == QT:               # the layouts coincide: a view, no copy
        assert tile_luts(plain[0], QT, Sp).data_ptr() == plain[0].data_ptr()


def test_plain_scan_matches_pallas_interpret():
    """On the JAX layout (a ragged last block per cell, and a trailing
    count-0 block) with the JAX tables: same distances, same +inf."""
    import jax.numpy as jnp

    from columbiaimagesearch_tpu.index import pallas_adc as jpa

    rng = np.random.RandomState(2)
    jm, tm = _models(_params(rng, "random"))
    coarse, fine, _ = _corpus(rng, 1500, 0)
    cells = coarse[:, 0].astype(np.int64) * V + coarse[:, 1]
    codes, bc, bn, _ = jpa.build_padded_layout(cells, fine)
    if not (bn == 0).any():     # a pair keeps the JAX grid's 2-block step
        codes = np.concatenate([codes, np.zeros((2 * BLK, M), np.uint8)])
        bc, bn = np.append(bc, [0, 0]), np.append(bn, [0, 0])
    assert (bn == 0).any() and ((bn > 0) & (bn < BLK)).any()
    X = _queries(rng, "random", 8)
    lut0, lut1 = jpa.build_query_luts(
        jnp.asarray(X), *(jnp.asarray(t.numpy())
                          for t in (tm.Cs, tm.Rs, tm.mus, tm.subs)))
    want = np.asarray(jpa.adc_scan_all(
        jnp.asarray(codes), jnp.asarray(bc.astype(np.int32)),
        jnp.asarray(bn.astype(np.int32)), lut0, lut1, V=V,
        n_blocks=len(bc), interpret=True))
    got = adc_scan_all_plain(
        torch.from_numpy(codes), torch.from_numpy(bc.astype(np.int32)),
        torch.from_numpy(bn.astype(np.int32)),
        *(torch.from_numpy(np.array(t)) for t in (lut0, lut1)), V=V).numpy()
    assert got.shape == want.shape == (8, len(bc) * BLK)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert (got[~fin] == np.inf).all() and (want[~fin] == np.inf).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


def test_cpu_tensors_take_plain_version_and_other_devices_raise():
    rng = np.random.RandomState(3)
    coarse, fine, _ = _corpus(rng, 300, 0)
    codes, bc, bn, _ = build_padded_layout(
        coarse[:, 0].astype(np.int64) * V + coarse[:, 1], fine)
    lut0 = rng.rand(V, M // 2, S, 3).astype(np.float32)
    lut1 = rng.rand(V, M // 2, S, 3).astype(np.float32)
    args = [torch.from_numpy(a) for a in (codes, bc, bn, lut0, lut1)]
    before = adc_scan_all.launches
    out = adc_scan_all(*args, V=V)
    assert adc_scan_all.launches == before
    torch.testing.assert_close(out, adc_scan_all_plain(*args, V=V),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="unsupported device"):
        adc_scan_all(*[a.to("meta") for a in args], V=V)


@pytest.mark.parametrize("levels,k", [(3, 40), (50, 7), (10 ** 6, 100)])
def test_topk_ascending_is_lax_top_k_order(levels, k):
    """Against a stable full sort, with many exact ties (few value
    levels), a tie group cut by the k-th position, and +inf padding."""
    rng = np.random.RandomState(levels)
    d = rng.randint(0, levels, (6, 2000)).astype(np.float32)
    d[:, 1500:] = np.inf
    d[5, 10:] = np.inf                  # fewer finite entries than k
    d = torch.from_numpy(d)
    vals, idx = _topk_ascending(d, k)
    want_v, want_i = torch.sort(d, dim=1, stable=True)
    fin = torch.isfinite(want_v[:, :k])
    torch.testing.assert_close(vals, want_v[:, :k], rtol=0, atol=0)
    assert torch.equal(idx[fin], want_i[:, :k][fin])


def _search_pair(kind, n, n_dup, nq=8):
    from columbiaimagesearch_tpu.index import pallas_adc as jpa

    rng = np.random.RandomState(4 if kind == "random" else 5)
    params = _params(rng, kind)
    jm, tm = _models(params)
    coarse, fine, ids = _corpus(rng, n, n_dup)
    jex = jpa.ExhaustiveADC(jm, interpret=True, nq=nq)
    tex = ExhaustiveADC(tm, nq=nq)
    for ex in (jex, tex):
        ex.build(coarse, fine, ids)
    return jex, tex, _queries(rng, kind, 11)


def _assert_same(want, got, exact_ties):
    assert len(got) == len(want)
    for (wi, wd), (gi, gd) in zip(want, got):
        assert gi == wi
        assert gd.dtype == np.float32
        if exact_ties:
            np.testing.assert_array_equal(gd, wd)
        else:
            np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind,n,n_dup,k", [
    ("random", 1500, 300, 10),
    ("integer", 1500, 300, 25),
    ("integer", 200, 60, 5000),          # k larger than the index
])
def test_search_batch_matches_jax(kind, n, n_dup, k):
    """11 queries at nq=8 (a full launch and a short one); duplicated
    (cell, codes) rows under new ids."""
    jex, tex, Q = _search_pair(kind, n, n_dup)
    want = jex.search_batch(Q, k=k)
    got = tex.search_batch(Q, k=k)
    _assert_same(want, got, exact_ties=kind == "integer")
    assert len(got[0][0]) == min(k, n + n_dup)
    if kind == "integer":               # the case exercises exact ties
        assert any((np.diff(d) == 0).any() for _, d in got)
    assert tex.search(Q[3], k=k)[0] == got[3][0]


def test_identity_ids_are_python_ints():
    rng = np.random.RandomState(6)
    _, tm = _models(_params(rng, "random"))
    coarse, fine, _ = _corpus(rng, 400, 0)
    ex = ExhaustiveADC(tm)
    ex.build(coarse, fine)
    ids, dists = ex.search(_queries(rng, "random", 1)[0], k=7)
    assert all(type(i) is int for i in ids) and len(ids) == 7


def test_padding_guard_matches_jax():
    """Every row in a cell of its own pads 128x past 4M rows: both raise."""
    from columbiaimagesearch_tpu.index import pallas_adc as jpa

    rng = np.random.RandomState(7)
    Vg = 200
    jm, tm = _models(_params(rng, "random", V=Vg))
    cells = np.arange(Vg * Vg)
    coarse = np.stack([cells // Vg, cells % Vg], 1).astype(np.int32)
    fine = np.zeros((len(cells), M), np.uint8)
    for ex in (jpa.ExhaustiveADC(jm, interpret=True), ExhaustiveADC(tm)):
        with pytest.raises(ValueError, match="would pad 40000 rows"):
            ex.build(coarse, fine)


def test_exhaustive_searcher_matches_jax():
    """Duplicate (cell, id) entries across dict adds are dropped (first
    insertion wins); a new id on the same cell is kept."""
    from columbiaimagesearch_tpu.index import pallas_adc as jpa

    rng = np.random.RandomState(8)
    jm, tm = _models(_params(rng, "integer"))
    coarse, fine, ids = _corpus(rng, 700, 0)
    first = {i: (tuple(c), tuple(f))
             for i, c, f in zip(ids[:500], coarse[:500], fine[:500])}
    second = {i: (tuple(c), tuple(f))           # 100 repeats, 200 new
              for i, c, f in zip(ids[400:], coarse[400:], fine[400:])}
    second["v3"] = (tuple(coarse[3]), tuple(fine[9]))    # same (cell, id)
    second["w3"] = (tuple(coarse[3]), tuple(fine[3]))    # new id
    js = jpa.ExhaustiveADCSearcher(jm, interpret=True)
    ts = ExhaustiveADCSearcher(tm)
    for s in (js, ts):
        s.add_codes_from_dict(first)
        s.add_codes_from_dict(second)
    assert ts.get_nb_indexed() == js.get_nb_indexed() == 701
    q = _queries(rng, "integer", 1)
    for kw in (dict(quota=20, with_dists=True), dict(quota=5, limit=12)):
        (wr, wv), (gr, gv) = js.search(q[0], **kw), ts.search(q[0], **kw)
        assert gv == wv == V * V
        assert [r.id for r in gr] == [r.id for r in wr]
        assert all(r.code is None for r in gr)
        if kw.get("with_dists"):
            assert [r.dist for r in gr] == [r.dist for r in wr]
    assert ExhaustiveADCSearcher(tm).search(q[0]) == ([], 0)


def _items_by_loop(bc, cap):
    """The work items, one block at a time."""
    out = []
    for b in range(len(bc)):
        if b == 0 or bc[b] != bc[b - 1] or b - out[-1] == cap:
            out.append(b)
    return out + [len(bc)]


@pytest.mark.parametrize("layout", ["random-9", "random-64", "long-runs",
                                    "one-cell", "empty"])
def test_scan_items_start_at_cell_boundaries(layout):
    """Items start at every cell change, hold one cell each, and split a
    run every ITEM_BLOCKS blocks."""
    rng = np.random.RandomState(11)
    if layout == "empty":
        cells = np.zeros(0, dtype=np.int64)
    elif layout == "one-cell":
        cells = np.full(23 * BLK + 5, 7)
    elif layout == "long-runs":           # runs of 1..13 blocks
        cells = np.repeat(np.arange(6), rng.randint(1, 13 * BLK, 6))
    else:
        n_cells = int(layout.split("-")[1])
        cells = rng.randint(0, n_cells, 5000)
    fine = np.zeros((len(cells), M), np.uint8)
    _, bc, _, _ = build_padded_layout(cells, fine)
    items = scan_items(torch.from_numpy(bc))
    assert items.dtype == torch.int32
    assert items.tolist() == _items_by_loop(bc.tolist(), ITEM_BLOCKS)
    it = items.numpy()
    assert (np.diff(it) >= 1).all() and (np.diff(it) <= ITEM_BLOCKS).all()
    for a, b in zip(it[:-1], it[1:]):
        assert (bc[a:b] == bc[a]).all()


@pytest.mark.parametrize("NQ,S", [(1, 16), (3, 16), (8, 30), (13, 30)])
def test_tile_luts_layout(NQ, S):
    """[V, F, S, NQ] -> [V, T, F, Sp, QT]: entry (v, t, f, s, k) is query
    t*QT + k; the padded queries and entries are 0."""
    rng = np.random.RandomState(NQ)
    lut = torch.from_numpy(rng.rand(5, 2, S, NQ).astype(np.float32))
    QT, Sp, smem = _scan_tiling(NQ, 4, S)
    assert Sp % 4 == 0 and Sp >= S and smem > 0
    assert QT == min(8, 1 << (NQ - 1).bit_length())
    t = tile_luts(lut, QT, Sp)
    T = -(-NQ // QT)
    assert t.shape == (5, T, 2, Sp, QT) and t.is_contiguous()
    back = t.permute(0, 2, 3, 1, 4).reshape(5, 2, Sp, T * QT)
    assert torch.equal(back[:, :, :S, :NQ], lut)
    assert not back[:, :, S:].any() and not back[:, :, :, NQ:].any()


@pytest.mark.parametrize("kind,NQ", [("integer", 1), ("integer", 3),
                                     ("integer", 12), ("random", 8),
                                     ("random", 13)])
def test_tiled_scan_matches_pallas_interpret(kind, NQ):
    """The CPU route of adc_scan_all (tiled tables, work items) against the
    JAX scan in interpret mode on the JAX layout, count-0 blocks included:
    bit-equal on the integer model, rtol 1e-5 / atol 1e-4 on the random
    one; identical +inf positions."""
    import jax.numpy as jnp

    from columbiaimagesearch_tpu.index import pallas_adc as jpa

    rng = np.random.RandomState(20 + NQ)
    _, tm = _models(_params(rng, kind))
    coarse, fine, _ = _corpus(rng, 1500, 0)
    coarse[:400] = coarse[0]                 # a cell spanning 4+ blocks
    cells = coarse[:, 0].astype(np.int64) * V + coarse[:, 1]
    codes, bc, bn, _ = jpa.build_padded_layout(cells, fine)
    X = _queries(rng, kind, NQ)
    lut0, lut1 = jpa.build_query_luts(
        jnp.asarray(X), *(jnp.asarray(t.numpy())
                          for t in (tm.Cs, tm.Rs, tm.mus, tm.subs)))
    bc, bn = bc.astype(np.int32), bn.astype(np.int32)
    want = np.asarray(jpa.adc_scan_all(
        jnp.asarray(codes), jnp.asarray(bc), jnp.asarray(bn), lut0, lut1,
        V=V, n_blocks=len(bc), interpret=True))
    args = [torch.from_numpy(np.array(a)) for a in (codes, bc, bn, lut0,
                                                    lut1)]
    got = adc_scan_all(*args, V=V).numpy()
    assert (np.diff(scan_items(args[1]).numpy()) > 1).any()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert (got[~fin] == np.inf).all()
    if kind == "integer":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got, adc_scan_all_plain(*args, V=V))


def test_tiled_plain_poisons_bad_cells_and_codes():
    """The kernel's rules in the plain scan, on the CPU, through both entry
    points (the JAX layout and the tiled one): an out-of-range cell makes
    its valid rows NaN, a code byte >= S its own row; padding stays
    +inf."""
    rng = np.random.RandomState(12)
    Sb = 30
    cells = rng.randint(0, V * V, 700)
    fine = rng.randint(0, Sb, (700, M)).astype(np.uint8)
    codes, bc, bn, _ = build_padded_layout(cells, fine)
    bc[2] = V * V                        # out of range
    codes[3 * BLK] = [0, Sb, 1, 2]       # a code byte >= S
    lut = [torch.from_numpy(rng.rand(V, M // 2, Sb, 5).astype(np.float32))
           for _ in range(2)]
    args = [torch.from_numpy(a) for a in (codes, bc, bn)] + lut
    got = adc_scan_all(*args, V=V)
    assert torch.isnan(got[:, 2 * BLK:2 * BLK + bn[2]]).all()
    assert torch.isinf(got[:, 2 * BLK + bn[2]:3 * BLK]).all()
    assert torch.isnan(got[:, 3 * BLK]).all()
    ok = torch.ones(got.shape[1], dtype=torch.bool)
    ok[2 * BLK:3 * BLK] = False
    ok[3 * BLK] = False
    bc_ok = bc.copy()
    bc_ok[2] = 0
    codes_ok = codes.copy()
    codes_ok[3 * BLK] = 0
    want = adc_scan_all_plain(torch.from_numpy(codes_ok),
                              torch.from_numpy(bc_ok), args[2], *lut, V=V)
    assert torch.equal(got[:, ok], want[:, ok])
    QT, Sp, _ = _scan_tiling(5, M, Sb)
    direct = adc_scan_tiled(
        *args[:3], tile_luts(lut[0], QT, Sp), tile_luts(lut[1], QT, Sp),
        V=V, NQ=5, S=Sb)
    assert torch.equal(direct.isnan(), got.isnan())
    assert torch.equal(direct[~got.isnan()], got[~got.isnan()])


# ------------------------------------------------------------- card only


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the H100)")
    return torch.device("cuda")


def _odd_layout(rng, NQ, dev):
    """The small odd shape: V=37, M=4, S=32, ragged last blocks, and
    count-0 blocks inserted at the front, the middle and the end."""
    Vo, Mo, So = 37, 4, 32
    n = 3000
    cells = np.concatenate([rng.randint(0, 5, n // 2),       # multi-block
                            rng.randint(0, Vo * Vo, n - n // 2)])
    fine = rng.randint(0, So, (n, Mo)).astype(np.uint8)
    codes, bc, bn, _ = build_padded_layout(cells, fine)
    at = [0, len(bc) // 2, len(bc)]
    codes = np.insert(codes.reshape(-1, BLK, Mo), at,
                      rng.randint(0, So, (BLK, Mo)), axis=0).reshape(-1, Mo)
    bc = np.insert(bc, at, rng.randint(0, Vo * Vo, 3)).astype(np.int32)
    bn = np.insert(bn, at, 0).astype(np.int32)
    lut0 = rng.rand(Vo, Mo // 2, So, NQ).astype(np.float32)
    lut1 = rng.rand(Vo, Mo // 2, So, NQ).astype(np.float32)
    return [torch.from_numpy(a).to(dev)
            for a in (codes, bc, bn, lut0, lut1)], Vo


@pytest.mark.cuda
@pytest.mark.parametrize("NQ", [1, 3, 8, 12, 64])
def test_scan_kernel_matches_plain_on_card(cuda_device, NQ):
    """Kernel vs plain version on the card: bit-equal (both add the M
    entries in m order), identical +inf positions. NQ 1, 3, 8, 12 and 64
    take query tiles of 1, 4 and 8 (12: a ragged last tile; 64: eight
    tiles)."""
    args, Vo = _odd_layout(np.random.RandomState(NQ), NQ, cuda_device)
    before = adc_scan_all.launches
    got = adc_scan_all(*args, V=Vo)
    torch.cuda.synchronize()
    assert adc_scan_all.launches == before + 1
    want = adc_scan_all_plain(*args, V=Vo)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert int(torch.isinf(got).sum()) > 3 * BLK * NQ
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("Mo", [4, 8])
@pytest.mark.parametrize("NQ", [1, 3, 8, 64])
def test_scan_kernel_edges_on_card(cuda_device, NQ, Mo):
    """The persistent kernel's edges: a cell of 10 blocks (three work
    items), 300 cells so that c // V changes inside a block's range,
    count-0 blocks at the front, middle and end, an out-of-range cell and
    a code byte >= S (NaN rows). Equal to the plain scan on the CPU,
    NaN positions included. M=8 takes the kernel's unrolled gathers, M=4
    its loop."""
    rng = np.random.RandomState(100 + NQ)
    Vo, So = 37, 30
    cells = np.concatenate([np.full(10 * BLK - 3, 40),
                            rng.randint(0, Vo * Vo, 4000)])
    fine = rng.randint(0, So, (len(cells), Mo)).astype(np.uint8)
    codes, bc, bn, _ = build_padded_layout(cells, fine)
    at = [0, len(bc) // 2, len(bc)]
    codes = np.insert(codes.reshape(-1, BLK, Mo), at,
                      rng.randint(0, So, (BLK, Mo)), axis=0).reshape(-1, Mo)
    bc = np.insert(bc, at, [3, 5, Vo * Vo - 1]).astype(np.int32)
    bn = np.insert(bn, at, 0).astype(np.int32)
    bc[7] = Vo * Vo + 2
    codes[9 * BLK + 1, 2] = So + 3
    lut = [rng.rand(Vo, Mo // 2, So, NQ).astype(np.float32)
           for _ in range(2)]
    cpu = [torch.from_numpy(a) for a in (codes, bc, bn, *lut)]
    items = scan_items(cpu[1])
    assert (torch.diff(items) == ITEM_BLOCKS).sum() >= 2
    want = adc_scan_all(*cpu, V=Vo, items=items)      # the plain scan
    got = adc_scan_all(*[a.to(cuda_device) for a in cpu], V=Vo,
                       items=items.to(cuda_device))
    torch.cuda.synchronize()
    got = got.cpu()
    assert torch.isnan(want).any() and torch.isinf(want).any()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got[~got.isnan()], want[~want.isnan()])


@pytest.mark.cuda
def test_scan_wrapper_rejects_bad_inputs(cuda_device):
    args, Vo = _odd_layout(np.random.RandomState(0), 3, cuda_device)
    codes, bc, bn, lut0, lut1 = args
    with pytest.raises(TypeError, match="dtype"):
        adc_scan_all(codes.to(torch.int32), bc, bn, lut0, lut1, V=Vo)
    with pytest.raises(ValueError, match="shape"):
        adc_scan_all(codes, bc, bn, lut0[1:], lut1, V=Vo)
    with pytest.raises(ValueError, match="contiguous"):
        adc_scan_all(codes, bc, bn, lut0.transpose(2, 3).contiguous()
                     .transpose(2, 3), lut1, V=Vo)
    with pytest.raises(ValueError, match="is on"):
        adc_scan_all(codes, bc.cpu(), bn, lut0, lut1, V=Vo)
