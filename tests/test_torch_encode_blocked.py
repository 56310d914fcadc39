"""The port's cluster-blocked encoder (index/encode.py
``lopq_encode_blocked``, ``blocks_needed``) and ``dedup_first_mask``
(utils/codes.py) against the JAX package.

Tables and rows are drawn with numpy from a seed at small shapes: a V that
is not a power of two, clusters no row reaches (their centroids moved far
away), N not a multiple of 256, and coarse chunks and windows smaller than
the input and the layout so that several of each run. Codes must equal JAX
``lopq_encode_blocked``'s and the port's ``lopq_encode``'s exactly; the
only exception allowed is a row whose differing code is a float64
near-tie within 1e-4 relative (0 such rows at these shapes when this
file was written: the codes were equal on every row).
"""

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch.index.encode import (
    BLK,
    blocks_needed,
    lopq_encode,
    lopq_encode_blocked,
)
from columbiaimagesearch_tpu_torch.utils.codes import dedup_first_mask

#: (N, V, D, M, S, clusters moved out of reach)
SHAPES = [(4096, 16, 32, 4, 16, 0), (3000, 64, 16, 4, 8, 8),
          (5000, 7, 32, 8, 16, 2)]
TIE_RTOL = 1e-4


def _tables(seed, N, V, D, M, S, empty):
    rng = np.random.RandomState(seed)
    Dh, F = D // 2, M // 2
    Cs = rng.randn(2, V, Dh).astype(np.float32)
    Cs[:, :empty] += 100.0
    Rs = np.stack([np.stack([np.linalg.qr(rng.randn(Dh, Dh))[0]
                             for _ in range(V)]) for _ in range(2)])
    mus = 0.1 * rng.randn(2, V, Dh)
    subs = rng.randn(2, F, S, Dh // F)
    X = rng.randn(N, D).astype(np.float32)
    return [a.astype(np.float32) for a in (Cs, Rs, mus, subs)], X


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _differing_rows(tables, X, got, want):
    """Rows whose codes differ; asserts that each is a float64 near-tie
    (its coarse code, else each differing subcode)."""
    Cs, Rs, mus, subs = [a.astype(np.float64) for a in tables]
    (cg, fg), (cw, fw) = got, want
    F, Dh = subs.shape[1], Cs.shape[2]
    bad = np.nonzero((cg != cw).any(1) | (fg != fw).any(1))[0]
    for i in bad:
        for s in range(2):
            x = X[i, s * Dh:(s + 1) * Dh].astype(np.float64)
            a, b = cg[i, s], cw[i, s]
            if a != b:              # then the fine codes are not comparable
                d = ((x - Cs[s][[a, b]]) ** 2).sum(1)
                assert abs(d[0] - d[1]) <= TIE_RTOL * d.max(), (i, s, d)
                continue
            pr = Rs[s][a] @ (x - Cs[s][a] - mus[s][a])
            for f in range(F):
                p, q = fg[i, s * F + f], fw[i, s * F + f]
                px = np.split(pr, F)[f]
                d = ((px - subs[s, f][[p, q]]) ** 2).sum(1)
                assert abs(d[0] - d[1]) <= TIE_RTOL * d.max(), (i, s, f, d)
    return len(bad)


def _needed(X, Cs, V):
    """Blocks the layout takes: the most over the halves."""
    Dh = Cs.shape[2]
    out = 0
    for s in range(2):
        xh = X[:, s * Dh:(s + 1) * Dh]
        a = np.argmin((Cs[s] ** 2).sum(1) - 2.0 * xh @ Cs[s].T, axis=1)
        counts = np.bincount(a, minlength=V)
        out = max(out, int(((counts + BLK - 1) // BLK).sum()))
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "N%d-V%d" % s[:2])
def test_blocked_codes_equal_jax_and_lopq_encode(shape, monkeypatch):
    from columbiaimagesearch_tpu.index.tpu_encode_blocked import (
        lopq_encode_blocked as jax_blocked,
    )

    N, V, D, M, S, empty = shape
    tables, X = _tables(N + V, N, V, D, M, S, empty)
    n_blocks = blocks_needed(N, V)
    want = tuple(np.asarray(a) for a in jax_blocked(*tables, X, V, n_blocks))
    tt = _torch(tables)
    windows = []
    bmm = torch.bmm
    monkeypatch.setattr(torch, "bmm", lambda *a: windows.append(1) or bmm(*a))
    got = lopq_encode_blocked(*tt, torch.from_numpy(X), V, n_blocks,
                              chunk=1000)
    monkeypatch.undo()
    assert len(windows) > 2                 # several windows in a half
    got = tuple(a.numpy() for a in got)
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32
    assert got[0].shape == (N, 2) and got[1].shape == (N, M)
    if empty:
        assert len(np.unique(got[0])) < V  # some cluster holds no row
    _differing_rows(tables, X, got, want)
    plain = tuple(a.numpy() for a in lopq_encode(*tt, torch.from_numpy(X)))
    _differing_rows(tables, X, got, plain)


@pytest.mark.parametrize("n,V", [(1, 1), (255, 7), (256, 16), (3000, 64),
                                 (10_485_760, 4096)])
def test_blocks_needed_equals_jax(n, V):
    from columbiaimagesearch_tpu.index.tpu_encode_blocked import (
        blocks_needed as jax_blocks_needed,
    )

    assert blocks_needed(n, V) == jax_blocks_needed(n, V)


def test_too_few_blocks_raise_and_extra_blocks_change_nothing():
    """JAX drops the rows past its buffer and returns wrong codes when
    given too few blocks; the port raises."""
    N, V, D, M, S, empty = SHAPES[1]
    tables, X = _tables(1, N, V, D, M, S, empty)
    tt, xt = _torch(tables), torch.from_numpy(X)
    need = _needed(X, tables[0], V)
    exact = lopq_encode_blocked(*tt, xt, V, need, chunk=1000)
    with pytest.raises(ValueError, match="blocks"):
        lopq_encode_blocked(*tt, xt, V, need - 1)
    extra = lopq_encode_blocked(*tt, xt, V, blocks_needed(N, V) + 100)
    for a, b in zip(exact, extra):
        assert torch.equal(a, b)


def test_outputs_lie_on_the_tables_device():
    N, V, D, M, S, empty = SHAPES[2]
    tables, X = _tables(2, N, V, D, M, S, empty)
    tt = _torch(tables)
    coarse, fine = lopq_encode_blocked(*tt, torch.from_numpy(X), V,
                                       blocks_needed(N, V))
    assert coarse.device == fine.device == tt[0].device
    with pytest.raises(ValueError, match="lies on"):
        lopq_encode_blocked(*tt, torch.empty((N, D), device="meta"), V,
                            blocks_needed(N, V))


def _dedup_cases():
    rs = np.random.RandomState(7)
    n = 5000
    cells = rs.randint(0, 64, n).astype(np.int64)
    ids = np.empty(n, dtype=object)
    ids[:] = [("s%d" % v) if v % 3 else v for v in rs.randint(0, n // 4, n)]
    big = rs.randint(0, 40_000, 150_000)
    wide = np.array([1 << 30, 5, 1 << 30, (1 << 31) + 3, 5, 1 << 30])
    return {
        "mixed": (cells, ids),
        "empty": (np.zeros(0, np.int64), []),
        "cells": (np.array([1, 2, 3]), ["a", "b", "a"]),
        "bulk": (rs.randint(0, 16, len(big)), big),
        "list": ([0, 0, 0, 1], [5, "5", 5, 5]),
        "two_column": (wide, ["a", "b", "a", "a", "b", "c"]),
    }


@pytest.mark.parametrize("case", list(_dedup_cases()))
def test_dedup_first_mask_equals_jax(case):
    from columbiaimagesearch_tpu.utils.codes import (
        dedup_first_mask as jax_dedup,
    )

    cells, ids = _dedup_cases()[case]
    got = dedup_first_mask(cells, ids)
    want = jax_dedup(cells, ids)
    assert got.dtype == bool and got.shape == (len(cells),)
    np.testing.assert_array_equal(got, want)
    seen, first = set(), []
    for c, i in zip(np.asarray(cells).tolist(), list(ids)):
        first.append((c, i) not in seen)
        seen.add((c, i))
    np.testing.assert_array_equal(got, first)
