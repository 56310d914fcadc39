"""Probe-ladder policy: rung geometry, the brute-vs-grid plan choice, the
quota-aware rung floor and the host-side escalation driver.

Copied from columbiaimagesearch_tpu/index/tpu_query.py:792-968 (pure Python
and numpy; the JAX module also imports Pallas, so the port keeps its own
copy). Only the plan's cost model differs: its form and its constants are
the H100's, fitted by ``chip_smoke.py`` ``phase_plan_costs``.
"""

import itertools
import math

import numpy as np

from columbiaimagesearch_tpu_torch.index.query import brute_chunk, uses_lut
from columbiaimagesearch_tpu_torch.utils.chunking import (
    STORE_CHUNK,
    store_capacity,
)

#: Cost model for the plan choice (brute vs probe ladder), both plans
#: costed as one wave of nq queries, in ns:
#:
#:   brute = BRUTE_NS_WAVE + nq * BRUTE_NS_QUERY
#:           + chunks * (BRUTE_NS_CHUNK
#:                       + rows * row_bytes * BRUTE_NS_CHUNK_PER_BYTE)
#:           + nq * rows * BRUTE_NS_PER_ROW
#:   grid  = GRID_NS_WAVE_LUT or GRID_NS_WAVE_DIRECT
#:           + nq * (GRID_NS_FIXED + GRID_NS_PER_CELL * G
#:                   + GRID_NS_PER_SLOT * Q on the direct route)
#:
#: ``rows`` is what ``brute_query_batch`` scans, the store's capacity for
#: nb rows (:func:`brute_rows`), and ``row_bytes`` a stored row's bytes
#: (D x the store's itemsize). A wave runs in ``chunks`` of the width
#: ``query.brute_chunk`` gives the pass itself: one chunk while the
#: chunk's transients stay small, else chunks of BRUTE_QCH queries. Each
#: chunk reads the whole store once (one matmul) and pays its launches;
#: the top-k selection is per query, and so are the host's unpacking and
#: result rows (BRUTE_NS_QUERY). G is the starting rung's region
#: (:func:`rung_cells`) and Q the wave's candidate budget. A rung whose
#: candidates are scored through ADC tables (``query.uses_lut``) costs
#: little per slot; the direct route scores each of its Q slots from
#: rotated residuals and launches more per wave. Both sides are what
#: ``search_batch`` takes for a wave on that plan, results included.
#:
#: Fitted by least squares of the relative error (:func:`fit_costs`) on
#: 164 waves, each the median of 9 rounds timed with CUDA events, by
#: ``chip_smoke.py`` ``phase_plan_costs`` (run alone by
#: ``scripts/torch_plan_costs.py``) on an NVIDIA H100 80GB HBM3 at a
#: 700 W power limit: the trained release model's index (V=4096, M=8,
#: D=256) at nb 20,000, 262,144, 1,048,576 and 10,485,760 in a float32
#: store and at 20,000 and 262,144 in a bfloat16 one, the trained face
#: model's (V=256, D=128, float32 store) at 20,000 and 262,144, waves of
#: 1, 16 and 100 queries, the brute pass and rungs 64, (128, 8), (256, 16)
#: and (512, 32) (the face store: 64 and (128, 8)) at quota 10,000, the
#: release index also at 100,000 (limit 100, rerank depth 1,000); and
#: ``eval_recall``'s 20,000 x 32 rows at V=16 (bfloat16 store, quota 500)
#: at 1, 16, 50 and 100 queries. Brute waves read 0.72-1.27 of the fit,
#: the host-bound ones below ~4 ms the farthest; grid waves 0.61-1.46,
#: 129 of 136 within 30%: six of the other seven take the table route at
#: 100 queries, whose cost grows with the rows in the probed cells. The
#: host-bound waves move by a third between machines (PERF.md, "Plan
#: costs").
BRUTE_NS_WAVE = 0.0
BRUTE_NS_QUERY = 69.51e3
BRUTE_NS_CHUNK = 2.899e6
BRUTE_NS_CHUNK_PER_BYTE = 3.039e-4
BRUTE_NS_PER_ROW = 0.02168
GRID_NS_WAVE_LUT = 6.396e6
GRID_NS_WAVE_DIRECT = 7.065e6
GRID_NS_FIXED = 40.42e3
GRID_NS_PER_CELL = 0.3911
GRID_NS_PER_SLOT = 5.516

#: the constants' names in the order of :func:`brute_terms` and
#: :func:`grid_terms`
BRUTE_NAMES = ("BRUTE_NS_WAVE", "BRUTE_NS_QUERY", "BRUTE_NS_CHUNK",
               "BRUTE_NS_CHUNK_PER_BYTE", "BRUTE_NS_PER_ROW")
GRID_NAMES = ("GRID_NS_WAVE_LUT", "GRID_NS_WAVE_DIRECT", "GRID_NS_FIXED",
              "GRID_NS_PER_CELL", "GRID_NS_PER_SLOT")


def brute_rows(nb):
    """Rows a brute pass scans over a single-device store of ``nb`` rows:
    the capacity ``LOPQSearcherTorch`` plans for them."""
    return store_capacity(nb, STORE_CHUNK)


def brute_terms(nq, nb, D, itemsize, K_pre):
    """The brute wave's terms, in the order of BRUTE_NAMES, over a store
    of ``D``-wide rows of ``itemsize`` bytes each with ``K_pre`` survivors
    a query (the rerank depth)."""
    rows = brute_rows(nb)
    chunks = math.ceil(nq / brute_chunk(nq, rows, K_pre, D))
    return (1, nq, chunks, chunks * rows * D * itemsize, nq * rows)


def grid_terms(nq, V, spec, Q):
    """The grid wave's terms at rung ``spec`` with a candidate budget of
    ``Q`` a query, in the order of GRID_NAMES."""
    B, SB = rung_parts(spec)
    lut = uses_lut(B, SB, V, Q)
    return (int(lut), int(not lut), nq, nq * rung_cells(spec, V),
            0 if lut else nq * Q)


def brute_wave_ns(nq, nb, D, itemsize, K_pre):
    """The model's ns for a brute wave of ``nq`` queries over nb rows
    (the store's width, itemsize and the survivors as in
    :func:`brute_terms`)."""
    return float(np.dot(brute_terms(nq, nb, D, itemsize, K_pre), (
        BRUTE_NS_WAVE, BRUTE_NS_QUERY, BRUTE_NS_CHUNK,
        BRUTE_NS_CHUNK_PER_BYTE, BRUTE_NS_PER_ROW)))


def grid_wave_ns(nq, V, spec, Q):
    """The model's ns for a grid wave of ``nq`` queries at rung ``spec``."""
    return float(np.dot(grid_terms(nq, V, spec, Q), (
        GRID_NS_WAVE_LUT, GRID_NS_WAVE_DIRECT, GRID_NS_FIXED,
        GRID_NS_PER_CELL, GRID_NS_PER_SLOT)))


def fit_costs(terms, ns):
    """Constants c >= 0 of a cost model ``terms @ c`` fitted to measured
    wave times ``ns`` by least squares of the relative error (waves from
    tens of microseconds to tens of milliseconds weigh alike). Exact
    non-negative least squares: every subset of free constants is solved
    and the best one with no negative constant kept.

    :param terms: [n, k] each point's terms (:func:`brute_terms`,
        :func:`grid_terms`)
    :param ns: [n] measured times
    :returns: [k] constants
    """
    ns = np.asarray(ns, np.float64)
    A = np.asarray(terms, np.float64) / ns[:, None]
    # Unit columns: the terms span ten orders of magnitude.
    scale = np.linalg.norm(A, axis=0)
    scale[scale == 0] = 1.0
    k = A.shape[1]
    best, best_err = None, np.inf
    for free in itertools.product((False, True), repeat=k):
        cols = np.flatnonzero(free)
        if not len(cols):
            continue
        c = np.zeros(k)
        c[cols] = np.linalg.lstsq(A[:, cols] / scale[cols],
                                  np.ones(len(ns)), rcond=None)[0]
        c /= scale
        if (c < 0).any():
            continue
        err = float(np.sum((A @ c - 1.0) ** 2))
        if err < best_err:
            best, best_err = c, err
    return best


def rung_cells(spec, V):
    """Probed-region size G of a ladder rung."""
    B, SB = rung_parts(spec)
    B = min(B, V)
    if not SB or B >= V:
        return B * B
    SL = min(8 * B, V)
    return SB * SL + (B - SB) * B + (SL - B) * SB


def prefer_brute(ladder_tail, nq, nb, V, Q, *, D, itemsize, K_pre):
    """True when one exact brute wave over the feature store is cheaper
    than the grid ladder's starting rung for this wave. ``ladder_tail``
    is the ladder from its floor rung on (empty -> brute wins by
    default); ``Q`` is the wave's candidate budget a query; the store
    holds ``D``-wide rows of ``itemsize`` bytes, and the brute pass keeps
    ``K_pre`` survivors a query. Both plans are costed as a wave of
    ``nq`` queries."""
    if not ladder_tail:
        return True
    nq = max(nq, 1)
    return (brute_wave_ns(nq, nb, D, itemsize, K_pre)
            < grid_wave_ns(nq, V, ladder_tail[0], Q))


#: Adaptive probe-width ladder. Rung spec: an int B (square B x B grid) or
#: a (B, SB) tuple (square plus SB-deep full-length edge strips — see
#: query.lopq_query's SB param).
PROBE_LADDER = (64, (128, 8), (256, 16), (512, 32), (1024, 64))


def rung_parts(spec):
    """(B, SB) of a ladder rung spec."""
    return spec if isinstance(spec, tuple) else (spec, 0)


def rung_floor(ladder, quota, nb, V, yield_est=None):
    """Quota-aware starting rung: the narrowest ladder width whose grid
    can plausibly contain the reference walk's quota crossing.

    The walk visits ~``quota / yield`` cells before crossing (yield =
    candidates per visited cell, observed by escalate_probe at real quota
    crossings), and a staircase region of A cells needs grid legs of
    ~sqrt(2A). Without an observed yield the ladder starts narrow:
    escalation guards correctness, and the first satisfied wave makes the
    floor real.
    """
    if nb <= 0 or len(ladder) <= 1:
        return 0
    quota_eff = min(int(quota), int(nb))
    if quota_eff <= 0:
        return 0
    if yield_est is None or yield_est <= 0:
        return 0
    required_b = math.sqrt(2.0 * quota_eff / float(yield_est))
    for i, spec in enumerate(ladder):
        if rung_parts(spec)[0] >= required_b:
            return i
    return len(ladder) - 1


def probe_ladder(V, probe_width=None, ladder=PROBE_LADDER):
    """Rung specs to try in order; a manual ``probe_width`` pins a single
    square rung."""
    if probe_width:
        return (min(probe_width, V),)
    out = []
    for spec in ladder:
        b, sb = rung_parts(spec)
        b = min(b, V)
        sb = 0 if b >= V else min(sb, b)
        spec = (b, sb) if sb else b
        if spec not in out:
            out.append(spec)
    return tuple(out)


def escalate_probe(run_tier, ladder, n, quota, nb, K_pad):
    """Host-side escalation driver: run ``run_tier(pending_idx, B)`` for
    successive ladder widths, re-issuing only the queries whose tier was
    insufficient — the candidate total fell short of the (index-size
    capped) quota, or the ``grid_ok`` certificate failed (reference
    probe-until-quota loop, lopq/lopq/search.py:110-135).

    :param run_tier: (idx [k] int array, B) -> (rows [k, K_pad],
        dists [k, K_pad], total [k], ncells [k], grid_ok [k]) numpy arrays
    :returns: (rows [n, K_pad] int32, dists [n, K_pad] f32, ncells [n],
        frac_short_first, settle_tier, yield_obs, settled) — see the JAX
        package's escalate_probe for the meaning of the last four.
    """
    quota_eff = min(int(quota), nb)
    rows_b = np.full((n, K_pad), -1, np.int32)
    dists_b = np.full((n, K_pad), np.inf, np.float32)
    ncells_b = np.zeros(n, np.int64)
    pend = np.arange(n)
    frac_short_first = 0.0
    settle_tier = max(len(ladder) - 1, 0)
    settled = False
    yield_sum, yield_n = 0.0, 0
    for ti, B in enumerate(ladder):
        r, dd, tot, nc, ok = run_tier(pend, B)
        rows_b[pend], dists_b[pend], ncells_b[pend] = r, dd, nc
        tot = np.asarray(tot)
        nc = np.asarray(nc)
        short = (tot < quota_eff) | (np.asarray(ok) == 0)
        sat = ~short & (nc > 0)
        if sat.any():
            yield_sum += float((tot[sat] / nc[sat]).sum())
            yield_n += int(sat.sum())
        if ti == 0:
            frac_short_first = float(short.mean()) if n else 0.0
        if n and (n - int(short.sum())) >= 0.9 * n and not settled:
            settle_tier = ti
            settled = True
        if ti + 1 == len(ladder):
            break
        pend = pend[short]
        if len(pend) == 0:
            break
    yield_obs = (yield_sum / yield_n) if yield_n else None
    return (rows_b, dists_b, ncells_b, frac_short_first, settle_tier,
            yield_obs, settled)
