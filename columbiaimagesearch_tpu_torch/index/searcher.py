"""``LOPQSearcherTorch``: the device-resident CSR multi-index searcher in
PyTorch (port of columbiaimagesearch_tpu/index/searcher.py:43-88, 290-1143,
1145-1175, 1352-1431, ``LOPQSearcherTPU``).

Codes live in capacity-padded device buffers in insertion order; each
refresh writes only the new rows and rebuilds the cell-sorted CSR view on
the device (index/csr.py). The host keeps insertion-order copies of cells,
fine codes and ids for result assembly, and the sorted key array of the
exact first-insertion dedup. Queries are answered in waves through
:func:`index.query.lopq_query` (square rungs build their tables with the
LUT kernel) and walk the probe ladder (index/probe.py); with a resident
feature store they rerank exactly on the device, or take the exact brute
plan when the cost model prefers it. With a :class:`LOPQModelPCA` the
searcher takes raw vectors: queries and stored rerank features are
PCA-projected on the device (searcher.py:503-504, 1078-1079, 1374-1375).

Differences from the JAX searcher:

- The rerank feature store lives on the device only (no host mirror):
  capacity growth copies it device to device. Its dtype follows the JAX
  plan (``_plan_rerank_dtype``: float32 while one store copy fits the
  budget, else bfloat16; ``rerank_dtype`` pins it), with the budget read
  from the card (``torch.cuda.mem_get_info``) rather than the v5e size.
  Candidates are gathered in the store's dtype and upcast to float32
  before the exact distance.
- Appends write into the capacity buffers in place where the JAX searcher
  donated them. A stale query snapshot reads only rows below its own
  count, which appends never touch, and growth allocates fresh buffers,
  so snapshots stay valid and no stale-snapshot retry is needed.
- Waves are not padded to bucket sizes (nothing is compiled per shape).
- The per-launch wave cap is sized from the device's free memory
  (``torch.cuda.mem_get_info``) against the transients of the port's
  gather route, and an out-of-memory launch
  (``torch.cuda.OutOfMemoryError``) halves this searcher's cap and
  retries, down to single-query launches.

The serving fast path (searcher.py:1176-1350) is ported:
:meth:`LOPQSearcherTorch.search_device_feats` takes raw features straight
from the featurizer (normalize and PCA on the device once a wave,
``query.normalize_project``), and :meth:`LOPQSearcherTorch.prewarm_ladder`
runs every rung once before traffic. Below the entry points the wave
(plan choice, brute pass or probe ladder, wave cap, result rows, prewarm)
is ``_WaveDriver``'s, which the sharded index shares. Search entry points
run under ``torch.inference_mode`` (grad mode is per thread, and serving
searches run in the coalescer's and the HTTP handlers' threads); the
device buffers are built outside it, so later in-place appends stay
legal.

``codestore_path`` persists the codes in the native store
(searcher.py:405-416, 486-492). At V >= ``WIDE_V_THRESHOLD`` (8192) the
searcher keeps no dense offsets table (wide-V mode): queries look buckets
up in the sorted cell ids (index/query.py).

The host reference path is ported too: ``LOPQSearcherBase`` (the
multisequence walk, per-cluster LUT memoization, ADC ranking;
searcher.py:176-258) and the dict-backed ``LOPQSearcher``
(searcher.py:261-287), the oracle the device searchers are held to.
"""

import threading
from collections import defaultdict, namedtuple
from itertools import count, repeat

import numpy as np
import torch

from columbiaimagesearch_tpu_torch.common.heap import Settled
from columbiaimagesearch_tpu_torch.common.profiling import span
from columbiaimagesearch_tpu_torch.device import device_bytes, free_bytes
from columbiaimagesearch_tpu_torch.index.csr import (
    append_and_build_csr,
    append_rows,
)
from columbiaimagesearch_tpu_torch.index.model import LOPQCode, LOPQModelPCA
from columbiaimagesearch_tpu_torch.index.multisequence import multisequence
from columbiaimagesearch_tpu_torch.index.probe import (
    escalate_probe,
    prefer_brute,
    probe_ladder,
    rung_cells,
    rung_floor,
    rung_parts,
)
from columbiaimagesearch_tpu_torch.index.query import (
    brute_query_batch,
    lopq_query_orig,
    lopq_query_rerank,
    normalize_project,
    pack_query_out,
    unpack_query_out,
    uses_lut,
)
from columbiaimagesearch_tpu_torch.utils.chunking import (
    STORE_CHUNK,
    round_up,
    store_capacity,
    wave_bucket,
)
from columbiaimagesearch_tpu_torch.utils.codes import (
    IncrementalDedup,
    code_dtype_for,
    ids_to_object_array,
)

Result = namedtuple("Result", ["id", "code"])
ResultDist = namedtuple("Result", ["id", "code", "dist"])


def _pyid(v):
    """Unbox numpy scalars so Result.id is always a plain Python value."""
    return v.item() if isinstance(v, np.generic) else v


def _valid_rows(rows, dists, ids):
    """One query's valid answer rows (row >= 0, finite distance): (the
    rows, their ids and their distances as Python lists). ``tolist``
    unboxes an int64 id array in C (per-id ``_pyid`` calls were most of a
    100-query wave's host time)."""
    keep = (rows >= 0) & np.isfinite(dists)
    rows = rows[keep]
    sel = ids[rows]
    sel = sel.tolist() if sel.dtype != object else [_pyid(i) for i in sel]
    return rows, sel, dists[keep].tolist()


def _codes_to_arrays(codes, ids, V, S):
    """Normalize codes input: iterable of LOPQCode tuples or array pair."""
    if isinstance(codes, tuple) and len(codes) == 2 and hasattr(codes[0], "ndim"):
        coarse, fine = codes
        coarse = np.asarray(coarse)
        fine = np.asarray(fine)
    else:
        codes = list(codes)
        coarse = np.asarray([c[0] for c in codes], dtype=code_dtype_for(V))
        fine = np.asarray([c[1] for c in codes], dtype=code_dtype_for(S))
    n = coarse.shape[0]
    # Identity ids stay an int64 arange (no object boxing at 10M scale).
    ids_arr = np.arange(n) if ids is None else ids_to_object_array(ids, n)
    return coarse, fine, ids_arr


def _query_geometry(quota, limit, nb, rerank_nb, Q=None):
    """Query shape math shared by the search paths.

    :returns: (K requested output rows, Q candidate budget, K_stage ADC
        top-k depth, R rerank depth (0 = off), K_emit rows per query)
    """
    K = min(limit if limit is not None else quota, nb)
    if Q is None:
        Q = min(round_up(int(quota) + 1024, 1024), round_up(nb, 256))
    if rerank_nb:
        K_stage = min(round_up(max(K, int(rerank_nb)), 16), Q)
        R = min(int(rerank_nb), K_stage)
        K_emit = min(round_up(K, 16), R)
    else:
        K_stage = min(round_up(K, 16), Q)
        R, K_emit = 0, K_stage
    return K, Q, K_stage, R, K_emit


def _row_norms_sq(f, chunk=1 << 20):
    """Per-row ||f||^2 of the rerank store, in row chunks so no
    store-sized ``f * f`` is ever materialized (11 GB at 10.5M x 256)."""
    out = torch.empty(f.shape[0], dtype=torch.float32, device=f.device)
    for lo in range(0, f.shape[0], chunk):
        part = f[lo:lo + chunk].to(torch.float32)
        out[lo:lo + chunk] = (part * part).sum(dim=1)
    return out


class LOPQSearcherBase:
    """The reference searcher's host query path (searcher.py:176-258):
    walk cells in multisequence order until the quota is covered, rank
    the candidates by ADC with per-cluster LUT memoization. Subclasses
    provide ``add_codes`` and ``get_cell``."""

    def __init__(self):
        self.nb_indexed = 0
        self.verbose = 0

    def get_nb_indexed(self):
        return self.nb_indexed

    def add_data(self, data, ids=None, num_procs=1):
        """Encode raw vectors (one ``predict_batch``) and index them;
        ``num_procs`` is the reference's and is ignored."""
        del num_procs
        coarse, fine = self.model.predict_batch(data)
        self.add_codes((coarse, fine), ids)

    def add_codes_from_dict(self, codes_dict):
        """Index ``{id: (coarse, fine)}``: the ids are the keys in order,
        the codes their values (searcher.py:195-198)."""
        ids = list(codes_dict.keys())
        self.add_codes([codes_dict[k] for k in ids], ids)

    def _coarse_host(self):
        """The coarse codebooks as float32 numpy, read once."""
        cs = getattr(self, "_cs_host", None)
        if cs is None:
            cs = self._cs_host = [c.cpu().numpy() for c in self.model.Cs]
        return cs

    def get_result_quota(self, x, quota=10):
        """Probe cells in distance order until ``quota`` candidates are
        covered (searcher.py:200-210): (candidates, cells visited)."""
        retrieved = []
        visited = 0
        for _, cell in multisequence(x, self._coarse_host()):
            retrieved += self.get_cell(cell)
            visited += 1
            if len(retrieved) >= quota:
                break
        return retrieved, visited

    def compute_distances(self, x, items):
        """ADC distances, one LUT per coarse cluster and split
        (searcher.py:212-233): a list of (distance, item)."""
        memo = [{}, {}]

        def luts(coarse):
            c0, c1 = int(coarse[0]), int(coarse[1])
            if c0 not in memo[0]:
                memo[0][c0] = self.model.get_subquantizer_distances(
                    x, coarse, coarse_split=0)
            if c1 not in memo[1]:
                memo[1][c1] = self.model.get_subquantizer_distances(
                    x, coarse, coarse_split=1)
            return memo[0][c0] + memo[1][c1]

        results = []
        for item in items:
            coarse, fine = item[1]
            tables = luts(coarse)
            dist = sum(tables[i][fc] for i, fc in enumerate(fine))
            results.append((dist, item))
        return results

    def search(self, x, quota=10, limit=None, with_dists=False):
        """Rank the probed candidates by ADC (searcher.py:235-252):
        (results, cells visited)."""
        if isinstance(self.model, LOPQModelPCA):
            x = self.model.apply_PCA(x).cpu().numpy()
        x = np.asarray(x, dtype=np.float32)
        retrieved, visited = self.get_result_quota(x, quota)
        results = sorted(self.compute_distances(x, retrieved),
                         key=lambda d: d[0])
        results = results[:quota if limit is None else limit]
        if with_dists:
            out = [ResultDist(item[0], item[1], d) for d, item in results]
        else:
            out = [Result(item[0], item[1]) for d, item in results]
        return out, visited

    def add_codes(self, codes, ids=None):
        raise NotImplementedError()

    def get_cell(self, cell):
        raise NotImplementedError()


class LOPQSearcher(LOPQSearcherBase):
    """In-RAM dict index; an id already in a cell is not added again
    (searcher.py:261-287, reference lopq/lopq/search.py:310-382)."""

    def __init__(self, model):
        super().__init__()
        self.model = model
        self.index = defaultdict(list)
        self._cell_ids = defaultdict(set)

    def add_codes(self, codes, ids=None):
        if ids is None:
            ids = count()
        if (isinstance(codes, tuple) and len(codes) == 2
                and hasattr(codes[0], "ndim")):
            coarse, fine = codes
            codes = [LOPQCode(tuple(c), tuple(f))
                     for c, f in zip(coarse, fine)]
        for item_id, code in zip(ids, codes):
            cell = tuple(int(c) for c in code[0])
            if item_id in self._cell_ids[cell]:
                continue
            self.index[cell].append((item_id, code))
            self._cell_ids[cell].add(item_id)
            self.nb_indexed += 1

    def get_cell(self, cell):
        return self.index[tuple(int(c) for c in cell)]


class _WaveDriver(Settled):
    """The wave below a device searcher's entry points, shared by
    :class:`LOPQSearcherTorch` and the sharded index
    (``parallel/sharded.py``): the plan choice, the brute pass or the probe
    ladder with its tier hint and yield EMA, the per-launch wave cap with
    its out-of-memory backoff, the result rows and the prewarm.

    A subclass supplies its snapshot (``_snapshot``: (snapshot dict with
    ``feats``, ids, cells, fine, rows)), the launches of one rung and of
    the brute pass (``_launch_rung``, ``_launch_brute``: a packed device
    tensor, see ``query.pack_query_out``), the projection of raw queries
    (``_project``), one query's result rows (``_rows_to_results``), and
    where it differs from one card the rows one brute scan reads
    (``_scan_rows``), the candidate budget (``_budget``) and the rows a
    query scores exactly (``_exact_rows``). It calls ``_init_waves`` with
    its devices."""

    #: every REPROBE_EVERY-th wave restarts the ladder from its floor so
    #: the tier hint can shift back down
    REPROBE_EVERY = 32

    def _init_waves(self, devices):
        #: distinct devices in order; the wave cap reads the tightest
        self._wave_devices = list(dict.fromkeys(devices))
        self._tier_hint = 0
        self._wave_i = 0
        self._brute_i = 0
        self._force_reprobe = False
        self._yield_ema = None
        #: wave-cap divisor, doubled each time a launch runs out of memory
        self._wave_oom_shrink = 1
        self.probe_stats = {"waves": 0, "escalated_queries": 0}

    def _probe_ladder(self):
        return probe_ladder(self.model.V, self.probe_width)

    def _scan_rows(self, nb):
        """Rows one brute scan reads."""
        return nb

    def _budget(self, d, quota, nb):
        """Q, one query's candidate budget."""
        return _query_geometry(quota, None, nb, 0)[1]

    def _exact_rows(self, K_stage, R):
        """Rows of a query the rerank scores exactly (0 = no rerank)."""
        return R

    def _use_brute(self, d, nq, quota, nb, R):
        """Plan choice for a rerank wave: one exact brute pass over the
        resident feature store vs the grid probe ladder (see
        probe.prefer_brute), both sides costed on the rows one scan reads.
        Only in rerank mode, and never with a pinned probe_width."""
        feats = d.get("feats")
        if not R or feats is None or self.probe_width:
            return False
        ladder = self._probe_ladder()
        V = self.model.V
        cost = (self._scan_rows(nb), V, self._budget(d, quota, nb))
        store = dict(D=feats.shape[1], itemsize=feats.element_size(),
                     K_pre=R)
        with self._mutlock:
            floor = rung_floor(ladder, quota, nb, V, self._yield_ema)
            # Cost the rung the wave will actually start at.
            start = max(floor, self._tier_hint)
            if start > floor and prefer_brute(ladder[start:], nq, *cost,
                                              **store):
                # Hint-driven brute waves bypass the ladder; every
                # REPROBE_EVERY-th one runs the ladder from the floor so
                # the hint can decay.
                self._brute_i += 1
                if self._brute_i % self.REPROBE_EVERY == 0:
                    self._force_reprobe = True
                    return False
                return True
        return prefer_brute(ladder[start:], nq, *cost, **store)

    def _run_brute(self, X, d, nb, R, K_emit, count_stats=True):
        """One exact brute wave over index-space queries ``X``: the
        launch, one device-to-host copy, the stats and the unpack.
        ``count_stats=False`` (prewarm) keeps warm-up launches out of the
        probe stats."""
        with span("cis.dispatch"):
            packed = self._launch_brute(X, d, nb, R, K_emit)
            with span("cis.fetch"):
                packed = packed.cpu().numpy()
            if count_stats:
                with self._mutlock:
                    self.probe_stats["waves"] += 1
                    self.probe_stats["brute_waves"] = (
                        self.probe_stats.get("brute_waves", 0) + 1)
            return unpack_query_out(packed, K_emit)

    def _bytes_per_query(self, Q, rung, R):
        """Device transients of one query of a wave at ``rung``, counted
        from the tensors :func:`lopq_query` (and the rerank) allocate:

        - coarse distances and, off the LUT route, the rotated residuals
          of every cluster: ~3 x [V, Dh] float32;
        - the probed region: grid, sort keys and permutation, cell ids,
          counts, starts and prefix sums: ~14 int64-sized values per cell
          (the sort-free wide square path holds fewer at its peak: the
          grid, counts, the global prefix table, the sort's values,
          permutation and workspace, and the sorted counts' cumsum,
          ~60 B a cell);
        - per candidate slot: slot metadata (~12 int64) plus the candidate
          codes and the gather indices and values (~20 B per code);
        - the LUT route's tables [2, B, F, S] float32, or the direct
          route's gathered rotated residuals and differences (~3 x Dh
          float32 per slot);
        - the rerank's gathered features in the store's dtype, their
          float32 upcast (a bfloat16 store only) and the differences.

        ``chip_smoke.py`` holds this against the measured peak allocation
        of a 100-query wave and fails if the model is below it. At 10.5M
        rows, V=4096, M=8, D=256, quota 10k on an NVIDIA H100 80GB HBM3
        at 700 W the model is 2.40x the measured peak at rung 64, 1.59x
        at (128, 8) and 1.69x at (128, 8) with rerank_nb=1000. On the wide
        square rung B=256 (G = 65,536) it is 2.17x at that size (V=4096,
        wave of 100) and 2.97x on the face index (8,388,608 rows, V=256,
        M=8, D=128, wave of 32), on the same card.
        """
        m = self.model
        V, M, Dh = m.V, m.M, int(m.Cs.shape[2])
        F, S = m.num_fine_splits, m.subquantizer_clusters
        B, SB = rung_parts(rung)
        B = min(B, V)
        G = rung_cells(rung, V)
        per_q = 3 * V * Dh * 4 + G * 112 + Q * (96 + 20 * M)
        if uses_lut(B, SB, V, Q):
            per_q += 2 * B * F * S * 4
        else:
            per_q += Q * Dh * 12
        if R and self._buf_feats is not None:
            esz = self._buf_feats.element_size()
            per_q += R * int(self._buf_feats.shape[1]) * (
                8 + (esz if esz < 4 else 0))
        return per_q

    def _wave_cap(self, Q, R):
        """Per-launch query cap as a function of the rung: half of the
        free memory of the tightest device over the per-query transients
        (the half is headroom for the caching allocator's fragmentation,
        which the measured peaks do not include)."""
        free = min(free_bytes(dev) for dev in self._wave_devices)
        return lambda rung: max(
            1, int(free / 2 / self._bytes_per_query(Q, rung, R)))

    def _chunk_waves(self, run_tier, nq_cap):
        """Wrap ``run_tier`` so waves split into <= nq_cap(rung) query
        launches. A launch that runs out of device memory halves this
        searcher's cap and retries, down to single-query launches."""

        def wrapped(idx, rung):
            with self._mutlock:
                shrink = self._wave_oom_shrink
            cap = max(1, nq_cap(rung) // shrink)
            if len(idx) <= cap:
                try:
                    return run_tier(idx, rung)
                except torch.cuda.OutOfMemoryError:
                    if cap <= 1:
                        raise
                    with self._mutlock:
                        self._wave_oom_shrink = max(self._wave_oom_shrink,
                                                    2 * shrink)
                    return wrapped(idx, rung)
            parts = [wrapped(idx[i:i + cap], rung)
                     for i in range(0, len(idx), cap)]
            return tuple(np.concatenate([p[j] for p in parts])
                         for j in range(5))
        return wrapped

    def _tier(self, X, d, quota, Q, K_stage, R, K_emit):
        """``run_tier`` of a wave of index-space queries ``X``: one rung
        over the rows ``idx`` (the launch, one device-to-host copy, the
        unpack), in launches of at most the wave cap."""
        V = self.model.V

        def run_tier(idx, rung):
            with span("cis.dispatch"):
                B, SB = rung_parts(rung)
                Xi = X if len(idx) == X.shape[0] else X[torch.from_numpy(
                    np.asarray(idx)).to(X.device)]
                packed = self._launch_rung(Xi, d, quota, V, B, Q, K_stage, R,
                                           K_emit, SB)
                with span("cis.fetch"):
                    packed = packed.cpu().numpy()  # one copy
                return unpack_query_out(packed, K_emit)
        return self._chunk_waves(
            run_tier, self._wave_cap(Q, self._exact_rows(K_stage, R)))

    def _escalate(self, run_tier, n, quota, nb, K_pad):
        """Ladder escalation with a quota-aware rung floor plus tier-hint
        hysteresis (the policy of the JAX searcher's ``_escalate``)."""
        with span("cis.ladder"):
            ladder = self._probe_ladder()
            with self._mutlock:
                floor = rung_floor(ladder, quota, nb, self.model.V,
                                   self._yield_ema)
                start = min(max(self._tier_hint, floor), len(ladder) - 1)
                self._wave_i += 1
                if start > floor and (
                        self._wave_i % self.REPROBE_EVERY == 0
                        or self._force_reprobe):
                    start = floor
                self._force_reprobe = False
            (rows, dists, ncells, frac_short, settle, yield_obs,
             settled) = escalate_probe(
                run_tier, ladder[start:], n, quota, nb, K_pad)
            with self._mutlock:
                # Jump the hint to the rung where >= 90% of this wave
                # settled; an unsettled wave moves it only when most
                # queries escalated.
                new_hint = min(start + settle, len(ladder) - 1)
                if not settled and frac_short < 0.5:
                    new_hint = self._tier_hint
                if start == floor:
                    self._tier_hint = new_hint   # full ladder view: may decay
                elif settle > 0:
                    # Escalated past its start: evidence for a wider hint.
                    self._tier_hint = max(self._tier_hint, new_hint)
                if yield_obs is not None:
                    self._yield_ema = (yield_obs if self._yield_ema is None
                                       else 0.7 * self._yield_ema
                                       + 0.3 * yield_obs)
                self.probe_stats["waves"] += 1
                self.probe_stats["escalated_queries"] += int(
                    round(frac_short * n))
                self.probe_stats.setdefault("wave_log", []).append(
                    [start, round(float(frac_short), 3), start + settle,
                     floor, None if self._yield_ema is None
                     else round(float(self._yield_ema), 2)])
                del self.probe_stats["wave_log"][:-64]
        return rows, dists, ncells

    def _wave_results(self, waves, K, K_emit, with_dists, ids_arr,
                      cells_arr, fine_arr, with_codes):
        """Per-query (results, visited) pairs of an answered wave."""
        rows_b, dists_b, ncells_b = waves
        K_out = min(K, K_emit)
        with span("cis.results"):
            return [
                (self._rows_to_results(rows, dists, with_dists, ids_arr,
                                       cells_arr, fine_arr,
                                       with_codes=with_codes), visited)
                for rows, dists, visited in zip(
                    rows_b[:, :K_out], dists_b[:, :K_out], ncells_b.tolist())
            ]

    def _search_wave(self, X, quota, limit, rerank_nb, with_dists,
                     with_codes):
        """Answer a wave of index-space queries ``X`` on one snapshot: the
        brute pass or the probe ladder, then the result rows."""
        d, ids_arr, cells_arr, fine_arr, nb = self._snapshot()
        nq = X.shape[0]
        if nb == 0:
            return [([], 0)] * nq
        if rerank_nb and d.get("feats") is None:
            raise ValueError(
                "rerank_nb requires a resident feature store "
                "(features with every add)")
        K, Q, K_stage, R, K_emit = _query_geometry(
            quota, limit, nb, rerank_nb, Q=self._budget(d, quota, nb))
        if self._use_brute(d, nq, quota, nb, R):
            rows_b, dists_b, _, ncells_b, _ = self._run_brute(
                X, d, nb, R, K_emit)
            waves = (rows_b, dists_b, ncells_b)
        else:
            waves = self._escalate(
                self._tier(X, d, quota, Q, K_stage, R, K_emit),
                nq, quota, nb, K_emit)
        return self._wave_results(waves, K, K_emit, with_dists, ids_arr,
                                  cells_arr, fine_arr, with_codes)

    @torch.inference_mode()
    def prewarm_ladder(self, quota=10, limit=None, rerank_nb=None,
                       waves=(1,)):
        """Run every ladder rung once (plus the brute plan when the store
        is resident) on zero raw queries, projected as a wave is, at each
        wave bucket of ``waves`` (searcher.py:1274-1350). Nothing compiles
        per shape here, but the first launch of each shape loads the LUT
        kernel, grows the caching allocator and picks library algorithms;
        this pays that before traffic. Results are discarded; the yield
        EMA, the tier hint and the probe stats are left alone.

        :returns: number of rung and brute launches driven"""
        d, _ids, _cells, _fine, nb = self._snapshot()
        if nb == 0:
            return 0
        if rerank_nb and d.get("feats") is None:
            rerank_nb = None
        _K, Q, K_stage, R, K_emit = _query_geometry(
            quota, limit, nb, rerank_nb, Q=self._budget(d, quota, nb))
        m = self.model
        raw_dim = (m.pca_P.shape[0] if isinstance(m, LOPQModelPCA)
                   else 2 * int(m.Cs.shape[2]))
        n_progs = 0
        for w in sorted({wave_bucket(max(1, int(b))) for b in waves}):
            X = self._project(torch.zeros((w, raw_dim), dtype=torch.float32,
                                          device=self._wave_devices[0]))
            # Through the wave cap and the OOM backoff, as under traffic.
            run_tier = self._tier(X, d, quota, Q, K_stage, R, K_emit)
            for rung in self._probe_ladder():
                run_tier(np.arange(w), rung)
                n_progs += 1
            if R:
                self._run_brute(X, d, nb, R, K_emit, count_stats=False)
                n_progs += 1
        return n_progs


class LOPQSearcherTorch(_WaveDriver, LOPQSearcherBase):
    """Device-resident CSR multi-index with batched probed queries.

    The process's first searcher freezes the import heap out of the
    garbage collector's full collections before it is allocated
    (``common/heap.py``); ``heap_stats`` keeps what that did."""

    #: appended chunks are sentinel-padded to this multiple
    CHUNK_QUANTUM = STORE_CHUNK
    #: at/above this V the dense [V^2+1] offsets table (268 MB at V=8192,
    #: 1 GB at V=16384) gives way to searchsorted lookups over the sorted
    #: cell ids (wide-V mode, searcher.py:518-523)
    WIDE_V_THRESHOLD = 8192
    #: device memory (bytes) the rerank store must leave free for the code
    #: buffers, the CSR view, an append chunk and wave transients
    #: (searcher.py:315)
    RERANK_HEADROOM_BYTES = 2.25e9

    @classmethod
    def rerank_f32_budget(cls, device):
        """Bytes a float32 rerank store may take on ``device`` before
        "auto" picks bfloat16: the card's memory size
        (``torch.cuda.mem_get_info``; on the CPU the fixed
        ``device.CPU_DEVICE_BYTES``) less the headroom."""
        return device_bytes(device) - cls.RERANK_HEADROOM_BYTES

    @classmethod
    def _plan_rerank_dtype(cls, rerank_dtype, cap, Dr, *, device):
        """The rerank store's dtype from the CAPACITY plan, budgeted at one
        store copy (searcher.py:325-338): it changes only when ``cap``
        does, and capacity growth is a rebuild anyway."""
        if rerank_dtype == "bfloat16":
            return torch.bfloat16
        if (rerank_dtype == "auto"
                and 4 * cap * Dr > cls.rerank_f32_budget(device)):
            return torch.bfloat16
        return torch.float32

    def __init__(self, model, probe_width=None, codestore_path=None,
                 rerank_dtype="auto", capacity_hint=0):
        """The JAX searcher's arguments in its order (searcher.py:340).
        ``codestore_path`` opens the durable native store
        (``native/codestore.py``): rows it holds are queued for the first
        refresh, and every ``add_codes`` appends to it. ``rerank_dtype``:
        "float32", "bfloat16" (half the store's memory, distances from
        bfloat16-rounded rows), or "auto" (see ``_plan_rerank_dtype``)."""
        super().__init__()
        self.rerank_dtype = rerank_dtype
        self.model = model
        self.device = model.device
        self.probe_width = probe_width
        #: expected index size (rows): sizing the buffers once up front
        #: makes every later refresh an in-place append
        self.capacity_hint = int(capacity_hint)
        self.nb_indexed = 0
        self._pending = []  # (cells int64 [n], fine uint8 [n, M], ids,
        #                      feats float32 tensor [n, D] or None)
        # Host mirror in CAPACITY-padded arrays written in place (O(new
        # rows) per append); rows past _n_host are uninitialized.
        self._host_cap = 0
        self._n_host = 0
        self._cells = None  # int64 [host_cap], insertion order
        self._fine = None   # uint8 [host_cap, M]
        self._ids = None    # int64 [host_cap] (identity ids) or object
        #: False once any add came without features: the store is dropped
        #: for good (device "exact" distances would be wrong for the gap)
        self._feats_ok = True
        self._dedup = IncrementalDedup()
        self._buf_cells = None  # device [cap] int32, sentinel-padded
        self._buf_fine = None   # device [cap, M] uint8
        self._buf_feats = None  # device [cap, D] rerank features
        self._cap = 0
        self._n_dev = 0
        self._dev = None        # model tables + codes/cell_start/order
        self._dirty = True
        # Mutations hold this lock; queries snapshot (_dev, ids, cells,
        # fine) atomically so a refresh can't mix old offsets with new
        # codes.
        self._mutlock = threading.RLock()
        self._init_waves([self.device])
        self._codestore = None
        if codestore_path is not None:
            # Durable native store (native/codestore.cpp): appends persist,
            # restarts reload the cell-sorted records in one pass
            # (searcher.py:405-416).
            from columbiaimagesearch_tpu_torch.native.codestore import (
                CodeStore,
            )

            self._codestore = CodeStore(codestore_path, m=model.M)
            if len(self._codestore):
                cells, fine, ids = self._codestore.read_all()
                ids_arr = np.empty(len(ids), dtype=object)
                ids_arr[:] = ids
                self._pending.append(
                    (cells.astype(np.int64), fine, ids_arr, None))

    def get_nb_indexed(self):
        self._pack()
        return self.nb_indexed

    # ------------------------------------------------------------- indexing

    def _plan_capacity(self, n):
        """Capacity (rows) for ``n`` occupied rows, shared by the host
        mirror and the device buffers."""
        return store_capacity(n, self.CHUNK_QUANTUM, self.capacity_hint)

    def _host_reserve(self, n_target, M, ids_obj=False):
        """Ensure the host mirror holds ``n_target`` rows. Growth allocates
        fresh arrays, so stale snapshot views keep their old buffers."""
        n = self._n_host
        if self._cells is None:
            self._host_cap = self._plan_capacity(n_target)
            self._cells = np.empty(self._host_cap, np.int64)
            self._fine = np.empty((self._host_cap, M), np.uint8)
            self._ids = np.empty(self._host_cap,
                                 dtype=object if ids_obj else np.int64)
            return
        if n_target > self._host_cap:
            cap = self._plan_capacity(n_target)
            for name in ("_cells", "_fine", "_ids"):
                a = getattr(self, name)
                grown = np.empty((cap,) + a.shape[1:], dtype=a.dtype)
                grown[:n] = a[:n]
                setattr(self, name, grown)
            self._host_cap = cap
        if ids_obj and self._ids.dtype != object:
            up = np.empty(self._host_cap, dtype=object)
            up[:n] = self._ids[:n]
            self._ids = up

    def add_codes(self, codes, ids=None, feats=None):
        """Index codes; optionally store the matching features (``feats``
        [n, D], array or tensor, same row order) on the device for exact
        reranking. Reranking stays available only while EVERY add
        supplies features."""
        coarse, fine, ids_arr = _codes_to_arrays(
            codes, ids, self.model.V, self.model.subquantizer_clusters)
        cells = (coarse[:, 0].astype(np.int64) * self.model.V
                 + coarse[:, 1].astype(np.int64))
        if feats is not None:
            feats = torch.as_tensor(feats, dtype=torch.float32).to(
                self.device)
            if len(feats) != len(cells):
                raise ValueError(
                    f"feats rows {len(feats)} != codes rows {len(cells)}")
        with self._mutlock:
            self._pending.append((cells, fine.astype(np.uint8), ids_arr,
                                  feats))
            if self._codestore is not None:
                self._codestore.append(cells.astype(np.uint32),
                                       fine.astype(np.uint8),
                                       [str(i) for i in ids_arr])
                self._codestore.sync()
            self._dirty = True

    def add_data(self, data, ids=None, num_procs=1, store_feats=False):
        """Encode raw vectors on the device and index them; with
        ``store_feats`` their index-space projection (PCA'd for a
        ``LOPQModelPCA``) is kept for device reranking. ``num_procs`` is
        the reference's and is ignored, as in JAX (searcher.py:495)."""
        del num_procs
        data = torch.as_tensor(data, dtype=torch.float32).to(self.device)
        coarse, fine = self.model.predict_batch(data)
        feats = None
        if store_feats:
            feats = (self.model.apply_PCA(data)
                     if isinstance(self.model, LOPQModelPCA) else data)
        self.add_codes((coarse, fine), ids, feats=feats)

    @property
    def has_rerank_feats(self):
        """True when the device feature store covers every indexed row."""
        with self._mutlock:
            self._pack_locked()
            return self._buf_feats is not None and self.nb_indexed > 0

    def _pack(self):
        with self._mutlock:
            self._pack_locked()

    def _take_pending(self):
        """Merge pending adds into the host mirror (after dedup); returns
        the new rows' features (device tensor) or None."""
        cells_new = np.concatenate([p[0] for p in self._pending])
        fine_new = np.concatenate([p[1] for p in self._pending])
        ids_new = np.concatenate([p[2] for p in self._pending])
        self._feats_ok = (self._feats_ok
                          and all(p[3] is not None for p in self._pending))
        feats_new = (torch.cat([p[3] for p in self._pending])
                     if self._feats_ok else None)
        self._pending = []
        keep = self._dedup.filter_new(cells_new, ids_new)
        if not keep.all():
            cells_new, fine_new, ids_new = (
                cells_new[keep], fine_new[keep], ids_new[keep])
            if feats_new is not None:
                feats_new = feats_new[torch.from_numpy(keep).to(
                    self.device)]
        if not self._feats_ok:
            self._buf_feats = None
        k = len(cells_new)
        if k:
            self._host_reserve(self._n_host + k, fine_new.shape[1],
                               ids_obj=ids_new.dtype == object)
            n0 = self._n_host
            self._cells[n0:n0 + k] = cells_new
            self._fine[n0:n0 + k] = fine_new
            self._ids[n0:n0 + k] = ids_new
            self._n_host = n0 + k
        return feats_new

    @torch.inference_mode(False)
    def _pack_locked(self):
        # Outside inference mode even when a search triggers the pack: the
        # buffers built here are appended to in place later.
        if not self._dirty:
            return
        V = self.model.V
        if V > 46340:
            # Cell ids c0*V + c1 live in int32 buffers (and V*V is the
            # empty-slot sentinel); past floor(sqrt(2^31-1)) they would
            # wrap (searcher.py:530-537).
            raise ValueError(
                f"V={V} too large: cell ids c0*V+c1 must fit int32 "
                "(V <= 46340)")
        feats_new = self._take_pending() if self._pending else None
        n = self._n_host
        self.nb_indexed = n
        if n == 0:
            self._dirty = False
            return
        dev = self.device
        if self._dev is None:
            m = self.model
            self._dev = {"Cs": m.Cs, "Rs": m.Rs, "mus": m.mus,
                         "subs": m.subs}
        M = self._fine.shape[1]
        sentinel = V * V
        n_old = self._n_dev
        need_cap = self._plan_capacity(n)
        if self._buf_cells is None or need_cap > self._cap:
            # (Re)build: fresh capacity buffers prefilled with every row.
            self._cap = need_cap
            self._buf_cells = torch.full((self._cap,), sentinel,
                                         dtype=torch.int32, device=dev)
            self._buf_cells[:n] = torch.from_numpy(
                self._cells[:n].astype(np.int32)).to(dev)
            self._buf_fine = torch.zeros((self._cap, M), dtype=torch.uint8,
                                         device=dev)
            self._buf_fine[:n] = torch.from_numpy(self._fine[:n]).to(dev)
            k_pad, offset, rebuild = self.CHUNK_QUANTUM, n, True
        else:
            k = n - n_old
            if k == 0:  # everything deduped away; device view unchanged
                self._dirty = False
                return
            k_pad, offset, rebuild = round_up(k, self.CHUNK_QUANTUM), n_old, False
        chunk_c = torch.full((k_pad,), sentinel, dtype=torch.int32)
        chunk_f = torch.zeros((k_pad, M), dtype=torch.uint8)
        if not rebuild:
            chunk_c[:n - n_old] = torch.from_numpy(
                self._cells[n_old:n].astype(np.int32))
            chunk_f[:n - n_old] = torch.from_numpy(self._fine[n_old:n])
        cells_sorted, codes, cell_start, order = append_and_build_csr(
            self._buf_cells, self._buf_fine, chunk_c.to(dev),
            chunk_f.to(dev), offset, V, wide=V >= self.WIDE_V_THRESHOLD)
        if self._feats_ok:
            old = self._buf_feats
            Dr = (feats_new if feats_new is not None else old).shape[1]
            fdt = self._plan_rerank_dtype(self.rerank_dtype, self._cap, Dr,
                                          device=dev)
            if rebuild or old is None or old.dtype != fdt:
                fbuf = torch.zeros((self._cap, Dr), dtype=fdt, device=dev)
                if old is not None:
                    fbuf[:n_old] = old[:n_old]
                if feats_new is not None:
                    fbuf[n_old:n] = feats_new
                self._buf_feats = fbuf
            elif feats_new is not None:
                # In place: the JAX searcher donates the store here
                # (csr.py:159); rows >= n_old are invisible to snapshots.
                append_rows(self._buf_feats, feats_new, n_old)
        self._n_dev = n
        # Atomic swap: in-flight queries keep their consistent dict.
        d = dict(self._dev)
        d["cells_sorted"] = cells_sorted
        d["codes"] = codes
        d["cell_start"] = cell_start
        d["order"] = order
        if self._feats_ok:
            d["feats"] = self._buf_feats
            d["feats_sq"] = _row_norms_sq(self._buf_feats)
            if cell_start is not None:
                d["n_occ"] = int((cell_start[1:] > cell_start[:-1]).sum())
            else:
                # Distinct real cells of the sorted ids (searcher.py:
                # 721-729): the sentinel tail is not a cell.
                cs = cells_sorted
                real = cs < sentinel
                d["n_occ"] = int(((cs[1:] != cs[:-1]) & real[1:]).sum()
                                 + real[0])
        else:
            d["feats"] = d["feats_sq"] = d["n_occ"] = None
        self._dev = d
        self._dirty = False

    def _snapshot(self):
        """Pack if needed and return a consistent (dev, ids, cells, fine,
        nb_indexed) view for one query."""
        with self._mutlock:
            self._pack_locked()
            n = self._n_host
            if n == 0:
                return self._dev, None, None, None, 0
            return (self._dev, self._ids[:n], self._cells[:n],
                    self._fine[:n], n)

    def get_cell(self, cell):
        """Every (id, code) pair of one cell, in insertion order
        (searcher.py:752-768): a host scan, for API parity, not a query
        path."""
        _, ids_arr, cells_arr, fine_arr, nb = self._snapshot()
        if nb == 0:
            return []
        V, S = self.model.V, self.model.subquantizer_clusters
        cdt, fdt = code_dtype_for(V), code_dtype_for(S)
        c = int(cell[0]) * V + int(cell[1])
        out = []
        for r in np.nonzero(cells_arr == c)[0]:
            coarse = (cdt(cells_arr[r] // V), cdt(cells_arr[r] % V))
            fine = tuple(fdt(v) for v in fine_arr[r])
            out.append((_pyid(ids_arr[r]), LOPQCode(coarse, fine)))
        return out

    # --------------------------------------------------------------- search

    def _project(self, X):
        """Raw features -> index-space queries on the device (the serving
        path's guarded normalize and PCA, ``query.normalize_project``)."""
        m = self.model
        if isinstance(m, LOPQModelPCA):
            return normalize_project(X, m.pca_P, m.pca_mu, m.renorm)
        return normalize_project(X)

    def _launch_rung(self, X, d, quota, V, B, Q, K, R, K_out, SB):
        """One rung of the probed query (with the exact rerank when ``R``)
        over index-space queries ``X``: packed [nq, 2 * K_emit + 3]."""
        tables = (d["Cs"], d["Rs"], d["mus"], d["subs"], d["codes"],
                  d["cell_start"], d["order"])
        cs = d["cells_sorted"] if d["cell_start"] is None else None
        if R:
            out = lopq_query_rerank(X, d["feats"], *tables, quota, V=V, B=B,
                                    Q=Q, K=K, R=R, K_out=K_out, SB=SB,
                                    cells_sorted=cs)
        else:
            out = lopq_query_orig(X, *tables, quota, V=V, B=B, Q=Q, K=K,
                                  SB=SB, cells_sorted=cs)
        return pack_query_out(*out)

    def _launch_brute(self, X, d, nb, R, K_emit):
        """The exact brute pass over the resident store: packed
        [nq, 2 * K_emit + 3]."""
        return brute_query_batch(X, d["feats"], d["feats_sq"], nb,
                                 d["n_occ"], K_pre=R, K_out=K_emit)

    @torch.inference_mode()
    def search_batch(self, X, quota=10, limit=None, with_dists=False,
                     with_codes=True, rerank_nb=None):
        """Answer a wave of queries. Returns a list of (results, visited)
        pairs, one per query.

        ``rerank_nb`` (with a resident feature store) re-scores the top
        ``rerank_nb`` ADC candidates by exact L2 on the device (reference:
        searcher_lopqhbase.py:862-912); reranked results carry exact L2
        distances. ``with_codes=False`` skips building LOPQCode tuples.
        """
        with span("cis.search"):
            X = torch.as_tensor(X, dtype=torch.float32).to(self.device)
            if isinstance(self.model, LOPQModelPCA):
                X = self.model.apply_PCA(X)
            return self._search_wave(X, quota, limit, rerank_nb, with_dists,
                                     with_codes)

    @torch.inference_mode()
    def search_device_feats(self, feats_dev, quota=10, limit=None,
                            with_dists=True, rerank_nb=None, n_valid=None):
        """Serving fast path (searcher.py:1176-1272): RAW features straight
        from the featurizer forward (before normalization and PCA) ->
        results, one device-to-host copy per probe tier. The wave is
        normalized and projected once on the device; with ``rerank_nb``
        and a resident feature store the exact rerank runs on the device
        too. Results carry code=None. Returns [(results, visited)] per
        query, like :meth:`search_batch`.

        ``n_valid``: the wave may arrive padded (rows past ``n_valid`` are
        padding). Only the first ``n_valid`` rows run, so pad rows never
        enter the escalation bookkeeping (a zero row always falls short of
        the quota and would drag every wave onto the wider rungs)."""
        with span("cis.search"):
            X = torch.as_tensor(feats_dev).to(self.device)
            if X.ndim == 1:
                X = X[None, :]
            if n_valid is not None:
                X = X[:int(n_valid)]
            return self._search_wave(self._project(X), quota, limit,
                                     rerank_nb, with_dists, False)

    @torch.inference_mode()
    def search(self, x, quota=10, limit=None, with_dists=False,
               rerank_nb=None):
        """One query; same contract as the JAX searcher's ``search``:
        returns (results, visited). Runs as a one-query wave (raw queries
        of a ``LOPQModelPCA`` are projected there)."""
        x = torch.as_tensor(x, dtype=torch.float32)
        return self.search_batch(x[None, :], quota=quota, limit=limit,
                                 with_dists=with_dists,
                                 rerank_nb=rerank_nb)[0]

    def _rows_to_results(self, rows, dists, with_dists, ids_arr, cells_arr,
                         fine_arr, with_codes=True):
        rows, ids, dists = _valid_rows(rows, dists, ids_arr)
        codes = repeat(None)
        if with_codes:
            V_, S = self.model.V, self.model.subquantizer_clusters
            cdt, fdt = code_dtype_for(V_), code_dtype_for(S)
            codes = [LOPQCode((cdt(c // V_), cdt(c % V_)),
                              tuple(fdt(v) for v in f))
                     for c, f in zip(cells_arr[rows], fine_arr[rows])]
        # tuple.__new__ mapped over the rows builds each namedtuple in C;
        # calling ResultDist(...) runs its Python __new__ once a row.
        if with_dists:
            return list(map(tuple.__new__, repeat(ResultDist),
                            zip(ids, codes, dists)))
        return list(map(tuple.__new__, repeat(Result), zip(ids, codes)))
