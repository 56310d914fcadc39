"""Mesh-parallel LOPQ on several devices: data-parallel Lloyd and encoding,
and the row-sharded index and searcher (port of columbiaimagesearch_tpu/
parallel/sharded.py).

Two parallel axes, as in the JAX package:

- **dp** (data parallel): :func:`dp_lloyd_step` and :func:`dp_encode` give
  each device its share of the rows; partial sums are added on the first
  device in mesh order, so the result does not depend on which device
  finishes first.
- **shard** (index parallel): :class:`ShardedLOPQIndex` deals rows
  round-robin over the shards; a query runs the probed query
  (``index.query.lopq_query``, whose LUT rungs launch ``lut_build``) on
  every shard, and the per-shard top-k come back to the first device to be
  merged.

The JAX package runs one ``shard_map`` program; the port runs a single
controller: the calling thread launches each shard's work on that shard's
device (every launch is asynchronous, and nothing reads a result back
before the last shard is launched, so the cards work at once), then merges.
A Flask server is one process, so nothing here needs ``torch.distributed``.
A mesh may name one device more than once (logical shards, parallel/
mesh.py).

Differences from the JAX package:

- Each shard's rerank features live on its device only (no host mirror);
  capacity growth copies them device to device.
- Appends write the shard buffers in place (the JAX program donated
  them); a stale snapshot reads only rows below its own count, so no
  stale-snapshot retry is needed. Queries still snapshot under
  ``_swaplock``, which an upload holds for its whole mutation.
- Appended chunks are not padded to a quantum (nothing compiles per
  shape), and waves are not padded to buckets.
- Identity ids are an int64 arange, not boxed objects (the single-device
  searchers' rule; at 10M rows boxing and sorting objects takes seconds).
- The rerank store's dtype plan (``LOPQSearcherTorch._plan_rerank_dtype``)
  is applied per device to every shard it holds, so logical shards share
  their card's budget.
- The wave below the entry points (plan choice, brute pass or probe
  ladder, the per-launch wave cap with its out-of-memory backoff, the
  result rows, the prewarm) is the single-device searcher's
  (``index.searcher._WaveDriver``); the index supplies its snapshot, the
  fan-out and merge of a rung and of the brute pass, and the per-shard
  sizes of the plan's cost and of the wave cap.
"""

import threading

import numpy as np
import torch

from columbiaimagesearch_tpu_torch.common.heap import Settled
from columbiaimagesearch_tpu_torch.common.profiling import span
from columbiaimagesearch_tpu_torch.index.csr import (
    append_and_build_csr,
    append_rows,
)
from columbiaimagesearch_tpu_torch.index.encode import lopq_encode
from columbiaimagesearch_tpu_torch.index.model import LOPQModelPCA
from columbiaimagesearch_tpu_torch.index.query import (
    _ascending,
    brute_query_batch,
    lopq_query,
    pack_query_out,
)
from columbiaimagesearch_tpu_torch.index.searcher import (
    LOPQSearcherTorch,
    Result,
    ResultDist,
    _row_norms_sq,
    _valid_rows,
    _WaveDriver,
)
from columbiaimagesearch_tpu_torch.ops.kmeans import _assign_rows, _pick_chunk
from columbiaimagesearch_tpu_torch.parallel.mesh import SHARD_AXIS, make_mesh
from columbiaimagesearch_tpu_torch.utils.chunking import (
    round_up,
    store_capacity,
)
from columbiaimagesearch_tpu_torch.utils.codes import (
    IncrementalDedup,
    ids_to_object_array,
)


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _weighted_sums(X, w, C):
    """One device's Lloyd accumulators over its rows: (sums [k, D],
    weights per centroid [k], weighted distance sum)."""
    k, D = C.shape
    sums = torch.zeros((k, D), dtype=torch.float32, device=C.device)
    counts = torch.zeros(k, dtype=torch.float32, device=C.device)
    total = torch.zeros((), dtype=torch.float32, device=C.device)
    c2 = (C * C).sum(dim=1)
    chunk = _pick_chunk(X.shape[0], k)
    for lo in range(0, X.shape[0], chunk):
        xc, wc = X[lo:lo + chunk], w[lo:lo + chunk]
        a, md = _assign_rows(xc, C, c2)
        sums.index_add_(0, a, xc * wc[:, None])
        counts.index_add_(0, a, wc)
        total += (md * wc).sum()
    return sums, counts, total


def dp_lloyd_step(X, w, C, k: int):
    """One Lloyd iteration over row-sharded data (sharded.py:37-59).

    :param X: [n_i, D] float32 row shards, one per device (as
        :func:`parallel.mesh.shard_rows` returns them), or one tensor
    :param w: [n_i] row weights (1 valid, 0 padding), sharded like ``X``
    :param C: [k, D] centroids on the first device
    :returns: (new centroids [k, D] on ``C``'s device, inertia as a 0-d
        tensor); an empty cluster keeps its centroid
    """
    del k  # the centroid count is C's; kept for the JAX signature
    X, w = _as_list(X), _as_list(w)
    parts = [_weighted_sums(xs, ws.to(xs.device, torch.float32),
                            C.to(xs.device))
             for xs, ws in zip(X, w)]
    sums, counts, total = (
        sum(p[i].to(C.device) for p in parts) for i in range(3))
    C_new = torch.where(counts[:, None] > 0,
                        sums / counts.clamp_min(1.0)[:, None], C)
    return C_new, total


def dp_encode(mesh, Cs, Rs, mus, subs, X, chunk: int = 2048):
    """Encode rows of ``X`` data-parallel across ``mesh``
    (sharded.py:62-81): device ``i`` encodes the ``i``-th contiguous block
    with the tables copied to it (``index.encode.lopq_encode``).

    :param Cs/Rs/mus/subs: the stacked model tables (arrays or tensors)
    :param X: [N, D] array or tensor
    :returns: (coarse [N, 2], fine [N, M]) int32 numpy arrays
    """
    X = torch.as_tensor(X, dtype=torch.float32)
    n = X.shape[0]
    per = max(round_up(max(n, 1), len(mesh)) // len(mesh), 1)
    tables = {}
    outs = []
    for i, dev in enumerate(mesh):
        block = X[i * per:(i + 1) * per]
        if block.shape[0] == 0:
            continue
        if dev not in tables:
            tables[dev] = [torch.as_tensor(t, dtype=torch.float32).to(dev)
                           for t in (Cs, Rs, mus, subs)]
        outs.append(lopq_encode(*tables[dev], block.to(dev),
                                chunk=min(chunk, per)))
    coarse = torch.cat([c.cpu() for c, _ in outs]).numpy()
    fine = torch.cat([f.cpu() for _, f in outs]).numpy()
    return coarse, fine


class ShardedLOPQIndex(_WaveDriver):
    """Row-sharded CSR multi-index over a mesh, with incremental append
    (sharded.py:84-932).

    Row ``g`` (global insertion index) lives on shard ``g % n`` at slot
    ``g // n``, in capacity-padded per-shard buffers in insertion order.
    A refresh writes only the new rows into each shard and rebuilds that
    shard's cell-sorted CSR view (``index.csr.append_and_build_csr``); a
    query runs the probed query on every shard and merges the per-shard
    top-k on the first device in ``lax.top_k`` order (ascending, the
    lower merged index first on ties).

    Like ``LOPQSearcherTorch``, the process's first one freezes the import
    heap before it is allocated (``common/heap.py``, ``heap_stats``), and
    its waves run the single device's wave code and policy (``_WaveDriver``,
    sharded.py:726-925).
    """

    #: per-shard capacities are multiples of this
    CHUNK_QUANTUM = 1024

    def __init__(self, model, mesh=None, probe_width=None,
                 rerank_dtype="auto", capacity_hint=0):
        self.model = model
        self.mesh = mesh if mesh is not None else make_mesh(axis=SHARD_AXIS)
        if getattr(self.mesh, "axis_name", SHARD_AXIS) != SHARD_AXIS:
            raise ValueError(f"index mesh axis must be '{SHARD_AXIS}'")
        self.devices = [torch.device(d) for d in self.mesh]
        self.probe_width = probe_width
        #: expected index size (global rows): sizes the host mirror and
        #: the per-shard buffers once up front
        self.capacity_hint = int(capacity_hint)
        #: the rerank store's dtype policy ("auto", "float32",
        #: "bfloat16"), applied per device (_plan_feat_dtype)
        self.rerank_dtype = rerank_dtype
        self.nb_indexed = 0
        # Host mirror in CAPACITY-padded arrays, appended in place; rows
        # past _n_host are uninitialized.
        self._host_capn = 0
        self._n_host = 0
        self._ids = None          # [host_cap] int64 or object, insertion order
        self._cells_host = None   # [host_cap] int64
        self._fine_host = None    # [host_cap, M] uint8
        #: False once an append came without features: the store is gone
        #: until the next build
        self._feats_ok = True
        self._shards = None       # per shard: cells, fine, feats buffers
        self._cap_per = 0
        self._n_dev_rows = 0      # rows present in the device buffers
        self._tables = {}         # device -> (Cs, Rs, mus, subs)
        self._dev = None          # query snapshot (see _upload_locked)
        self._mutlock = threading.Lock()   # stats, hint, EMA, wave cap
        # Uploads hold this for their whole mutation and queries snapshot
        # under it, so a query never mixes two refreshes' views.
        self._swaplock = threading.RLock()
        self._init_waves(self.devices)

    @property
    def has_rerank_feats(self):
        return self._feats_ok and self.nb_indexed > 0

    @property
    def _buf_feats(self):
        """The first shard's feature buffer (its dtype and width size the
        per-query transients), or None."""
        return self._shards[0]["feats"] if self._shards else None

    # ------------------------------------------------------------- building

    def _tables_on(self, dev):
        """The model tables on ``dev``, copied once."""
        t = self._tables.get(dev)
        if t is None:
            m = self.model
            t = self._tables[dev] = tuple(
                x.to(dev) for x in (m.Cs, m.Rs, m.mus, m.subs))
        return t

    @staticmethod
    def _per_shard_count(n, n_dev):
        """Occupancy of each shard after n globally dealt rows."""
        base = np.full(n_dev, n // n_dev, dtype=np.int64)
        base[:n % n_dev] += 1
        return base

    def append(self, coarse, fine, ids=None, feats=None):
        """Add rows. ``feats`` [k, D] (array or tensor) keeps the matching
        index-space features resident, row-sharded like the codes, for the
        exact rerank; one featureless append drops the whole store."""
        V = self.model.V
        coarse = np.asarray(coarse)
        fine = np.asarray(fine).astype(np.uint8)
        k = len(coarse)
        if k == 0:
            return
        cells = (coarse[:, 0].astype(np.int64) * V
                 + coarse[:, 1].astype(np.int64))
        # Identity ids stay an int64 arange (no object boxing at 10M rows;
        # the single-device searcher's rule).
        ids_arr = (np.arange(self.nb_indexed, self.nb_indexed + k)
                   if ids is None else ids_to_object_array(ids, k))
        if feats is not None:
            feats = torch.as_tensor(feats, dtype=torch.float32)
            if len(feats) != k:
                raise ValueError(
                    f"feats rows {len(feats)} != codes rows {k}")
        if feats is None or not self._feats_ok:
            self._feats_ok = False
            feats = None
        n0 = self.nb_indexed
        self._host_reserve(n0 + k, fine.shape[1],
                           ids_obj=ids_arr.dtype == object)
        self._ids[n0:n0 + k] = ids_arr
        self._cells_host[n0:n0 + k] = cells
        self._fine_host[n0:n0 + k] = fine
        self._n_host = n0 + k
        self._upload(n0, feats)
        self.nb_indexed = self._n_host

    def _plan_capacity(self, n):
        """Global-row capacity for ``n`` occupied rows: the single-device
        plan (a size-scaled quantum plus ``capacity_hint``)."""
        return int(store_capacity(n, self.CHUNK_QUANTUM, self.capacity_hint))

    def _host_reserve(self, n_target, M, ids_obj=False):
        """Capacity-padded host mirror, appended in place; growth
        allocates fresh arrays. The ids are int64 until the first add of
        other ids (then object, once)."""
        n = self._n_host
        cap_needed = self._plan_capacity(n_target)
        if self._ids is None:
            self._host_capn = cap_needed
            self._ids = np.empty(cap_needed,
                                 dtype=object if ids_obj else np.int64)
            self._cells_host = np.empty(cap_needed, np.int64)
            self._fine_host = np.empty((cap_needed, M), np.uint8)
            self._n_host = 0
            return
        if n_target > self._host_capn:
            for name in ("_ids", "_cells_host", "_fine_host"):
                a = getattr(self, name)
                grown = np.empty((cap_needed,) + a.shape[1:], dtype=a.dtype)
                grown[:n] = a[:n]
                setattr(self, name, grown)
            self._host_capn = cap_needed
        if ids_obj and self._ids.dtype != object:
            up = np.empty(self._host_capn, dtype=object)
            up[:n] = self._ids[:n]
            self._ids = up

    def build(self, coarse, fine, ids=None, feats=None):
        """Bulk (re)build: resets state, then appends everything."""
        with self._swaplock:
            self.nb_indexed = 0
            self._ids = self._cells_host = self._fine_host = None
            self._host_capn = 0
            self._n_host = 0
            self._feats_ok = True
            self._shards = None
            self._cap_per = 0
            self._n_dev_rows = 0
            self._dev = None
        self.append(coarse, fine, ids, feats=feats)

    def _plan_feat_dtype(self, D):
        """The rerank store's dtype from the capacity plan: the
        single-device plan (``LOPQSearcherTorch._plan_rerank_dtype``)
        applied on each device to the [cap_per, D] slices of every shard it
        holds; bfloat16 if any device needs it."""
        dts = {LOPQSearcherTorch._plan_rerank_dtype(
            self.rerank_dtype, self._cap_per * self.devices.count(dev), D,
            device=dev) for dev in set(self.devices)}
        return torch.bfloat16 if torch.bfloat16 in dts else torch.float32

    @torch.inference_mode(False)
    def _upload(self, prev_n, feats_new):
        """Push rows [prev_n, n) into the shard buffers and rebuild each
        changed shard's CSR, under the swap lock. ``feats_new``: their
        features, or None. Outside inference mode: the buffers built here
        are appended to in place later."""
        with self._swaplock:
            self._upload_locked(prev_n, feats_new)

    def _upload_locked(self, prev_n, feats_new):
        V = self.model.V
        n = self._n_host
        n_dev = len(self.devices)
        M = self._fine_host.shape[1]
        sentinel = V * V
        need_per = round_up(-(-self._plan_capacity(n) // n_dev),
                            self.CHUNK_QUANTUM)
        rebuild = self._shards is None or need_per > self._cap_per
        old_shards = self._shards or [None] * n_dev
        old_snap = self._dev["shards"] if self._dev else [None] * n_dev
        if rebuild:
            self._cap_per = need_per
        base = self._per_shard_count(prev_n, n_dev)
        count = self._per_shard_count(n, n_dev)
        fdt = None
        if feats_new is not None:
            fdt = self._plan_feat_dtype(int(feats_new.shape[1]))
        shards, snap = [], []
        for s, dev in enumerate(self.devices):
            # Global rows of this shard among the new ones: g0, g0+n_dev..
            g0 = prev_n + (s - prev_n) % n_dev
            lo = 0 if rebuild else int(base[s])
            g_lo = s if rebuild else g0
            cells = torch.from_numpy(
                self._cells_host[g_lo:n:n_dev].astype(np.int32))
            fine = torch.from_numpy(self._fine_host[g_lo:n:n_dev])
            old = old_shards[s]
            if rebuild:
                buf_c = torch.full((self._cap_per,), sentinel,
                                   dtype=torch.int32, device=dev)
                buf_f = torch.zeros((self._cap_per, M), dtype=torch.uint8,
                                    device=dev)
            else:
                buf_c, buf_f = old["cells"], old["fine"]
            if rebuild or count[s] > base[s]:
                _sorted, codes, cell_start, order = append_and_build_csr(
                    buf_c, buf_f, cells.to(dev), fine.to(dev), lo, V)
            else:                     # no new rows here: the view stands
                prev = old_snap[s]
                codes, cell_start, order = (prev["codes"],
                                            prev["cell_start"],
                                            prev["order"])
            feats = None
            if feats_new is not None:
                feats = self._shard_feats(
                    old and old["feats"], feats_new[g0 - prev_n::n_dev],
                    int(base[s]), dev, fdt, rebuild)
            shards.append(dict(cells=buf_c, fine=buf_f, feats=feats))
            snap.append(dict(dev=dev, codes=codes, cell_start=cell_start,
                             order=order, feats=feats, count=int(count[s]),
                             feats_sq=None))
        self._shards = shards
        self._n_dev_rows = n
        n_occ = None
        if feats_new is not None:
            # Cells occupied on at least one shard: the brute plan's
            # ``visited`` (a cell counts once however many shards hold it).
            dev0 = self.devices[0]
            occ = None
            for sh in snap:
                cs = sh["cell_start"]
                o = (cs[1:] > cs[:-1]).to(dev0)
                occ = o if occ is None else occ | o
            n_occ = int(occ.sum())
        # Atomic swap: in-flight queries keep their consistent snapshot.
        # ``feats``: the first shard's store (the plan costs its rows).
        self._dev = dict(shards=snap, n_occ=n_occ, feats=snap[0]["feats"],
                         cap_per=self._cap_per)

    def _shard_feats(self, old, new, n_old, dev, fdt, rebuild):
        """One shard's feature buffer after appending ``new`` rows at slot
        ``n_old``: in place, or a fresh [cap_per, D] buffer holding the
        old rows (capacity growth, a dtype change, the first upload)."""
        if rebuild or old is None or old.dtype != fdt:
            buf = torch.zeros((self._cap_per, new.shape[1]), dtype=fdt,
                              device=dev)
            if old is not None and n_old:
                buf[:n_old] = old[:n_old].to(dev)
            buf[n_old:n_old + new.shape[0]] = new.to(dev)
            return buf
        return append_rows(old, new.to(dev), n_old)

    # -------------------------------------------------------------- queries

    def _run_shards(self, X, d, quota, V, B, Q, K, R, K_out, SB):
        """The fan-out and merge of one rung (sharded.py:501-557): every
        shard's probed query is launched before anything is read back.

        :returns: packed [nq, 2 * K_emit + 3] int32 on the first device
        """
        n_dev = len(self.devices)
        dev0 = self.devices[0]
        parts = []
        for s, sh in enumerate(d["shards"]):
            dev = sh["dev"]
            Xs = X.to(dev)
            rows, dists, total, ncells, ok = lopq_query(
                Xs, *self._tables_on(dev), sh["codes"], sh["cell_start"],
                quota, V=V, B=B, Q=Q, K=K, SB=SB)
            slots = sh["order"][rows.clamp(min=0)].long()
            rows_g = torch.where(rows >= 0, slots * n_dev + s, -1)
            exact = None
            if R:
                # Each shard scores its own candidates against its own
                # feature shard.
                cand = sh["feats"][slots].to(torch.float32)
                diff = cand - Xs[:, None, :]
                exact = torch.where(rows >= 0,
                                    torch.sqrt((diff * diff).sum(dim=-1)),
                                    float("inf"))
            parts.append((rows_g, dists, total, ncells, ok, exact))

        def gather(i):                     # [nq, n_dev * K], shard-major
            return torch.cat([p[i].to(dev0) for p in parts], dim=1)

        all_rows, all_dists = gather(0), gather(1)
        top, top_i = _ascending(all_dists, K)
        m_rows = all_rows.gather(1, top_i)
        m_dists = top
        if R:
            m_exact = gather(5).gather(1, top_i)[:, :R]
            r_top, r_i = _ascending(m_exact, min(K_out, R) if K_out else R)
            m_rows = torch.where(torch.isfinite(r_top),
                                 m_rows[:, :R].gather(1, r_i), -1)
            m_dists = r_top
        # total/ncells are summed over shards (the global candidate count
        # drives escalation); grid_ok holds only if it holds on every
        # shard.
        total = sum(p[2].to(dev0) for p in parts)
        ncells = sum(p[3].to(dev0) for p in parts)
        ok = torch.stack([p[4].to(dev0) for p in parts]).all(dim=0)
        return pack_query_out(m_rows, m_dists, total, ncells, ok)

    def _launch_brute(self, X, d, nb, R, K_emit):
        """The exact brute plan across shards (sharded.py:572-662): each
        shard's ``brute_query_batch`` over its own rows, then the merge.
        Per-shard top-K_out sets cover the global top-K_out, so the merge
        is exact.

        :returns: packed [nq, 2 * K_out + 3] int32 on the first device
        """
        n_dev = len(self.devices)
        dev0 = self.devices[0]
        parts = []
        for s, sh in enumerate(d["shards"]):
            packed = brute_query_batch(
                X.to(sh["dev"]), sh["feats"], self._feats_sq(sh),
                sh["count"], 0, K_pre=R, K_out=K_emit)
            ko = (packed.shape[1] - 3) // 2
            rows = packed[:, :ko].long()
            dists = packed[:, ko:2 * ko].contiguous().view(torch.float32)
            rows_g = torch.where(rows >= 0, rows * n_dev + s, -1)
            parts.append((rows_g, torch.where(rows >= 0, dists,
                                              float("inf"))))
        all_rows = torch.cat([p[0].to(dev0) for p in parts], dim=1)
        all_dists = torch.cat([p[1].to(dev0) for p in parts], dim=1)
        K_out = min(K_emit, all_rows.shape[1])
        top, top_i = _ascending(all_dists, K_out)
        m_rows = torch.where(torch.isfinite(top), all_rows.gather(1, top_i),
                             -1)
        nq = X.shape[0]
        return pack_query_out(
            m_rows, top, torch.full((nq,), int(nb), device=dev0),
            torch.full((nq,), int(d["n_occ"]), device=dev0),
            torch.ones(nq, dtype=torch.bool, device=dev0))

    def _feats_sq(self, sh):
        """A shard's row norms squared, computed once per snapshot."""
        if sh["feats_sq"] is None:
            sh["feats_sq"] = _row_norms_sq(sh["feats"])
        return sh["feats_sq"]

    def _snapshot(self):
        """A consistent (snapshot, ids, None, None, rows) view for one
        wave, taken under the swap lock."""
        with self._swaplock:
            return self._dev, self._ids, None, None, self._n_dev_rows

    def _launch_rung(self, X, d, quota, V, B, Q, K, R, K_out, SB):
        """One rung: the fan-out and merge of :meth:`_run_shards`."""
        return self._run_shards(X, d, quota, V, B, Q, K, R, K_out, SB)

    def _scan_rows(self, nb):
        """Each shard streams its own rows and walks its own CSR
        (sharded.py:664-694)."""
        return -(-nb // len(self.devices))

    def _budget(self, d, quota, nb):
        """A shard's candidate budget: each shard scans its own CSR, so the
        budget scales with the shard's capacity, not the global index
        size."""
        return min(round_up(int(quota * 1.5) + 256, 1024),
                   round_up(max(d["cap_per"], 256), 256))

    def _exact_rows(self, K_stage, R):
        """A shard scores every one of its ``K_stage`` candidates exactly
        before the merge keeps ``R``."""
        return K_stage if R else 0

    def _project(self, X):
        """Raw queries -> index-space queries on the first device."""
        if isinstance(self.model, LOPQModelPCA):
            return self.model.apply_PCA(X).to(self.devices[0])
        return X

    @torch.inference_mode()
    def search_batch(self, X, quota=10, limit=None, rerank_nb=None):
        """Answer a wave on every shard; a list of ([(id, dist)],
        cells visited) per query."""
        with span("cis.search"):
            X = torch.as_tensor(X, dtype=torch.float32).to(self.devices[0])
            if X.ndim == 1:
                X = X[None, :]
            return self._search_wave(self._project(X), quota, limit,
                                     rerank_nb, True, False)

    def _rows_to_results(self, rows, dists, with_dists, ids_arr, *codes,
                         with_codes=False):
        """One query's [(id, dist)] pairs, the valid rows only."""
        _rows, ids, dists = _valid_rows(rows, dists, ids_arr)
        return list(zip(ids, dists))

    def search(self, x, quota=10, limit=None, rerank_nb=None):
        """One query on every shard: ([(id, dist)], cells visited)."""
        x = torch.as_tensor(x, dtype=torch.float32)
        return self.search_batch(x[None], quota=quota, limit=limit,
                                 rerank_nb=rerank_nb)[0]


class ShardedLOPQSearcher(Settled):
    """``LOPQSearcher``-compatible facade over :class:`ShardedLOPQIndex`
    (sharded.py:934-1100): accumulates adds, deduplicates them (first
    insertion of an (id, cell) wins) and rebuilds the sharded index lazily;
    returns the single-device searchers' Result tuples with ``code=None``.
    It settles the heap before it is allocated, as the index does
    (``common/heap.py``, ``heap_stats``).
    """

    def __init__(self, model, mesh=None, probe_width=None,
                 rerank_dtype="auto", capacity_hint=0):
        self.model = model
        self.index = ShardedLOPQIndex(model, mesh=mesh,
                                      probe_width=probe_width,
                                      rerank_dtype=rerank_dtype,
                                      capacity_hint=capacity_hint)
        self._parts = []  # pending (coarse int32, fine int32, ids, feats)
        self._dirty = False
        self._dedup = IncrementalDedup()
        self._mutlock = threading.RLock()
        self.nb_indexed = 0

    @property
    def probe_stats(self):
        return self.index.probe_stats

    @property
    def _tier_hint(self):
        return self.index._tier_hint

    @property
    def rerank_dtype(self):
        return self.index.rerank_dtype

    @property
    def capacity_hint(self):
        return self.index.capacity_hint

    def add_codes(self, codes, ids=None, feats=None):
        """Codes ``(coarse [n, 2], fine [n, M])``; ``feats`` [n, D] (array
        or tensor) keeps index-space features resident for the device
        rerank (see :meth:`ShardedLOPQIndex.append`)."""
        coarse, fine = codes
        coarse = np.asarray(coarse, dtype=np.int32)
        fine = np.asarray(fine, dtype=np.int32)
        n = len(coarse)
        ids_arr = (np.arange(n) if ids is None
                   else ids_to_object_array(ids, n))
        if feats is not None:
            feats = torch.as_tensor(feats, dtype=torch.float32)
        with self._mutlock:
            self._parts.append((coarse, fine, ids_arr, feats))
            self._dirty = True

    def add_codes_from_dict(self, codes_dict):
        n = len(codes_dict)
        if n == 0:
            return
        ids = np.empty(n, dtype=object)
        ids[:] = list(codes_dict.keys())
        coarse = np.asarray([codes_dict[i][0] for i in ids], dtype=np.int32)
        fine = np.asarray([codes_dict[i][1] for i in ids], dtype=np.int32)
        with self._mutlock:
            self._parts.append((coarse, fine, ids, None))
            self._dirty = True

    def get_nb_indexed(self):
        self._maybe_build()
        return self.nb_indexed

    def _maybe_build(self):
        with self._mutlock:
            if not (self._dirty and self._parts):
                return
            parts, self._parts = self._parts, []
            coarse = np.concatenate([p[0] for p in parts])
            fine = np.concatenate([p[1] for p in parts])
            ids = np.concatenate([p[2] for p in parts])
            feats = None
            if all(p[3] is not None for p in parts):
                dev = parts[0][3].device
                feats = (parts[0][3] if len(parts) == 1 else
                         torch.cat([p[3].to(dev) for p in parts]))
            cells = (coarse[:, 0].astype(np.int64) * self.model.V
                     + coarse[:, 1].astype(np.int64))
            keep = self._dedup.filter_new(cells, ids)
            if not keep.all():
                coarse, fine, ids = coarse[keep], fine[keep], ids[keep]
                if feats is not None:
                    feats = feats[torch.from_numpy(keep).to(feats.device)]
            if len(ids):
                self.index.append(coarse, fine, ids, feats=feats)
            self.nb_indexed = self.index.nb_indexed
            self._dirty = False

    @property
    def has_rerank_feats(self):
        self._maybe_build()
        return self.index.has_rerank_feats

    def prewarm_ladder(self, quota=10, limit=None, rerank_nb=None,
                       waves=(1,)):
        """Run every ladder rung (plus the brute plan with a resident
        store) once at each wave bucket of ``waves`` on zero queries;
        results are discarded and the stats, hint and EMA left alone.
        Returns the number of rung and brute launches driven."""
        self._maybe_build()
        return self.index.prewarm_ladder(quota=quota, limit=limit,
                                         rerank_nb=rerank_nb, waves=waves)

    @staticmethod
    def _to_results(pairs, with_dists):
        if with_dists:
            return [ResultDist(rid, None, dist) for rid, dist in pairs]
        return [Result(rid, None) for rid, _dist in pairs]

    def search(self, x, quota=10, limit=None, with_dists=False,
               rerank_nb=None):
        self._maybe_build()
        if self.nb_indexed == 0:
            return [], 0
        pairs, visited = self.index.search(x, quota=quota, limit=limit,
                                           rerank_nb=rerank_nb)
        return self._to_results(pairs, with_dists), visited

    def search_batch(self, X, quota=10, limit=None, with_dists=False,
                     with_codes=False, rerank_nb=None):
        """A wave on every shard (the single-device ``search_batch``
        contract; results carry ``code=None``, so ``with_codes`` is
        accepted and ignored)."""
        del with_codes
        self._maybe_build()
        if self.nb_indexed == 0:
            return [([], 0)] * len(X)
        waves = self.index.search_batch(X, quota=quota, limit=limit,
                                        rerank_nb=rerank_nb)
        return [(self._to_results(pairs, with_dists), visited)
                for pairs, visited in waves]
