"""``bulk_waves``: a closed loop of search waves into
``LOPQSearcherTorch.search_batch``, as a batch search of an image list or
a near-duplicate sweep sends them: each wave is sent when the last one
has been answered.

Parameters (``traffic/<mix>.json``): ``wave`` queries a wave, ``limit``
results a query, ``quota`` candidates a query, ``rerank_nb`` candidates
re-scored exactly, ``pool_waves`` distinct waves drawn from the seed and
sent in turn, ``warmup_waves`` sent in set-up, ``per_kept`` queries of
every wave whose answers are kept (which ones drawn from the seed and the
wave's ordinal), ``sample`` kept queries checked once the window has
closed, and ``trace_waves``: the waves a traced run sends under the
profiler once the window has closed.
"""

import gc
import time

import numpy as np
import torch

from portbench import check, data, roofline, trace
from portbench.reference import lopq_search
from portbench.util import log, sync


#: waves whose kept queries are drawn in set-up; later waves repeat them
PICK_WAVES = 1 << 14


class Kept:
    """The kept answers, in arrays that grow by doubling: no container
    that the garbage collector would traverse grows in the window."""

    def __init__(self, limit, cap=1 << 12):
        self.n = 0
        self.where = np.empty((cap, 2), np.int64)        # (wave, query)
        self.ids = np.empty((cap, limit), np.int64)
        self.dists = np.empty((cap, limit), np.float64)
        self.count = np.empty(cap, np.int64)

    def add(self, k, i, results):
        if self.n == len(self.count):
            for name in ("where", "ids", "dists", "count"):
                a = getattr(self, name)
                grown = np.empty((2 * len(a),) + a.shape[1:], a.dtype)
                grown[:len(a)] = a
                setattr(self, name, grown)
        m = min(len(results), self.ids.shape[1])
        self.where[self.n] = k, i
        self.ids[self.n, :m] = [r.id for r in results[:m]]
        self.dists[self.n, :m] = [r.dist for r in results[:m]]
        self.count[self.n] = m
        self.n += 1

    def rows(self, j):
        """The ``j``-th kept answer: (ids, dists)."""
        return self.ids[j, :self.count[j]], self.dists[j, :self.count[j]]


class Load:
    """One run of a ``bulk_waves`` cell (see the module docstring)."""

    def __init__(self, cfg, mix, seed, dev):
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, int(seed), dev
        self.kept = Kept(mix["limit"])

    # ------------------------------------------------------------ set-up

    def setup(self):
        """Make the inputs, index the corpus through the program and warm
        up the waves' shapes. Returns the stages' seconds."""
        from columbiaimagesearch_tpu_torch.index.encode import (
            blocks_needed,
            lopq_encode_blocked,
        )
        from columbiaimagesearch_tpu_torch.index.model import (
            LOPQModel,
            LOPQModelPCA,
        )
        from columbiaimagesearch_tpu_torch.index.searcher import (
            LOPQSearcherTorch,
        )

        cfg, mix, dev = self.cfg, self.mix, self.dev
        stages = {}
        clock = [time.perf_counter()]

        def lap(name):
            sync(dev)
            now = time.perf_counter()
            stages[name] = now - clock[0]
            clock[0] = now

        self.inputs = inp = data.Inputs(cfg, self.seed, dev)
        lap("model")
        rows = inp.rows()
        lap("rows")
        t = inp.tables
        V = cfg["V"]
        coarse, fine = lopq_encode_blocked(
            t["Cs"], t["Rs"], t["mus"], t["subs"], rows, V,
            blocks_needed(rows.shape[0], V))
        coarse, fine = coarse.cpu().numpy(), fine.to(torch.uint8).cpu().numpy()
        lap("encode")
        if inp.pca is None:
            model = LOPQModel(t["Cs"], t["Rs"], t["mus"], t["subs"],
                              device=dev)
        else:
            model = LOPQModelPCA(t["Cs"], t["Rs"], t["mus"], t["subs"],
                                 inp.pca["P"], inp.pca["mu"], device=dev)
        self.searcher = LOPQSearcherTorch(model, capacity_hint=cfg["rows"],
                                          rerank_dtype=cfg["rerank_dtype"])
        self.searcher.add_codes((coarse, fine), feats=rows)
        del rows, coarse, fine
        nb = self.searcher.get_nb_indexed()
        if nb != cfg["rows"]:
            raise RuntimeError(f"indexed {nb} rows of {cfg['rows']}")
        lap("index")
        self.pool = inp.queries(mix["pool_waves"] * mix["wave"]).cpu() \
            .numpy().reshape(mix["pool_waves"], mix["wave"], -1)
        lap("queries")
        for k in range(mix["warmup_waves"]):
            self._wave(k)
        self.probe0 = dict(self.searcher.probe_stats)
        lap("warmup")
        rng = np.random.default_rng(data.derive(self.seed, data.SAMPLE))
        self.picks = np.argpartition(
            rng.random((PICK_WAVES, mix["wave"])), mix["per_kept"] - 1,
            axis=1)[:, :mix["per_kept"]]
        lap("picks")
        # every window starts from an emptied collector: the same state in
        # every run, whatever set-up left behind
        gc.collect()
        lap("collect")
        return stages

    def _wave(self, k):
        m = self.mix
        return self.searcher.search_batch(
            self.pool[k % len(self.pool)], quota=m["quota"], limit=m["limit"],
            with_dists=True, with_codes=False, rerank_nb=m["rerank_nb"])

    # ------------------------------------------------------------ window

    def window(self, seconds, traced):
        """The measured window: waves back to back for ``seconds``, then,
        when ``traced``, ``trace_waves`` more under the profiler with the
        spans set up (so the profiler's cost stays out of the window)."""
        m, dev = self.mix, self.dev

        def send(k):
            res = self._wave(k)
            for i in self.picks[k % PICK_WAVES].tolist():
                self.kept.add(k, i, res[i][0])

        # seconds and count of collections by generation, kept without
        # growing a container that the collector would then traverse
        gc_s, gc_n, started = [0.0, 0.0, 0.0], [0, 0, 0], [0.0]

        def on_gc(phase, info):
            if phase == "start":
                started[0] = time.perf_counter()
            else:
                gc_s[info["generation"]] += time.perf_counter() - started[0]
                gc_n[info["generation"]] += 1

        k = 0
        ends = []
        gc.callbacks.append(on_gc)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            send(k)
            k += 1
            ends.append(time.perf_counter())
        gc.callbacks.remove(on_gc)
        elapsed = time.perf_counter() - t0
        sync(dev)
        ms = np.diff([t0] + ends) * 1e3
        half = len(ends) // 2
        log(f"window: {k} waves in {elapsed:.3f} s; wave ms p10 "
            f"{np.percentile(ms, 10):.3f} p50 {np.median(ms):.3f} p90 "
            f"{np.percentile(ms, 90):.3f} max {ms.max():.3f}; halves "
            f"{ms[:half].mean():.3f} / {ms[half:].mean():.3f} ms a wave; "
            f"garbage collections by generation {gc_n} in "
            f"{[round(x, 3) for x in gc_s]} s")
        s = self.searcher.probe_stats
        counters = {key: s.get(key, 0) - self.probe0.get(key, 0)
                    for key in ("waves", "escalated_queries", "brute_waves")}
        counters.update(queries=k * m["wave"], sent_waves=k)
        out = dict(e2e={"queries_per_s": k * m["wave"] / elapsed},
                   attempted=k * m["wave"], failed=0, counters=counters,
                   window_s=elapsed, trace=None, lut_work=[],
                   host=dict(wave_ms=ms, gc_s=gc_s, gc_n=gc_n))
        if traced:
            spans = self._spans()
            spans.recording = True
            with trace.profiler() as prof:
                for j in range(k, k + m["trace_waves"]):
                    with torch.profiler.record_function(trace.PREFIX + "wave"):
                        send(j)
            spans.remove()
            out["trace"] = trace.Reduction(trace.events_of(prof), "wave")
            cfg = self.cfg
            F, Dh = cfg["M"] // 2, cfg["dim"] // 2
            out["lut_work"] = [
                roofline.lut_work(isel, cfg["V"], Dh, F, cfg["subq"], Dh // F)
                for isel in spans.calls["lut_build"]]
        return out

    def _spans(self):
        """Spans around the program's layers, set up from outside: the plan
        choice, the probe ladder, the brute pass, the LUT kernel's wrapper,
        the PCA projection and the host's result rows."""
        from columbiaimagesearch_tpu_torch.index import query

        spans = trace.Spans()
        s = self.searcher
        spans.wrap(s, "_use_brute", "plan")
        spans.wrap(s, "_escalate", "ladder")
        spans.wrap(s, "_run_brute", "brute")
        spans.wrap(s, "_wave_results", "results")
        spans.wrap(query, "build_luts", "lut_build",
                   keep=lambda x2, isel, *a: isel)
        if hasattr(s.model, "apply_PCA"):
            spans.wrap(s.model, "apply_PCA", "pca")
        return spans

    # ------------------------------------------------------------- check

    def sample(self):
        """The checked queries, drawn from the seed among the kept ones:
        (query rows [n, dim] float32, [(ids, dists)] of the program)."""
        kept = self.kept
        rng = np.random.default_rng(data.derive(self.seed, data.SAMPLE) + 1)
        take = np.sort(rng.choice(kept.n, min(self.mix["sample"], kept.n),
                                  replace=False))
        log(f"check: {len(take)} of {kept.n} kept answers sampled")
        X = np.stack([self.pool[k % len(self.pool)][i]
                      for k, i in kept.where[take]])
        got = [kept.rows(j) for j in take]
        self.kept = Kept(self.mix["limit"])
        return X, got

    def free(self):
        """Drop the program's state and the device memory it held."""
        self.searcher = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, sample, control=False):
        """The check's numbers for the program's answers (and, with
        ``control``, for the reference's own at TF32 in their place)."""
        X, got = sample
        inp, m = self.inputs, self.mix
        rows = inp.rows()
        Xd = torch.as_tensor(X, device=self.dev)
        kw = dict(quota=m["quota"], limit=m["limit"],
                  rerank_nb=m["rerank_nb"])
        ref = lopq_search.search(inp.tables, inp.pca, rows, Xd, **kw)
        out = {"program": check.judge(got, ref, inp.pca, rows, Xd)}
        if control:
            ctl = lopq_search.search(inp.tables, inp.pca, rows, Xd,
                                     precision="tf32", **kw)
            out["control"] = check.judge(
                [(i.cpu().numpy(), d.cpu().numpy()) for i, d in ctl], ref,
                inp.pca, rows, Xd)
        return out
