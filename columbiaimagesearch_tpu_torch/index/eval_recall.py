"""Recall@k evaluation on the card: probed vs exact vs brute force (port
of scripts/eval_recall.py:1-388).

The measurement the reference carries as a library but never wires in
(reference: lopq/lopq/eval.py:92-142, TODO at searcher_lopqhbase.py:
477-480): train a model on synthetic clustered data, index N vectors, and
report recall@{1,10,100} of (a) the probed searcher over a sweep of probe
widths and quotas, (b) the probed searcher with the exact top-1000 rerank
fused on the device, and (c) the exhaustive scan (``ExhaustiveADC``),
against brute-force ground truth.

Usage: python -m columbiaimagesearch_tpu_torch.index.eval_recall \\
           --n 1000000 --V 256 --queries 100 [--cpu] [--out FILE]

The arguments, the printed rows and the artifact (``config``, ``runs``
with ``recall@{1,10,100}`` and ``ms_per_query_e2e_host``) are the JAX
script's, so a port artifact compares like for like with
``benchmarks/r0*_recall_*.json``; ``config`` also names the ``device``.
Everything runs on the first card (no card: raises) unless ``--cpu``.

Data: the host path draws the JAX script's numpy rows exactly (the same
``RandomState`` seeds for the components, the training rows, the data and
the queries), so the data, the queries and the brute-force neighbours
(fp32, TF32 off) are JAX's. ``--stream-synth`` makes each 2M-row chunk on
the device from a ``torch.Generator`` seeded 1000 + c instead of holding
the rows; that stream differs from JAX's PRNG, and the artifact records
``stream_synth`` so runs are compared like for like.

Each probed sweep runs one uncounted warm-up wave (it settles the ladder's
tier hint at the sweep's rung, the steady state of a serving process) and
one timed ``search_batch`` wave. The stages are functions (:func:`run`
calls them in order), so a caller can run them on a model of its own.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from columbiaimagesearch_tpu_torch.device import default_device

#: mixture components of the synthetic data (scripts/eval_recall.py:77)
N_COMP = 512
#: rows per chunk of the data, the ground truth and the encode
CH = 1 << 21
#: results per query, and the k of recall@k
LIMIT = 100
KS = (1, 10, 100)
#: exact-rerank depth of the fused rerank method
RERANK_NB = 1000


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv=None):
    """The JAX script's arguments (scripts/eval_recall.py:25-67)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--train-n", type=int, default=100_000)
    ap.add_argument("--V", type=int, default=256)
    ap.add_argument("--M", type=int, default=8)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--quota", type=int, default=10_000)
    ap.add_argument("--probe-width", type=int, default=None,
                    help="clusters probed per split (B; default: the "
                         "adaptive ladder)")
    ap.add_argument("--query-noise", type=float, default=0.1,
                    help="queries are indexed points + this noise (the "
                         "near-duplicate retrieval scenario the system "
                         "serves); 0 disables and samples fresh points")
    ap.add_argument("--rerank-dtype", default="auto",
                    choices=("auto", "float32", "bfloat16"),
                    help="resident rerank-store dtype for the fused-rerank "
                         "row")
    ap.add_argument("--skip-exact", action="store_true")
    ap.add_argument("--skip-rerank", action="store_true")
    ap.add_argument("--stream-synth", action="store_true",
                    help="make data chunks on the device from seeds "
                         "instead of holding X in host memory; implies "
                         "--skip-exact/--skip-rerank (both need random "
                         "row access)")
    ap.add_argument("--probe-widths", default=None,
                    help="comma list to sweep, 0 = adaptive ladder "
                         "(e.g. '64,256,0'); default: one run at "
                         "--probe-width")
    ap.add_argument("--quotas", default=None,
                    help="comma list of quotas to sweep (each crossed "
                         "with --probe-widths); default: --quota only")
    ap.add_argument("--out", default=None,
                    help="write a JSON artifact here")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the first card; "
                         "raises without one)")
    return ap.parse_args(argv)


class SynthData:
    """The evaluation's rows (scripts/eval_recall.py:74-145): ``N_COMP``
    unit-norm components, rows = a component + 0.25 N(0, I). ``train``
    (seed 1), ``X`` (seed 2, None when streaming) and ``queries`` are
    host float32 arrays; :meth:`chunk` gives chunk ``c`` of the data as a
    tensor on ``device``."""

    def __init__(self, n, dim, train_n, n_queries, query_noise,
                 stream_synth, device):
        self.n, self.dim, self.device = n, dim, torch.device(device)
        rng = np.random.RandomState(0)
        comp = rng.randn(N_COMP, dim).astype(np.float32)
        comp /= np.linalg.norm(comp, axis=1, keepdims=True)
        self.comp = comp
        self._comp_dev = torch.from_numpy(comp).to(self.device)
        self.train = self.host_rows(train_n, 1)
        self.X = None if stream_synth else self.host_rows(n, 2)
        if query_noise > 0:
            r = np.random.RandomState(3)
            src = r.randint(0, n, n_queries)
            self.queries = (self.rows_of(src) + query_noise
                            * r.randn(n_queries, dim)).astype(np.float32)
        else:
            self.queries = self.host_rows(n_queries, 3)

    @property
    def n_chunks(self):
        return (self.n + CH - 1) // CH

    def host_rows(self, n, seed):
        """``n`` rows from ``RandomState(seed)``, as the JAX script's
        ``synth`` draws them: every component index first, then the noise
        in blocks of ``CH`` rows from the same generator, each written
        into one float32 array. Legacy ``randn`` carries its Gaussian
        state across calls, so the rows are bit-equal to the one-shot
        draw, and the host holds the float32 rows plus one block's float64
        noise and float32 temporaries, where the one-shot draw holds
        [n, dim] float64 arrays (a 55 GB peak at 10,485,760 x 256)."""
        r = np.random.RandomState(seed)
        comp_idx = r.randint(0, N_COMP, n)
        out = np.empty((n, self.dim), np.float32)
        for lo in range(0, n, CH):
            block = r.randn(min(CH, n - lo), self.dim)
            block *= 0.25
            np.add(self.comp[comp_idx[lo:lo + CH]], block,
                   out=out[lo:lo + CH], casting="same_kind")
        return out

    def chunk(self, c):
        """Rows ``[c * CH, min((c + 1) * CH, n))`` on the device; when
        streaming, made there from a generator seeded 1000 + c."""
        if self.X is not None:
            return torch.from_numpy(self.X[c * CH:(c + 1) * CH]).to(
                self.device)
        g = torch.Generator(device=self.device)
        g.manual_seed(1000 + c)
        idx = torch.randint(0, N_COMP, (CH,), generator=g,
                            device=self.device)
        noise = torch.randn(CH, self.dim, generator=g, device=self.device)
        rows = self._comp_dev[idx] + 0.25 * noise
        return rows[:min(CH, self.n - c * CH)]

    def rows_of(self, src):
        """The rows at indices ``src`` (host float32); streaming remakes
        each row's chunk on the device and copies only the rows asked."""
        src = np.asarray(src)
        if self.X is not None:
            return self.X[src]
        out = np.empty((len(src), self.dim), np.float32)
        for c in np.unique(src // CH):
            sel = np.nonzero(src // CH == c)[0]
            rows = self.chunk(int(c))
            out[sel] = rows[torch.from_numpy(src[sel] % CH).to(
                self.device)].cpu().numpy()
        return out


def ground_truth(data, t0=None):
    """Each query's nearest row by brute force in fp32 on the device, a
    chunk at a time: ``|x|^2 - 2 q.x``, the first minimum of a chunk, the
    earlier chunk on equal distances (scripts/eval_recall.py:147-203).
    Returns int64 row indices."""
    t0 = time.time() if t0 is None else t0
    qd = torch.from_numpy(data.queries).to(data.device)
    best_d = np.full(len(qd), np.inf, np.float32)
    best_i = np.zeros(len(qd), np.int64)
    for c in range(data.n_chunks):
        Xc = data.chunk(c)
        d = (Xc * Xc).sum(dim=1)[None, :] - 2.0 * (qd @ Xc.T)
        i = torch.argmin(d, dim=1)
        dmin = torch.gather(d, 1, i[:, None])[:, 0]
        dmin, i = dmin.cpu().numpy(), i.cpu().numpy()
        upd = dmin < best_d
        best_d = np.where(upd, dmin, best_d)
        best_i = np.where(upd, c * CH + i.astype(np.int64), best_i)
        if c % 8 == 7:
            log(f"[{time.time()-t0:.0f}s] gt "
                f"{min((c + 1) * CH, data.n)}/{data.n}")
    return best_i


def train_model(train, V, M, device):
    """``LOPQModel.fit`` as the JAX script trains (S=256, n_init=1,
    random_state=0), on ``device``."""
    from columbiaimagesearch_tpu_torch.index.model import LOPQModel

    return LOPQModel.fit(train, n_init=1, random_state=0, V=V, M=M,
                         subquantizer_clusters=256, device=device)


def encode(model, data, t0=None):
    """Codes of every row, a chunk at a time on the model's device:
    (coarse [n, 2], fine [n, M] uint8) numpy."""
    t0 = time.time() if t0 is None else t0
    co_parts, fi_parts = [], []
    for c in range(data.n_chunks):
        co, fi = model.predict_batch(data.chunk(c))
        co_parts.append(co)
        fi_parts.append(fi)
        if c % 8 == 7:
            log(f"[{time.time()-t0:.0f}s] encoded "
                f"{min((c + 1) * CH, data.n)}/{data.n}")
    return np.concatenate(co_parts), np.concatenate(fi_parts).astype(
        np.uint8)


def recall_row(method, answers, nns, seconds, **extra):
    """The artifact row of one method: recall@{1,10,100} of ``answers``
    (one id list a query) against ``nns``, and the host ms a query."""
    hits = {k: 0 for k in KS}
    for qi, ids in enumerate(answers):
        for k in KS:
            if nns[qi] in ids[:k]:
                hits[k] += 1
    row = {"method": method,
           **{f"recall@{k}": hits[k] / len(answers) for k in KS},
           "ms_per_query_e2e_host": round(seconds / len(answers) * 1e3, 2),
           **extra}
    print(json.dumps(row), flush=True)
    return row


def _timed_wave(s, queries, **kw):
    """One uncounted warm-up wave, then the timed one: (answers,
    seconds)."""
    s.search_batch(queries, limit=LIMIT, with_codes=False, **kw)
    t = time.perf_counter()
    outs = s.search_batch(queries, limit=LIMIT, with_codes=False, **kw)
    dt = time.perf_counter() - t
    return [[r.id for r in res] for res, _visited in outs], dt


def probed_sweep(model, coarse, fine, queries, nns, widths, quotas,
                 t0=None):
    """The probed searcher over every (quota, probe width) pair, 0 = the
    adaptive ladder (scripts/eval_recall.py:262-332). Returns the rows."""
    from columbiaimagesearch_tpu_torch.index.searcher import (
        LOPQSearcherTorch,
    )

    t0 = time.time() if t0 is None else t0
    s = LOPQSearcherTorch(model)
    s.add_codes((coarse, fine))      # default ids = row index
    rows = []
    for quota in quotas:
        for w in widths:
            s.probe_width = w or None
            label_w = "adaptive" if not w else str(w)
            log(f"[{time.time()-t0:.0f}s] probed search B={label_w} "
                f"quota={quota}")
            answers, dt = _timed_wave(s, queries, quota=quota)
            rows.append(recall_row(f"probed_quota{quota}", answers, nns, dt,
                                   batched=True, probe_width=label_w))
    return rows


def probed_rerank(model, coarse, fine, X, queries, nns, quota,
                  rerank_dtype):
    """The production configuration (scripts/eval_recall.py:334-376): the
    adaptive ladder with the rows resident on the device and the exact
    top-``RERANK_NB`` rerank fused into the query."""
    from columbiaimagesearch_tpu_torch.index.searcher import (
        LOPQSearcherTorch,
    )

    s = LOPQSearcherTorch(model, rerank_dtype=rerank_dtype)
    s.add_codes((coarse, fine), feats=X)
    answers, dt = _timed_wave(s, queries, quota=quota, rerank_nb=RERANK_NB)
    return recall_row(f"probed_quota{quota}_rerank{RERANK_NB}", answers,
                      nns, dt, batched=True, probe_width="adaptive",
                      rerank="fused_device", rerank_dtype=rerank_dtype)


def exhaustive_exact(model, coarse, fine, queries, nns):
    """Every code scored by ``ExhaustiveADC``, one query at a time as the
    JAX script does (scripts/eval_recall.py:378-386). Returns the row and
    each query's ids."""
    from columbiaimagesearch_tpu_torch.index.exhaustive_adc import (
        ExhaustiveADC,
    )

    ex = ExhaustiveADC(model)
    ex.build(coarse, fine)           # identity ids: row index
    t = time.perf_counter()
    answers = [ex.search(q, k=LIMIT)[0] for q in queries]
    dt = time.perf_counter() - t
    return recall_row("exhaustive_exact", answers, nns, dt), answers


def run(args):
    """Every stage of the evaluation. Returns (the artifact, the state:
    ``model``, ``data``, ``nns``, ``coarse``, ``fine`` and the exhaustive
    stage's ``exact_ids``)."""
    device = torch.device("cpu") if args.cpu else default_device()
    t0 = time.time()
    data = SynthData(args.n, args.dim, args.train_n, args.queries,
                     args.query_noise, args.stream_synth, device)
    log(f"[{time.time()-t0:.0f}s] training V={args.V} M={args.M} on "
        f"{device}")
    model = train_model(data.train, args.V, args.M, device)
    log(f"[{time.time()-t0:.0f}s] trained; brute-force ground truth")
    nns = ground_truth(data, t0)
    log(f"[{time.time()-t0:.0f}s] encoding {args.n}")
    coarse, fine = encode(model, data, t0)

    widths = ([int(w) for w in args.probe_widths.split(",")]
              if args.probe_widths else [args.probe_width or 0])
    quotas = ([int(q) for q in args.quotas.split(",")]
              if args.quotas else [args.quota])
    runs = probed_sweep(model, coarse, fine, data.queries, nns, widths,
                        quotas, t0)
    if not args.skip_rerank and not args.stream_synth:
        log(f"[{time.time()-t0:.0f}s] probed + fused device rerank")
        runs.append(probed_rerank(model, coarse, fine, data.X, data.queries,
                                  nns, args.quota, args.rerank_dtype))
    exact_ids = None
    if not args.skip_exact and not args.stream_synth:
        log(f"[{time.time()-t0:.0f}s] exhaustive exact search")
        row, exact_ids = exhaustive_exact(model, coarse, fine, data.queries,
                                          nns)
        runs.append(row)
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    artifact = {
        "config": {"n": args.n, "dim": args.dim, "V": args.V, "M": args.M,
                   "query_noise": args.query_noise,
                   "queries": args.queries, "quota": args.quota,
                   "stream_synth": bool(args.stream_synth),
                   "device": device_name},
        "runs": runs,
    }
    log(f"[{time.time()-t0:.0f}s] done")
    return artifact, dict(model=model, data=data, nns=nns, coarse=coarse,
                          fine=fine, exact_ids=exact_ids)


def main(argv=None):
    """Run the evaluation, write ``--out``; returns the artifact."""
    args = parse_args(argv)
    artifact, _state = run(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
        log(f"wrote {args.out}")
    return artifact


if __name__ == "__main__":
    main()
