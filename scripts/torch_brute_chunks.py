#!/usr/bin/env python3
"""The port's exact brute pass (``index/query.py`` ``brute_query_batch``)
on the card: where a chunk's time goes, and what the chunk width costs.

1. ``trace``: one 16-query chunk at two stores, the recall test's
   configuration (20,000 rows x 32, bfloat16, capacity 32,768) and the
   headline's (1,048,576 x 256, float32, capacity 2,097,152), with
   ``torch.profiler``: the top ops by host (self CPU) time with their
   counts and us a call, the device kernels launched, the chunk's host
   wall without the profiler, and every synchronizing call that
   ``torch.cuda.set_sync_debug_mode`` reports.
2. ``widths``: whole brute waves (nq 16, 50, 100) over stores of 20,000,
   262,144, 1,048,576 and 10,485,760 rows (float32 at D=256), 20,000 and
   262,144 rows (bfloat16 at D=256, float32 at D=128) and the recall
   configuration, at chunk widths 16, the whole wave and the widths that
   byte bounds of 256, 512 and 1,024 MiB give, timed with CUDA events
   (median of 9 rounds, the widths in turns), with each width's peak
   device memory above the store; each width's packed output held
   against width 16's: equal ids but for swaps of rows at float32
   near-ties (``chip_smoke.BRUTE_TIE_ATOL``), counted. The pass's own
   width (``query.brute_chunk``) is printed beside them.

Rows are unit vectors from a seeded ``torch.Generator`` on the card (the
brute pass's cost does not depend on a model); queries are stored rows
plus noise 0.1. Rerank depth (K_pre) 1,000 and 100 rows out, as the
headline's and the recall test's searchers call it.

    python3 scripts/torch_brute_chunks.py

Needs one CUDA card; imports nothing of JAX. Prints one line per point
and, last, one JSON object with every number.
"""

import collections
import json
import os
import sys
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from columbiaimagesearch_tpu_torch.index import query  # noqa: E402
from columbiaimagesearch_tpu_torch.index.searcher import (  # noqa: E402
    _row_norms_sq,
)
from columbiaimagesearch_tpu_torch.utils.chunking import (  # noqa: E402
    STORE_CHUNK,
    store_capacity,
)

K_PRE, K_OUT = 1000, 100
#: (label, rows, D, dtype)
TRACE_STORES = [("recall config", 20_000, 32, torch.bfloat16),
                ("headline 1M", 1_048_576, 256, torch.float32)]
WIDTH_STORES = [("recall config", 20_000, 32, torch.bfloat16),
                ("f32 D256", 20_000, 256, torch.float32),
                ("f32 D256", 262_144, 256, torch.float32),
                ("f32 D256", 1_048_576, 256, torch.float32),
                ("f32 D256", 10_485_760, 256, torch.float32),
                ("bf16 D256", 20_000, 256, torch.bfloat16),
                ("bf16 D256", 262_144, 256, torch.bfloat16),
                ("f32 D128", 20_000, 128, torch.float32),
                ("f32 D128", 262_144, 128, torch.float32)]
NQS = (16, 50, 100)
ROUNDS = 9
Res = collections.namedtuple("Res", ["id", "dist"])


def store(dev, nb, D, dtype, seed=0):
    """A searcher-shaped store: ``nb`` unit rows in a zero-padded buffer
    of the single-device capacity, its row norms squared, and a draw of
    queries near stored rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cap = store_capacity(nb, STORE_CHUNK)
    feats = torch.zeros(cap, D, dtype=dtype, device=dev)
    for lo in range(0, nb, 1 << 20):
        hi = min(nb, lo + (1 << 20))
        x = torch.randn(hi - lo, D, generator=g, device=dev)
        feats[lo:hi] = (x / x.norm(dim=1, keepdim=True)).to(dtype)
    fsq = _row_norms_sq(feats)
    pick = torch.randint(0, nb, (max(NQS),), generator=g, device=dev)
    X = (feats[pick].float()
         + 0.1 * torch.randn(max(NQS), D, generator=g, device=dev)
         / D ** 0.5)
    return feats, fsq, X


def brute(X, feats, fsq, nb, QCH):
    return query.brute_query_batch(X, feats, fsq, nb, 7, K_pre=K_PRE,
                                   K_out=K_OUT, QCH=QCH)


def trace_chunk(dev, label, nb, D, dtype, card):
    """torch.profiler of one 16-query chunk (after warm-up), its host
    wall without the profiler, and the synchronizing calls in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    feats, fsq, X = store(dev, nb, D, dtype)
    Xc = X[:16].contiguous()
    sync = torch.cuda.synchronize
    for _ in range(3):
        brute(Xc, feats, fsq, nb, 16)
    sync()
    wall = cs.host_ms(lambda: brute(Xc, feats, fsq, nb, 16), 21, sync)
    enq = []
    for _ in range(21):                 # the host's enqueue alone
        sync()
        t0 = time.perf_counter()
        brute(Xc, feats, fsq, nb, 16)
        enq.append((time.perf_counter() - t0) * 1e3)
    sync()
    dev_ms = cs.kernel_ms(lambda: brute(Xc, feats, fsq, nb, 16), 20)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            brute(Xc, feats, fsq, nb, 16)
            sync()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sorted({str(w.message).splitlines()[0][:120] for w in caught})
    stats0 = torch.cuda.memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        brute(Xc, feats, fsq, nb, 16)
        sync()
    stats1 = torch.cuda.memory_stats()
    allocs = {k: stats1.get(k, 0) - stats0.get(k, 0)
              for k in ("num_device_alloc", "num_device_free",
                        "num_alloc_retries")}
    avgs = prof.key_averages()
    dkey = ("self_device_time_total"
            if hasattr(avgs[0], "self_device_time_total")
            else "self_cuda_time_total")
    kernels = sum(1 for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
    top = sorted(avgs, key=lambda a: -a.self_cpu_time_total)[:14]
    rows = [dict(op=a.key[:60], count=a.count,
                 self_cpu_us=round(a.self_cpu_time_total, 1),
                 us_a_call=round(a.self_cpu_time_total / max(a.count, 1), 1),
                 self_device_us=round(getattr(a, dkey), 1)) for a in top]
    aten = sum(1 for e in prof.events() if e.name.startswith("aten::")
               and e.device_type == DeviceType.CPU and e.cpu_parent is None)
    out = dict(label=label, nb=nb, D=D, dtype=str(dtype).split(".")[-1],
               cap=feats.shape[0], host_wall_ms=float(np.median(wall)),
               enqueue_ms=float(np.median(enq)), device_ms=dev_ms,
               kernels=kernels, aten_calls=aten, syncs=syncs,
               allocator=allocs, top=rows)
    cs.log(f"trace: one 16-query brute chunk, {label} ({nb} rows x {D} "
           f"{out['dtype']}, capacity {out['cap']}): host wall "
           f"{out['host_wall_ms']:.3f} ms, enqueue {out['enqueue_ms']:.3f} "
           f"ms, device {dev_ms:.4f} ms a chunk back to back; {kernels} "
           f"device kernels, {aten} top-level aten calls; sync warnings {syncs}; "
           f"allocator {allocs} [{card}]")
    for r in rows:
        cs.log(f"trace:   {r['op']:60s} x{r['count']:<4d} self cpu "
               f"{r['self_cpu_us']:9.1f} us ({r['us_a_call']:7.1f} a "
               f"call), self device {r['self_device_us']:9.1f} us")
    del feats, fsq, X
    torch.cuda.empty_cache()
    return out


#: byte bounds a chunk width is shown for (``query.BRUTE_CHUNK_BYTES``'s
#: candidates)
BOUNDS_MIB = (256, 512, 1024)


def widths_for(nq, cap, D):
    """Chunk widths timed for a wave of ``nq``: 16, the whole wave, and
    the widths the byte bounds of BOUNDS_MIB give (the transients counted
    as ``query.brute_chunk`` counts them)."""
    per_query = 4 * (cap + min(K_PRE, cap) * D)
    ws = [16, nq] + [max(16, (b << 20) // per_query) for b in BOUNDS_MIB]
    return sorted(set(min(w, nq) for w in ws))


def as_results(packed):
    rows, dists, _t, cells, _ok = query.unpack_query_out(packed, K_OUT)
    return [([Res(int(r), float(x)) for r, x in zip(rr, dd) if r >= 0],
             int(c)) for rr, dd, c in zip(rows, dists, cells)]


def width_points(dev, label, nb, D, dtype, card):
    feats, fsq, X = store(dev, nb, D, dtype)
    cap = feats.shape[0]
    out = []
    for nq in NQS:
        Xq = X[:nq].contiguous()
        ws = widths_for(nq, cap, D)
        ref = brute(Xq, feats, fsq, nb, 16).cpu().numpy()
        ties = {}
        for w in ws:
            got = brute(Xq, feats, fsq, nb, w).cpu().numpy()
            _, ties[w] = cs._same_ids_but_ties(
                as_results(got), as_results(ref), cs.BRUTE_TIE_ATOL,
                f"brute width {w} vs 16 at {label} nb={nb} nq={nq}")
        peak = {}
        for w in ws:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            brute(Xq, feats, fsq, nb, w)
            torch.cuda.synchronize()
            peak[w] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        times = {w: [] for w in ws}
        rng = np.random.default_rng(0)
        for _ in range(ROUNDS):
            for w in rng.permutation(ws):
                times[int(w)].append(cs.event_ms(
                    lambda: brute(Xq, feats, fsq, nb, int(w)).cpu()))
        med = {w: float(np.median(t)) for w, t in times.items()}
        pick = query.brute_chunk(nq, cap, K_PRE, D)
        out.append(dict(label=label, nb=nb, D=D,
                        dtype=str(dtype).split(".")[-1], cap=cap, nq=nq,
                        ms=med, peak_mib=peak, ties=ties, pick=pick))
        cs.log(f"widths: {label} nb={nb} cap={cap} nq={nq}: wave ms by "
               f"chunk width {json.dumps(med)} (CUDA events, median of "
               f"{ROUNDS}); peak MiB above the store "
               f"{json.dumps({w: round(v, 1) for w, v in peak.items()})}; "
               f"the pass picks {pick}; near-tie swaps against width 16 "
               f"{ties} [{card}]")
    del feats, fsq, X
    torch.cuda.empty_cache()
    return out


def main():
    if not torch.cuda.is_available():
        print("torch_brute_chunks: no CUDA device", file=sys.stderr)
        return 2
    import columbiaimagesearch_tpu_torch  # noqa: F401  (TF32 off)

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    cs.log(card)
    t0 = time.perf_counter()
    traces = [trace_chunk(dev, *s, card) for s in TRACE_STORES]
    points = []
    for s in WIDTH_STORES:
        points += width_points(dev, *s, card)
    name, power = card.rsplit(",", 1)
    cs.log(f"torch_brute_chunks: {time.perf_counter() - t0:.1f} s")
    print(json.dumps(dict(traces=traces, widths=points, card=name.strip(),
                          power_limit=power.strip())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
