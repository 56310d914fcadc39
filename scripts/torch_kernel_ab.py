#!/usr/bin/env python3
"""Time the port's two Hopper kernels (``csrc/lut_build.cu``,
``csrc/adc_scan.cu``) against another version of them, in turns on one
card (old, new, new, old), at the shapes ``chip_smoke.py`` times, with each
shape's bound and, for the scan, one ``embedding_bag`` on the same inputs.
Both versions are called straight through ctypes on buffers made
beforehand, and timed as device time per call over back-to-back calls
(``chip_smoke.kernel_ms``), as device time per call replayed from a CUDA
graph (``chip_smoke.graph_ms``: no host in the loop, which matters where a
call is shorter than its launch), and per call with its launch
(``chip_smoke.time_ms``); the port's Python wrapper (``build_luts``,
``adc_scan_all``) is timed back to back and with its launch.

The other version's sources sit in a directory given with ``--old`` and
keep the C interfaces the kernels had before their redesign:
``lut_build(x2, isel, Cs, Rs, mus, subs, out, NQ, B, V, Dh, F, S, Dsub,
num_sms, stream)`` and ``adc_scan(codes, block_cell, block_count, lut0,
lut1, out, NB, M, V, S, NQ, stream)`` (tables in the [V, F, S, NQ] layout).
For example, from a git checkout:

    mkdir -p build/parent && for n in lut_build adc_scan; do
      git show <commit>:columbiaimagesearch_tpu_torch/csrc/$n.cu \\
        > build/parent/$n.cu; done
    python3 scripts/torch_kernel_ab.py --old build/parent

Needs one CUDA card and nvcc; imports nothing of JAX. Prints one line per
shape and, last, one JSON object with every number.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

P, I = ctypes.c_void_p, ctypes.c_int

LUT_SHAPES = [("serving wave NQ=32", 32, 4096, 128, 4, 256, 64),
              ("headline NQ=100", 100, 4096, 128, 4, 256, 64),
              ("headline NQ=1", 1, 4096, 128, 4, 256, 64),
              ("exhaustive all-V NQ=64", 64, 256, 64, 4, 256, 256)]
#: (label, rows, V, M, S, NQ): chip_smoke's face index (encoded rows,
#: ``chip_smoke.face_index``), the face scale with uniform random cells,
#: and the profile configuration of chip_smoke's SCAN_CASES
SCAN_SHAPES = [("face index NQ=8", 8_388_608, 256, 8, 256, 8),
               ("face index NQ=64", 8_388_608, 256, 8, 256, 64),
               ("face-scale random NQ=8", 8_388_608, 256, 8, 256, 8),
               ("face-scale random NQ=64", 8_388_608, 256, 8, 256, 64),
               ("profile NQ=8", 1 << 20, 64, 8, 256, 8),
               ("profile NQ=64", 1 << 20, 64, 8, 256, 64)]


def build_old(src_dir):
    """nvcc each old source with the port's flags into build/kernel_ab/."""
    from columbiaimagesearch_tpu_torch.kernels import build

    out_dir = os.path.join(ROOT, "build", "kernel_ab")
    os.makedirs(out_dir, exist_ok=True)
    libs = {}
    procs = {}
    for name in ("lut_build", "adc_scan"):
        so = os.path.join(out_dir, f"lib{name}_old.so")
        procs[name] = (so, subprocess.Popen(
            [build._nvcc()] + build.NVCC_FLAGS
            + ["-o", so, os.path.join(src_dir, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the old {name}:\n{log}")
        libs[name] = ctypes.CDLL(so)
    libs["lut_build"].lut_build.argtypes = [P] * 7 + [I] * 8 + [P]
    libs["adc_scan"].adc_scan.argtypes = [P] * 6 + [I] * 5 + [P]
    return libs


def turns(old, new, iters):
    """Device ms per call of old, new, new, old (``chip_smoke.kernel_ms``
    over ``iters`` back-to-back calls each, and ``chip_smoke.graph_ms``
    over ``iters`` calls in a CUDA graph) and of one call with its launch
    (``chip_smoke.time_ms``), as ({who: median back to back}, {who: median
    in a graph}, {who: [turns]}, {who: per-call ms with launch})."""
    t = {"old": [], "new": []}
    gr = {"old": [], "new": []}
    for who in ("old", "new", "new", "old"):
        fn = old if who == "old" else new
        t[who].append(cs.kernel_ms(fn, iters))
        gr[who].append(cs.graph_ms(fn, iters))
    call = {who: float(np.median(cs.time_ms(fn, iters)))
            for who, fn in (("old", old), ("new", new))}
    return ({k: float(np.median(v)) for k, v in t.items()},
            {k: float(np.median(v)) for k, v in gr.items()}, t, call)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True,
                    help="directory with the old lut_build.cu, adc_scan.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import columbiaimagesearch_tpu_torch  # noqa: F401  (TF32 off)
    from columbiaimagesearch_tpu_torch.index import exhaustive_adc as ex
    from columbiaimagesearch_tpu_torch.index import lut as lut_mod

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    libs = build_old(args.old)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    report = {"card": card, "lut_build": {}, "adc_scan": {}}

    for label, NQ, V, Dh, F, S, B in LUT_SHAPES:
        x2, isel, Cs, Rs, mus, subs = cs.lut_inputs(
            dev, g, NQ, V, Dh, F, S, B)
        if label.startswith("exhaustive"):
            isel = torch.arange(V, dtype=torch.int32, device=dev).expand(
                NQ, 2, V).contiguous()
        B = isel.shape[2]
        out_old = torch.empty((NQ, 2, B, F, S), device=dev)

        def old():
            err = libs["lut_build"].lut_build(
                x2.data_ptr(), isel.data_ptr(), Cs.data_ptr(), Rs.data_ptr(),
                mus.data_ptr(), subs.data_ptr(), out_old.data_ptr(), NQ, B,
                V, Dh, F, S, Dh // F, sms,
                torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"old lut_build: CUDA error {err}")

        out_new = torch.empty_like(out_old)
        lib_new = lut_mod._library()
        scratch = torch.empty(lib_new.lut_scratch_ints(NQ, B, V),
                              dtype=torch.int32, device=dev)

        # the grouping the port's wrappers pass (index/lut.py)
        mode = 2 if label.startswith("exhaustive") else int(NQ > 1)

        def new():
            err = lib_new.lut_build(
                x2.data_ptr(), isel.data_ptr(), Cs.data_ptr(), Rs.data_ptr(),
                mus.data_ptr(), subs.data_ptr(), out_new.data_ptr(),
                scratch.data_ptr(), mode, NQ, B, V, Dh, F, S, Dh // F, sms,
                torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"new lut_build: CUDA error {err}")

        def wrapper():
            if mode == 2:
                return lut_mod.build_luts_all_clusters(x2, Cs, Rs, mus, subs)
            return lut_mod.build_luts(x2, isel, Cs, Rs, mus, subs)

        old()
        new()
        got = wrapper()
        torch.cuda.synchronize()
        if not (torch.allclose(out_new, out_old, rtol=cs.LUT_RTOL,
                               atol=cs.LUT_ATOL) and torch.equal(got, out_new)):
            raise AssertionError(f"lut_build {label}: old and new differ")
        med, gmed, raw, call = turns(old, new, 20)
        w_ms = cs.kernel_ms(wrapper, 20)
        w_call = float(np.median(cs.time_ms(wrapper, 20)))
        nbytes, flops, distinct = cs.lut_work(isel, V, Dh, F, S, Dh // F)
        b_ms, by = cs.bound_of(nbytes, flops)
        print(f"lut_build {label} ({distinct} distinct matrices): old "
              f"{med['old']:.4f} ms new {med['new']:.4f} ms (turns {raw}); "
              f"in a graph old {gmed['old']:.4f} new {gmed['new']:.4f} ms; "
              f"bound {b_ms:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.3f} GFLOP) share (graph) old "
              f"{b_ms / gmed['old']:.3f} new {b_ms / gmed['new']:.3f} "
              f"library none; per call with its "
              f"launch old {call['old']:.4f} new {call['new']:.4f} ms; "
              f"build_luts {w_ms:.4f} ms, with its launch {w_call:.4f} ms "
              f"[{card}]", flush=True)
        report["lut_build"][label] = dict(
            old_ms=med["old"], new_ms=med["new"], old_graph_ms=gmed["old"],
            new_graph_ms=gmed["new"], bound_ms=b_ms,
            bound_by=by, bytes=nbytes, flops=flops, distinct=distinct,
            old_call_ms=call["old"], new_call_ms=call["new"],
            wrapper_ms=w_ms, wrapper_call_ms=w_call)
        del x2, isel, Cs, Rs, mus, subs, out_old, out_new, scratch, got

    from scripts.torch_kernel_breakdown import face_layout

    rng = np.random.RandomState(12)
    face = face_layout(dev)
    for label, n, V, M, S, NQ in SCAN_SHAPES:
        if label.startswith("face index"):
            a = face + [10 * torch.rand(V, M // 2, S, NQ, generator=g,
                                        device=dev) for _ in range(2)]
        else:
            a = cs.scan_case_args(dev, rng, g, n, V, M, S, NQ, False)
        items = ex.scan_items(a[1])
        NB = a[1].shape[0]
        out_old = torch.empty((NQ, NB * 128), device=dev)
        out_new = torch.empty_like(out_old)
        QT, Sp, smem = ex._scan_tiling(NQ, M, S)
        lt = [ex.tile_luts(t, QT, Sp) for t in a[3:]]
        lib_new = ex._library()

        def old():
            err = libs["adc_scan"].adc_scan(
                *(t.data_ptr() for t in a), out_old.data_ptr(), NB, M, V, S,
                NQ, torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"old adc_scan: CUDA error {err}")

        def new():
            err = lib_new.adc_scan(
                *(t.data_ptr() for t in a[:3]), items.data_ptr(),
                *(t.data_ptr() for t in lt), out_new.data_ptr(), NB,
                items.shape[0] - 1, M, V, S, Sp, NQ, QT, ex.ITEM_BLOCKS,
                smem, sms, torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"new adc_scan: CUDA error {err}")

        def wrapper():
            return ex.adc_scan_all(*a, V=V, items=items)

        old()
        new()
        got = wrapper()
        torch.cuda.synchronize()
        if not (torch.equal(out_new, out_old) and torch.equal(got, out_old)):
            raise AssertionError(f"adc_scan {label}: old and new differ")
        del got
        med, gmed, raw, call = turns(old, new, 10)
        w_ms = cs.kernel_ms(wrapper, 10)
        w_call = float(np.median(cs.time_ms(wrapper, 10)))
        idx, weight = cs.scan_library_inputs(*a, V)
        l_ms = cs.kernel_ms(lambda: cs.scan_library(idx, weight), 10)
        del idx, weight
        nbytes, flops = cs.scan_work(a[2], M, V, S, NQ)
        b_ms, by = cs.bound_of(nbytes, flops)
        print(f"adc_scan {label} (padded {NB * 128}): old {med['old']:.4f} "
              f"ms new {med['new']:.4f} ms (turns {raw}); in a graph old "
              f"{gmed['old']:.4f} new {gmed['new']:.4f} ms; bound "
              f"{b_ms:.4f} ms by {by} ({nbytes / 1e6:.1f} MB) share (graph) "
              f"old {b_ms / gmed['old']:.3f} new {b_ms / gmed['new']:.3f} "
              f"library (embedding_bag) {l_ms:.4f} ms; per call with its "
              f"launch old {call['old']:.4f} new {call['new']:.4f} ms; "
              f"adc_scan_all (tables tiled in the call) {w_ms:.4f} ms, with "
              f"its launch {w_call:.4f} ms [{card}]", flush=True)
        report["adc_scan"][label] = dict(
            old_ms=med["old"], new_ms=med["new"], old_graph_ms=gmed["old"],
            new_graph_ms=gmed["new"], bound_ms=b_ms,
            bound_by=by, bytes=nbytes, flops=flops, library_ms=l_ms,
            padded=NB * 128, old_call_ms=call["old"], new_call_ms=call["new"],
            wrapper_ms=w_ms, wrapper_call_ms=w_call)
        del a, lt, out_old, out_new
        torch.cuda.empty_cache()
    del face
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
