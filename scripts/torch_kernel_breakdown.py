#!/usr/bin/env python3
"""Where the time of the port's two Hopper kernels goes, on one card.

Builds copies of ``csrc/lut_build.cu`` and ``csrc/adc_scan.cu`` with the
compile-time switches their headers list (``-D`` flags: a part taken out,
or another ring depth or walk order), and times each copy through ctypes on
buffers made beforehand (device time per call replayed from a CUDA graph,
``chip_smoke.graph_ms``),
beside the unchanged source, at the shapes ``chip_smoke.py`` times:

- LUT tables at the serving wave (NQ=32), the headline waves (NQ=100, 1)
  and the exhaustive all-V shape (NQ=64, V=256): the grouping launch alone,
  without the tables, the producer's copies and the walk alone, three ring
  stages, registers
  sized for three blocks an SM, and the other groupings (a run-time
  argument: 0, every slot a group of its own, so each matrix is read once
  per probing slot; 1, the counting sort); beside them
  ``torch.index_select`` of the same distinct matrices (read and written
  once each), a yardstick for the loads;
- the scan on ``chip_smoke.py``'s face index (8,388,608 encoded rows,
  V=256, M=8, S=256, cells as long as the data makes them) and at the same
  scale with uniform random cells, at NQ 8 and 64: without the lut1 fill,
  without the gathers,
  without the output stores, the walk alone (none of the three), three ring
  buffers (one block an SM), each item's query tiles back to back (its
  codes re-read from L2 for every tile, lut0 refilled with every step), and
  items of up to 8 and 16 blocks and as long as their cells, where two
  buffers of their codes fit beside the tables (the ``ITEM_BLOCKS`` cap is
  4; a run-time argument).

The copies with a part taken out compute wrong outputs and are not
checked; the others are held to the port's wrappers. Needs one CUDA card
and nvcc; imports nothing of JAX. Prints one line per shape and, last, one
JSON object with every number. Run from the root of a checkout:

    python3 scripts/torch_kernel_breakdown.py [--parts lut,scan]
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
from scripts.torch_kernel_ab import LUT_SHAPES  # noqa: E402

P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: LUT copies: name -> (nvcc -D flags, checked against build_luts)
LUT_VARIANTS = {
    "as is": ([], True),
    "sort only": (["-DLUT_SORT_ONLY"], False),
    "no tables": (["-DLUT_NO_TABLES"], False),
    "loads only": (["-DLUT_LOADS_ONLY"], False),
    "3 stages": (["-DLUT_STAGES=3"], True),
    "3 blocks an SM, 3 stages": (["-DLUT_MIN_BLOCKS=3", "-DLUT_STAGES=3"],
                                 True),
}
#: scan copies: name -> (nvcc -D flags, ring buffers, checked)
SCAN_VARIANTS = {
    "as is": ([], 2, True),
    "no lut1 fill": (["-DADC_NO_FILL"], 2, False),
    "no gathers": (["-DADC_NO_GATHER"], 2, False),
    "no stores": (["-DADC_NO_STORE"], 2, False),
    "walk only": (["-DADC_NO_FILL", "-DADC_NO_GATHER", "-DADC_NO_STORE"], 2,
                  False),
    "3 ring buffers": (["-DADC_STAGES=3"], 3, True),
    "tiles inner": (["-DADC_TILE_INNER"], 2, True),
}
#: (label, NQ): chip_smoke's face index (FACE: the seeded mixture encoded
#: by a seeded model, so cells as long as the data makes them), then
#: uniform random cells at the same scale (8,388,608 rows, V=256, M=8,
#: S=256)
SCAN_SHAPES = [("face index NQ=8", 8), ("face index NQ=64", 64),
               ("face-scale random NQ=8", 8), ("face-scale random NQ=64", 64)]


def face_layout(dev):
    """chip_smoke's face index (``chip_smoke.face_index``, same seeds): the
    padded codes, block_cell and block_count on ``dev``."""
    from columbiaimagesearch_tpu_torch.index.exhaustive_adc import (
        build_padded_layout,
    )

    _, coarse, fine, _, _ = cs.face_index(dev)
    V = cs.FACE["V"]
    codes, bc, bn, _ = build_padded_layout(
        coarse[:, 0].astype(np.int64) * V + coarse[:, 1], fine)
    return [torch.from_numpy(x).to(dev) for x in (codes, bc, bn)]


def build_copies(name, variants):
    """nvcc each copy of csrc/<name>.cu with its -D flags (all at once)
    into build/breakdown/; returns {variant: ctypes library}."""
    from columbiaimagesearch_tpu_torch.kernels import build

    src = build.source_path(name)
    out_dir = os.path.join(ROOT, "build", "breakdown")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (label, flags) in enumerate(variants.items()):
        so = os.path.join(out_dir, f"{name}_{i}.so")
        procs[label] = (so, subprocess.Popen(
            [build._nvcc()] + build.NVCC_FLAGS + flags + ["-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {label}:\n{log}")
        libs[label] = ctypes.CDLL(so)
    return libs


def lut_part(dev, sms, card, report):
    from columbiaimagesearch_tpu_torch.index.lut import build_luts

    libs = build_copies("lut_build",
                        {k: v[0] for k, v in LUT_VARIANTS.items()})
    for lib in libs.values():
        lib.lut_build.argtypes = [P] * 8 + [I] * 9 + [P]
        lib.lut_scratch_ints.argtypes = [I] * 3
        lib.lut_scratch_ints.restype = LL
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    for label, NQ, V, Dh, F, S, B in LUT_SHAPES:
        x2, isel, Cs, Rs, mus, subs = cs.lut_inputs(
            dev, g, NQ, V, Dh, F, S, B)
        if label.startswith("exhaustive"):
            isel = torch.arange(V, dtype=torch.int32, device=dev).expand(
                NQ, 2, V).contiguous()
        B = isel.shape[2]
        out = torch.empty((NQ, 2, B, F, S), device=dev)
        scratch = torch.empty(libs["as is"].lut_scratch_ints(NQ, B, V),
                              dtype=torch.int32, device=dev)
        want = build_luts(x2, isel, Cs, Rs, mus, subs)
        # the grouping the port's wrappers pass (lut.py): the exhaustive
        # path's calls know theirs (2), one query needs none (0)
        mode = 2 if label.startswith("exhaustive") else int(NQ > 1)
        row = {}
        runs = [(v, libs[v], mode, LUT_VARIANTS[v][1]) for v in LUT_VARIANTS
                if mode == 1 or v != "sort only"]
        runs += [(f"grouping {m}", libs["as is"], m, True)
                 for m in (0, 1) if m != mode]
        for variant, lib, grouping, checked in runs:
            def fn(lib=lib, grouping=grouping):
                err = lib.lut_build(
                    x2.data_ptr(), isel.data_ptr(), Cs.data_ptr(),
                    Rs.data_ptr(), mus.data_ptr(), subs.data_ptr(),
                    out.data_ptr(), scratch.data_ptr(), grouping, NQ, B, V,
                    Dh, F, S, Dh // F, sms,
                    torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"lut_build {variant}: CUDA error "
                                       f"{err}")
            fn()
            torch.cuda.synchronize()
            if checked and not torch.equal(out, want):
                raise AssertionError(f"lut_build {label} {variant}: differs "
                                     "from build_luts")
            row[variant] = cs.graph_ms(fn, 20)
        s = torch.arange(2, device=dev).view(1, 2, 1)
        keys = torch.unique((s * V + isel.long()).flatten())
        flat = Rs.view(2 * V, Dh * Dh)
        dst = torch.empty((keys.numel(), Dh * Dh), device=dev)
        row["index_select of the distinct matrices"] = cs.graph_ms(
            lambda: torch.index_select(flat, 0, keys, out=dst), 20)
        gbytes = 2 * keys.numel() * Dh * Dh * 4 / 1e9
        rate = gbytes / row["index_select of the distinct matrices"]
        print(f"lut_build {label}: " + " | ".join(
            f"{k} {v:.4f} ms" for k, v in row.items())
            + f" (index_select moves {gbytes:.3f} GB read + written: "
            f"{rate:.2f} TB/s) [{card}]", flush=True)
        report["lut_build"][label] = dict(row, index_select_tb_s=rate)
        del x2, isel, Cs, Rs, mus, subs, out, scratch, dst, want


def scan_part(dev, sms, card, report):
    from columbiaimagesearch_tpu_torch.index import exhaustive_adc as ex

    libs = build_copies("adc_scan",
                        {k: v[0] for k, v in SCAN_VARIANTS.items()})
    for lib in libs.values():
        lib.adc_scan.argtypes = [P] * 7 + [I] * 9 + [LL, I, P]
    rng = np.random.RandomState(12)
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    V, M, S = cs.FACE["V"], cs.FACE["M"], cs.FACE["S"]
    face = face_layout(dev)
    for label, NQ in SCAN_SHAPES:
        if label.startswith("face index"):
            a = face + [10 * torch.rand(V, M // 2, S, NQ, generator=g,
                                        device=dev) for _ in range(2)]
        else:
            a = cs.scan_case_args(dev, rng, g, cs.FACE["rows"], V, M, S, NQ,
                                  False)
        NB = a[1].shape[0]
        QT, Sp, _ = ex._scan_tiling(NQ, M, S)
        lt = [ex.tile_luts(t, QT, Sp) for t in a[3:]]
        out = torch.empty((NQ, NB * ex.BLK), device=dev)
        want = ex.adc_scan_all(*a, V=V)
        half = (M // 2) * Sp * QT * 4
        # the longest cell, in blocks: items as long as their cells where
        # two buffers of its codes fit beside the tables, else longer caps
        _, runs = torch.unique_consecutive(a[1], return_counts=True)
        longest = int(runs.max())
        row = {"longest cell (blocks)": longest}
        plan = [(v, libs[v], SCAN_VARIANTS[v][1], ex.ITEM_BLOCKS,
                 SCAN_VARIANTS[v][2]) for v in SCAN_VARIANTS]
        for cap in sorted({8, 16, longest}):
            if (ex.ITEM_BLOCKS < cap <= longest and 128 + 3 * half
                    + 2 * cap * ex.BLK * M <= ex.MAX_SMEM):
                plan.append((f"items of up to {cap} blocks", libs["as is"],
                             2, cap, True))
        for variant, lib, stages, cap, checked in plan:
            items = ex.scan_items(a[1], cap)
            codes = -(-(cap * ex.BLK * M) // 16) * 16
            smem = 128 + (1 + stages) * half + stages * codes

            def fn(lib=lib, smem=smem, items=items, cap=cap):
                err = lib.adc_scan(
                    *(t.data_ptr() for t in a[:3]), items.data_ptr(),
                    *(t.data_ptr() for t in lt), out.data_ptr(), NB,
                    items.shape[0] - 1, M, V, S, Sp, NQ, QT, cap, smem, sms,
                    torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"adc_scan {variant}: CUDA error "
                                       f"{err}")
            fn()
            torch.cuda.synchronize()
            if checked and not torch.equal(out, want):
                raise AssertionError(f"adc_scan {label} {variant}: differs "
                                     "from adc_scan_all")
            row[variant] = cs.graph_ms(fn, 10)
        print(f"adc_scan {label} ({NB} blocks):"
              + " | ".join(f" {k} {v:.4f} ms" if isinstance(v, float)
                           else f" {k} {v}" for k, v in row.items())
              + f" [{card}]", flush=True)
        report["adc_scan"][label] = row
        del a, lt, out, want
        torch.cuda.empty_cache()
    del face


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="lut,scan",
                    help="comma-separated: lut, scan")
    parts = ap.parse_args(argv).parts.split(",")
    if not torch.cuda.is_available():
        print("torch_kernel_breakdown: no CUDA device", file=sys.stderr)
        return 2
    import columbiaimagesearch_tpu_torch  # noqa: F401  (TF32 off)
    from columbiaimagesearch_tpu_torch.device import sm_count

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    sms = sm_count(dev)
    report = {"card": card, "lut_build": {}, "adc_scan": {}}
    if "lut" in parts:
        lut_part(dev, sms, card, report)
    if "scan" in parts:
        scan_part(dev, sms, card, report)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
