"""The roofline counts against hand-worked shapes."""

import json
import os

import pytest
import torch

from portbench import roofline

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_peak_seconds():
    t, by = roofline.peak_seconds(3.35e12, 0)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = roofline.peak_seconds(0, 67e12 * 2)
    assert t == pytest.approx(2.0) and by == "operations"


def test_lut_work_by_hand():
    # 2 queries, B=3, V=8, Dh=8, F=2, S=4, Dsub=4; ids of split 0:
    # {1, 2, 3} and {1, 2, 4}; split 1: {0, 1, 2} and an invalid slot
    isel = torch.tensor([[[1, 2, 3], [0, 1, 2]],
                         [[1, 2, 4], [0, 1, -1]]], dtype=torch.int32)
    nbytes, flops = roofline.lut_work(isel, V=8, Dh=8, F=2, S=4, Dsub=4)
    distinct = 4 + 3                 # (0,1..4) and (1,0..2)
    want_bytes = (distinct * (64 + 16) * 4 + 2 * 2 * 8 * 4 + 12 * 4
                  + 2 * 2 * 4 * 4 * 4 + 2 * 2 * 3 * 2 * 4 * 4)
    assert nbytes == want_bytes
    slots = 11
    assert flops == slots * (2 * 64 + 16 + 3 * 2 * 4 * 4)


def test_wave_work_release_shapes():
    with open(os.path.join(PB, "configs", "release_10Mi.json")) as f:
        cfg = json.load(f)
    nbytes, flops = roofline.wave_work(cfg, 100, 10_000, 100, 1000)
    # centroids 2*4096*128*4, PCA 4096*256*4; a query: 4096*4 features,
    # 10,000*8 codes, 1,000*256*4 rerank rows, 100*8 results
    per_q = 16384 + 80000 + 1_024_000 + 800
    assert nbytes == 4_194_304 + 4_194_304 + 100 * per_q
    tables = 2 * 64 * (2 * 128 * 128 + 2 * 128 + 3 * 4 * 256 * 32)
    per_q_flops = (3 * 2 * 4096 * 128 + 10_000 * 7 + 1000 * 3 * 256
                   + tables + 2 * 4096 * 256)
    assert flops == 100 * per_q_flops
    least, by = roofline.peak_seconds(nbytes, flops)
    assert by == "bytes" and least == pytest.approx(nbytes / 3.35e12)


def test_wave_work_face_has_no_pca():
    with open(os.path.join(PB, "configs", "face_8Mi.json")) as f:
        cfg = json.load(f)
    nbytes, flops = roofline.wave_work(cfg, 1, 10_000, 100, 1000)
    assert nbytes == 2 * 256 * 64 * 4 + 128 * 4 + 80000 + 512_000 + 800
