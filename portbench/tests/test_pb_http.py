"""The ``http_closed`` kind end to end at CPU size, the forward's work
against its hand count, and the new readers on a trace without the served
path's spans."""

import json
import os
import types

import pytest

from portbench import roofline, run, served, spec
from portbench.tests.conftest import PB

CELL = "release_served_10Mi.http_closed32"
READERS = ["featurizer.device_ms_per_image.http", "sentibank_roofline.http",
           "host.decode_ms_per_image.http", "coalesce.wave_size.http",
           "device.idle_share.http", "wave_mfu.http"]


def tiny_http_cell():
    """The served cell at a size the CPU holds: the whole net, an index of
    V=16, D=32 and 20,000 rows, 8 pool images of 120 x 160, 2 clients."""
    cell = spec.Cell(CELL)
    cfg = dict(cell.cfg, dim=32, V=16, subq=16, rows=20000, train_rows=4000,
               fit_images=64)
    cfg["conf_overrides"] = dict(cfg["conf_overrides"],
                                 SEARCHLOPQ_lopq_V=16, SEARCHLOPQ_lopq_subq=16,
                                 SEARCHLOPQ_lopq_pcadims=32,
                                 SEARCHLOPQ_coalesce_max_batch=4)
    mix = dict(cell.mix, clients=2, client_procs=2, images=8, height=120,
               width=160, options={"max_returned": 10, "reranking": True,
                                   "rerank_nb": 100},
               limit=10, rerank_nb=100, warmup_requests=4, sample=16,
               trace_seconds=1)
    return types.SimpleNamespace(
        name=CELL + ".tiny", chips=1, cfg=cfg, mix=mix, limits=cell.limits,
        end_to_end=cell.end_to_end, per_layer=cell.per_layer)


def test_the_cell_is_declared():
    cell = spec.Cell(CELL)
    assert cell.chips == 1
    assert [m["name"] for m in cell.end_to_end] == ["setup_s",
                                                    "queries_per_s"]
    assert [m["name"] for m in cell.per_layer] == READERS
    numbers = {"decode_mean", "decode_p99", "fc7_rel_err", "dist_gap",
               "list_miss"}
    assert set(cell.limits) == numbers | {"readings"}
    # each limit lies between the program's largest calibration reading
    # and the control's smallest
    r = cell.limits["readings"]
    for k in numbers:
        assert r["program_max"][k] < cell.limits[k] < r["control_min"][k]


@pytest.mark.parametrize("traced", [False, True])
def test_http_closed_end_to_end(cpu, traced):
    """setup, window, sample, free and judge at CPU size: every reply good,
    every image on the coefficient route, the check correct and its
    controls not, and in a traced run the served spans read."""
    out = run.execute(tiny_http_cell(), 2**33 + 11, 2.0, traced, cpu,
                      control=not traced)
    c = out["counters"]
    assert out["failed"] == 0 and c["requests"] > 0
    assert c["pixel_images"] == 0 and c["coeff_images"] >= c["requests"]
    assert c["kept"] == min(16, c["requests"])
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    if traced:
        m = {k: v["value"] for k, v in out["metrics"].items()}
        # the CPU launches no kernels: the forward's roofline reads nothing
        assert set(m) == set(READERS) - {"sentibank_roofline.http"}, m
        assert m["coalesce.wave_size.http"] >= 1
        assert 0 < m["wave_mfu.http"] < 100
        assert m["host.decode_ms_per_image.http"] > 0
        assert out["device"]["window_s"] > 0
    else:
        ctl = out["control"]
        assert not ctl["correct"], ctl
        over = {k for k, v in ctl["checks"].items()
                if v["value"] > v["limit"]}
        assert {"decode_mean", "decode_p99", "fc7_rel_err"} <= over, ctl


def test_sentibank_work_is_the_hand_count():
    nbytes, flops = served.sentibank_work(1)
    mflop = [211, 448, 299, 224, 150, 75, 34]       # conv1-5, fc6, fc7
    assert abs(flops / 1e6 - sum(mflop)) < 2
    assert abs(flops / 1e9 - 1.44) < 0.005
    fc6, fc7 = 9216 * 4096 * 4, 4096 * 4096 * 4
    weights = served.sentibank_work(0)[0]
    assert fc6 + fc7 < weights < fc6 + fc7 + 10 * 2**20
    assert abs(weights / 1e6 - 227.4) < 0.5
    assert nbytes - weights == 4 * (3 * 227 * 227 + 4096)
    assert served.sentibank_work(32)[1] == 32 * flops
    # a 32-image forward binds on FLOPs: 0.69 ms at 67 TFLOP/s
    least, by = roofline.peak_seconds(*served.sentibank_work(32))
    assert by == "operations" and abs(least * 1e3 - 0.688) < 0.01


@pytest.mark.parametrize("name", READERS)
def test_readers_are_silent_without_the_spans(name):
    """On a traced run of a program without the served spans (the parent
    commit's), the readers of the spans read nothing and raise nothing."""
    from portbench import trace

    events = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window",
               "ts": 0, "dur": 100, "tid": 1},
              {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 5,
               "tid": 7, "args": {"correlation": 1}}]
    red = trace.Reduction(events, "window")
    with open(os.path.join(os.path.dirname(PB), "BENCHMARK.json")) as f:
        assert name in {m["name"] for m in json.load(f)["per_layer"]}
    r = types.SimpleNamespace(
        cfg=spec.Cell(CELL).cfg, mix=spec.Cell(CELL).mix, roofline=roofline,
        trace=red, served=dict(spans=[], traced_sizes=[3, 4],
                               forward_images=[]),
        window_sizes=[], window_s=1.0)
    v = spec.reader(name)(r)
    if name == "device.idle_share.http":
        assert v == pytest.approx(95.0)
    else:
        assert v is None
