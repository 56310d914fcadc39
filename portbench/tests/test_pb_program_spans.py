"""The readers of the program's ``cis.`` spans on a hand-made trace."""

import json
import os

import numpy as np
import pytest

from portbench import program_spans, roofline, spec, trace

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)

NEW = ("device.idle_gc_share.bulk", "device.idle_results_share.bulk",
       "device.idle_dispatch_share.bulk", "device.idle_ladder_share.bulk",
       "host.fetch_ms_per_wave.bulk")
OLD = ("probe.escalated_share.bulk", "probe.brute_wave_share.bulk",
       "query.device_ms_per_wave.bulk", "lut_build_roofline.bulk",
       "device.idle_share.bulk", "wave.p50_ms.bulk", "host.gc_share.bulk",
       "wave_mfu.bulk")


def _x(name, cat, ts, dur, tid=1, **args):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, tid=tid,
                args=args)


def _span(name, ts, dur, tid=1):
    return _x(name, "user_annotation", ts, dur, tid)


# One traced wave, 0-100 us. The device is busy 15-28 and 40-45; each idle
# stretch falls under the innermost program span open over it:
#   0-2 none, 2-5 search, 5-10 ladder, 10-15 dispatch, 28-30 fetch,
#   30-40 ladder, 45-50 ladder, 50-55 search, 55-70 results, 70-80 gc.2
#   (inside results), 80-95 results, 95-98 search, 98-100 none.
OUTSIDE = [
    _x("portbench.wave", "user_annotation", 0, 100),
    _x("portbench.ladder", "user_annotation", 4, 47),
    _x("portbench.lut_build", "user_annotation", 11, 3),
    _x("cudaLaunchKernel", "cuda_runtime", 12, 1, correlation=7),
    _x("portbench.results", "user_annotation", 54, 42),
    _x("aten::copy_", "cpu_op", 21, 8),
    _x("lut_band_kernel", "kernel", 15, 10, correlation=7),
    _x("topk_kernel", "kernel", 22, 6, correlation=8),
    _x("memcpy", "gpu_memcpy", 40, 5),
]
PROGRAM = [
    _span("cis.search", 2, 96),
    _span("cis.ladder", 5, 45),
    _span("cis.dispatch", 10, 20),
    _span("cis.fetch", 20, 10),
    _span("cis.results", 55, 40),
    _span("cis.gc.2", 70, 10),
    # the same names elsewhere: another thread, the device's timeline
    _span("cis.results", 0, 100, tid=2),
    _x("cis.search", "gpu_user_annotation", 2, 96, tid=9),
]
IDLE = {None: 4e-6, "cis.search": 11e-6, "cis.ladder": 20e-6,
        "cis.dispatch": 5e-6, "cis.fetch": 2e-6, "cis.results": 30e-6,
        "cis.gc.2": 10e-6}


def _run(events):
    with open(os.path.join(PB, "configs", "release_10Mi.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(PB, "traffic", "bulk_waves.json")) as f:
        mix = json.load(f)
    return type("Run", (), dict(
        cfg=cfg, mix=mix, roofline=roofline,
        trace=trace.Reduction(events, "wave"),
        counters=dict(queries=400, escalated_queries=12, brute_waves=0,
                      waves=4, sent_waves=4),
        host=dict(wave_ms=np.array([20.0, 30.0, 25.0, 22.0]),
                  gc_s=[0.001, 0.0, 0.004], gc_n=[10, 0, 1]),
        lut_work=[(2e5, 1e6)], window_s=0.1))()


def _read(name, run):
    return spec.reader(name)(run)


def test_idle_split_by_innermost_span():
    run = _run(OUTSIDE + PROGRAM)
    assert program_spans.idle_split(run.trace) == pytest.approx(IDLE)


def test_each_reader_by_hand():
    run = _run(OUTSIDE + PROGRAM)
    # window 100 us
    assert _read("device.idle_gc_share.bulk", run) == pytest.approx(10.0)
    assert _read("device.idle_results_share.bulk", run) == pytest.approx(30.0)
    assert _read("device.idle_dispatch_share.bulk", run) == pytest.approx(5.0)
    assert _read("device.idle_ladder_share.bulk", run) == pytest.approx(20.0)
    # one cis.fetch of 10 us in one cis.search
    assert _read("host.fetch_ms_per_wave.bulk", run) == pytest.approx(0.01)


def test_parts_add_up_to_the_idle_share():
    run = _run(OUTSIDE + PROGRAM)
    parts = sum(_read(name, run) for name in NEW[:4])
    rest = program_spans.idle_split(run.trace)
    parts += 100.0 * (rest["cis.search"] + rest["cis.fetch"]
                      + rest[None]) / run.trace.window_s
    assert parts == pytest.approx(_read("device.idle_share.bulk", run))
    assert _read("device.idle_share.bulk", run) == pytest.approx(82.0)


def test_collections_and_waves_in_turn():
    """Two waves with a young collection in each launch's enqueue and one
    between the waves: spans that start together nest by length."""
    events = [
        _x("portbench.wave", "user_annotation", 0, 50),
        _x("portbench.wave", "user_annotation", 60, 40),
        _span("cis.search", 0, 50), _span("cis.dispatch", 0, 20),
        _span("cis.gc.0", 0, 5), _span("cis.fetch", 10, 10),
        _span("cis.results", 20, 30),
        _span("cis.gc.0", 52, 6),           # between the waves
        _span("cis.search", 60, 40), _span("cis.results", 60, 40),
        _span("cis.gc.1", 70, 10),
        _x("k", "kernel", 5, 10), _x("k", "kernel", 85, 5),
    ]
    run = _run(events)
    # idle: 0-5 gc.0, 15-20 fetch, 20-50 results, 50-60 none (the gc.0
    # between the waves falls outside the window's waves but inside
    # [t0, t1]: it counts), 60-70 results, 70-80 gc.1, 80-85 and 90-100
    # results
    split = program_spans.idle_split(run.trace)
    assert split == pytest.approx({"cis.gc.0": 11e-6, "cis.fetch": 5e-6,
                                   "cis.results": 55e-6, None: 4e-6,
                                   "cis.gc.1": 10e-6})
    assert _read("device.idle_gc_share.bulk", run) == pytest.approx(21.0)
    assert _read("host.fetch_ms_per_wave.bulk", run) == pytest.approx(0.005)


@pytest.mark.parametrize("name", NEW)
def test_none_without_the_program_spans(name):
    """A trace of a program that opens no spans (its parent commit's)."""
    assert _read(name, _run(OUTSIDE)) is None


@pytest.mark.parametrize("name", OLD)
def test_existing_readers_ignore_the_program_spans(name):
    without, with_ = _run(OUTSIDE), _run(OUTSIDE + PROGRAM)
    assert _read(name, with_) == _read(name, without)
    assert _read(name, without) is not None


def test_breakdown_ignores_the_program_spans():
    without, with_ = _run(OUTSIDE).trace, _run(OUTSIDE + PROGRAM).trace
    assert with_.idle_gaps() == without.idle_gaps()
    assert with_.device_ops() == without.device_ops()
    assert with_.busy_intervals == without.busy_intervals
