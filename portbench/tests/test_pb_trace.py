"""The trace's reduction on a hand-made trace."""

import pytest

from portbench import trace


def _x(name, cat, ts, dur, tid=1, **args):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, tid=tid,
                args=args)


EVENTS = [
    _x("portbench.wave", "user_annotation", 0, 100),
    _x("portbench.ladder", "user_annotation", 5, 40),
    _x("portbench.lut_build", "user_annotation", 10, 10),
    _x("cudaLaunchKernel", "cuda_runtime", 12, 2, correlation=7),
    _x("aten::sort", "cpu_op", 30, 10),
    _x("portbench.results", "user_annotation", 60, 40),
    _x("lut_band_kernel", "kernel", 20, 10, correlation=7),
    _x("sort_kernel", "kernel", 25, 10, correlation=8),
    _x("memcpy", "gpu_memcpy", 50, 5),
    _x("other", "kernel", 200, 10),
]


def test_busy_window_and_gaps():
    red = trace.Reduction(EVENTS, "wave")
    assert red.n_windows == 1
    assert red.window_s == pytest.approx(100e-6)
    # kernels 20-35 merged, the copy 50-55: 20 us busy
    assert red.busy_s == pytest.approx(20e-6)
    ops = dict(red.device_ops())
    assert ops == pytest.approx({"lut_band_kernel": 10e-6,
                                 "sort_kernel": 10e-6, "memcpy": 5e-6})
    gaps = dict(red.idle_gaps())
    # 0-20 (mid 10: lut_build), 35-50 (mid 42.5: ladder), 55-100 (mid
    # 77.5: results)
    assert gaps == pytest.approx({"portbench.lut_build": 20e-6,
                                  "portbench.ladder": 15e-6,
                                  "portbench.results": 45e-6})
    assert red.span_device("lut_build") == pytest.approx([10e-6])
    assert red.span_device("missing") == []


def test_spans_wrap_and_remove():
    class Obj:
        def f(self, x):
            return x + 1

    o = Obj()
    spans = trace.Spans()
    spans.wrap(o, "f", "f", keep=lambda x: x)
    spans.recording = True
    assert o.f(1) == 2 and spans.calls["f"] == [1]
    spans.remove()
    assert "f" not in vars(o) and o.f(2) == 3
