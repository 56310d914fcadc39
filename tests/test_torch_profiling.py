"""The port's ``common/profiling.py``: the two cases of
tests/test_profiling.py on ``StageTimer`` and ``ThroughputStats`` (copies
of the JAX classes), and ``device_trace``, which replaces the JAX
``jax.profiler`` context with ``torch.profiler`` and writes a chrome trace
(here on the CPU; on the card it records the device too)."""

import json
import os

import torch

from columbiaimagesearch_tpu_torch.common.profiling import (
    StageTimer,
    ThroughputStats,
    device_trace,
)


def test_stage_timer():
    t = StageTimer()
    with t.stage("detect"):
        pass
    with t.stage("detect"):
        pass
    with t.stage("featurize"):
        pass
    s = t.summary()
    assert s["detect"]["count"] == 2
    assert s["featurize"]["count"] == 1
    assert json.loads(t.report())["detect"]["mean_ms"] >= 0


def test_throughput_stats():
    printed = []
    st = ThroughputStats("ing", report_every=2, printer=printed.append)
    st.toc_ok()
    st.toc_ok()   # triggers report at 2
    st.toc_fail()
    assert len(printed) == 1
    rep = json.loads(st.report())
    assert rep["ok"] == 2 and rep["failed"] == 1


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "trace"), "mm") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "trace" / "mm.json"
    assert path.exists() and os.path.getsize(path) > 0
    with open(path) as f:
        assert "traceEvents" in json.load(f)
    assert any("mm" in e.key for e in prof.key_averages())
