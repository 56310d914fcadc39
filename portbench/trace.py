"""The traced part of a ``--trace 1`` run: spans from the benchmark's own
wrappers around calls into the program, a ``torch.profiler`` trace of the
device, and its reduction to device busy time, kernel time by name, idle
gaps by what the host was doing and the device time of each span's
launches.

Device busy is the union of kernel, copy and memset intervals
(``chip_smoke.py`` ``trace``'s arithmetic).
"""

import json
import os
import shutil
import tempfile
from collections import defaultdict

import torch

#: prefix of the benchmark's own span names
PREFIX = "portbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Spans:
    """Wrappers that record a span around calls into the program:
    ``wrap(obj, attr, name)`` replaces the attribute ``attr`` of a module
    or an instance, and ``remove()`` puts every original back. While
    ``recording`` is set, ``keep(*args, **kwargs)`` of a wrapped call is
    appended to ``calls[name]``."""

    def __init__(self):
        self._saved = []
        self.recording = False
        self.calls = defaultdict(list)

    def wrap(self, obj, attr, name, keep=None):
        inner = getattr(obj, attr)
        label = PREFIX + name

        def wrapped(*args, **kwargs):
            if self.recording and keep is not None:
                self.calls[name].append(keep(*args, **kwargs))
            with torch.profiler.record_function(label):
                return inner(*args, **kwargs)

        self._saved.append((obj, attr, inner if attr in vars(obj) else None))
        setattr(obj, attr, wrapped)

    def remove(self):
        for obj, attr, own in reversed(self._saved):
            if own is None:
                delattr(obj, attr)         # the class's method shows again
            else:
                setattr(obj, attr, own)
        self._saved = []


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def events_of(prof):
    """The trace's events (exported to a file under ``TMPDIR`` and read
    back; the file is deleted)."""
    work = tempfile.mkdtemp(prefix="portbench-trace-")
    try:
        path = os.path.join(work, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Reduction:
    """What the per-layer readers take from one trace (times in seconds).

    :param events: the chrome trace's events
    :param window_name: the span that bounds the traced window (the
        traced waves' spans; the window runs from the first one's start to
        the last one's end)
    """

    def __init__(self, events, window_name):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = [e for e in xs if e.get("cat") in DEVICE_CATS]
        host = [e for e in xs if e.get("cat") in ("user_annotation",
                                                   "cpu_op")]
        self.spans = [e for e in host if e["name"].startswith(PREFIX)]
        self.launches = [e for e in xs if e.get("cat") in LAUNCH_CATS]
        waves = [e for e in self.spans if e["name"] == PREFIX + window_name]
        # host operations of the thread that drives the waves
        tids = {e.get("tid") for e in waves}
        self.ops = [e for e in host if not e["name"].startswith(PREFIX)
                    and e.get("tid") in tids]
        self.n_windows = len(waves)
        if waves:
            self.t0 = min(e["ts"] for e in waves)
            self.t1 = max(e["ts"] + e["dur"] for e in waves)
        else:
            self.t0 = self.t1 = 0.0
        merged = _union((max(e["ts"], self.t0), min(e["ts"] + e["dur"],
                                                    self.t1))
                        for e in self.device
                        if e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0)
        self.busy_intervals = [(a, b) for a, b in merged if b > a]

    @property
    def window_s(self):
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals) / 1e6

    def device_ops(self, top=10):
        """[[kernel name, seconds]] of the ``top`` device operations by
        time in the window."""
        by = defaultdict(float)
        for e in self.device:
            if self.t0 <= e["ts"] < self.t1:
                by[e["name"]] += e["dur"] / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top=10):
        """[[what the host was doing, seconds]]: the device's idle time in
        the window, each gap given to the innermost span of the benchmark
        (else the innermost host operation) open at its middle, summed by
        that name, the ``top`` largest."""
        edges = [self.t0] + [t for ab in self.busy_intervals for t in ab] \
            + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        mids = [(a + b) / 2 for a, b in gaps]
        in_span = _innermost(self.spans, mids)
        in_op = _innermost(self.ops, mids)
        by = defaultdict(float)
        for (a, b), s, o in zip(gaps, in_span, in_op):
            by[s or o or "host: outside any span"] += (b - a) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def span_device(self, name):
        """[(kernel seconds)] of each call of the span ``name``: the device
        time of the kernels that the host launched inside it."""
        spans = [e for e in self.spans if e["name"] == PREFIX + name]
        if not spans:
            return []
        by_corr = defaultdict(float)
        for e in self.device:
            corr = e.get("args", {}).get("correlation")
            if corr is not None and e.get("cat") == "kernel":
                by_corr[corr] += e["dur"] / 1e6
        out = []
        for s in sorted(spans, key=lambda e: e["ts"]):
            a, b = s["ts"], s["ts"] + s["dur"]
            out.append(sum(by_corr.get(e.get("args", {}).get("correlation"),
                                       0.0)
                           for e in self.launches if a <= e["ts"] <= b))
        return out


def _innermost(events, times):
    """For each of the ascending ``times``, the name of the innermost of
    ``events`` (host spans, nested) open at it, or None: one sweep with a
    stack of the open spans."""
    events = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
    stack, out, i = [], [], 0
    for t in times:
        while i < len(events) and events[i]["ts"] <= t:
            e = events[i]
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"]:
                stack.pop()
            stack.append(e)
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < t:
            stack.pop()
        out.append(stack[-1]["name"] if stack else None)
    return out
