"""The program's own spans in a ``--trace 1`` run: the ``cis.`` spans that
``columbiaimagesearch_tpu_torch`` opens on the wave's thread
(``common/profiling.py`` ``span``: ``cis.search``, ``cis.ladder``,
``cis.dispatch``, ``cis.fetch``, ``cis.results``; its garbage-collection
hook: ``cis.gc.<generation>``), on the profiler's clock with the device's
kernels and copies.

The device's idle time in the traced window (the complement of
``Reduction.busy_intervals`` within ``[t0, t1]``, the window of
``device.idle_share.bulk``) is split exactly among the innermost ``cis.``
span open over each part of it: a span's share is its self time while
the device idles. The parts under every name, and under none (``None``),
add up to the idle time.
"""

from collections import defaultdict

#: prefix of the program's span names
PREFIX = "cis."


def spans(red):
    """The program's spans on the wave's thread (``Reduction.ops``)."""
    return [e for e in red.ops if e.get("cat") == "user_annotation"
            and e["name"].startswith(PREFIX)]


def named(red, name):
    """The program's spans ``name`` that start in the traced window."""
    return [e for e in spans(red)
            if e["name"] == name and red.t0 <= e["ts"] < red.t1]


def idle_intervals(red):
    """(start, end) of each stretch of the window with the device idle."""
    edges = [red.t0] + [t for ab in red.busy_intervals for t in ab] \
        + [red.t1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def innermost(events):
    """[(start, end, name)], ascending and disjoint: the stretches in which
    some of ``events`` is open, each with the innermost one open over it
    (the latest started; of two started together, the shorter)."""
    events = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
    bounds = sorted({t for e in events for t in (e["ts"],
                                                 e["ts"] + e["dur"])})
    out, stack, i = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while i < len(events) and events[i]["ts"] <= a:
            stack.append(events[i])
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= a:
            stack.pop()
        if stack:
            out.append((a, b, stack[-1]["name"]))
    return out


def idle_split(red):
    """{innermost span name, or None outside any: seconds of the device's
    idle time in the window}."""
    segs = innermost(spans(red))
    by = defaultdict(float)
    j = 0
    for a, b in idle_intervals(red):
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        covered = 0.0
        k = j
        while k < len(segs) and segs[k][0] < b:
            part = min(b, segs[k][1]) - max(a, segs[k][0])
            if part > 0:
                by[segs[k][2]] += part
                covered += part
            k += 1
        by[None] += (b - a) - covered
    return {k: v / 1e6 for k, v in by.items()}


def idle_share(run, pick):
    """Share of the traced window, in %, in which the device idles under
    an innermost span whose name ``pick`` accepts; None where the run
    traced no ``cis.search``."""
    red = run.trace
    if not red.window_s or not named(red, PREFIX + "search"):
        return None
    idle = idle_split(red)
    return 100.0 * sum(v for k, v in idle.items()
                       if k is not None and pick(k)) / red.window_s


def span_ms_per_wave(run, name):
    """The summed durations of the spans ``name`` over the count of
    ``cis.search`` spans, in ms; None where the run traced no
    ``cis.search``."""
    red = run.trace
    waves = len(named(red, PREFIX + "search"))
    if not waves:
        return None
    return sum(e["dur"] for e in named(red, name)) / 1e3 / waves
