"""Tracing and throughput statistics (port of
columbiaimagesearch_tpu/common/profiling.py:1-97).

The reference instruments everything with wall-clock prints — per-stage
detect/featurize/search timings (reference: searcher/generic_searcher.py:
365-389, searcher_lopqhbase.py:858-928) and every-1000-messages throughput
stats in the ingesters (reference: ingester/kafka_ingester.py:117-184
``toc_process_ok``/``print_stats``). This module provides the structured
equivalents plus a ``torch.profiler`` trace context for device-level
timelines.

``StageTimer`` and ``ThroughputStats`` are copies (profiling.py:17-84).
``device_trace`` replaces the JAX ``jax.profiler`` context (:87-97): it
records the host and the card with ``torch.profiler`` and writes a chrome
trace into ``logdir``.

The search path and the served path open named spans (:func:`span`, all
named ``cis.*``) while a profiler session is open in the process, on
whichever thread they run, and this module's ``gc.callbacks`` hook spans
every garbage collection (``cis.gc.<gen>``). They land in the same trace
as the device's kernels and copies, on the same clock (category
``user_annotation``). A session records the spans of the thread that
opened it; one opened with ``profile_all_threads`` (``torch._C._profiler.
_ExperimentalConfig``) records those of every thread, as the served path
needs:

- ``cis.search``: one wave of ``search_batch`` or ``search_device_feats``;
- ``cis.ladder``: the probe ladder (``_escalate``);
- ``cis.dispatch``: one launch, from the host enqueuing its ops to the
  unpacked output; inside it ``cis.fetch``, the copy-out of the packed
  output (the host waiting for the device);
- ``cis.results``: the wave's result rows;
- ``cis.gc.0``, ``cis.gc.1``, ``cis.gc.2``: a collection of that
  generation;
- on an HTTP handler's thread: ``cis.http``, one request from reading its
  body to writing the JSON reply (``api/app.py``); inside it
  ``cis.decode``, the request's image read (the featurizer's
  ``prepare_wave``: the JPEG coefficient read), and ``cis.queue``, the
  request's wait in the coalescer from ``submit`` to the start of its
  batch (``api/microbatch.py``);
- on the coalescer's thread, one served wave: ``cis.featurize`` (pixel
  reconstruction, preprocessing and the forward to fc7), then
  ``cis.search`` as above, then one ``cis.assemble`` a request (its reply
  rows, ``format_output``).

To read a ``device_trace``: the device is idle wherever no kernel, copy
or memset runs; over each idle gap, the innermost ``cis.`` span open on
the host's thread says what the host was doing (``cis.dispatch`` alone:
enqueuing or unpacking; ``cis.gc.*``: collecting). With no profiler
session open a span costs one read of torch's process-wide profiler flag
and records nothing.
"""

import contextlib
import gc
import json
import os
import time
from collections import defaultdict

import torch

#: torch's module whose ``_is_profiler_enabled`` is set while a profiler
#: session is open in the process, whichever thread opened it
_flags = torch.autograd.profiler
_OFF = contextlib.nullcontext()
_GC_SPANS = ("cis.gc.0", "cis.gc.1", "cis.gc.2")


def _recording():
    """Whether a profiler session is open in the process."""
    return _flags._is_profiler_enabled


def span(name):
    """A ``torch.profiler.record_function(name)`` while a profiler session
    is open, else a shared context that does nothing. ``name`` starts with
    ``cis.`` and carries no value (a span's arguments do not reach the
    chrome trace). A session records it if it records this thread."""
    if _flags._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


#: the record that the running collection's ``start`` entered, if any
_gc_open = []


def _gc_span(phase, info):
    """``gc.callbacks`` hook: a collection is the span ``cis.gc.<gen>``
    while a profiler session is open. ``stop`` exits only a record that its
    ``start`` entered (a profiler may start or stop during a
    collection)."""
    if phase == "start":
        if _recording():
            _gc_open.append(torch.ops.profiler._record_function_enter_new(
                _GC_SPANS[info["generation"]], None))
    elif _gc_open:
        torch.ops.profiler._record_function_exit._RecordFunction(
            _gc_open.pop())


gc.callbacks.append(_gc_span)


class StageTimer:
    """Accumulates per-stage wall-clock times; drop-in for the reference's
    scattered ``start = time.time()`` prints."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name):
        start = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - start
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self):
        return {
            name: {"total_s": round(self.totals[name], 4),
                   "count": self.counts[name],
                   "mean_ms": round(1000 * self.totals[name]
                                    / max(self.counts[name], 1), 3)}
            for name in sorted(self.totals)
        }

    def report(self):
        return json.dumps(self.summary())


class ThroughputStats:
    """ok/skip/fail counters with periodic rate reporting
    (the ingester ``print_stats`` role)."""

    def __init__(self, name="stats", report_every=1000, printer=print):
        self.name = name
        self.report_every = report_every
        self.printer = printer
        self.ok = self.skipped = self.failed = 0
        self.start = time.time()

    def _maybe_report(self):
        total = self.ok + self.skipped + self.failed
        if self.report_every and total % self.report_every == 0:
            self.printer(f"[{self.name}] {self.report()}")

    def toc_ok(self, n=1):
        self.ok += n
        self._maybe_report()

    def toc_skip(self, n=1):
        self.skipped += n
        self._maybe_report()

    def toc_fail(self, n=1):
        self.failed += n
        self._maybe_report()

    def report(self):
        elapsed = max(time.time() - self.start, 1e-9)
        total = self.ok + self.skipped + self.failed
        return json.dumps({
            "ok": self.ok, "skipped": self.skipped, "failed": self.failed,
            "elapsed_s": round(elapsed, 1),
            "rate_per_s": round(total / elapsed, 2),
        })


@contextlib.contextmanager
def device_trace(logdir, name="trace"):
    """``torch.profiler`` over the block, host and card (the card only
    when CUDA is available); on exit the chrome trace goes to
    ``<logdir>/<name>.json``. Yields the profiler, whose
    ``key_averages()`` sums the recorded ops. The trace carries the
    search path's ``cis.`` spans and the collections' (see the module
    docstring for how to read its idle gaps)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"{name}.json"))
