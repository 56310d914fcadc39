"""Copy of columbiaimagesearch_tpu/api/microbatch.py:1-140.

Cross-request micro-batching for the serving tier.

The reference scales request throughput by running many gunicorn workers,
each with its own searcher process (reference: api/gunicorn_api.py:21-75,
one model replica per worker). With one accelerator the economics invert:
ONE resident index + ONE device wave per batch of concurrent requests
beats N replicas, because the conv forward and the probed query run far
more efficiently at batch 8-64 than at batch 1, and device memory holds a
single copy of the codes. This module is a small coalescing queue that
melds requests arriving within a short window into one device batch.

Latency math: a request pays at most ``window_ms`` extra wait; the batch
amortizes the fixed per-launch host cost and runs the forward/query at
wave efficiency.

Port-side addition: while a profiler session is open, a request's wait
from ``submit`` to the start of its batch is the span ``cis.queue`` on
the submitting thread (``common/profiling.py``); the slot then carries a
second event, set when its batch is taken. With no session open it costs
one flag check a submit and one a slot.
"""

import threading
import time

from columbiaimagesearch_tpu_torch.common.profiling import _recording, span


class _Slot:
    __slots__ = ("item", "event", "result", "error", "taken")

    def __init__(self, item, taken=None):
        self.item = item
        self.event = threading.Event()
        self.result = None
        self.error = None
        #: set when the slot's batch is taken (only while profiling)
        self.taken = taken


class MicroBatcher:
    """Coalesce concurrent ``submit`` calls into one ``batch_fn`` call.

    ``batch_fn(items) -> results`` must return one result per item, in
    order. A returned Exception instance (or a raised one) is re-raised in
    the corresponding caller(s); a raise fails the whole batch.

    The worker thread blocks until a first item arrives, then drains the
    queue for up to ``window_ms`` or until ``max_batch`` items are
    collected, whichever is first. ``close()`` stops the worker; submits
    after close raise RuntimeError.
    """

    def __init__(self, batch_fn, max_batch=32, window_ms=4.0, name=None):
        self.batch_fn = batch_fn
        self.max_batch = int(max_batch)
        self.window_s = float(window_ms) / 1e3
        self._slots = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        #: batch sizes executed (for tests / metrics)
        self.batch_sizes = []
        self._worker = threading.Thread(
            target=self._run, name=name or "microbatcher", daemon=True)
        self._worker.start()

    def submit(self, item):
        """Block until the batch containing ``item`` completes; return its
        result (or raise its error). Fails fast instead of parking forever
        if the worker thread has died (e.g. a BaseException escaped
        batch_fn)."""
        slot = _Slot(item, threading.Event() if _recording() else None)
        with self._wake:
            if self._closed or not self._worker.is_alive():
                raise RuntimeError("MicroBatcher is closed")
            self._slots.append(slot)
            self._wake.notify()
        if slot.taken is not None:
            with span("cis.queue"):
                while not slot.taken.wait(timeout=5.0):
                    if not self._worker.is_alive():
                        break
        while not slot.event.wait(timeout=5.0):
            if not self._worker.is_alive():
                raise RuntimeError("MicroBatcher worker died")
        if slot.error is not None:
            raise slot.error
        return slot.result

    def close(self):
        with self._wake:
            self._closed = True
            self._wake.notify()
        self._worker.join(timeout=5)

    # ------------------------------------------------------------ worker

    def _take_batch(self):
        """Wait for >=1 slot, then collect up to max_batch within the
        window. Returns [] only when closed and drained."""
        with self._wake:
            while not self._slots and not self._closed:
                self._wake.wait()
            if not self._slots:
                return []
            deadline = time.monotonic() + self.window_s
            while (len(self._slots) < self.max_batch and not self._closed):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._wake.wait(timeout=remaining)
            batch = self._slots[:self.max_batch]
            del self._slots[:len(batch)]
            for s in batch:
                if s.taken is not None:
                    s.taken.set()
            return batch

    def _run(self):
        try:
            self._run_inner()
        finally:
            # A BaseException escaping batch_fn kills the worker; mark
            # closed and release any parked submitters so the serving
            # tier fails fast instead of hanging (see submit()).
            with self._wake:
                self._closed = True
                pending, self._slots = self._slots, []
            for s in pending:
                s.error = RuntimeError("MicroBatcher worker died")
                s.event.set()

    def _run_inner(self):
        while True:
            batch = self._take_batch()
            if not batch:
                return
            self.batch_sizes.append(len(batch))
            try:
                results = self.batch_fn([s.item for s in batch])
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"batch_fn returned {len(results)} results for "
                        f"{len(batch)} items")
                for s, r in zip(batch, results):
                    if isinstance(r, Exception):
                        s.error = r
                    else:
                        s.result = r
            except Exception as inst:  # noqa: BLE001 — propagate to callers
                for s in batch:
                    s.error = inst
            finally:
                for s in batch:
                    s.event.set()
