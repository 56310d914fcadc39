"""The process's import heap, taken out of the garbage collector's full
collections.

A serving process imports torch, numpy and the port, and loads its model,
before it builds a searcher: some 170,000 container objects that live as
long as the process. Every full collection traverses all of them again,
~100 ms each on an H100 machine's host, and a search wave's result rows
(10,000 tuples at 100 queries and limit 100) set one off every few waves.

:func:`settle` runs once a process, when its first searcher is built
(``LOPQSearcherTorch``, ``ShardedLOPQIndex``, ``ShardedLOPQSearcher``):
one full collection, then ``gc.freeze()``, which moves every object that
survived it into the collector's permanent generation. Later full
collections traverse only what was allocated since. The searchers settle
in ``__new__`` (:class:`Settled`), before the instance is allocated: a
searcher holds reference cycles, so the first one, frozen, would never be
collected, nor the device memory it holds.

The rule for whoever runs a process: whatever is alive when its first
searcher is built is never cycle-collected. Reference counting still frees
such an object once nothing refers to it; only a reference cycle among
objects alive at the freeze stays in memory for good. So build nothing
that will later be dropped in a cycle before the first searcher.

Modules imported after the freeze stay in the ordinary generations, and
full collections traverse them again: the first ``torch.profiler``
session of a process imports ``torch._inductor`` (its ``prepare_trace``
asks ``hasattr(torch, "_inductor")``), some 120,000 objects.
"""

import gc
import threading
import time

_lock = threading.Lock()
#: what the call that froze did, once it has run
_done = None


def settle():
    """Collect once and freeze the survivors, the first time it is called
    in this process; later calls (any thread) do nothing. Returns
    ``frozen_objects`` (``gc.get_freeze_count()`` after the freeze) and
    ``settle_s`` (the collection and freeze's seconds) of the call that
    froze, and ``settled_here``: whether this call froze."""
    global _done
    with _lock:
        if _done is not None:
            return dict(_done, settled_here=False)
        t0 = time.perf_counter()
        gc.collect()
        gc.freeze()
        _done = {"frozen_objects": gc.get_freeze_count(),
                 "settle_s": time.perf_counter() - t0}
        return dict(_done, settled_here=True)


class Settled:
    """Base of the searchers: :func:`settle` runs before the instance is
    allocated, and the instance keeps its result as ``heap_stats``."""

    def __new__(cls, *args, **kwargs):
        heap_stats = settle()
        self = super().__new__(cls)
        self.heap_stats = heap_stats
        return self
