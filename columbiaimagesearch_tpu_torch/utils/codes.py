"""Code dtype conventions and insertion dedup
(copy of columbiaimagesearch_tpu/utils/codes.py:12-17, 56-138;
``dedup_first_mask`` ports codes.py:20-53 onto ``IncrementalDedup``).

Cluster-id dtypes follow the codebook cardinality at the host API
boundary (reference: lopq/lopq/utils.py:33-53): uint8 for <=256 clusters,
uint16 for <=65536, else uint32.

Repair in the copy: the bulk path of ``IncrementalDedup`` interned ids with
``pandas.factorize`` (codes.py:107). The port does not depend on pandas; it
interns with ``np.unique(..., return_inverse=True)``, which takes integer
ids (the identity-id fast path) and any sortable object ids, and falls back
to the per-id dict for ids that do not sort together (mixed types, None).
The keep-mask does not depend on how ids are numbered, so the result is the
same as the JAX package's.
"""

import numpy as np


def code_dtype_for(num_clusters: int):
    if num_clusters <= 256:
        return np.uint8
    elif num_clusters <= 65536:
        return np.uint16
    return np.uint32


def ids_to_object_array(ids, n):
    """Materialize an id iterable into an object ndarray without a Python
    per-element loop (C-level fill). Sequence-typed ids (tuples/lists as a
    single id) fall back to a per-element fill, since numpy would otherwise
    broadcast them."""
    if isinstance(ids, np.ndarray) and ids.dtype == object and len(ids) == n:
        return ids
    if not isinstance(ids, (list, tuple, np.ndarray)):
        ids = list(ids)
    ids_arr = np.empty(n, dtype=object)
    try:
        ids_arr[:] = ids[:n]
    except ValueError:  # per-id sequences: assign one by one
        for i in range(n):
            ids_arr[i] = ids[i]
    return ids_arr


class IncrementalDedup:
    """Exact first-insertion (cell, id) dedup across refreshes.

    Ids intern into a persistent dense-int table so only NEW rows are
    hashed per refresh; seen keys live in one sorted int64 array
    (reference duplicate handling: lopq/lopq/search.py:342-364).
    """

    #: below this many rows the first add interns through the dict directly
    BULK_MIN_ROWS = 100_000

    def __init__(self):
        self._id_index = {}
        self._bulk_uniques = None  # lazily materialized into _id_index
        self._keys = None

    def _materialize(self):
        """Turn a deferred bulk intern result into the intern dict (only
        needed once incremental appends start)."""
        if self._bulk_uniques is not None:
            uniques = self._bulk_uniques
            self._id_index = dict(zip(uniques.tolist(), range(len(uniques))))
            self._bulk_uniques = None

    def _intern_bulk(self, ids_new, idx):
        """First large add: sort-based interning (no Python loop, no
        pandas). Returns False when the ids do not sort together."""
        try:
            uniques, inverse = np.unique(ids_new, return_inverse=True)
        except TypeError:  # mixed-type or None ids: no total order
            return False
        idx[:] = inverse.reshape(-1)
        self._bulk_uniques = uniques
        return True

    def intern(self, ids_new):
        """Dense int64 ids of ``ids_new``, numbered on from the ids seen
        before."""
        n = len(ids_new)
        idx = np.empty(n, dtype=np.int64)
        bulk = (not self._id_index and self._bulk_uniques is None
                and n > self.BULK_MIN_ROWS
                and self._intern_bulk(ids_new, idx))
        if not bulk:
            self._materialize()
            d = self._id_index
            for i, x in enumerate(ids_new):
                v = d.get(x)
                if v is None:
                    v = len(d)
                    d[x] = v
                idx[i] = v
        return idx

    def filter_new(self, cells_new, ids_new):
        """Keep-mask over the new rows: first occurrence of a never-seen
        (cell, id)."""
        n = len(cells_new)
        idx = self.intern(ids_new)
        keys = (np.asarray(cells_new, dtype=np.int64) << 34) | idx
        keep = np.zeros(n, dtype=bool)
        _, first = np.unique(keys, return_index=True)
        keep[first] = True
        if self._keys is not None and len(self._keys):
            pos = np.minimum(np.searchsorted(self._keys, keys),
                             len(self._keys) - 1)
            keep &= self._keys[pos] != keys
        new_keys = keys[keep]
        self._keys = np.sort(new_keys if self._keys is None
                             else np.concatenate([self._keys, new_keys]))
        return keep


def dedup_first_mask(cells, ids):
    """Boolean keep-mask selecting the FIRST occurrence of each (cell, id)
    (the reference's per-row duplicate check on insertion,
    lopq/lopq/search.py:342-364). A fresh ``IncrementalDedup``'s
    ``filter_new``; any hashable ids, mixed types included. Keys that
    would overflow its packing (``cells >= 2**30``, or an id index
    ``>= 2**34``: ids intern densely, so more than ``2**34`` rows) take a
    two-column ``np.unique`` instead, as codes.py:44-47 does."""
    n = len(cells)
    if n == 0:
        return np.ones(0, dtype=bool)
    cells = np.asarray(cells, dtype=np.int64)
    if not isinstance(ids, np.ndarray):     # a list of mixed types must
        ids = ids_to_object_array(ids, n)   # not become one string array
    dedup = IncrementalDedup()
    if int(cells.max()) < (1 << 30) and n <= (1 << 34):
        return dedup.filter_new(cells, ids)
    idx = dedup.intern(ids)
    _, first = np.unique(np.stack([cells, idx], axis=1), axis=0,
                         return_index=True)
    keep = np.zeros(n, dtype=bool)
    keep[first] = True
    return keep
