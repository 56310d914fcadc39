"""CSR multi-index construction in PyTorch
(port of columbiaimagesearch_tpu/index/csr.py:22-81, 159-173).

Codes sorted by cell id (stable argsort, so rows of one cell keep their
insertion order) plus a ``[V^2 + 1]`` int32 offsets table, or in wide-V
mode only the sorted cell ids (the table would take 268 MB at V=8192);
unoccupied capacity rows carry the sentinel cell ``V*V``, which sorts after
every real cell and is left out of the offsets. ``merge_append_csr`` (used by the JAX
searcher only above 32M rows of capacity, where XLA's sort was slow) is
not ported: ``torch.sort`` refreshes 8,192 rows at 41,943,040 rows of
capacity in milliseconds on the H100 (ROADMAP.md, "Do not port").

Where the JAX functions donated their capacity buffers, the port writes
into them in place.
"""

import torch


def _sentinel(V):
    return V * V


def _offsets(cells, V):
    """[V^2 + 1] int32 offsets of the real (non-sentinel) cells."""
    counts = torch.bincount(cells[cells < _sentinel(V)].long(),
                            minlength=V * V)
    zero = torch.zeros(1, dtype=torch.int64, device=cells.device)
    # cumsum promotes to int64; the table is int32 like csr.py:42, 80.
    return torch.cat([zero, torch.cumsum(counts, 0)]).to(torch.int32)


def build_csr(coarse, fine, V: int):
    """Build the CSR index.

    :param coarse: [N, 2] integer coarse codes
    :param fine: [N, M] integer fine codes
    :returns: (codes [N, M] uint8 cell-sorted, cell_start [V^2+1] int32,
        order [N] int32 — original row index of each sorted row)
    """
    cells = coarse[:, 0].long() * V + coarse[:, 1].long()
    _, order = torch.sort(cells, stable=True)
    codes = fine.to(torch.uint8)[order]
    return codes, _offsets(cells, V), order.to(torch.int32)


def append_and_build_csr(dev_cells, dev_fine, new_cells, new_fine, offset,
                         V: int, wide: bool = False):
    """Write a chunk into the capacity buffers at ``offset`` and rebuild
    the cell-sorted view (csr.py:47-81). With ``wide`` (wide-V mode) no
    dense offsets table is built, ``cell_start`` is None, and queries
    look buckets up in ``cells_sorted`` (``torch.searchsorted``).

    :param dev_cells: [cap] int32 cell ids, sentinel V*V on unoccupied
        rows (written in place)
    :param dev_fine: [cap, M] uint8 fine codes (written in place)
    :param new_cells: [k] int32 chunk (sentinel-padded tail allowed)
    :param new_fine: [k, M] uint8 chunk
    :param offset: number of occupied rows before the append
    :returns: (cells_sorted [cap] int32, codes_sorted [cap, M] uint8,
        cell_start [V^2+1] int32 or None (``wide``), order [cap] int32 —
        insertion index of each sorted row)
    """
    k = new_cells.shape[0]
    if offset + k > dev_cells.shape[0]:
        raise ValueError(f"append of {k} rows at {offset} overflows "
                         f"capacity {dev_cells.shape[0]}")
    # In place: the JAX function donates these two buffers (csr.py:47).
    dev_cells[offset:offset + k] = new_cells
    dev_fine[offset:offset + k] = new_fine
    cells_sorted, order = torch.sort(dev_cells, stable=True)
    codes = dev_fine[order]
    cell_start = None if wide else _offsets(dev_cells, V)
    return cells_sorted, codes, cell_start, order.to(torch.int32)


def append_rows(buf, chunk, offset):
    """Write a row chunk into a capacity buffer at ``offset``, in place
    (the JAX ``append_rows`` donates ``buf``, csr.py:159). Used for the
    insertion-order rerank feature store, whose rows never reorder."""
    k = chunk.shape[0]
    if offset + k > buf.shape[0]:
        raise ValueError(f"append of {k} rows at {offset} overflows "
                         f"capacity {buf.shape[0]}")
    buf[offset:offset + k] = chunk
    return buf
