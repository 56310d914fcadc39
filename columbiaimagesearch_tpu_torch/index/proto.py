"""Protobuf import/export of LOPQ models (copy of
columbiaimagesearch_tpu/index/proto.py:1-89, over the port's tensors).

Wire-compatible with the reference's format (reference:
lopq/lopq/model.py:748-820 ``export_proto``/``load_proto`` and the
com.flickr.vision.lopq schema), with its array ordering: ``Rs``/``mus``
chained across both coarse splits (2V entries, first split then second),
``subs`` across both splits' fine splits (M entries). A model written by
either package is byte-identical.

Needs the ``protobuf`` package; without it both functions raise
``ImportError`` naming it.
"""

import numpy as np


def _pb2():
    try:
        from columbiaimagesearch_tpu_torch.index.protos import lopq_model_pb2
    except ImportError as e:
        raise ImportError(
            "LOPQ proto I/O needs the protobuf package (google.protobuf), "
            f"which is not installed: {e}") from e
    return lopq_model_pb2


def _host(t):
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                      else t, dtype=np.float32)


def _fill_matrix(m, a):
    a = np.asarray(a, dtype=np.float32)
    m.values.extend(a.reshape(-1, order="C").tolist())
    m.shape.extend(a.shape)
    return m


def _fill_vector(v, a):
    v.values.extend(np.asarray(a, dtype=np.float32).reshape(-1).tolist())
    return v


def export_proto(model, f):
    """Write the model's LOPQ tables in the reference's protobuf wire
    format to a path or a binary file object (a PCA model's projection is
    not part of the schema)."""
    pb2 = _pb2()
    Cs, Rs, mus, subs = (_host(model.Cs), _host(model.Rs), _host(model.mus),
                         _host(model.subs))
    p = pb2.LOPQModelParams()
    p.D = 2 * Cs.shape[2]
    p.V = model.V
    p.M = model.M
    p.num_subquantizers = model.subquantizer_clusters
    for C in Cs:
        _fill_matrix(p.Cs.add(), C)
    for split in Rs:
        for R in split:
            _fill_matrix(p.Rs.add(), R)
    for split in mus:
        for mu in split:
            _fill_vector(p.mus.add(), mu)
    for split in subs:
        for sub in split:
            _fill_matrix(p.subs.add(), sub)
    data = p.SerializeToString()
    if isinstance(f, str):
        with open(f, "wb") as fh:
            fh.write(data)
    else:
        f.write(data)


def load_proto(filename, *, device):
    """An ``LOPQModel`` on ``device`` from the reference's protobuf
    format."""
    from columbiaimagesearch_tpu_torch.index.model import LOPQModel

    pb2 = _pb2()
    p = pb2.LOPQModelParams()
    with open(filename, "rb") as f:
        p.ParseFromString(f.read())

    def mats(seq):
        return [np.array(m.values, dtype=np.float32).reshape(tuple(m.shape))
                for m in seq]

    def halves(seq):
        n = len(seq) // 2
        return np.stack([np.stack(seq[:n]), np.stack(seq[n:])])

    Cs = np.stack(mats(p.Cs))
    Rs = halves(mats(p.Rs))
    mus = halves([np.array(mu.values, dtype=np.float32) for mu in p.mus])
    subs = halves(mats(p.subs))
    return LOPQModel(Cs, Rs, mus, subs, device=device)
