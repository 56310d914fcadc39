"""LOPQ model parameters as tensors on an explicit device
(port of columbiaimagesearch_tpu/index/model.py:145-253, 372-387, 403-487).

The port's model is a parameter container: ``Cs [2, V, Dh]``,
``Rs [2, V, Dh, Dh]`` (applied as ``R @ r``), ``mus [2, V, Dh]`` and
``subs [2, F, S, Dsub]``, all float32 on ``device``. ``predict_batch``
encodes through :func:`index.encode.lopq_encode`. ``export_npz``/
``load_npz`` use the JAX package's npz layout (model.py:372-387), and
:meth:`LOPQModel.from_numpy` takes a JAX ``LOPQModel``'s numpy tuples
(``model.Cs, model.Rs, model.mus, model.subquantizers``), so both packages
can run on the same weights. A pickled model (the facade's storer keeps
one) holds the same npz fields as numpy arrays and unpickles as a host
(CPU) model, whatever device it was saved from and whether or not a card
is present; whoever runs it places it with :meth:`LOPQModel.to` (the
``SearcherLOPQ`` facade moves it to its own device).

:class:`LOPQModelPCA` adds the PCA front end of the release model
(``lopq_pca``): ``pca_P [D_raw, D]``, ``pca_mu [D_raw]`` and ``renorm``.
``apply_PCA`` is one fp32 ``torch.matmul`` on the model's device (the JAX
package runs it in numpy, outside any kernel). Training (``fit``,
``fit_pca``) and ``.mat``/proto I/O are not ported yet (ROADMAP.md).
"""

from collections import namedtuple

import numpy as np
import torch

from columbiaimagesearch_tpu_torch.index.encode import lopq_encode
from columbiaimagesearch_tpu_torch.utils.codes import code_dtype_for

LOPQCode = namedtuple("LOPQCode", ["coarse", "fine"])


class LOPQModel:
    """LOPQ parameters on one device."""

    def __init__(self, Cs, Rs, mus, subs, *, device):
        """:param Cs/Rs/mus/subs: stacked arrays or tensors (see module
        docstring for shapes); copied to ``device`` as float32."""
        self.device = torch.device(device)
        self.Cs = torch.as_tensor(Cs, dtype=torch.float32).to(
            self.device).contiguous()
        self.Rs = torch.as_tensor(Rs, dtype=torch.float32).to(
            self.device).contiguous()
        self.mus = torch.as_tensor(mus, dtype=torch.float32).to(
            self.device).contiguous()
        self.subs = torch.as_tensor(subs, dtype=torch.float32).to(
            self.device).contiguous()
        if self.Cs.shape[0] != 2 or self.subs.shape[0] != 2:
            raise ValueError("LOPQ models have exactly two coarse splits")
        self.V = int(self.Cs.shape[1])
        self.num_fine_splits = int(self.subs.shape[1])
        self.M = 2 * self.num_fine_splits
        self.subquantizer_clusters = int(self.subs.shape[2])

    @classmethod
    def from_numpy(cls, Cs, Rs, mus, subs, *, device):
        """From the JAX package's parameter tuples: ``Cs``/``Rs``/``mus``
        are pairs of arrays, ``subs`` a pair of length-F lists of
        [S, Dsub] codebooks (``LOPQModel.subquantizers``)."""
        return cls(np.stack(Cs), np.stack(Rs), np.stack(mus),
                   np.stack([np.stack(h) for h in subs]), device=device)

    # --------------------------------------------------------------- encode

    def predict_batch(self, X):
        """Code N vectors at once.

        :param X: [N, D] array or tensor
        :returns: (coarse [N, 2] and fine [N, M] numpy arrays, dtypes sized
            to the codebook cardinalities)
        """
        X = torch.as_tensor(X, dtype=torch.float32).to(self.device)
        coarse, fine = lopq_encode(self.Cs, self.Rs, self.mus, self.subs, X)
        return (coarse.cpu().numpy().astype(code_dtype_for(self.V)),
                fine.cpu().numpy().astype(
                    code_dtype_for(self.subquantizer_clusters)))

    # ---------------------------------------------------------- persistence

    def _npz_fields(self):
        return dict(Cs=self.Cs.cpu().numpy(), Rs=self.Rs.cpu().numpy(),
                    mus=self.mus.cpu().numpy(), subs=self.subs.cpu().numpy(),
                    V=self.V, M=self.M)

    @classmethod
    def _from_fields(cls, d, *, device):
        return cls(d["Cs"], d["Rs"], d["mus"], d["subs"], device=device)

    def to(self, device):
        """This model on ``device``: itself when it is there already,
        else a copy of the same type."""
        device = torch.device(device)
        if device == self.Cs.device:
            return self
        return type(self)._from_fields(self._npz_fields(), device=device)

    def export_npz(self, filename):
        np.savez_compressed(filename, **self._npz_fields())

    @classmethod
    def load_npz(cls, filename, *, device):
        with np.load(filename) as d:
            return cls._from_fields(d, device=device)

    def __reduce__(self):
        return _unpickle_model, (type(self), self._npz_fields())


class LOPQModelPCA(LOPQModel):
    """LOPQ over a PCA-reduced space: ``predict_batch`` applies PCA first
    (columbiaimagesearch_tpu/index/model.py:403-487)."""

    def __init__(self, Cs, Rs, mus, subs, pca_P, pca_mu, renorm=False, *,
                 device):
        """:param pca_P: [D_raw, D] projection; ``pca_mu``: [D_raw] mean;
        ``renorm``: L2-normalize each projected row."""
        super().__init__(Cs, Rs, mus, subs, device=device)
        self.pca_P = torch.as_tensor(pca_P, dtype=torch.float32).to(
            self.device).contiguous()
        self.pca_mu = torch.as_tensor(pca_mu, dtype=torch.float32).to(
            self.device).contiguous()
        D = 2 * int(self.Cs.shape[2])
        if (self.pca_P.ndim != 2 or self.pca_P.shape[1] != D
                or tuple(self.pca_mu.shape) != (self.pca_P.shape[0],)):
            raise ValueError(
                f"pca_P {tuple(self.pca_P.shape)} and pca_mu "
                f"{tuple(self.pca_mu.shape)} do not map onto D={D}")
        self.renorm = bool(renorm)

    @classmethod
    def from_numpy(cls, Cs, Rs, mus, subs, pca_P, pca_mu, renorm=False, *,
                   device):
        """From a JAX ``LOPQModelPCA``: its parameter tuples (see
        :meth:`LOPQModel.from_numpy`) plus ``pca_P``, ``pca_mu`` and
        ``renorm``."""
        return cls(np.stack(Cs), np.stack(Rs), np.stack(mus),
                   np.stack([np.stack(h) for h in subs]), pca_P, pca_mu,
                   renorm, device=device)

    def apply_PCA(self, x):
        """PCA-project (and with ``renorm`` L2-normalize) rows: ``[N, D_raw]``
        array or tensor -> ``[N, D]`` float32 tensor on the model's device
        (model.py:449-457)."""
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        out = torch.matmul(x - self.pca_mu, self.pca_P)
        if self.renorm:
            out = out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)
        return out

    def predict_batch(self, X):
        """Code N raw vectors: PCA first, then the LOPQ encoder."""
        return super().predict_batch(self.apply_PCA(X))

    def _npz_fields(self):
        return dict(super()._npz_fields(), pca_P=self.pca_P.cpu().numpy(),
                    pca_mu=self.pca_mu.cpu().numpy(), renorm=self.renorm)

    @classmethod
    def _from_fields(cls, d, *, device):
        return cls(d["Cs"], d["Rs"], d["mus"], d["subs"], d["pca_P"],
                   d["pca_mu"], bool(d["renorm"]), device=device)


def _unpickle_model(cls, fields):
    return cls._from_fields(fields, device="cpu")
