"""LOPQ model parameters as tensors on an explicit device
(port of columbiaimagesearch_tpu/index/model.py:145-253, 372-387, 403-487,
565-716).

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
``apply_PCA`` is an fp32 ``torch.matmul`` on the model's device over row
chunks (the JAX package runs it in numpy, outside any kernel).

Training (model.py:43-142, 179-186, 424-447): :func:`train` fits the
coarse k-means per half, the local rotations and the subquantizers on the
device (ops/), reusing any parameters given. The port's models are built
from tables, so ``LOPQModel.fit`` and ``LOPQModelPCA.fit`` are
classmethods that take the JAX ``fit`` arguments (plus the constructor's
``V``/``M``/``subquantizer_clusters``, ``parameters=`` for reuse,
``device`` and ``generator``) and return a trained model; the JAX methods
train the instance in place. The single-vector API of the JAX model
(``predict``, ``predict_coarse``/``predict_fine``, ``project``,
``reconstruct``, ``get_subquantizer_distances``, the cell-id helpers;
model.py:565-716) takes numpy and returns numpy, computed on the model's
device. ``export_mat``/``load_mat`` (scipy) and ``export_proto``/
``load_proto`` (protobuf, index/proto.py) read and write the reference's
formats (model.py:346-400); each raises ``ImportError`` naming its package
when it is missing, and the loaders take an explicit ``device``.
"""

from collections import namedtuple

import numpy as np
import torch

from columbiaimagesearch_tpu_torch.device import compute_device
from columbiaimagesearch_tpu_torch.index.encode import lopq_encode
from columbiaimagesearch_tpu_torch.ops.kmeans import (
    STREAMING_THRESHOLD_ELEMENTS,
    fit_kmeans_auto,
)
from columbiaimagesearch_tpu_torch.ops.pca import train_pca
from columbiaimagesearch_tpu_torch.ops.rotations import (
    compute_local_rotations,
    compute_residuals,
    project_residuals_to_local,
)
from columbiaimagesearch_tpu_torch.utils.codes import code_dtype_for

LOPQCode = namedtuple("LOPQCode", ["coarse", "fine"])

#: rows a chunk of ``apply_PCA`` (a [chunk, D_raw] centred transient)
_PCA_CHUNK = 32768


def _derive_seed(random_state, salt: int):
    if random_state is None:
        return None
    return (int(random_state) + salt) % (2**31 - 1)


def _half_on(x, dev):
    """One half of the training data on ``dev``, unless it is too large
    to move whole; then it stays where it is and the ops stream it."""
    if (not isinstance(x, torch.Tensor)
            and np.asarray(x).size > STREAMING_THRESHOLD_ELEMENTS):
        return x
    return torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()


def train(data, V: int = 8, M: int = 4, subquantizer_clusters: int = 256,
          parameters=None, kmeans_coarse_iters: int = 10,
          kmeans_local_iters: int = 20, n_init: int = 10,
          subquantizer_sample_ratio: float = 1.0, random_state=None,
          verbose: bool = False, *, device=None, generator=None):
    """Fit an LOPQ model (model.py:43-142): coarse k-means per half,
    local rotations per coarse cluster, subquantizer k-means over the
    locally projected residuals, reusing any parameters given (``Cs``,
    ``Rs`` with ``mus``; given subquantizers are retrained, as in JAX).

    :param data: [N, D] array or tensor; a device tensor stays on the
        device throughout
    :param random_state: seeds the subsample (numpy, as the reference)
        and, through ``_derive_seed``, every k-means run
    :param generator: a ``torch.Generator`` on ``device`` that every
        k-means run draws from instead of its seed
    :returns: ((C1, C2), (Rs1, Rs2), (mu1, mu2), (subs1, subs2)) tensors
        on the device, ``subs*`` lists of M/2 [S, D/M] codebooks
    """
    del verbose  # stage logging is handled by callers
    dev = compute_device(data, device)
    if not isinstance(data, torch.Tensor):
        data = np.asarray(data, dtype=np.float32)
    Cs = Rs = mus = None
    if parameters is not None:
        Cs, Rs, mus = parameters[:3]
    if Rs is None or mus is None:
        Rs = mus = None
    N, D = data.shape
    halves = [_half_on(data[:, :D // 2], dev), _half_on(data[:, D // 2:], dev)]
    kw = dict(device=dev, generator=generator)

    if Cs is not None:
        Cs = [torch.as_tensor(C, dtype=torch.float32, device=dev) for C in Cs]
    else:
        Cs = [fit_kmeans_auto(h, V, kmeans_coarse_iters, n_init,
                              seed=_derive_seed(random_state, s), **kw)
              for s, h in enumerate(halves)]

    if Rs is not None:
        Rs = [torch.as_tensor(R, dtype=torch.float32, device=dev) for R in Rs]
        mus = [torch.as_tensor(m, dtype=torch.float32, device=dev)
               for m in mus]
        assignments = residuals = None
    else:
        fitted = [compute_local_rotations(h, C, M // 2, device=dev)
                  for h, C in zip(halves, Cs)]
        Rs, mus, assignments, residuals = (list(t) for t in zip(*fitted))

    # Subsample for subquantizer training with the reference's RNG
    # (np.random.RandomState(random_state).choice, model.py:104-106), so
    # matched seeds select identical rows in both packages.
    N2 = int(np.floor(min(subquantizer_sample_ratio, 1.0) * N))
    sample_inds = np.random.RandomState(random_state).choice(N, N2, False)
    si = torch.from_numpy(sample_inds)

    def pick(x):
        return (x[si.to(x.device)] if isinstance(x, torch.Tensor)
                else x[sample_inds])

    if assignments is not None:
        residuals = [pick(r) for r in residuals]
        assignments = [pick(a) for a in assignments]
    else:
        pairs = [compute_residuals(pick(h), C, device=dev)
                 for h, C in zip(halves, Cs)]
        residuals, assignments = (list(t) for t in zip(*pairs))
    projected = [project_residuals_to_local(r, a, R, mu, device=dev)
                 for r, a, R, mu in zip(residuals, assignments, Rs, mus)]
    del residuals, assignments

    subs = []
    for s, p in enumerate(projected):
        width = p.shape[1] // (M // 2)
        subs.append([fit_kmeans_auto(
            p[:, i * width:(i + 1) * width].contiguous(),
            subquantizer_clusters, kmeans_local_iters, n_init,
            seed=_derive_seed(random_state, 100 * (s + 1) + 10 * i), **kw)
            for i in range(M // 2)])
    return tuple(Cs), tuple(Rs), tuple(mus), tuple(subs)


def _stacked(params):
    """``train``'s pairs as the port's stacked tables."""
    Cs, Rs, mus, subs = params
    return (torch.stack(list(Cs)), torch.stack(list(Rs)),
            torch.stack(list(mus)),
            torch.stack([torch.stack(list(h)) for h in subs]))


def _apply_pca(x, P, mu, renorm):
    """``(x - mu) @ P`` over row chunks on ``P``'s device (a host array
    moves a chunk at a time), L2-normalized per row with ``renorm``."""
    dev = P.device
    out = torch.empty((x.shape[0], P.shape[1]), dtype=torch.float32,
                      device=dev)
    for lo in range(0, x.shape[0], _PCA_CHUNK):
        part = torch.as_tensor(x[lo:lo + _PCA_CHUNK], dtype=torch.float32,
                               device=dev)
        part = torch.matmul(part - mu, P)
        if renorm:
            part = part / torch.linalg.vector_norm(part, dim=-1,
                                                   keepdim=True)
        out[lo:lo + _PCA_CHUNK] = part
    return out


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

    @classmethod
    def fit(cls, data, kmeans_coarse_iters=10, kmeans_local_iters=20,
            n_init=10, subquantizer_sample_ratio=1.0, random_state=None,
            verbose=False, *, V=8, M=4, subquantizer_clusters=256,
            parameters=None, device=None, generator=None):
        """A model trained on ``data`` (model.py:179-186): the JAX
        ``fit`` arguments in their order; ``V``, ``M`` and
        ``subquantizer_clusters`` are the JAX constructor's. ``parameters``
        (``Cs``, ``Rs``, ``mus``, ``subs``, any of them None) are reused
        where given; ``V`` is then that of ``Cs``. See :func:`train`."""
        if parameters is not None and parameters[0] is not None:
            V = int(parameters[0][0].shape[0])
        dev = compute_device(data, device)
        params = train(data, V, M, subquantizer_clusters, parameters,
                       kmeans_coarse_iters, kmeans_local_iters, n_init,
                       subquantizer_sample_ratio, random_state, verbose,
                       device=dev, generator=generator)
        return cls(*_stacked(params), device=dev)

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

    # ------------------------------------------------- single-vector API
    # (model.py:565-716): numpy in, numpy out, computed on the model's
    # device; codes carry the dtypes sized to the codebooks, as JAX's.

    def _rows(self, X):
        return torch.as_tensor(np.asarray(X, dtype=np.float32)).to(
            self.device)

    def predict(self, x):
        """Code one vector: ``LOPQCode(coarse tuple, fine tuple)``; a
        ``LOPQModelPCA`` projects it first (its ``predict_batch``)."""
        coarse, fine = self.predict_batch(np.asarray(x, np.float32)[None, :])
        return LOPQCode(tuple(coarse[0]), tuple(fine[0]))

    def predict_coarse(self, x):
        """The coarse codes of one vector (a pair)."""
        X = self._rows(np.asarray(x, np.float32)[None, :])
        Dh = int(self.Cs.shape[2])
        out = []
        for s in range(2):
            xs = X[:, s * Dh:(s + 1) * Dh]
            c2 = (self.Cs[s] * self.Cs[s]).sum(dim=1)
            d2 = c2[None, :] - 2.0 * (xs @ self.Cs[s].T)
            out.append(int(torch.argmin(d2, dim=1)[0]))
        return tuple(np.asarray(out).astype(code_dtype_for(self.V)))

    def predict_fine(self, x, coarse_codes=None):
        """The fine codes of one vector under ``coarse_codes`` (its own
        when None)."""
        x = np.asarray(x, dtype=np.float32)
        if coarse_codes is None:
            coarse_codes = self.predict_coarse(x)
        px = torch.as_tensor(self.project_batch(
            x[None, :], np.asarray(coarse_codes)[None, :])).to(self.device)
        F, Dsub = self.num_fine_splits, int(self.subs.shape[3])
        pr = px.reshape(1, 2, F, Dsub)
        fine = []
        for s in range(2):
            s2 = (self.subs[s] * self.subs[s]).sum(dim=2)        # [F, S]
            prod = torch.einsum("nfd,fsd->nfs", pr[:, s], self.subs[s])
            fine.extend(torch.argmin(s2[None] - 2.0 * prod,
                                     dim=2)[0].tolist())
        return tuple(np.asarray(fine).astype(
            code_dtype_for(self.subquantizer_clusters)))

    def project(self, x, coarse_codes, coarse_split=None):
        """One vector in its local residual frame: ``R_c (x_s - C_c -
        mu_c)`` for one split, or both halves concatenated."""
        x = np.asarray(x, dtype=np.float32)
        if coarse_split is not None:
            Dh = int(self.Cs.shape[2])
            s, c = int(coarse_split), int(coarse_codes[coarse_split])
            r = self._rows(x[s * Dh:(s + 1) * Dh]) - self.Cs[s, c] \
                - self.mus[s, c]
            return (self.Rs[s, c] @ r).cpu().numpy()
        return self.project_batch(x[None, :],
                                  np.asarray(coarse_codes)[None, :])[0]

    def project_batch(self, X, coarse):
        """[N, D] rows in their local frames given coarse codes [N, 2]."""
        X = self._rows(X)
        a = torch.as_tensor(np.asarray(coarse, dtype=np.int64)).to(
            self.device)
        Dh = int(self.Cs.shape[2])
        outs = []
        for s in range(2):
            r = (X[:, s * Dh:(s + 1) * Dh] - self.Cs[s][a[:, s]]
                 - self.mus[s][a[:, s]])
            outs.append(torch.bmm(self.Rs[s][a[:, s]], r[:, :, None])[:, :, 0])
        return torch.cat(outs, dim=1).cpu().numpy()

    def reconstruct(self, codes):
        """One code (coarse, fine) back to an approximate vector."""
        coarse, fine = codes
        return self.reconstruct_batch(np.asarray(coarse)[None, :],
                                      np.asarray(fine)[None, :])[0]

    def reconstruct_batch(self, coarse, fine):
        """[N, 2] coarse + [N, M] fine codes -> [N, D]:
        ``R_c^T sub + mu_c + C_c`` per half."""
        a = torch.as_tensor(np.asarray(coarse, dtype=np.int64)).to(
            self.device)
        fc = torch.as_tensor(np.asarray(fine, dtype=np.int64)).to(
            self.device)
        F = self.num_fine_splits
        outs = []
        for s in range(2):
            sx = torch.cat([self.subs[s, f][fc[:, s * F + f]]
                            for f in range(F)], dim=1)         # [N, Dh]
            Rt = self.Rs[s][a[:, s]].transpose(1, 2)
            r = torch.bmm(Rt, sx[:, :, None])[:, :, 0]
            outs.append(r + self.mus[s][a[:, s]] + self.Cs[s][a[:, s]])
        return torch.cat(outs, dim=1).cpu().numpy()

    def get_subquantizer_distances(self, x, coarse_codes, coarse_split=None):
        """Squared distances of the locally projected query to every
        subquantizer centroid (the ADC tables): a list of [S] arrays, one
        per subquantizer of the requested split(s)."""
        splits = ([coarse_split] if coarse_split is not None else range(2))
        F, Dsub = self.num_fine_splits, int(self.subs.shape[3])
        dists = []
        for s in splits:
            px = torch.as_tensor(self.project(x, coarse_codes,
                                              coarse_split=s)).to(self.device)
            for f in range(F):
                d = px[f * Dsub:(f + 1) * Dsub][None, :] - self.subs[s, f]
                dists.append((d * d).sum(dim=1).cpu().numpy())
        return dists

    def get_cell_id_for_coarse_codes(self, coarse_codes):
        return int(coarse_codes[1]) + int(coarse_codes[0]) * self.V

    def get_coarse_codes_for_cell_id(self, cell_id):
        return (int(cell_id) // self.V, int(cell_id) % self.V)

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

    def export_mat(self, filename):
        """The LOPQ tables as a MATLAB .mat file, in the reference's layout
        (lopq/lopq/model.py:712-728; JAX model.py:346-357): ``Cs``,
        ``Rs``, ``mus``, ``subs`` stacked, plus ``V`` and ``M``. A PCA
        model writes its LOPQ tables only, as the JAX package does.

        :raises ImportError: scipy is not installed
        """
        savemat = _scipy_io().savemat
        f = self._npz_fields()
        savemat(filename, {k: f[k] for k in ("Cs", "Rs", "mus", "subs", "V",
                                              "M")})

    @staticmethod
    def load_mat(filename, *, device):
        """An ``LOPQModel`` on ``device`` from a .mat file of either
        package's ``export_mat`` (JAX model.py:359-370)."""
        d = _scipy_io().loadmat(filename)
        M = int(d["M"][0][0])
        V = int(d["V"][0][0])
        Cs = np.asarray(d["Cs"])
        Dh = Cs.shape[-1]
        subs = np.asarray(d["subs"])
        return LOPQModel(Cs.reshape(2, V, Dh),
                         np.asarray(d["Rs"]).reshape(2, V, Dh, Dh),
                         np.asarray(d["mus"]).reshape(2, V, Dh),
                         subs.reshape((2, M // 2) + subs.shape[-2:]),
                         device=device)

    def export_proto(self, f):
        """The LOPQ tables in the reference's protobuf wire format, to a
        path or a binary file object (index/proto.py; JAX
        model.py:389-394).

        :raises ImportError: protobuf is not installed
        """
        from columbiaimagesearch_tpu_torch.index import proto

        proto.export_proto(self, f)

    @staticmethod
    def load_proto(filename, *, device):
        """An ``LOPQModel`` on ``device`` from a proto file of either
        package (JAX model.py:396-400).

        :raises ImportError: protobuf is not installed
        """
        from columbiaimagesearch_tpu_torch.index import proto

        return proto.load_proto(filename, device=device)

    def __reduce__(self):
        return _unpickle_model, (type(self), self._npz_fields())


def _scipy_io():
    try:
        import scipy.io
    except ImportError as e:
        raise ImportError(
            "LOPQ .mat I/O needs the scipy package (scipy.io), which is not "
            f"installed: {e}") from e
    return scipy.io


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

    @staticmethod
    def fit_pca(data, pca_dims=256, pca_subsample=None, *, device=None):
        """PCA of the first ``pca_subsample`` rows (model.py:424-430):
        ``(pca_P [D_raw, pca_dims], pca_mu [D_raw])`` on the device. The
        JAX method sets them on the instance; here they go to
        :meth:`fit` or the constructor."""
        params, _ = train_pca(data, pca_dims, pca_subsample, device=device)
        return params["P"], params["mu"]

    @classmethod
    def fit(cls, data, pca_dims=256, kmeans_coarse_iters=10,
            kmeans_local_iters=20, n_init=10, subquantizer_sample_ratio=1.0,
            random_state=None, verbose=False, pca_subsample=None,
            apply_pca=True, train_pca=True, *, V=8, M=4,
            subquantizer_clusters=256, renorm=False, parameters=None,
            device=None, generator=None):
        """A PCA model trained on raw ``data`` (model.py:432-447): the
        JAX ``fit`` arguments in their order, then the constructor's.
        ``parameters`` is the JAX six-tuple (``Cs``, ``Rs``, ``mus``,
        ``subs``, ``pca_P``, ``pca_mu``); with ``train_pca`` a given PCA
        raises, as in JAX. See :meth:`LOPQModel.fit`."""
        dev = compute_device(data, device)
        base, pca_P, pca_mu = (None, None, None)
        if parameters is not None:
            base, pca_P, pca_mu = parameters[:4], parameters[4], parameters[5]
            if base[0] is not None:
                V = int(base[0][0].shape[0])
        if train_pca:
            if pca_P is not None and pca_mu is not None:
                raise ValueError("You are trying to retrain PCA...")
            pca_P, pca_mu = cls.fit_pca(data, pca_dims, pca_subsample,
                                        device=dev)
        pca_P = torch.as_tensor(pca_P, dtype=torch.float32, device=dev)
        pca_mu = torch.as_tensor(pca_mu, dtype=torch.float32, device=dev)
        if apply_pca:
            data = _apply_pca(data, pca_P, pca_mu, renorm)
        params = train(data, V, M, subquantizer_clusters, base,
                       kmeans_coarse_iters, kmeans_local_iters, n_init,
                       subquantizer_sample_ratio, random_state, verbose,
                       device=dev, generator=generator)
        return cls(*_stacked(params), pca_P, pca_mu, renorm, device=dev)

    def apply_PCA(self, x):
        """PCA-project (and with ``renorm`` L2-normalize) rows: ``[N, D_raw]``
        array or tensor -> ``[N, D]`` float32 tensor on the model's device
        (model.py:449-457), over row chunks; one [D_raw] row gives [D]."""
        if not isinstance(x, (torch.Tensor, np.ndarray)):
            x = np.asarray(x, dtype=np.float32)
        if x.ndim == 1:
            return _apply_pca(x[None], self.pca_P, self.pca_mu,
                              self.renorm)[0]
        return _apply_pca(x, self.pca_P, self.pca_mu, self.renorm)

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
