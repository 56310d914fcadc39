"""PCA training as one covariance product + ``torch.linalg.eigh``
(port of columbiaimagesearch_tpu/ops/pca.py:1-67).

The covariance is the reference estimator in its centred form,
``(Xc^T Xc + outer(mu, mu)) / (n - 1)``, accumulated in fp32 over row
chunks (TF32 off, device.py) so that no centred copy of the data is
materialized; the eigendecomposition runs on the data's device, and the
kept eigenvectors are permuted by ``eigenvalue_allocation(2, E)`` as in the
reference, so the two coarse halves carry balanced variance.
"""

import torch

from columbiaimagesearch_tpu_torch.device import compute_device
from columbiaimagesearch_tpu_torch.ops.eigen_alloc import eigenvalue_allocation

#: rows a chunk of the covariance product
_COV_CHUNK = 65536


def _pca_cov(X):
    n, D = X.shape
    mu = X.mean(dim=0)
    A = torch.outer(mu, mu)
    for lo in range(0, n, _COV_CHUNK):
        xc = X[lo:lo + _COV_CHUNK] - mu
        A.addmm_(xc.T, xc)
    return mu, A / (n - 1)


def train_pca(data, pca_dims: int = 256, pca_subsample: int | None = None,
              *, device=None):
    """Train PCA on the first ``pca_subsample`` rows (all when None);
    returns (params dict, pca_dims) like the reference (pca.py:35-67).

    params: ``mu`` [D] mean, ``P`` [D, pca_dims] projection, ``E`` kept
    eigenvalues (ascending), ``A`` [D, D] covariance (tensors on the
    device), ``c`` the sample count.
    """
    dev = compute_device(data, device)
    if pca_subsample:
        data = data[: min(int(pca_subsample), data.shape[0])]
    data = torch.as_tensor(data, dtype=torch.float32, device=dev)
    count, D = data.shape
    pca_dims = min(pca_dims, D)
    mu, A = _pca_cov(data)
    # eigh returns ascending eigenvalues, like numpy (the reference relies
    # on it).
    E, P = torch.linalg.eigh(A)
    E, P = E[-pca_dims:], P[:, -pca_dims:]
    perm = eigenvalue_allocation(2, E.cpu().numpy())
    P = P[:, torch.from_numpy(perm).to(dev)].contiguous()
    return {"mu": mu, "P": P, "E": E, "A": A, "c": count}, pca_dims
