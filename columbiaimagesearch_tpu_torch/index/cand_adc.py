"""Per-candidate ADC distances from rotated residuals, the table-free route
of the probed query (step 4 of index/query.py ``lopq_query`` on rungs that
build no tables; port of columbiaimagesearch_tpu/index/tpu_query.py:
597-609): the CUDA kernel's wrapper and its plain PyTorch version.

For query n and valid slot j (``j < n_valid[n]``), with the probed
clusters ``c_s = isel_s[n, slot_s[n, j]]`` and the codes ``codes[rows[n,
j]]``: the sum over both halves and their F fine splits of
``||R_s[c_s] ((x_s - C_s[c_s]) - mu_s[c_s])_f - subs[s, f, code_f]||^2``,
and ``+inf`` on the other slots.

:func:`cand_dists` takes :func:`cand_dists_plain` for CPU tensors; on a
CUDA tensor it launches or raises, never falls back. On the card it writes
every (half, cluster, query) residual once into ``[2, V, NQ, Dh]``
(``csrc/cand_adc.cu`` ``cand_residuals``), rotates them with one fp32
batched GEMM against each ``R_s`` transposed (TF32 off), and scores the
candidates in one kernel (``cand_adc``) that reads each slot's codes and
rotated residual rows where they lie, so no ``[NQ, Q, Dh]`` gather or
per-split temporary is made. ``cand_dists.launches`` counts the calls that
launched the kernel.
"""

import ctypes

import torch

from columbiaimagesearch_tpu_torch.device import sm_count
from columbiaimagesearch_tpu_torch.index.lut import _check
from columbiaimagesearch_tpu_torch.kernels.build import load_library

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _half_dists(x_s, C_s, R_s, mu_s, sub_s, isel, slot, cc):
    """Candidate ADC distances of one half from rotated residuals: rotate
    the residual of every cluster, gather each candidate's, and sum the
    squared subvector differences (tpu_query.py:597-609)."""
    F, Dsub = sub_s.shape[0], sub_s.shape[2]
    NQ, Q = slot.shape
    r = x_s[:, None, :] - C_s[None] - mu_s[None]             # [NQ, V, Dh]
    pr_all = torch.einsum("vij,nvj->nvi", R_s, r)            # [NQ, V, Dh]
    clus = isel.gather(1, slot)                               # [NQ, Q]
    pr = pr_all.gather(1, clus[:, :, None].expand(NQ, Q, pr_all.shape[2]))
    acc = torch.zeros((NQ, Q), dtype=torch.float32, device=x_s.device)
    for f in range(F):
        diff = pr[:, :, f * Dsub:(f + 1) * Dsub] - sub_s[f][cc[:, :, f]]
        acc = acc + (diff * diff).sum(dim=-1)
    return acc


def cand_dists_plain(x2, Cs, Rs, mus, subs, codes, rows, isel0, isel1, slot0,
                     slot1, n_valid):
    """Plain PyTorch version: each half through :func:`_half_dists` (every
    cluster's rotated residual, a gather of each candidate's, a masked sum
    a fine split), half 0 plus half 1, ``+inf`` past ``n_valid``.

    :param x2: [NQ, 2, Dh] float32 query halves
    :param Cs/mus: [2, V, Dh]; Rs: [2, V, Dh, Dh]; subs: [2, F, S, Dsub]
    :param codes: [N, M] uint8 code store (M = 2F)
    :param rows: [NQ, Q] integer rows of ``codes``
    :param isel0/isel1: [NQ, Bi] integer probed cluster ids of each half
    :param slot0/slot1: [NQ, Q] integer ranks into ``isel0``/``isel1``
    :param n_valid: [NQ] integer valid slots of each query (at most Q)
    :returns: [NQ, Q] float32
    """
    F = subs.shape[1]
    Q = rows.shape[1]
    cand = codes[rows].long()                                 # [NQ, Q, M]
    dists = (_half_dists(x2[:, 0], Cs[0], Rs[0], mus[0], subs[0], isel0,
                         slot0, cand[:, :, :F])
             + _half_dists(x2[:, 1], Cs[1], Rs[1], mus[1], subs[1], isel1,
                           slot1, cand[:, :, F:]))
    valid = torch.arange(Q, device=rows.device)[None, :] < n_valid[:, None]
    return torch.where(valid, dists, float("inf"))


def _library():
    lib = load_library("cand_adc")
    fn = lib.cand_adc
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_L, _L, _I, _P, _P, _L, _I, _P, _P, _P] + (
            [_I] * 7 + [_P])
        fn.restype = _I
        lib.cand_residuals.argtypes = [_P] * 4 + [_I] * 3 + [_P]
        lib.cand_residuals.restype = _I
    return lib


def _check_ids(name, t, shape, dev):
    """An int64 id table on ``dev`` with unit column stride (a row stride
    of its own, at least its width, is allowed: the top-B slices are
    views)."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != torch.int64:
        raise TypeError(f"{name} has dtype {t.dtype}, expected torch.int64")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dim() == 2 and (t.stride(1) != 1 or t.stride(0) < t.shape[1]):
        raise ValueError(f"{name} needs unit column stride, got "
                         f"{t.stride()}")


def rotated_residuals(x2, Cs, Rs, mus):
    """``pr[s, v, n] = R_s[v] ((x2[n, s] - C_s[v]) - mu_s[v])`` on the card:
    the residuals in one pass (``cand_residuals``) into [2, V, NQ, Dh],
    then one fp32 batched GEMM over the 2V clusters against each rotation
    transposed, so a (half, cluster, query) row is contiguous.

    :returns: [2, V, NQ, Dh] float32
    """
    NQ, V, Dh = x2.shape[0], Cs.shape[1], Cs.shape[2]
    dev, f32 = x2.device, torch.float32
    if dev.type != "cuda":
        raise ValueError(f"rotated_residuals: unsupported device {dev}")
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    if Dh % 4:
        raise ValueError(f"cand_residuals reads float4 rows: Dh={Dh} must "
                         f"be a multiple of 4")
    _check("x2", x2, f32, (NQ, 2, Dh), dev, aligned=True)
    _check("Cs", Cs, f32, (2, V, Dh), dev, aligned=True)
    _check("mus", mus, f32, (2, V, Dh), dev, aligned=True)
    _check("Rs", Rs, f32, (2, V, Dh, Dh), dev)
    r = torch.empty((2, V, NQ, Dh), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().cand_residuals(x2.data_ptr(), Cs.data_ptr(),
                                        mus.data_ptr(), r.data_ptr(), NQ, V,
                                        Dh, stream)
    if err != 0:
        raise RuntimeError(f"cand_residuals launch failed: CUDA error {err}")
    pr = torch.bmm(r.view(2 * V, NQ, Dh),
                   Rs.view(2 * V, Dh, Dh).transpose(1, 2))
    return pr.view(2, V, NQ, Dh)


def cand_adc(pr, subs, codes, rows, isel0, isel1, slot0, slot1, n_valid):
    """The kernel alone: candidate distances from rotated residuals ``pr``
    [2, V, NQ, Dh] (:func:`rotated_residuals`); the other arguments as
    :func:`cand_dists_plain`'s, every id int64.

    :returns: [NQ, Q] float32
    """
    dev = pr.device
    if dev.type != "cuda":
        raise ValueError(f"cand_adc: unsupported device {dev}")
    _, V, NQ, Dh = pr.shape
    F, S, Dsub = subs.shape[1], subs.shape[2], subs.shape[3]
    Q = rows.shape[1]
    N, M = codes.shape
    if F * Dsub != Dh or M != 2 * F:
        raise ValueError(f"subs {tuple(subs.shape)} and codes "
                         f"{tuple(codes.shape)} do not tile Dh={Dh}")
    if Dsub % 4:
        raise ValueError(f"cand_adc reads float4 rows: Dsub={Dsub} must be "
                         f"a multiple of 4")
    if not 1 <= S <= 256:
        raise ValueError(f"S={S}: uint8 codes need 1 <= S <= 256")
    f32 = torch.float32
    _check("pr", pr, f32, (2, V, NQ, Dh), dev, aligned=True)
    _check("subs", subs, f32, (2, F, S, Dsub), dev, aligned=True)
    _check("codes", codes, torch.uint8, (N, M), dev)
    Bi = isel0.shape[1]
    for name, t, shape in (("rows", rows, (NQ, Q)), ("slot0", slot0, (NQ, Q)),
                           ("slot1", slot1, (NQ, Q)),
                           ("n_valid", n_valid, (NQ,))):
        _check(name, t, torch.int64, shape, dev)
    _check_ids("isel0", isel0, (NQ, Bi), dev)
    _check_ids("isel1", isel1, (NQ, Bi), dev)
    out = torch.empty((NQ, Q), dtype=f32, device=dev)
    # The library launches on the calling thread's current device: make
    # it the inputs' (a shard on cuda:1 must not launch on cuda:0).
    with torch.cuda.device(dev):
        sms = sm_count(dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().cand_adc(
            rows.data_ptr(), slot0.data_ptr(), slot1.data_ptr(),
            isel0.data_ptr(), isel1.data_ptr(), isel0.stride(0),
            isel1.stride(0), Bi, n_valid.data_ptr(), codes.data_ptr(), N, M,
            pr.data_ptr(), subs.data_ptr(), out.data_ptr(), NQ, Q, V, F, S,
            Dsub, sms, stream)
    if err != 0:
        raise RuntimeError(f"cand_adc launch failed: CUDA error {err}")
    return out


def cand_dists(x2, Cs, Rs, mus, subs, codes, rows, isel0, isel1, slot0,
               slot1, n_valid):
    """Candidate ADC distances of a wave from rotated residuals (arguments
    as :func:`cand_dists_plain`'s; on the card every id int64).

    :returns: [NQ, Q] float32, ``+inf`` on the slots past ``n_valid``
    """
    if x2.device.type == "cpu":
        return cand_dists_plain(x2, Cs, Rs, mus, subs, codes, rows, isel0,
                                isel1, slot0, slot1, n_valid)
    if x2.device.type != "cuda":
        raise ValueError(f"cand_dists: unsupported device {x2.device}")
    out = cand_adc(rotated_residuals(x2, Cs, Rs, mus), subs, codes, rows,
                   isel0, isel1, slot0, slot1, n_valid)
    cand_dists.launches += 1
    return out


cand_dists.launches = 0
