"""ADC lookup tables for the probed clusters: the CUDA kernel's wrapper and
its plain PyTorch version (port of columbiaimagesearch_tpu/index/
tpu_query.py:71-143, ``_lut_kernel`` / ``build_luts_pallas``).

For query q, split s and probed slot b with cluster v = isel[q, s, b]:
``r = x2[q, s] - Cs[s, v] - mus[s, v]``, ``pr = Rs[s, v] @ r`` and
``T[q, s, b, f, t] = ||pr_f - subs[s, f, t]||^2``. The TPU kernel took one
query; the port takes a batch (``isel [NQ, 2, B]``), so single searches
and request waves both go through it.

:func:`build_luts` launches ``csrc/lut_build.cu`` for CUDA tensors and
uses :func:`build_luts_plain` for CPU tensors; on a CUDA tensor it
launches or raises, never falls back. On the card the kernel launches
under the inputs' device and its current stream. One call groups each
split's slots by probed cluster (a counting sort; a one-query call and
:func:`build_luts_all_clusters` need none), then builds the tables band by
band: each probed rotation matrix is read from device memory once, by TMA
bulk copies, and applied to every residual that probes it (see the
kernel's header). ``build_luts.launches`` counts the calls that launched
the kernel, through either entry point.
"""

import ctypes

import torch

from columbiaimagesearch_tpu_torch.device import sm_count
from columbiaimagesearch_tpu_torch.kernels.build import load_library

_P = ctypes.c_void_p
_I = ctypes.c_int


def build_luts_plain(x2, isel, Cs, Rs, mus, subs):
    """Plain PyTorch version: gather the probed rotation matrices and
    contract with einsum.

    :param x2: [NQ, 2, Dh] float32 query halves
    :param isel: [NQ, 2, B] integer probed cluster ids
    :returns: [NQ, 2, B, F, S] float32
    """
    NQ, _, B = isel.shape
    F, S, Dsub = subs.shape[1], subs.shape[2], subs.shape[3]
    sidx = torch.arange(2, device=isel.device)[None, :, None]
    v = isel.long()
    r = x2[:, :, None, :] - Cs[sidx, v] - mus[sidx, v]          # [NQ,2,B,Dh]
    pr = torch.einsum("nsbij,nsbj->nsbi", Rs[sidx, v], r)
    prf = pr.reshape(NQ, 2, B, F, 1, Dsub)
    out = torch.empty((NQ, 2, B, F, S), dtype=torch.float32,
                      device=x2.device)
    for s in range(2):       # per split: bounds the [.., S, Dsub] transient
        diff = prf[:, s] - subs[s][None, None]               # [NQ,B,F,S,Dsub]
        out[:, s] = (diff * diff).sum(dim=-1)
    return out


def _library():
    lib = load_library("lut_build")
    fn = lib.lut_build
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 9 + [_P]
        fn.restype = _I
        lib.lut_scratch_ints.argtypes = [_I] * 3
        lib.lut_scratch_ints.restype = ctypes.c_longlong
    return lib


def _check(name, t, dtype, shape, device, aligned=False):
    """Raise unless ``t`` is on ``device`` with this dtype and shape, and
    contiguous; ``aligned``: read by bulk copies or float4 loads, so it
    must also start on a 16-byte boundary."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


#: lut_build's grouping modes (csrc/lut_build.cu)
_SLOTS, _SORTED, _ALL_CLUSTERS = 0, 1, 2


def build_luts(x2, isel, Cs, Rs, mus, subs):
    """ADC tables for the probed clusters of a batch of queries.

    :param x2: [NQ, 2, Dh] float32 query halves
    :param isel: [NQ, 2, B] probed cluster ids (int32 on the card)
    :param Cs/mus: [2, V, Dh] float32; Rs: [2, V, Dh, Dh] float32;
        subs: [2, F, S, Dsub] float32
    :returns: [NQ, 2, B, F, S] float32
    """
    if x2.device.type == "cpu":
        return build_luts_plain(x2, isel, Cs, Rs, mus, subs)
    # A query's probes of a split are distinct clusters: one query has
    # nothing to group.
    return _launch(x2, isel, Cs, Rs, mus, subs,
                   _SORTED if isel.shape[0] > 1 else _SLOTS)


def build_luts_all_clusters(x2, Cs, Rs, mus, subs):
    """:func:`build_luts` with every query probing every cluster in order
    (``isel[q, s, b] = b``, B = V), as the exhaustive path needs: on the
    card the kernel knows the grouping and sorts nothing.

    :returns: [NQ, 2, V, F, S] float32
    """
    NQ, V = x2.shape[0], Cs.shape[1]
    if x2.device.type == "cpu":
        isel = torch.arange(V, dtype=torch.int32).expand(NQ, 2, V)
        return build_luts_plain(x2, isel, Cs, Rs, mus, subs)
    return _launch(x2, None, Cs, Rs, mus, subs, _ALL_CLUSTERS)


def _launch(x2, isel, Cs, Rs, mus, subs, grouping):
    if x2.device.type != "cuda":
        raise ValueError(f"build_luts: unsupported device {x2.device}")
    NQ = x2.shape[0]
    V, Dh = Cs.shape[1], Cs.shape[2]
    B = V if isel is None else isel.shape[2]
    F, S, Dsub = subs.shape[1], subs.shape[2], subs.shape[3]
    if F * Dsub != Dh:
        raise ValueError(f"subs {tuple(subs.shape)} do not tile Dh={Dh}")
    if Dh % 4 or Dsub % 4:
        raise ValueError(f"lut_build reads float4 rows: Dh={Dh} and "
                         f"Dsub={Dsub} must be multiples of 4")
    dev, f32 = x2.device, torch.float32
    _check("x2", x2, f32, (NQ, 2, Dh), dev)
    if isel is not None:
        _check("isel", isel, torch.int32, (NQ, 2, B), dev)
    _check("Cs", Cs, f32, (2, V, Dh), dev, aligned=True)
    _check("mus", mus, f32, (2, V, Dh), dev, aligned=True)
    _check("Rs", Rs, f32, (2, V, Dh, Dh), dev, aligned=True)
    _check("subs", subs, f32, (2, F, S, Dsub), dev, aligned=True)
    out = torch.empty((NQ, 2, B, F, S), dtype=f32, device=dev)
    lib = _library()
    iscratch = (torch.empty(lib.lut_scratch_ints(NQ, B, V),
                            dtype=torch.int32, device=dev)
                if grouping == _SORTED else None)
    # The library launches on the calling thread's current device: make
    # it the inputs' (a shard on cuda:1 must not launch on cuda:0 with a
    # stream of cuda:1).
    with torch.cuda.device(dev):
        sms = sm_count(dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lut_build(x2.data_ptr(),
                            None if isel is None else isel.data_ptr(),
                            Cs.data_ptr(), Rs.data_ptr(), mus.data_ptr(),
                            subs.data_ptr(), out.data_ptr(),
                            None if iscratch is None
                            else iscratch.data_ptr(),
                            grouping, NQ, B, V, Dh, F, S, Dsub, sms, stream)
    if err != 0:
        raise RuntimeError(f"lut_build launch failed: CUDA error {err} (1: "
                           f"a shape the kernel does not take, e.g. bands of "
                           f"{Dsub * Dh * 4} bytes too large for shared "
                           f"memory)")
    build_luts.launches += 1
    return out


build_luts.launches = 0
