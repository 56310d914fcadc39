"""Device meshes of the port (port of columbiaimagesearch_tpu/parallel/
mesh.py).

The JAX package builds a ``jax.sharding.Mesh`` and runs one program over
it under ``shard_map``. The port keeps that single controller: one
process holds every shard, and each shard's work is launched on its own
device from the calling thread, without ``torch.distributed``. A mesh is
an ordered tuple of ``torch.device`` along one named axis.

An explicit ``devices`` list may name one device more than once: each
entry is a shard of its own ("logical shards"), so the CPU tests and one
card can drive as many shards as a multi-card host (the JAX tests force 8
host devices for the same purpose, tests/conftest.py:11-14).
"""

import torch

from columbiaimagesearch_tpu_torch.device import resolve_device
from columbiaimagesearch_tpu_torch.utils.chunking import round_up

DATA_AXIS = "dp"
SHARD_AXIS = "shard"


class Mesh(tuple):
    """Ordered devices along the axis ``axis_name``."""

    def __new__(cls, devices, axis_name=DATA_AXIS):
        mesh = super().__new__(cls, (torch.device(d) for d in devices))
        mesh.axis_name = axis_name
        return mesh

    @property
    def size(self):
        return len(self)


def make_mesh(n_devices=None, axis=DATA_AXIS, devices=None):
    """A mesh over ``devices``, by default every visible card in order
    (``cuda:0`` .. ``cuda:count-1``), cut to the first ``n_devices``.

    :raises RuntimeError: without a card when no devices are named; the
        CPU is never picked in its place
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; name the devices "
                "(devices=['cpu']) to build a mesh without a card")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [resolve_device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    return Mesh(devices, axis)


def shard_rows(mesh, x, pad_value=0.0):
    """Pad the leading dim to a multiple of the mesh size and split it into
    contiguous blocks, block ``i`` on ``mesh[i]`` (the JAX row sharding).

    :returns: (list of per-device tensors, original row count)
    """
    x = torch.as_tensor(x)
    n = x.shape[0]
    target = round_up(max(n, 1), len(mesh))
    if target != n:
        pad = x.new_full((target - n,) + tuple(x.shape[1:]), pad_value)
        x = torch.cat([x, pad.to(x.device)])
    per = target // len(mesh)
    return [x[i * per:(i + 1) * per].to(d) for i, d in enumerate(mesh)], n
