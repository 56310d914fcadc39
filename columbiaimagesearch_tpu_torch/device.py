"""Device conventions of the port.

Distance-critical math (coarse and fine argmin, rotations, ADC tables,
rerank and brute distances) runs in true fp32, the counterpart of the JAX
package's ``precision="highest"``: TF32 would keep ~3 decimal digits and
flip argmins. Both PyTorch switches are set here, once, when the package
is imported.

Every function takes its ``device`` (or the device of the tensors it is
given) explicitly. Where a caller may leave it out (the serving facade,
the featurizer, ``run_search_api``), :func:`resolve_device` reads ``None``
as the first card and raises when there is none: the CPU runs only where
a caller names it (``device="cpu"``, ``--device cpu``), never because the
card is missing.
"""

import functools

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: Working-set budget for CPU tensors (the CPU tests and rehearsals). The
#: card reports its own free memory; the host has no such query that is
#: meaningful under a shared machine, so waves on the CPU are sized
#: against this fixed budget instead.
CPU_WORKSET_BYTES = 2e9
#: The memory size a CPU "device" reports to the rerank-store dtype plan
#: (index/searcher.py ``rerank_f32_budget``), for the same reason: fixed,
#: so tests can set it.
CPU_DEVICE_BYTES = 16e9


def default_device():
    """The first CUDA card.

    :raises RuntimeError: when no card is available; the CPU is never
        picked in its place
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card unless "
            "the caller asks for the CPU: pass device='cpu' (run_search_api: "
            "--device cpu)")
    return torch.device("cuda", 0)


def resolve_device(device=None):
    """``device`` as a ``torch.device``: ``None`` and an unnumbered
    ``"cuda"`` are :func:`default_device` (which raises without a card)."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    return default_device()


def compute_device(x, device=None):
    """Where an entry point given ``x`` runs: ``device`` when the caller
    names one, else ``x``'s own device for a tensor, else
    :func:`default_device` (raises without a card)."""
    if device is not None:
        return resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    return default_device()


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device):
    """The SM count of a CUDA ``device`` (kernel grid sizes), read once."""
    index = torch.device(device).index
    return _sm_count(torch.cuda.current_device() if index is None else index)


def device_bytes(device):
    """The memory size of ``device``: a card's total memory
    (``torch.cuda.mem_get_info``), else :data:`CPU_DEVICE_BYTES`."""
    device = torch.device(device)
    if device.type != "cuda":
        return CPU_DEVICE_BYTES
    return float(torch.cuda.mem_get_info(device)[1])


def free_bytes(device):
    """Bytes a new allocation on ``device`` can use right now: the card's
    free memory plus what PyTorch's caching allocator holds unused."""
    device = torch.device(device)
    if device.type != "cuda":
        return CPU_WORKSET_BYTES
    free, _total = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return float(free + cached)
