"""Device conventions of the port.

Distance-critical math (coarse and fine argmin, rotations, ADC tables,
rerank and brute distances) runs in true fp32, the counterpart of the JAX
package's ``precision="highest"``: TF32 would keep ~3 decimal digits and
flip argmins. Both PyTorch switches are set here, once, when the package
is imported.

Every function takes its ``device`` (or the device of the tensors it is
given) explicitly. :func:`default_device` is read only where no caller can
pass one: a model unpickled from a storer, and the featurizer and models
the serving facade builds from a configuration.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: Working-set budget for CPU tensors (the CPU tests and rehearsals). The
#: card reports its own free memory; the host has no such query that is
#: meaningful under a shared machine, so waves on the CPU are sized
#: against this fixed budget instead.
CPU_WORKSET_BYTES = 2e9


def default_device():
    """The first CUDA card when there is one, else the CPU."""
    if torch.cuda.is_available():
        return torch.device("cuda", 0)
    return torch.device("cpu")


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
