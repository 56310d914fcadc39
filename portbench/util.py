"""Small helpers of the harness's modules."""

import sys


def log(msg):
    """A line on standard error, at once."""
    print(msg, file=sys.stderr, flush=True)


def sync(dev):
    """Wait for the device's queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)
