"""The DeepSentibank forward's share of its roofline over the traced waves,
in %: the least time of each forward's bytes and FLOPs
(``served.sentibank_work`` from the published widths, against the card's
peaks in ``roofline.py``), summed, over the device time of the kernels
that the forwards launched (the benchmark's ``portbench.forward`` spans
around the featurizer's ``_forward``, inside the program's
``cis.featurize``). None where the run traced no ``cis.featurize``."""

from portbench import served


def read(run):
    fwd = served.forwards(run)
    kernel_s = sum(k for _, k in fwd)
    if not fwd or not kernel_s:
        return None
    least = sum(run.roofline.peak_seconds(*served.sentibank_work(n))[0]
                for n, _ in fwd)
    return 100.0 * least / kernel_s
