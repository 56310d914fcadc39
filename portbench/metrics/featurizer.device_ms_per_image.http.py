"""Device busy a served image inside the featurizer: the device time of
the kernels that the coalescer's thread launched inside the program's
``cis.featurize`` spans (pixel reconstruction, preprocessing and the
DeepSentibank forward) over the images of those waves, in ms. None where
the run traced no ``cis.featurize``."""

from portbench import served


def read(run):
    s = getattr(run, "served", None)
    if not s:
        return None
    feats = served.named(s["spans"], served.PREFIX + "featurize")
    images = sum(s["traced_sizes"])
    if not feats or len(feats) != len(s["traced_sizes"]) or not images:
        return None
    return 1e3 * sum(served.kernel_seconds(run.trace, feats)) / images
