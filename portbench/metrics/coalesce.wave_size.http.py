"""The mean count of requests a coalesced wave over the window: the
coalescer's ``batch_sizes`` (``api/microbatch.py``) of the waves it ran
in the window."""


def read(run):
    sizes = getattr(run, "window_sizes", None)
    return sum(sizes) / len(sizes) if sizes else None
