"""The served cells' yardstick and trace readers: the bytes and operations
of a DeepSentibank forward from the published widths, and the program's
``cis.`` spans of every thread (the HTTP handlers' and the coalescer's)
in a ``--trace 1`` run.

``roofline.py``'s peaks and ``wave_work`` count the search; this module
counts the net. A served run records its spans with a profiler that
records every thread (:func:`profiler`): the program opens ``cis.http``,
``cis.decode`` and ``cis.queue`` on the handlers' threads and
``cis.featurize``, ``cis.search`` and ``cis.assemble`` on the
coalescer's (``common/profiling.py``).
"""

from collections import defaultdict

#: prefix of the program's span names
PREFIX = "cis."
#: DeepSentibank's convolutions (published widths, pycaffe_sentibank
#: .prototxt): (out channels, in channels a group, kernel, output side)
SENTIBANK_CONVS = ((96, 3, 11, 55), (256, 48, 5, 27), (384, 256, 3, 13),
                   (384, 192, 3, 13), (256, 192, 3, 13))
#: its fully connected layers up to the feature: (in, out)
SENTIBANK_FCS = ((256 * 6 * 6, 4096), (4096, 4096))
#: the forward's input (float32 [3, 227, 227]) and output (fc7) an image
SENTIBANK_IN, SENTIBANK_OUT = 3 * 227 * 227, 4096


def sentibank_work(n, itemsize=4):
    """Bytes and FLOPs of DeepSentibank's fc7 forward of ``n`` images:
    the weights and biases of conv1 to fc7 read once a wave, each image's
    input read once and its fc7 written once (intermediate activations
    are not counted: a forward need not write them out); two FLOPs a
    multiply-add of each convolution and fully connected layer (biases,
    ReLUs, pools and LRN, under 1% of it, are not counted). Returns
    (bytes, flops)."""
    params = flops = 0
    for out_c, in_c, k, side in SENTIBANK_CONVS:
        params += out_c * in_c * k * k + out_c
        flops += 2 * side * side * out_c * in_c * k * k
    for i, o in SENTIBANK_FCS:
        params += i * o + o
        flops += 2 * i * o
    nbytes = itemsize * (params + n * (SENTIBANK_IN + SENTIBANK_OUT))
    return nbytes, n * flops


def profiler():
    """A ``torch.profiler`` session of the host and the card that records
    the spans of every thread of the process."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


def program_spans(events, t0, t1):
    """The program's spans of every thread that start in ``[t0, t1)``."""
    return [e for e in events if e.get("ph") == "X" and "dur" in e
            and e.get("cat") == "user_annotation"
            and e["name"].startswith(PREFIX) and t0 <= e["ts"] < t1]


def named(spans, name):
    """Of ``spans``, those named ``name``, by start."""
    return sorted((e for e in spans if e["name"] == name),
                  key=lambda e: e["ts"])


def kernel_seconds(red, spans):
    """[seconds] of each span: the device time of the kernels that its
    thread launched inside it (``red``: a ``trace.Reduction``)."""
    by_corr = defaultdict(float)
    for e in red.device:
        corr = e.get("args", {}).get("correlation")
        if corr is not None and e.get("cat") == "kernel":
            by_corr[corr] += e["dur"] / 1e6
    launches = defaultdict(list)
    for e in red.launches:
        launches[e.get("tid")].append(e)
    out = []
    for s in spans:
        a, b = s["ts"], s["ts"] + s["dur"]
        out.append(sum(by_corr.get(e.get("args", {}).get("correlation"),
                                   0.0)
                       for e in launches[s.get("tid")] if a <= e["ts"] <= b))
    return out


def within(inner, outer):
    """Of the spans ``inner``, those that lie inside one of ``outer`` on
    the same thread, with their indices in ``inner``."""
    return [(i, e) for i, e in enumerate(inner)
            if any(o.get("tid") == e.get("tid") and o["ts"] <= e["ts"]
                   and e["ts"] + e["dur"] <= o["ts"] + o["dur"]
                   for o in outer)]


def forwards(run):
    """[(images, kernel seconds)] of each traced net forward that ran
    inside a ``cis.featurize`` span: the benchmark's ``portbench.forward``
    spans around the featurizer's ``_forward``, with the image count of
    each call. [] where the run traced no ``cis.featurize`` (or the calls
    and the spans do not pair up)."""
    s = getattr(run, "served", None)
    if not s or not s["spans"]:
        return []
    feats = named(s["spans"], PREFIX + "featurize")
    fwd = sorted((e for e in run.trace.spans
                  if e["name"] == "portbench.forward"),
                 key=lambda e: e["ts"])
    if not feats or len(fwd) != len(s["forward_images"]):
        return []
    inside = within(fwd, feats)
    secs = kernel_seconds(run.trace, [e for _, e in inside])
    return [(s["forward_images"][i], k) for (i, _), k in zip(inside, secs)]
