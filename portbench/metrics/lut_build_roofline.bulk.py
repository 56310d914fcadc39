"""``lut_build``'s share of its roofline over the traced waves, in %: the
least time of each call's bytes and FLOPs (``roofline.lut_work`` on its
probed cluster ids) against the card's peaks, summed, over the device
time of the kernels that the calls launched. None where no traced wave
built tables."""


def read(run):
    kernel_s = sum(run.trace.span_device("lut_build"))
    if not run.lut_work or not kernel_s:
        return None
    least = sum(run.roofline.peak_seconds(b, f)[0] for b, f in run.lut_work)
    return 100.0 * least / kernel_s
