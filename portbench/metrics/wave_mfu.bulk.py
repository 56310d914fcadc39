"""The whole search wave's share of the card's peak, in %: the least time
of the work one wave of these shapes needs (``roofline.wave_work``: bytes
over the memory rate or FLOPs over the float32 rate, the larger) times
the window's waves, over the window's length."""


def read(run):
    m = run.mix
    nbytes, flops = run.roofline.wave_work(run.cfg, m["wave"], m["quota"],
                                           m["limit"], m["rerank_nb"])
    waves = run.counters["sent_waves"]
    least = run.roofline.peak_seconds(nbytes, flops)[0]
    return 100.0 * least * waves / run.window_s if waves else None
