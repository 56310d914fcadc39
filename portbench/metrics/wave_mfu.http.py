"""The served waves' share of the card's peak, in %: the least time of the
window's counted work over the window's length. A coalesced wave of n
requests counts the DeepSentibank forward of its n images
(``served.sentibank_work``) and the search of its n queries
(``roofline.wave_work`` at the mix's limit, quota and rerank depth), each
at the larger of its bytes over the memory rate and its FLOPs over the
float32 rate; the wave's forward and search run one after the other."""

from portbench import served


def read(run):
    sizes = getattr(run, "window_sizes", None)
    if not sizes:
        return None
    m, rf = run.mix, run.roofline
    least = sum(rf.peak_seconds(*served.sentibank_work(n))[0]
                + rf.peak_seconds(*rf.wave_work(run.cfg, n, m["quota"],
                                                m["limit"], m["rerank_nb"]))[0]
                for n in sizes)
    return 100.0 * least / run.window_s
