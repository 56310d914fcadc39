"""The handlers' decode a served image: the summed durations of the
program's ``cis.decode`` spans (``prepare_wave``: the JPEG coefficient
read, on the HTTP handlers' threads) over their count, one image a
request in this traffic, in ms of the host's clock. None where the run
traced no ``cis.decode``."""

from portbench import served


def read(run):
    s = getattr(run, "served", None)
    dec = served.named(s["spans"], served.PREFIX + "decode") if s else []
    if not dec:
        return None
    return sum(e["dur"] for e in dec) / 1e3 / len(dec)
