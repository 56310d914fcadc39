"""Share of the traced window in which the device idles while the host
collects garbage (innermost program span ``cis.gc.<generation>``), in %."""

from portbench import program_spans


def read(run):
    return program_spans.idle_share(run, lambda n: n.startswith("cis.gc."))
