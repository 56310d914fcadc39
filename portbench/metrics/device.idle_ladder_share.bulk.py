"""Share of the traced window in which the device idles in the probe
ladder's own work (innermost program span ``cis.ladder``, ``_escalate``:
the rung floor, the bookkeeping between rungs, the hint; its launches
excluded), in %."""

from portbench import program_spans


def read(run):
    return program_spans.idle_share(run, lambda n: n == "cis.ladder")
