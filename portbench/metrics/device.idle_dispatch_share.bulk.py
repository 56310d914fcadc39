"""Share of the traced window in which the device idles while the host
enqueues a launch's ops or unpacks its output (innermost program span
``cis.dispatch``: its self time, the copy-out ``cis.fetch`` excluded),
in %."""

from portbench import program_spans


def read(run):
    return program_spans.idle_share(run, lambda n: n == "cis.dispatch")
