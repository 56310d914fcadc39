"""Share of the traced window in which the device idles while the host
builds the wave's result rows (innermost program span ``cis.results``:
``_wave_results``, ``_rows_to_results``; collections inside it excluded),
in %."""

from portbench import program_spans


def read(run):
    return program_spans.idle_share(run, lambda n: n == "cis.results")
