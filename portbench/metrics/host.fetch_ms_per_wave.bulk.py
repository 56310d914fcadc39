"""The host's wait for the device a traced wave: the summed durations of
the program's ``cis.fetch`` spans (each launch's copy-out of its packed
output) over the count of ``cis.search`` spans, in ms."""

from portbench import program_spans


def read(run):
    return program_spans.span_ms_per_wave(run, "cis.fetch")
