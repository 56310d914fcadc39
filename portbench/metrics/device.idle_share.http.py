"""Share of the traced window of served traffic in which no operation ran
on the device, in %."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s else None
