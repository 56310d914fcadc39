"""Share of the window's waves that the plan choice sent to the exact
brute pass (``probe_stats`` ``brute_waves`` over ``waves``), in %."""


def read(run):
    w = run.counters["waves"]
    return 100.0 * run.counters["brute_waves"] / w if w else None
