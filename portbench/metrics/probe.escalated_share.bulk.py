"""Share of the window's queries that the probe ladder sent on past the
rung their wave started at (``LOPQSearcherTorch.probe_stats``
``escalated_queries``), in % of the queries sent."""


def read(run):
    q = run.counters["queries"]
    return 100.0 * run.counters["escalated_queries"] / q if q else None
