"""The median wave's host-clock time in the window, in ms: a steadier
statistic beside ``queries_per_s``, which the window's slow waves (full
garbage collections, host stalls) move."""

import numpy as np


def read(run):
    ms = run.host["wave_ms"]
    return float(np.median(ms)) if len(ms) else None
