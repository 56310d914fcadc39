"""Device busy time a traced wave (the union of kernel, copy and memset
intervals over the traced waves, over their count), in ms."""


def read(run):
    t = run.trace
    return t.busy_s / t.n_windows * 1e3 if t.n_windows and t.busy_s else None
