"""Share of the window that the interpreter spent in garbage collections
of its oldest generation (``gc.callbacks`` around each), in %: full
collections traverse every object the process holds, the imported
libraries' too, and the program's result tuples set them off."""


def read(run):
    return 100.0 * run.host["gc_s"][2] / run.window_s if run.window_s else None
