"""The traffic kinds. A traffic mix (``traffic/<mix>.json``) names its
``kind``; ``kinds/<kind>.py`` (found by that name, ``spec.kind``) defines
``Load(cfg, mix, seed, dev)``, one run of a cell of that kind, which
``run.execute`` drives through these calls alone:

- ``setup()``: make the inputs from the seed, build the program and warm
  up the cell's shapes; returns {stage: seconds};
- ``window(seconds, traced)``: offer the load for ``seconds``; returns a
  dict with ``e2e`` ({metric: value}), ``attempted``, ``failed``,
  ``counters`` and, when ``traced``, ``trace`` (a ``trace.Reduction``);
  every key of it is also an attribute of what the per-layer readers get;
- ``sample()``: the answers that the check compares, drawn from the seed;
- ``free()``: drop the program's state and its device memory;
- ``judge(sample, control=False)``: {"program": {number: value}} and, with
  ``control``, {"control": {...}} for the control's answers in the
  program's place, each number to be held to its limit in
  ``limits/<cell>.json``.

A new kind is a new file here; nothing else changes.
"""
