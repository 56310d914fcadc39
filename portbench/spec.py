"""A cell as ``BENCHMARK.json`` names it, with every file that belongs to it
found by name: ``configs`` (the configuration's file, as the benchmark's
entry names it), ``traffic/<mix>.json``, the mix's ``kinds/<kind>.py``,
``limits/<cell>.json`` and ``metrics/<metric>.py``. A cell or a metric is added by adding its files
and its entries; no file here changes.
"""

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """Everything one workload of the benchmark needs to run."""

    def __init__(self, name):
        bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
        byname = {w["name"]: w for w in bench["workloads"]}
        if name not in byname:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(byname)})")
        w = byname[name]
        entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
        self.name, self.chips = name, int(w["chips"])
        self.cfg = _json(os.path.join(ROOT, entry["file"]))
        self.mix = _json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
        self.limits = _json(os.path.join(HERE, "limits", name + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in e2e)]


def reader(metric):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kind(name):
    """The module ``kinds/<name>.py`` of a traffic kind (its ``Load``)."""
    return importlib.import_module("portbench.kinds." + name)
