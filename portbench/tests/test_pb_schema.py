"""The result line's schema, the cell files found by name, the refusal
without a card, and that nothing the harness loads is JAX or the JAX
package."""

import json
import os
import re
import subprocess
import sys

import pytest

from portbench import run, spec
from portbench.tests.conftest import tiny_cell

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_schema(traced, cpu):
    out = run.execute(tiny_cell("face_8Mi"), 2**33 + 3, 0.3, traced, cpu)
    line = json.loads(json.dumps(out))
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool) and line["attempted"] > 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if traced:
        assert {"busy_s", "window_s"} <= set(dev)
        bd = line["breakdown"]
        assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
        assert "wave.p50_ms.bulk" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"setup_s", "queries_per_s"}


def test_every_cell_finds_its_files():
    bench = _bench()
    for w in bench["workloads"]:
        cell = spec.Cell(w["name"])
        assert cell.chips == 1 and cell.cfg["rows"] > 0
        assert callable(spec.kind(cell.mix["kind"]).Load)
        assert set(cell.limits) == {"dist_gap", "list_miss"}
        assert [m["name"] for m in cell.end_to_end] == ["setup_s",
                                                       "queries_per_s"]
        for m in cell.per_layer:
            assert callable(spec.reader(m["name"]))
    with pytest.raises(KeyError):
        spec.Cell("no_such.cell")


def test_benchmark_json_contract():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in bench[k]}) == len(bench[k])
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert len(c["source"]) <= 200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "columbiaimagesearch_tpu_torch_x", None)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "columbiaimagesearch_tpu.index", None)
    assert run.forbidden_modules() == ["columbiaimagesearch_tpu"]


def test_no_jax_is_loaded():
    """A whole tiny run, traced, in a fresh process: no module of JAX or
    of the JAX package is loaded."""
    code = (
        "import sys, torch\n"
        "from portbench import run, calibrate, spec\n"
        "from portbench.tests.conftest import tiny_cell\n"
        "for m in json.load(open(spec.ROOT + '/BENCHMARK.json'))"
        "['per_layer']:\n"
        "    spec.reader(m['name'])\n"
        "run.execute(tiny_cell(), 5, 0.2, True, torch.device('cpu'))\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", "import json\n" + code],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_refuses_without_a_card():
    """No result, and a code other than 0, where no card is visible."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "face_8Mi.bulk_waves", "--seed", str(2**33), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 2 and out.stdout == ""
