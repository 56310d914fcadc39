"""The recall evaluation at the JAX artifacts' configurations, on the CPU.

- ``SynthData.host_rows`` draws the noise in row blocks of ``CH`` from one
  ``RandomState``: the rows are bit-equal to the JAX script's one-shot
  ``synth`` (scripts/eval_recall.py:87-92, copied below), and the host
  holds the float32 rows plus one block.
- The adversarial mode of benchmarks/r05_recall_adversarial_10M_rerank.json
  (query noise 0.25, two quotas, a small, a large and the adaptive probe
  width, the fused bfloat16 rerank) at n 20,000, dim 32, V 16: the JAX
  script runs whole once (its searcher class wrapped to record the
  model), and the port's stages on the JAX-trained model give each
  artifact row within 0.05 of the JAX script's recall@k. Each package
  picks the rerank row's plan by its own cost model, and both take the
  exact brute pass.
- The parity rule ``chip_smoke.py`` holds the card's runs to: it passes on
  each JAX artifact compared with itself, and fails on a row moved past
  its bound, a missing row or a broken ordering.
"""

import copy
import json
import os
import sys
import tracemalloc

import numpy as np
import pytest

import chip_smoke
from columbiaimagesearch_tpu_torch.index import eval_recall
from columbiaimagesearch_tpu_torch.index.model import LOPQModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--n", "20000", "--dim", "32", "--V", "16", "--train-n", "4000",
        "--queries", "50", "--query-noise", "0.25", "--quota", "500",
        "--quotas", "500,2000", "--probe-widths", "4,16,0",
        "--rerank-dtype", "bfloat16", "--skip-exact"]
RECALL_ATOL = 0.05
ARTIFACTS = {name: spec["ref"]
             for name, spec in chip_smoke.RECALL_PARITY.items()}


def _jax_synth(comp, n, dim, seed):
    """The JAX script's ``synth`` (scripts/eval_recall.py:87-92)."""
    r = np.random.RandomState(seed)
    return (comp[r.randint(0, eval_recall.N_COMP, n)]
            + 0.25 * r.randn(n, dim)).astype(np.float32)


def _synth_data(dim):
    """A SynthData with only its components drawn (seed 0, as both
    scripts draw them)."""
    data = eval_recall.SynthData.__new__(eval_recall.SynthData)
    data.dim = dim
    rng = np.random.RandomState(0)
    comp = rng.randn(eval_recall.N_COMP, dim).astype(np.float32)
    comp /= np.linalg.norm(comp, axis=1, keepdims=True)
    data.comp = comp
    return data


@pytest.mark.parametrize("n,dim,block", [
    (257, 8, 1),         # a block of one row
    (300, 16, 1000),     # a block larger than n
    (1001, 8, 100),      # n not a multiple of the block
    (999, 33, 128),      # an odd dim: odd counts of normals a block
    (1000, 7, 333),      # both
])
def test_block_draw_is_bit_equal_to_the_one_shot_draw(monkeypatch, n, dim,
                                                      block):
    monkeypatch.setattr(eval_recall, "CH", block)
    data = _synth_data(dim)
    got = data.host_rows(n, 2)
    assert got.dtype == np.float32 and got.shape == (n, dim)
    np.testing.assert_array_equal(got, _jax_synth(data.comp, n, dim, 2))


def test_block_draw_holds_the_rows_and_one_block(monkeypatch):
    """The host peak of a draw: the float32 rows, the component indices
    and one block's float64 noise and float32 temporaries (16 bytes a
    value); the one-shot draw holds four times the rows more."""
    n, dim, block = 20000, 64, 1000
    monkeypatch.setattr(eval_recall, "CH", block)
    data = _synth_data(dim)
    tracemalloc.start()
    try:
        rows = data.host_rows(n, 2)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    limit = rows.nbytes + block * dim * 16 + n * 8 + (64 << 10)
    assert peak <= limit, (peak, limit)
    assert limit < n * dim * 8


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX script's artifact at ARGS and its trained model."""
    mp = pytest.MonkeyPatch()
    had_cache_env = "JAX_COMPILATION_CACHE_DIR" in os.environ
    try:
        from columbiaimagesearch_tpu.index import searcher as jax_searcher

        from scripts import eval_recall as jax_eval_recall

        seen = {}
        Base = jax_searcher.LOPQSearcherTPU

        class Recording(Base):
            def __init__(self, model, *a, **kw):
                seen["model"] = model
                seen["searcher"] = self
                super().__init__(model, *a, **kw)

        mp.setattr(jax_searcher, "LOPQSearcherTPU", Recording)
        out = tmp_path_factory.mktemp("jax") / "recall.json"
        mp.setattr(sys, "argv", ["eval_recall.py", *ARGS, "--cpu", "--out",
                                 str(out)])
        jax_eval_recall.main()
        with open(out) as f:
            seen["artifact"] = json.load(f)
    finally:
        mp.undo()
        if not had_cache_env:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    return seen


@pytest.fixture(scope="module")
def port_runs(jax_run):
    """The port's stages on the JAX-trained model, as ``run`` calls them
    (the fused rerank in bfloat16), and the rerank stage's searcher."""
    from columbiaimagesearch_tpu_torch.index import searcher as port_searcher

    made = []

    class Recording(port_searcher.LOPQSearcherTorch):
        def __init__(self, *a, **kw):
            made.append(self)
            super().__init__(*a, **kw)

    jm = jax_run["model"]
    model = LOPQModel.from_numpy(jm.Cs, jm.Rs, jm.mus, jm.subquantizers,
                                 device="cpu")
    args = eval_recall.parse_args(ARGS + ["--cpu"])
    data = eval_recall.SynthData(args.n, args.dim, args.train_n,
                                 args.queries, args.query_noise, False, "cpu")
    nns = eval_recall.ground_truth(data)
    coarse, fine = eval_recall.encode(model, data)
    runs = eval_recall.probed_sweep(model, coarse, fine, data.queries, nns,
                                    [4, 16, 0], [500, 2000])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_searcher, "LOPQSearcherTorch", Recording)
        runs.append(eval_recall.probed_rerank(model, coarse, fine, data.X,
                                              data.queries, nns, args.quota,
                                              args.rerank_dtype))
    return runs, made[-1]


@pytest.mark.parametrize("row", range(7))
def test_adversarial_rows_on_the_carried_model_match_jax(jax_run, port_runs,
                                                         row):
    runs, _ = port_runs
    want = jax_run["artifact"]["runs"]
    assert len(want) == len(runs) == 7
    got, w = runs[row], want[row]
    for k in ("method", "probe_width", "rerank", "rerank_dtype"):
        assert got.get(k) == w.get(k)
    for k in (1, 10, 100):
        assert abs(got[f"recall@{k}"] - w[f"recall@{k}"]) <= RECALL_ATOL, (
            got, w)


def test_rerank_row_takes_the_brute_pass_in_both(jax_run, port_runs):
    """Each package costs the rerank row's 50-query wave with its own plan
    model, and both run it as one exact brute pass (the warm-up wave and
    the timed one)."""
    for s in (jax_run["searcher"], port_runs[1]):
        stats = s.probe_stats
        assert stats["waves"] >= 1
        assert stats.get("brute_waves", 0) == stats["waves"], stats


def _artifact(name):
    with open(os.path.join(ROOT, ARTIFACTS[name])) as f:
        return json.load(f)


def _check(name, port_runs, ref):
    return chip_smoke.check_recall_parity(name, port_runs, ref, 100, "cpu")


@pytest.mark.parametrize("name", sorted(ARTIFACTS))
def test_parity_passes_on_an_artifact_against_itself(name):
    ref = _artifact(name)
    table = _check(name, copy.deepcopy(ref["runs"]), ref)
    assert table["ok"] and not table["order_misses"]
    assert len(table["rows"]) == 3 * len(ref["runs"])
    assert all(r["delta"] == 0 for r in table["rows"])


@pytest.mark.parametrize("name,row,move", [
    ("adversarial_10M", 0, 0.11),
    ("adversarial_10M", 6, -0.11),
    ("stream_100M", 4, None),        # past 3 sigma at its pooled recall
    ("neardup_100M", 1, -0.05),
])
def test_parity_fails_on_a_row_past_its_bound(name, row, move):
    ref = _artifact(name)
    runs = copy.deepcopy(ref["runs"])
    jax = ref["runs"][row]["recall@10"]
    if move is None:
        # The smallest move past 3 sigma of the pooled recall.
        move = 0.01
        while abs(move) <= 3 * np.sqrt(2 * (jax + move / 2)
                                       * (1 - jax - move / 2) / 100):
            move += 0.01
    runs[row]["recall@10"] = round(jax + move, 2)
    with pytest.raises(AssertionError, match="recall@10"):
        _check(name, runs, ref)


@pytest.mark.parametrize("name", ["adversarial_10M", "neardup_100M"])
def test_parity_holds_a_row_at_its_bound(name):
    """A row exactly at its bound passes: the difference is rounded, so
    float noise in ``p - jax`` cannot fail it."""
    ref = _artifact(name)
    runs = copy.deepcopy(ref["runs"])
    bound = chip_smoke.RECALL_PARITY[name]["bound"]
    for r in runs:
        r["recall@1"] = round(r["recall@1"] - bound, 2)
    assert _check(name, runs, ref)["ok"]


@pytest.mark.parametrize("name", sorted(ARTIFACTS))
def test_parity_fails_on_a_missing_row(name):
    ref = _artifact(name)
    runs = copy.deepcopy(ref["runs"])[1:]
    with pytest.raises(AssertionError, match="port None"):
        _check(name, runs, ref)


@pytest.mark.parametrize("name,method,width", [
    ("adversarial_10M", "probed_quota10000", "256"),   # below width 64
    ("stream_100M", "probed_quota100000", "64"),       # below quota 10k
])
def test_parity_fails_on_an_ordering_violation(name, method, width):
    """The same rows on both sides (every delta 0), but one recall below
    the ordering's slack: the width or the quota ordering fails."""
    ref = _artifact(name)
    for r in ref["runs"]:
        if r["method"] == method and r["probe_width"] == width:
            r["recall@1"] = 0.2
    with pytest.raises(AssertionError, match="below quota"):
        _check(name, copy.deepcopy(ref["runs"]), ref)
