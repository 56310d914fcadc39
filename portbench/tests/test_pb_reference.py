"""The plain reference against the program at a tiny size on the CPU, the
control failing the committed limits, and the faults that a run must
catch."""

from unittest import mock

import numpy as np
import pytest
import torch

from portbench import run
from portbench.reference import lopq_search
from portbench.tests.conftest import tiny_cell

CONFIGS = ["release_10Mi", "face_8Mi"]


def _ladder_only():
    """Keep the plan on the probe ladder: at a tiny size the brute pass
    wins, and the ladder is what the cells run."""
    from columbiaimagesearch_tpu_torch.index.searcher import LOPQSearcherTorch

    return mock.patch.object(LOPQSearcherTorch, "_use_brute",
                             lambda self, *a: False)


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("plan", ["ladder", "brute"])
def test_program_matches_reference(config, plan, cpu):
    cell = tiny_cell(config)
    if plan == "ladder":
        with _ladder_only():
            out = run.execute(cell, 2**33 + 7, 0.3, False, cpu)
    else:
        out = run.execute(cell, 2**33 + 7, 0.3, False, cpu)
        assert out["counters"]["brute_waves"] == out["counters"]["waves"]
    assert out["correct"], out["checks"]
    checks = out["checks"]
    assert list(out)[-1] == "checks"
    assert checks["dist_gap"]["value"] < 1e-6
    # the ladder gives the reference's lists; the exact pass the same
    # rows or nearer ones
    assert checks["list_miss"]["value"] == 0.0


@pytest.mark.parametrize("config", CONFIGS)
def test_control_fails_the_limits(config, cpu):
    """The reference in TF32, put in the program's place, reads not
    correct through the run's own comparison with the committed limits."""
    cell = tiny_cell(config)
    with _ladder_only():
        out = run.execute(cell, 2**35 + 3, 0.3, False, cpu, control=True)
    assert out["correct"]
    ctl = out["control"]
    assert not ctl["correct"], ctl
    assert any(c["value"] > c["limit"] for c in ctl["checks"].values())


def _altered(field):
    """search_batch whose answers are altered where they are produced: the
    first result's id or distance of every query."""
    from columbiaimagesearch_tpu_torch.index import searcher as mod

    live = mod.LOPQSearcherTorch._rows_to_results

    def rows_to_results(self, rows, dists, *a, **kw):
        rows, dists = np.array(rows), np.array(dists, dtype=np.float32)
        if field == "id":
            rows[0] = (rows[0] + 1) % self.nb_indexed
        else:
            dists[0] *= 1.001
        return live(self, rows, dists, *a, **kw)
    return mock.patch.object(mod.LOPQSearcherTorch, "_rows_to_results",
                             rows_to_results)


def _probe_cut():
    """lopq_query that loses the second half of each query's candidate
    budget (a probe that stops early)."""
    from columbiaimagesearch_tpu_torch.index import query

    live = query.lopq_query

    def cut(X, Cs, Rs, mus, subs, codes, cell_start, quota, **kw):
        return live(X, Cs, Rs, mus, subs, codes, cell_start, quota // 2, **kw)
    return mock.patch.object(query, "lopq_query", cut)


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("fault", ["id", "dist", "probe"])
def test_faults_read_incorrect(config, fault, cpu):
    cell = tiny_cell(config)
    patch = _probe_cut() if fault == "probe" else _altered(fault)
    with _ladder_only(), patch:
        out = run.execute(cell, 2**34 + 11, 0.3, False, cpu)
    assert not out["correct"], out["checks"]


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.0 - 2 ** -12], dtype=torch.float32)
    got = lopq_search.round_tf32(x)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.0])
    assert torch.equal(got, want)


def test_candidate_budget():
    assert lopq_search.candidate_budget(10_000, 10_485_760) == 11_264
    assert lopq_search.candidate_budget(500, 20_000) == 2048
    assert lopq_search.candidate_budget(10_000, 3000) == 3072


@pytest.mark.cuda
def test_program_matches_reference_on_the_card(cuda_dev):
    """The tiny cell through the card's kernels, traced."""
    out = run.execute(tiny_cell("face_8Mi"), 2**33 + 19, 0.5, True, cuda_dev)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
