"""Tiny cells for the benchmark's CPU tests, and the ``cuda`` marker: a
test so marked runs on an NVIDIA card and skips without one (it decides
inside the test, never at import)."""

import json
import os
import types

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card")


def tiny_cell(config="release_10Mi"):
    """A cell of ``config``'s file and the bulk_waves mix at a size the CPU
    holds (V=16, D=32, 20,000 rows), with the committed limits."""
    with open(os.path.join(PB, "configs", config + ".json")) as f:
        cfg = json.load(f)
    cfg.update(dim=32, V=16, subq=16, rows=20000, train_rows=4000)
    if cfg["model_type"] == "lopq_pca":
        cfg.update(raw_dim=64)
    with open(os.path.join(PB, "traffic", "bulk_waves.json")) as f:
        m = json.load(f)
    m.update(wave=10, limit=20, quota=500, rerank_nb=100, pool_waves=4,
             warmup_waves=3, sample=16, trace_waves=3)
    with open(os.path.join(PB, "limits", config + ".bulk_waves.json")) as f:
        limits = json.load(f)
    with open(os.path.join(os.path.dirname(PB), "BENCHMARK.json")) as f:
        bench = json.load(f)
    return types.SimpleNamespace(
        name=config + ".tiny", chips=1, cfg=cfg, mix=m, limits=limits,
        end_to_end=[e for e in bench["end_to_end"]],
        per_layer=[p for p in bench["per_layer"]])


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")


@pytest.fixture
def cuda_dev():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
