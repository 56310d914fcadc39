"""No silent CPU: without a card the port's default device raises, and the
CPU runs only where a caller names it (``device="cpu"``, ``--device cpu``).
The card is reported absent by monkeypatching ``torch.cuda.is_available``,
so these tests mean the same on a machine with a card."""

import json

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch.device import default_device, resolve_device


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
    for asked in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(asked)
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")


def test_featurizer_and_facade_raise_without_a_card(no_card):
    from columbiaimagesearch_tpu_torch.index.model import LOPQModel
    from columbiaimagesearch_tpu_torch.models.sentibank import (
        SentibankFeaturizer,
        init_params,
    )
    from columbiaimagesearch_tpu_torch.searcher.searcher_lopq import (
        SearcherLOPQ,
    )
    from columbiaimagesearch_tpu_torch.store import KVIndexer, MemoryStorer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        SentibankFeaturizer(params=init_params(seed=0))
    rng = np.random.RandomState(0)
    V, F, S, Dh = 4, 2, 8, 4
    m = LOPQModel(rng.randn(2, V, Dh), rng.randn(2, V, Dh, Dh),
                  rng.randn(2, V, Dh), rng.randn(2, F, S, Dh // F),
                  device="cpu")
    kw = dict(model=m, model_type="lopq", V=V, M=2 * F,
              subquantizer_clusters=S, featurizer=object(),
              indexer=KVIndexer(path=":memory:"), storer=MemoryStorer())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SearcherLOPQ(**kw)
    facade = SearcherLOPQ(**kw, device="cpu")
    assert facade.device == torch.device("cpu")
    assert facade.model.device.type == "cpu"


def test_run_search_api_raises_without_a_card(no_card, tmp_path,
                                              monkeypatch):
    """The default ``--device cuda`` raises at once instead of entering
    the boot retry loop (which would retry forever)."""
    from columbiaimagesearch_tpu_torch.api import run_search_api
    from columbiaimagesearch_tpu_torch.common import factory

    def must_not_build(*a, **kw):
        raise AssertionError("build_searcher ran without a device")

    monkeypatch.setattr(factory, "build_searcher", must_not_build)
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({"SEARCHLOPQ_model_type": "lopq"}))
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_search_api.main(["-c", str(conf), "--retry-delay", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_search_api.main(["-c", str(conf), "--device", "cuda",
                             "--retry-delay", "0"])


def test_new_entry_points_raise_without_a_card(no_card):
    """The entry points of the device decode, the renderer, face training
    and preprocessing take the card by default, like the featurizer."""
    from columbiaimagesearch_tpu_torch.extraction.extractor import (
        get_featurizer,
    )
    from columbiaimagesearch_tpu_torch.models.face_align import (
        init_landmark_params,
        train_landmark_net,
    )
    from columbiaimagesearch_tpu_torch.models.preprocess import (
        default_mean_image,
        preprocess_batch,
        preprocess_buffers,
    )
    from columbiaimagesearch_tpu_torch.utils.synthimg import (
        make_render_batch,
        make_render_one,
    )

    img = np.zeros((8, 8, 3), np.uint8)
    calls = [
        lambda: get_featurizer("sentibank"),
        lambda: make_render_batch(2),
        lambda: make_render_one(16),
        lambda: train_landmark_net(init_landmark_params(0),
                                   np.zeros((1, 64, 64, 1), np.float32),
                                   np.zeros((1, 5, 2), np.float32), steps=1),
        lambda: preprocess_batch([img], default_mean_image()),
        lambda: preprocess_buffers([], default_mean_image()),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert preprocess_batch([img], default_mean_image(),
                            device="cpu").device.type == "cpu"
