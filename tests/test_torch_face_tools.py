"""The port's face operator tools against the JAX package's scripts, on
the CPU: ``ConvHOGFaceDetector.save_template``, the template-training
helpers (``models/train_face_template.py``) and the evaluation helpers
(``models/eval_face_detector.py``, ``models/eval_face_real_composite
.py``).

The helpers are numpy + PIL in both packages, so from one
``RandomState`` they give equal arrays; ``evaluate`` on detectors with
one template gives equal true-positive flags and scores within the
detector's card-vs-CPU tolerance (tests/test_torch_face_detector.py).
"""

import os
import sys

import numpy as np
import pytest

from columbiaimagesearch_tpu_torch.models import (
    eval_face_detector,
    eval_face_real_composite,
    train_face_template,
)
from columbiaimagesearch_tpu_torch.models.face_detector import (
    ConvHOGFaceDetector,
    default_template_path,
)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scripts")
SCORE_ATOL = 1e-4


@pytest.fixture
def jax_scripts(monkeypatch):
    """The JAX scripts' modules; ``eval_face_real_composite`` imports its
    sibling as a top-level module, and ``real_mosaic_negatives`` puts the
    scripts directory on ``sys.path``: both are undone after the test."""
    monkeypatch.setattr(sys, "path", [SCRIPTS] + list(sys.path))
    from scripts import eval_face_detector as jax_efd
    from scripts import eval_face_real_composite as jax_efr
    from scripts import train_face_template as jax_tft

    return jax_tft, jax_efd, jax_efr


def _same_list(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_save_template_reads_in_both_packages(tmp_path, monkeypatch):
    from columbiaimagesearch_tpu.models.face_detector import (
        ConvHOGFaceDetector as JaxDetector,
    )

    rng = np.random.RandomState(0)
    template = rng.randn(10, 10, 8).astype(np.float32)
    port = ConvHOGFaceDetector(template=template, bias=-0.25, device="cpu")
    jax_det = JaxDetector(template=template, bias=-0.25)
    p_path, j_path = str(tmp_path / "p" / "t.npz"), str(tmp_path / "j.npz")
    assert port.save_template(p_path) == p_path
    jax_det.save_template(j_path)
    with np.load(p_path) as p, np.load(j_path) as j:
        assert sorted(p.files) == sorted(j.files) == ["bias", "template"]
        for k in p.files:
            assert p[k].dtype == j[k].dtype
            np.testing.assert_array_equal(p[k], j[k])
    # Each package's detector loads the other's file from the default path.
    monkeypatch.setenv("FACE_TEMPLATE", p_path)
    np.testing.assert_array_equal(np.asarray(JaxDetector().template),
                                  template)
    assert JaxDetector().bias == np.float32(-0.25)
    monkeypatch.setenv("FACE_TEMPLATE", j_path)
    back = ConvHOGFaceDetector(device="cpu")
    np.testing.assert_array_equal(back.template.numpy(), template)
    assert back.bias == np.float32(-0.25)
    # With no path, the template goes where the detector reads it.
    default = str(tmp_path / "default.npz")
    monkeypatch.setenv("FACE_TEMPLATE", default)
    assert default_template_path() == default
    assert port.save_template() == default
    np.testing.assert_array_equal(
        ConvHOGFaceDetector(device="cpu").template.numpy(), template)


def test_training_helpers_equal_jax(jax_scripts):
    """``crops_for``, ``augment_positives``, ``synth_training_set``, the
    real-negative corpus and the mosaics from one ``RandomState``."""
    jax_tft = jax_scripts[0]
    path, bbox = next(iter(train_face_template.DEFAULT_ANNOTATIONS.items()))
    gray = train_face_template._gray(path)
    for name in ("crops_for", "synth", "augment"):
        r1, r2 = np.random.RandomState(0), np.random.RandomState(0)
        if name == "crops_for":
            got = train_face_template.crops_for(gray, bbox, r1)
            want = jax_tft.crops_for(gray, bbox, r2)
        elif name == "synth":
            got = train_face_template.synth_training_set(8, r1)
            want = jax_tft.synth_training_set(8, r2)
        else:
            pos = train_face_template.crops_for(
                gray, bbox, np.random.RandomState(1))[0][:9]
            got = (train_face_template.augment_positives(pos, r1),)
            want = (jax_tft.augment_positives(pos, r2),)
        for g, w in zip(got, want):
            _same_list(g, w)
        assert r1.randint(1 << 30) == r2.randint(1 << 30)
    assert len(got[0]) == 27
    assert train_face_template.real_negative_corpus() == \
        jax_tft.REAL_NEGATIVE_CORPUS
    _same_list(train_face_template.real_mosaic_negatives(n_scenes=2),
               jax_tft.real_mosaic_negatives(n_scenes=2))
    img = train_face_template.real_mosaic_negatives(n_scenes=1)[0]
    r1, r2 = np.random.RandomState(3), np.random.RandomState(3)
    _same_list(train_face_template.random_crops(img, r1, 5, lo=60, hi=200),
               jax_tft.random_crops(img, r2, 5, lo=60, hi=200))


def test_mining_and_evaluation_equal_jax(jax_scripts):
    """``mine_hard_negatives``, ``evaluate``, ``pr_curve``, ``iou`` and
    the real-composite scenes on detectors with one template."""
    from columbiaimagesearch_tpu.models.face_detector import (
        ConvHOGFaceDetector as JaxDetector,
    )
    from columbiaimagesearch_tpu.models.face_synth import make_scene

    _, jax_efd, jax_efr = jax_scripts
    port = ConvHOGFaceDetector(device="cpu")         # the shipped template
    jax_det = JaxDetector()
    np.testing.assert_array_equal(port.template.numpy(),
                                  np.asarray(jax_det.template))

    # Mining at its floor of -1 needs windows above it: a weak template.
    weak = 0.05 * np.random.RandomState(4).randn(10, 10, 8)
    p_weak = ConvHOGFaceDetector(template=weak, bias=0.0, device="cpu")
    mined = train_face_template.mine_hard_negatives(p_weak, 1, None,
                                                    per_scene=4)
    want = jax_scripts[0].mine_hard_negatives(
        JaxDetector(template=weak, bias=0.0), 1, None, per_scene=4)
    assert p_weak.threshold == 0.5 and len(mined) == 4
    _same_list(mined, want)

    specs = [make_scene(1000 + s, list(range(120, 124))) for s in range(2)]
    got = eval_face_detector.evaluate(port, specs)
    exp = jax_efd.evaluate(jax_det, specs)
    np.testing.assert_array_equal(got[1], exp[1])
    np.testing.assert_allclose(got[0], exp[0], atol=SCORE_ATOL)
    assert got[2] == exp[2] == sum(len(gt) for _, gt in specs)
    curve, want_curve = (eval_face_detector.pr_curve(*exp),
                         jax_efd.pr_curve(*exp))
    for g, w in zip(curve, want_curve):
        np.testing.assert_array_equal(g, w)
    rng = np.random.RandomState(5)
    for _ in range(50):
        a, b = (np.sort(rng.randint(0, 100, 4).reshape(2, 2), axis=0)
                .T.ravel()[[0, 2, 1, 3]] for _ in range(2))
        assert eval_face_detector.iou(a, b) == jax_efd.iou(a, b)

    got_scenes = eval_face_real_composite.build_scenes(3, 1)
    want_scenes = jax_efr.build_scenes(3, 1)
    assert len(got_scenes) == len(want_scenes) == 4
    for (gs, gg), (ws, wg) in zip(got_scenes, want_scenes):
        assert gs.dtype == ws.dtype
        np.testing.assert_array_equal(gs, ws)
        assert gg == wg


def test_train_and_evaluate_entry_points(tmp_path):
    """``train_face_template --synth`` writes a template that round-trips
    bit-equal, and both evaluations read it and write the JAX artifacts'
    schemas."""
    import json

    out = str(tmp_path / "tpl.npz")
    det, path = train_face_template.main(
        ["--synth", "8", "--steps", "20", "--mine-rounds", "0", "--out",
         out, "--cpu"])
    assert path == out
    loaded = eval_face_detector.load_detector(out, "cpu")
    np.testing.assert_array_equal(loaded.template.numpy(),
                                  det.template.numpy())
    assert loaded.bias == np.float32(det.bias)
    res = eval_face_detector.main(["--template", out, "--train-n", "8",
                                   "--eval-n", "4", "--scenes", "2",
                                   "--out", str(tmp_path / "e.json"),
                                   "--cpu"])
    with open(tmp_path / "e.json") as f:
        assert json.loads(f.read()) == res
    with open(os.path.join(os.path.dirname(SCRIPTS), "benchmarks",
                           "r04_face_detector_eval.json")) as f:
        ref = json.loads(f.readline())
    assert set(res) == set(ref) and set(res["extra"]) == set(ref["extra"])
    assert 0.0 <= res["value"] <= 1.0
    res = eval_face_real_composite.main(["--template", out, "--pos-scenes",
                                         "2", "--neg-scenes", "1", "--cpu"])
    with open(os.path.join(os.path.dirname(SCRIPTS), "benchmarks",
                           "r05_face_real_composite_eval.json")) as f:
        ref = json.loads(f.readline())
    assert set(res) == set(ref) and set(res["extra"]) == set(ref["extra"])
    assert res["extra"]["n_scenes"] == 3
