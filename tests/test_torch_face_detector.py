"""The port's conv-HOG face detector (models/face_detector.py) against the
JAX package's (columbiaimagesearch_tpu/models/face_detector.py).

``hog_features`` and ``score_map`` agree within atol 1e-5 (fp32 both
sides; the cell means and the template convolution sum in another
order). ``detect_from_img`` on ``face_synth`` scenes, with the repo's
trained template, gives the same boxes, and scores within 1e-4.
"""

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch.models.face_detector import (
    ConvHOGFaceDetector,
    _bucket,
    hog_features,
    score_map,
)
from columbiaimagesearch_tpu_torch.models.face_synth import make_scene

ATOL = 1e-5
SCORE_ATOL = 1e-4


def _padded_scene(seed):
    img, _ = make_scene(seed, range(3), h=200, w=260, max_face=150)
    padded = np.zeros((_bucket(200), _bucket(260)), np.float32)
    padded[:200, :260] = img
    return padded


@pytest.mark.parametrize("seed", [0, 1])
def test_hog_and_score_map_match_jax(seed):
    import jax.numpy as jnp

    from columbiaimagesearch_tpu.models import face_detector as jfd

    padded = _padded_scene(seed)
    det = ConvHOGFaceDetector(device="cpu")
    want = np.asarray(jfd.hog_features(jnp.asarray(padded)))
    with torch.inference_mode():
        got = hog_features(torch.from_numpy(padded))
        smap = score_map(got, det.template, det.bias).numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    wmap = np.asarray(jfd.score_map(jnp.asarray(want),
                                    jnp.asarray(det.template.numpy()),
                                    jnp.float32(det.bias)))
    assert smap.shape == wmap.shape == (want.shape[0] - 9,
                                        want.shape[1] - 9)
    np.testing.assert_allclose(smap, wmap, rtol=0, atol=ATOL)


def test_template_is_the_jax_package_s():
    """The port loads its copy of the trained template, equal to the JAX
    package's."""
    from columbiaimagesearch_tpu.models.face_detector import (
        ConvHOGFaceDetector as JaxDetector,
    )

    det, jdet = ConvHOGFaceDetector(device="cpu"), JaxDetector()
    np.testing.assert_array_equal(det.template.numpy(),
                                  np.asarray(jdet.template))
    assert det.bias == jdet.bias


@pytest.mark.parametrize("scene", [3, 8])
def test_detect_from_img_matches_jax(scene):
    """face_synth scenes of 1-3 identities at the serving size (480x640,
    upsampled x2 by default): the same boxes as the JAX detector."""
    from columbiaimagesearch_tpu.models.face_detector import (
        ConvHOGFaceDetector as JaxDetector,
    )

    gray, gt = make_scene(scene, range(10 * scene, 10 * scene + 3))
    img = np.stack([gray.astype(np.uint8)] * 3, axis=-1)
    want = JaxDetector().detect_from_img(img)
    got = ConvHOGFaceDetector(device="cpu").detect_from_img(img)
    assert want, "the JAX detector found no face: the scene tests nothing"
    assert [{k: d[k] for k in ("left", "top", "right", "bottom")}
            for d in got] == [{k: d[k] for k in ("left", "top", "right",
                                                  "bottom")} for d in want]
    np.testing.assert_allclose([d["score"] for d in got],
                               [d["score"] for d in want], rtol=0,
                               atol=SCORE_ATOL)


def test_run_splits_into_host_and_device_halves():
    gray, _ = make_scene(5, range(2), h=240, w=320)
    det = ConvHOGFaceDetector(device="cpu")
    levels = det.pyramid(gray, 0)
    assert levels[0][0].shape == (240, 320)
    assert all(min(c.shape) >= det.min_size for c, *_ in levels)
    smaps = det.score_maps(levels)
    assert [s.shape for s in smaps] == [
        (_bucket(c.shape[0]) // 8 - 9, _bucket(c.shape[1]) // 8 - 9)
        for c, *_ in levels]
    boxes, scores = det.collect(levels, smaps)
    b2, s2 = det.run(gray, 0)
    np.testing.assert_array_equal(boxes, b2)
    np.testing.assert_array_equal(scores, s2)


@pytest.mark.parametrize("kind", ["face", "dlib"])
def test_get_detector_builds_face_detector(kind):
    """``get_detector("face")`` (and its conf alias ``"dlib"``) is the
    conv-HOG detector with the shipped template, on the device asked
    for; ``"full"`` stays None."""
    from columbiaimagesearch_tpu_torch.extraction.detector import (
        FaceDetector,
        get_detector,
    )

    det = get_detector(kind, device="cpu")
    assert isinstance(det, FaceDetector)
    assert det.model.device.type == "cpu"
    assert det.model._load_default() is not None
    gray, _ = make_scene(5, range(2), h=240, w=320, max_face=150)
    img = np.stack([gray.astype(np.uint8)] * 3, axis=-1)
    assert det.detect_from_img(img) == det.model.detect_from_img(img)
    assert get_detector("full") is None


def test_train_waits_for_training_slice():
    """Template training is ported (tests/test_torch_face_train.py holds
    it against JAX's): a short fit on face_synth crops sets the template
    and bias and returns the detector."""
    from columbiaimagesearch_tpu_torch.models.face_synth import (
        render_face,
        render_hard_negative,
    )
    from PIL import Image

    def win(a):
        return np.asarray(Image.fromarray(a).resize((80, 80)), np.float32)

    pos = []
    for i in range(6):
        img, (l, t, r, b) = render_face(i)
        pos.append(win(img[t:b, l:r]))
    neg = [win(render_hard_negative(k % 6, k)) for k in range(12)]
    det = ConvHOGFaceDetector(device="cpu")
    assert det.train(pos, neg, steps=50) is det
    assert det.template.shape == (10, 10, 8) and det.bias != 0.0
    f = lambda im: float(score_map(hog_features(torch.from_numpy(im)),
                                   det.template, det.bias).max())
    assert min(map(f, pos)) > max(map(f, neg))
