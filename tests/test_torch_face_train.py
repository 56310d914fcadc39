"""Face training in the port (``ConvHOGFaceDetector.train``,
``make_landmark_training_set``, ``train_landmark_net``) against the JAX
package's.

- The detector template trained from the same crops matches JAX's
  ``train``: full-batch gradient descent from zero is deterministic, and
  fp32 sums in another order keep the template within rtol 1e-3,
  atol 1e-5 and the bias within 1e-4.
- ``make_landmark_training_set`` is numpy + PIL in both: bit-equal.
- One Adam step (``torch.optim.Adam``) equals optax.adam's on the same
  batch: a one-row training set makes both packages' minibatches the
  same. The step is lr * g / (|g| + eps), at most lr = 1e-3: where a
  gradient is a sum that cancels to near eps = 1e-8, the two backward
  passes' fp32 rounding moves its step by up to ~0.1% of lr. So every
  parameter within atol 1e-5 (1% of lr), and all but 0.01% of them within
  1e-7.
- A short training reaches the held-out bound of
  tests/test_face_align68.py:81-91 (mean error < 0.06) and the loss
  bound (< 5e-3).
"""

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch.models.face_align import (
    init_landmark_params,
    make_landmark_training_set,
    predict_landmarks,
    train_landmark_net,
    _params_to,
)
from columbiaimagesearch_tpu_torch.models.face_detector import (
    ConvHOGFaceDetector,
)

from tests.test_extraction import face_like, neg_patch


def _crops():
    rng = np.random.RandomState(2)
    return ([face_like(rng) for _ in range(40)],
            [neg_patch(rng) for _ in range(60)], rng)


def test_detector_template_matches_jax(neg_weight=2.0):
    from columbiaimagesearch_tpu.models.face_detector import (
        ConvHOGFaceDetector as JaxDetector,
    )

    pos, neg, _ = _crops()
    want = JaxDetector(threshold=0.0).train(pos, neg, steps=200,
                                            neg_weight=neg_weight)
    got = ConvHOGFaceDetector(threshold=0.0, device="cpu").train(
        pos, neg, steps=200, neg_weight=neg_weight)
    assert got.template.shape == (10, 10, 8)
    np.testing.assert_allclose(got.template.numpy(),
                               np.asarray(want.template), rtol=1e-3,
                               atol=1e-5)
    assert abs(got.bias - want.bias) < 1e-4


def test_trained_template_separates_faces():
    pos, neg, rng = _crops()
    det = ConvHOGFaceDetector(threshold=0.0, device="cpu").train(
        pos, neg, steps=200)
    from columbiaimagesearch_tpu_torch.models.face_detector import (
        hog_features,
        score_map,
    )

    def score(im):
        f = hog_features(torch.from_numpy(im))
        return float(score_map(f, det.template, det.bias).max())

    assert min(score(face_like(rng)) for _ in range(5)) > max(
        score(neg_patch(rng)) for _ in range(5))


def test_landmark_training_set_bit_equal_to_jax():
    from columbiaimagesearch_tpu.models.face_align import (
        make_landmark_training_set as jmake,
    )

    for n_points in (5, 68):
        a = make_landmark_training_set(range(3), 2, seed=4,
                                       n_points=n_points)
        b = jmake(range(3), 2, seed=4, n_points=n_points)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="5 or 68"):
        make_landmark_training_set(range(1), 1, n_points=7)


def test_one_adam_step_equals_optax():
    from columbiaimagesearch_tpu.models.face_align import (
        train_landmark_net as jtrain,
    )

    crops, pts = make_landmark_training_set(range(1), 1, seed=0,
                                            n_points=5)
    params = init_landmark_params(seed=3, n_points=5)
    want, wloss = jtrain(params, crops, pts, steps=1, batch=4)
    got, gloss = train_landmark_net(params, crops, pts, steps=1, batch=4,
                                    device="cpu")
    assert abs(gloss - wloss) <= 1e-6 * max(1.0, abs(wloss))
    moved, off, total = 0.0, 0, 0
    for layer in params:
        for k in params[layer]:
            w = np.asarray(want[layer][k])
            np.testing.assert_allclose(got[layer][k], w, rtol=0, atol=1e-5)
            off += int((np.abs(got[layer][k] - w) > 1e-7).sum())
            total += w.size
            moved = max(moved, float(np.abs(got[layer][k]
                                            - params[layer][k]).max()))
    assert off <= 1e-4 * total, (off, total)
    assert 5e-4 < moved <= 1.01e-3                # one step of at most lr


def test_short_training_reaches_the_held_out_bound():
    crops, targets = make_landmark_training_set(range(0, 40),
                                                n_per_identity=3, seed=0)
    params = init_landmark_params(0, n_points=68)
    params, loss = train_landmark_net(params, crops, targets, steps=400,
                                      device="cpu")
    assert loss < 5e-3
    ho_crops, ho_targets = make_landmark_training_set(
        range(200, 212), n_per_identity=2, seed=1)
    pred = predict_landmarks(_params_to(params, "cpu"),
                             torch.from_numpy(ho_crops), n_points=68)
    err = float(np.abs(pred.numpy() - ho_targets).mean())
    assert err < 0.06, err
