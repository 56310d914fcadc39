"""The port's face alignment (models/face_align.py) against the JAX
package's (columbiaimagesearch_tpu/models/face_align.py): the landmark
net on the JAX parameters, the Umeyama fit, the bilinear warp and the
aligner end to end.

Landmarks agree within atol 1e-5 (points in [0, 1]; fp32 convolutions
summed in another order). Warped pixels (0..255) agree within atol 1e-2:
the same gather-and-blend arithmetic, but a batched fp32 einsum may round
a source coordinate one ulp apart (7.6e-6 px at 64-128), and on a noise
image the blend moves up to 255 per px in x and in y (~4e-3). The numpy
parts are equal.
"""

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch.models.face_align import (
    CANONICAL_POINTS,
    FaceAligner,
    canonical_points_68,
    estimate_similarity,
    key5_from_68,
    predict_landmarks,
    _params_to,
    warp_affine,
)

LM_ATOL = 1e-5
PIX_ATOL = 1e-2


@pytest.mark.parametrize("n_points", [5, 68])
def test_landmark_net_matches_jax(n_points):
    import jax.numpy as jnp

    from columbiaimagesearch_tpu.models.face_align import (
        init_landmark_params,
        predict_landmarks as jpredict,
    )

    params = init_landmark_params(seed=1, n_points=n_points)
    crops = np.random.RandomState(0).rand(3, 64, 64, 1).astype(np.float32)
    want = np.asarray(jpredict(params, jnp.asarray(crops), n_points=n_points))
    got = predict_landmarks(_params_to(params, "cpu"),
                            torch.from_numpy(crops), n_points=n_points)
    assert got.shape == want.shape == (3, n_points, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LM_ATOL)


def test_numpy_parts_equal_jax():
    from columbiaimagesearch_tpu.models import face_align as jfa

    rng = np.random.RandomState(4)
    src = rng.rand(5, 2) * 100
    np.testing.assert_array_equal(estimate_similarity(src, CANONICAL_POINTS),
                                  jfa.estimate_similarity(src,
                                                          CANONICAL_POINTS))
    pts = rng.rand(68, 2)
    np.testing.assert_array_equal(key5_from_68(pts), jfa.key5_from_68(pts))
    np.testing.assert_array_equal(canonical_points_68(),
                                  jfa.canonical_points_68())


def test_warp_affine_matches_jax():
    import jax.numpy as jnp

    from columbiaimagesearch_tpu.models.face_align import warp_affine as jwarp

    rng = np.random.RandomState(5)
    imgs = (255 * rng.rand(2, 90, 120, 3)).astype(np.float32)
    A_inv = []
    for k in range(2):
        A = estimate_similarity(rng.rand(5, 2) * 60 + 20, CANONICAL_POINTS)
        M = np.eye(3)
        M[:2] = A
        A_inv.append(np.linalg.inv(M)[:2].astype(np.float32))
    A_inv = np.stack(A_inv)
    want = np.asarray(jwarp(jnp.asarray(imgs), jnp.asarray(A_inv), 150, 150))
    got = warp_affine(torch.from_numpy(imgs), torch.from_numpy(A_inv), 150,
                      150).numpy()
    assert got.shape == want.shape == (2, 150, 150, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=PIX_ATOL)


def test_aligner_matches_jax():
    """FaceAligner.align on the JAX landmark parameters: the same chips."""
    from columbiaimagesearch_tpu.models.face_align import (
        FaceAligner as JaxAligner,
    )

    from columbiaimagesearch_tpu_torch.models.face_synth import render_face

    face, (l, t, r, b) = render_face(3)
    img = np.stack([face.astype(np.uint8)] * 3, -1)
    bboxes = [{"left": l, "top": t, "right": r, "bottom": b},
              {"left": l + 4, "top": t - 3, "right": r + 2, "bottom": b}]
    jal = JaxAligner(seed=2)
    al = FaceAligner(params=jal.params, device="cpu")
    want = jal.align(img, bboxes)
    got = al.align(img, bboxes)
    assert got.shape == want.shape == (2, 150, 150, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=PIX_ATOL)
    with pytest.raises(ValueError, match="n_points"):
        FaceAligner(n_points=7, device="cpu")
