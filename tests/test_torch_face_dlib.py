"""The port's import-exact dlib face net (models/face_dlib.py) against the
JAX package's (columbiaimagesearch_tpu/models/face_dlib.py) on the same
dlib-layout weights and chips.

Embeddings agree at rtol 2e-3, atol 2e-4, the tolerance of
tests/test_face_dlib.py's own torch twin (29 fp32 convolutions summed in
another order); weight conversion and npz files are exact.
"""

import numpy as np
import torch

from columbiaimagesearch_tpu_torch.models.face_dlib import (
    BLOCKS,
    DlibExactFaceEmbedder,
    _tree_to,
    dlib_face_embeddings,
    init_params,
    load_dlib_weights,
    load_params_npz,
    save_params_npz,
)

RTOL, ATOL = 2e-3, 2e-4


def _dlib_blobs(seed=0):
    """Random weights in dlib's native layout with trained-like scales (the
    generator of tests/test_face_dlib.py:26-47)."""
    r = np.random.RandomState(seed)
    blobs = {}

    def con(i, cout, cin, k):
        blobs[f"con{i}"] = (0.1 * r.randn(cout, cin, k, k)).astype(
            np.float32)
        blobs[f"affine{i}"] = (
            (1.0 + 0.1 * r.randn(cout)).astype(np.float32),
            (0.05 * r.randn(cout)).astype(np.float32))

    con(0, 32, 3, 7)
    ci, cin = 1, 32
    for n, _down in BLOCKS:
        con(ci, n, cin, 3)
        con(ci + 1, n, n, 3)
        ci += 2
        cin = max(cin, n)
    blobs["fc"] = (0.05 * r.randn(256, 128)).astype(np.float32)
    return blobs


def _flat(params):
    out = {"fc": np.asarray(params["fc"])}
    out.update({f"stem/{k}": np.asarray(v)
                for k, v in params["stem"].items()})
    for i, blk in enumerate(params["blocks"]):
        out.update({f"blocks/{i}/{k}": np.asarray(v) for k, v in blk.items()})
    return out


def test_dlib_embeddings_match_jax():
    from columbiaimagesearch_tpu.models.face_dlib import (
        dlib_face_embeddings as jemb,
        load_dlib_weights as jload,
    )

    blobs = _dlib_blobs(0)
    chips = np.random.RandomState(1).randint(0, 255, (2, 150, 150, 3)
                                             ).astype(np.float32)
    want = np.asarray(jemb(jload(blobs), chips))
    params = load_dlib_weights(blobs)
    for k, v in _flat(jload(blobs)).items():
        np.testing.assert_array_equal(_flat(params)[k], v)
    with torch.inference_mode():
        got = dlib_face_embeddings(_tree_to(params, "cpu"),
                                   torch.from_numpy(chips)).numpy()
    assert got.shape == want.shape == (2, 128)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_init_and_npz_match_jax(tmp_path):
    """``init_params`` draws the JAX package's values (one numpy RNG); the
    npz files of either package load in the other."""
    from columbiaimagesearch_tpu.models.face_dlib import (
        init_params as jinit,
        load_params_npz as jload_npz,
        save_params_npz as jsave_npz,
    )

    mine, theirs = _flat(init_params(3)), _flat(jinit(3))
    assert mine.keys() == theirs.keys()
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k])
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jsave_npz(jinit(4), jpath)
    save_params_npz(_tree_to(init_params(4), "cpu"), tpath)
    for a, b in ((_flat(load_params_npz(jpath)), _flat(jload_npz(tpath))),
                 (_flat(load_params_npz(tpath)), _flat(init_params(4)))):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_embedder_facade_matches_jax():
    """float64 [N, 128] at the host boundary, the same bbox chips and
    embeddings as the JAX facade, deterministic."""
    from columbiaimagesearch_tpu.models.face_dlib import (
        DlibExactFaceEmbedder as JaxEmbedder,
    )

    emb, jemb = DlibExactFaceEmbedder(seed=0, device="cpu"), JaxEmbedder(seed=0)
    rng = np.random.RandomState(2)
    img = rng.randint(0, 255, (220, 180, 3), dtype=np.uint8)
    bbox = {"left": 30, "top": 40, "right": 150, "bottom": 170}
    f1 = emb.featurize(img, bbox)
    assert f1.dtype == np.float64 and f1.shape == (128,)
    np.testing.assert_array_equal(f1, emb.featurize(img, bbox))
    np.testing.assert_allclose(f1, jemb.featurize(img, bbox), rtol=RTOL,
                               atol=ATOL)
    chips = rng.randint(0, 255, (3, 150, 150, 3)).astype(np.uint8)
    out = emb.featurize_chips(chips)
    assert out.shape == (3, 128) and out.dtype == np.float64
    np.testing.assert_allclose(out, jemb.featurize_chips(chips), rtol=RTOL,
                               atol=ATOL)
