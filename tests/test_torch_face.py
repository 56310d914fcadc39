"""The port's face embedder (models/face.py) against the JAX package's
(columbiaimagesearch_tpu/models/face.py) on the same parameters and chips.

``FaceResNet`` must equal the JAX ``face_embeddings`` at rtol 1e-4, atol
1e-4 (fp32 both sides, 29 convolutions summed in another order; the
embeddings are O(1)). ``extract_chip`` is bit-equal (the same PIL resize).
The npz weights round-trip in the JAX key layout both ways.
"""

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch.models.face import (
    BLOCKS,
    EMBED_DIM,
    FaceEmbedder,
    FaceResNet,
    extract_chip,
    face_embeddings,
    from_flax_params,
    init_params,
    load_weights_npz,
    save_weights_npz,
)

RTOL, ATOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def jax_params():
    from columbiaimagesearch_tpu.models.face import init_params as jinit

    return jinit(seed=3)


@pytest.fixture(scope="module")
def chips():
    rng = np.random.RandomState(0)
    return rng.randint(0, 256, (2, 150, 150, 3)).astype(np.float32)


def test_face_resnet_matches_jax(jax_params, chips):
    from columbiaimagesearch_tpu.models.face import face_embeddings as jfe

    want = np.asarray(jfe(jax_params, chips))
    net = FaceResNet.from_state_dict(from_flax_params(jax_params), "cpu")
    with torch.inference_mode():
        got = face_embeddings(net, torch.from_numpy(chips)).numpy()
    assert got.shape == want.shape == (2, EMBED_DIM)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_topology_is_the_jax_code_s():
    """13 residual blocks, three of them down blocks with a 1x1
    projection, as face.py:60-70 builds them."""
    assert len(BLOCKS) == 13
    net = FaceResNet(device="meta")
    assert [b.proj is not None for b in net.blocks] == [d for _, d in BLOCKS]
    assert sum(d for _, d in BLOCKS) == 3


def test_extract_chip_bit_equal():
    from columbiaimagesearch_tpu.models.face import extract_chip as jchip

    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (220, 180, 3), dtype=np.uint8)
    gray = rng.randint(0, 256, (90, 120), dtype=np.uint8)
    for im, bbox in ((img, {"left": 30, "top": 40, "right": 150,
                            "bottom": 170}),
                     (img, {"left": -10, "top": 0, "right": 60,
                            "bottom": 230}),
                     (img, {"left": 50, "top": 50, "right": 50,
                            "bottom": 80}),
                     (gray, {"left": 10, "top": 20, "right": 70,
                             "bottom": 80})):
        got, want = extract_chip(im, bbox), jchip(im, bbox)
        assert got.dtype == want.dtype and got.shape == (150, 150, 3)
        np.testing.assert_array_equal(got, want)


def test_npz_roundtrip_in_jax_layout(jax_params, chips, tmp_path):
    """JAX save -> port load, and port save -> JAX load, give the same
    embeddings as the parameters they came from."""
    from columbiaimagesearch_tpu.models.face import (
        face_embeddings as jfe,
        load_weights_npz as jload,
        save_weights_npz as jsave,
    )

    jpath = str(tmp_path / "jax.npz")
    jsave(jax_params, jpath)
    sd = load_weights_npz(jpath)
    want = from_flax_params(jax_params)
    assert sd.keys() == want.keys()
    for k in sd:
        assert torch.equal(sd[k], want[k]), k

    port = init_params(seed=5)
    tpath = str(tmp_path / "port.npz")
    save_weights_npz(port, tpath)
    with np.load(tpath) as z, np.load(jpath) as zj:
        assert set(z.files) == set(zj.files)
    net = FaceResNet.from_state_dict(port, "cpu")
    with torch.inference_mode():
        got = face_embeddings(net, torch.from_numpy(chips)).numpy()
    np.testing.assert_allclose(np.asarray(jfe(jload(tpath), chips)), got,
                               rtol=RTOL, atol=ATOL)


def test_face_embedder_contract(chips):
    """float64 [N, 128] at the host boundary, bbox plumbing, determinism;
    the CPU runs only where it is asked for."""
    emb = FaceEmbedder(seed=0, device="cpu")
    assert not emb.pretrained and emb.device.type == "cpu"
    rng = np.random.RandomState(2)
    img = rng.randint(0, 255, (220, 180, 3), dtype=np.uint8)
    bbox = {"left": 30, "top": 40, "right": 150, "bottom": 170}
    f1 = emb.featurize(img, bbox)
    f2 = emb.featurize_batch(img, [bbox, bbox])
    assert f1.dtype == np.float64 and f1.shape == (EMBED_DIM,)
    assert f2.dtype == np.float64 and f2.shape == (2, EMBED_DIM)
    np.testing.assert_array_equal(f1, emb.featurize(img, bbox))
    # one batch of two: another convolution algorithm than one chip
    np.testing.assert_allclose(f2[0], f2[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f1, f2[0], rtol=1e-5, atol=1e-5)
    out = emb.featurize_chips(chips.astype(np.uint8))
    assert out.shape == (2, EMBED_DIM) and out.dtype == np.float64
    assert np.isfinite(out).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8])
def test_embedder_on_card_matches_cpu(cuda_device, n):
    """Same weights, same chips: the card's FaceResNet (cuDNN, TF32 off)
    equals the CPU forward at rtol 1e-4, atol 1e-4."""
    sd = init_params(seed=0)
    chips = np.random.RandomState(n).randint(0, 256, (n, 150, 150, 3),
                                             dtype=np.uint8)
    card = FaceEmbedder(params=sd, device=cuda_device)
    got = card.embed(chips)
    assert got.device.type == "cuda" and got.shape == (n, EMBED_DIM)
    want = FaceEmbedder(params=sd, device="cpu").featurize_chips(chips)
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=RTOL, atol=ATOL)


def test_face_embedder_reads_weights_env(jax_params, chips, tmp_path,
                                         monkeypatch):
    """``params=None`` loads $FACE_WEIGHTS, the file a deployment drops."""
    from columbiaimagesearch_tpu.models.face import (
        face_embeddings as jfe,
        save_weights_npz as jsave,
    )

    path = str(tmp_path / "face.npz")
    jsave(jax_params, path)
    monkeypatch.setenv("FACE_WEIGHTS", path)
    emb = FaceEmbedder(device="cpu")
    assert emb.pretrained
    np.testing.assert_allclose(emb.featurize_chips(chips),
                               np.asarray(jfe(jax_params, chips)),
                               rtol=RTOL, atol=ATOL)
