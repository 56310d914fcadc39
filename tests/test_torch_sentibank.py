"""Image -> fc7 in the port (models/layers.py, models/preprocess.py,
models/sentibank.py, native/imgpipe.py) against the JAX package on the
same numpy inputs and the same weights, carried over with
``from_flax_params``.

Tolerances: ``lrn``/``caffe_max_pool`` rtol 1e-5; ``preprocess_device``
exact; DeepSentibank fc7 and logits at full width rtol/atol 2e-3, as
tests/test_sentibank.py:106 holds the JAX net to its torch oracle; the
golden fc7 of tests/data/golden_fc7.npz at tests/test_sentibank_weights.py's
rtol 1e-3, atol 1e-5. The card tests (marked ``cuda``) hold the card's
forward to the CPU's at rtol/atol 2e-3 and import no JAX and no repo test
helper.
"""

import io
import os
import pickle
import time

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch.models.layers import caffe_max_pool, lrn
from columbiaimagesearch_tpu_torch.models.preprocess import (
    default_mean_image,
    preprocess_batch,
    preprocess_device,
)
from columbiaimagesearch_tpu_torch.models.sentibank import (
    DeepSentibank,
    SentibankFeaturizer,
    from_flax_params,
    init_params,
    load_caffe_weights,
    load_torch_weights,
    load_weights_npz,
    save_weights_npz,
)
from columbiaimagesearch_tpu_torch.native.imgpipe import decode_resize_batch

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
HOPPER = os.path.join(DATA, "grace_hopper.jpg")


def steady_jax_imgpipe(timeout_s=60.0):
    """Load the JAX package's native decoder for certain before a test
    compares the two packages' decode routes.

    The JAX loader compiles ``native/libimgpipe.so`` straight onto the
    library's path (no temporary file, no rename) whenever the file is
    missing or older than its source. Processes that start at once (pytest
    workers importing the same test modules) then run g++ on the same
    output together, and one that loads the library while another is still
    writing it gets ``OSError``, caches None for its lifetime and decodes
    with PIL, whose pixels differ from the native decoder's. This clears
    both caches and retries the load until the file is whole.
    """
    from columbiaimagesearch_tpu.native import build, imgpipe

    deadline = time.monotonic() + timeout_s
    while True:
        with build._LOCK:
            build._CACHE.pop("imgpipe", None)
        imgpipe._lib = None
        if build.load_library("imgpipe") is not None:
            break
        if time.monotonic() > deadline:
            pytest.fail(f"the JAX package's native/libimgpipe.so did not "
                        f"load within {timeout_s:.0f} s (g++, libjpeg or "
                        f"libpng missing?)")
        time.sleep(0.5)
    # the next decode binds the loaded library's symbols afresh
    imgpipe._lib = None
    assert imgpipe.imgpipe_available()


def _jpegs(rng, n, shape=(60, 50, 3)):
    from PIL import Image

    out = []
    for _ in range(n):
        b = io.BytesIO()
        Image.fromarray(rng.randint(0, 255, shape, dtype=np.uint8)).save(
            b, format="JPEG", quality=90)
        out.append(b.getvalue())
    return out


@pytest.mark.parametrize("shape", [(2, 96, 27, 27), (1, 7, 5, 3)])
def test_lrn_matches_jax(shape):
    from columbiaimagesearch_tpu.models.layers import lrn as jax_lrn

    x = np.random.RandomState(0).randn(*shape).astype(np.float32) * 30
    want = np.asarray(jax_lrn(np.transpose(x, (0, 2, 3, 1)), 5, 1e-4, 0.75))
    got = lrn(torch.from_numpy(x), 5, 1e-4, 0.75).numpy()
    np.testing.assert_allclose(got, np.transpose(want, (0, 3, 1, 2)),
                               rtol=1e-5)


@pytest.mark.parametrize("hw", [(55, 55), (13, 13), (14, 9)])
def test_caffe_max_pool_matches_jax(hw):
    from columbiaimagesearch_tpu.models.layers import (
        caffe_max_pool as jax_pool,
    )

    x = np.random.RandomState(1).randn(2, 4, *hw).astype(np.float32)
    want = np.asarray(jax_pool(np.transpose(x, (0, 2, 3, 1)), 3, 2))
    got = caffe_max_pool(torch.from_numpy(x), 3, 2).numpy()
    np.testing.assert_allclose(got, np.transpose(want, (0, 3, 1, 2)),
                               rtol=1e-5)


def test_preprocess_device_matches_jax_exactly():
    from columbiaimagesearch_tpu.models.preprocess import (
        preprocess_device as jax_pre,
    )

    rng = np.random.RandomState(2)
    x = rng.randint(0, 255, (3, 256, 256, 3), dtype=np.uint8)
    mean = default_mean_image() + rng.rand(227, 227, 3).astype(np.float32)
    want = np.asarray(jax_pre(x, mean))
    got = preprocess_device(torch.from_numpy(x), torch.from_numpy(mean))
    assert got.shape == (3, 3, 227, 227) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.transpose(want, (0, 3, 1, 2)))


@pytest.fixture(scope="module")
def jax_net():
    """The JAX net's params from test_sentibank's random Caffe blobs, and a
    seeded full-width batch of 2."""
    from columbiaimagesearch_tpu.models.sentibank import (
        load_caffe_weights as jax_load_caffe,
    )

    from tests.test_sentibank import make_caffe_blobs

    rng = np.random.RandomState(0)
    params = jax_load_caffe(make_caffe_blobs(rng))
    x = rng.rand(2, 227, 227, 3).astype(np.float32) * 50.0
    return params, x


def test_fc7_and_logits_match_jax(jax_net):
    from columbiaimagesearch_tpu.models.sentibank import (
        sentibank_features,
        sentibank_logits,
    )

    params, x = jax_net
    want_f = np.asarray(sentibank_features(params, x))
    want_l = np.asarray(sentibank_logits(params, x))
    net = DeepSentibank.from_state_dict(from_flax_params(
        {k: {n: np.asarray(a) for n, a in v.items()}
         for k, v in params.items()}))
    with torch.inference_mode():
        xt = torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy())
        got_f = net.features(xt).numpy()
        got_l = net(xt).numpy()
    assert got_f.shape == (2, 4096) and got_l.shape == (2, 2089)
    assert (got_f >= 0).all() and np.linalg.norm(got_f) > 1.0
    np.testing.assert_allclose(got_f, want_f, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got_l, want_l, rtol=2e-3, atol=2e-3)


def test_golden_fc7_on_grace_hopper():
    """Deterministic Caffe blobs through ``load_caffe_weights`` reproduce
    the committed fc7 of the real photo (and its mirror image)."""
    from PIL import Image

    from tests.test_sentibank_weights import _deterministic_caffe_blobs

    img = np.asarray(Image.open(HOPPER).convert("RGB"))
    x = preprocess_batch([img, img[:, ::-1]], default_mean_image(),
                         device="cpu")
    net = DeepSentibank.from_state_dict(
        load_caffe_weights(_deterministic_caffe_blobs()))
    with torch.inference_mode():
        got = net.features(x).numpy()
    with np.load(os.path.join(DATA, "golden_fc7.npz")) as z:
        want = z["fc7"]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_weights_npz_is_shared_with_jax(tmp_path, writer):
    """One npz (JAX key layout) serves both packages."""
    from columbiaimagesearch_tpu.models.sentibank import (
        load_caffe_weights as jax_load_caffe,
        load_weights_npz as jax_load_npz,
        save_weights_npz as jax_save_npz,
    )

    from tests.test_sentibank_weights import _deterministic_caffe_blobs

    blobs = _deterministic_caffe_blobs(seed=3)
    path = str(tmp_path / "w.npz")
    if writer == "jax":
        jax_save_npz(jax_load_caffe(blobs), path)
        got = load_weights_npz(path)
        for name, t in load_caffe_weights(blobs).items():
            np.testing.assert_array_equal(got[name].numpy(), t.numpy())
    else:
        save_weights_npz(load_caffe_weights(blobs), path)
        got = jax_load_npz(path)
        for layer, lv in jax_load_caffe(blobs).items():
            for k in ("kernel", "bias"):
                np.testing.assert_array_equal(np.asarray(got[layer][k]),
                                              np.asarray(lv[k]))


def test_torch_and_random_weights_load():
    sd = init_params(seed=4)
    again = init_params(seed=4)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    torch_style = {k.replace("fc8_t", "fc8"): v for k, v in sd.items()}
    got = load_torch_weights(torch_style)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    net = DeepSentibank.from_state_dict(sd)
    assert not any(p.requires_grad for p in net.parameters())


def test_native_decode_matches_jax_binding():
    """The port's binding of native/imgpipe.cpp decodes like the JAX one
    (both take the same source; the PIL path where it is not built)."""
    from columbiaimagesearch_tpu.native.imgpipe import (
        decode_resize_batch as jax_decode,
    )

    steady_jax_imgpipe()
    with open(HOPPER, "rb") as f:
        bufs = [f.read(), b"not an image"] + _jpegs(
            np.random.RandomState(5), 2)
    for dct in (True, False):
        got, st = decode_resize_batch(bufs, dct_scale=dct)
        want, wst = jax_decode(bufs, dct_scale=dct)
        assert list(st) == list(wst) == [0, -1, 0, 0]
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def featurizer_pair():
    """The JAX and the port's SentibankFeaturizer on the same weights."""
    from columbiaimagesearch_tpu.models.sentibank import (
        SentibankFeaturizer as JaxFeaturizer,
        load_caffe_weights as jax_load_caffe,
    )

    from tests.test_sentibank_weights import _deterministic_caffe_blobs

    steady_jax_imgpipe()
    blobs = _deterministic_caffe_blobs(seed=1)
    return (JaxFeaturizer(params=jax_load_caffe(blobs)),
            SentibankFeaturizer(params=load_caffe_weights(blobs),
                                device="cpu"))


def test_featurizer_routes_match_jax(featurizer_pair):
    jf, tf = featurizer_pair
    rng = np.random.RandomState(6)
    with open(HOPPER, "rb") as f:
        bufs = [f.read()] + _jpegs(rng, 2)
    want, wst = jf.featurize_buffers(bufs)
    got, st = tf.featurize_buffers(bufs)
    assert list(st) == [int(s) for s in wst] == [0, 0, 0]
    assert isinstance(got, np.ndarray) and got.shape == (3, 4096)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-4)
    # the serving wave route and the split halves give the same rows
    wave, n, wstat = tf.featurize_wave(bufs)
    assert n == 3 and list(wstat) == [0, 0, 0]
    assert isinstance(wave, torch.Tensor) and not wave.requires_grad
    pix, _ = tf.decode_wave(bufs)
    pwave, pn = tf.featurize_pixel_wave(pix)
    np.testing.assert_allclose(wave.numpy(), got, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(pwave.numpy(), wave.numpy())
    dev, dstat = tf.featurize_buffers_device(bufs)
    np.testing.assert_array_equal(dev.numpy(), wave.numpy())
    # decoded images through the host resize path
    imgs = [np.asarray(__import__("PIL.Image", fromlist=["Image"]).open(
        io.BytesIO(b)).convert("RGB")) for b in bufs[1:]]
    np.testing.assert_allclose(tf.featurize_batch(imgs),
                               np.asarray(jf.featurize_batch(imgs)),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(tf.featurize(imgs[0]),
                               tf.featurize_batch(imgs)[0], rtol=1e-4,
                               atol=1e-5)


def test_featurize_buffers_pipelined_matches_single_wave(featurizer_pair):
    """Past PIPELINE_CHUNK the decode-ahead path runs; features and status
    match the one-wave path, a decode failure included."""
    _, tf = featurizer_pair
    bufs = _jpegs(np.random.RandomState(4), 4)
    bufs[2] = b"not an image"
    bufs = bufs * 2
    tf.PIPELINE_CHUNK = 3
    try:
        feats_p, status_p = tf.featurize_buffers(bufs)
    finally:
        del tf.PIPELINE_CHUNK
    feats_1, status_1 = tf.featurize_buffers(bufs)
    assert [int(s) for s in status_p] == [int(s) for s in status_1]
    assert [i for i, s in enumerate(status_p) if int(s)] == [2, 6]
    np.testing.assert_allclose(feats_p, feats_1, rtol=1e-5, atol=1e-6)


def test_featurizer_bf16_and_options(featurizer_pair):
    _, tf = featurizer_pair
    bf = SentibankFeaturizer(params=tf.params, compute_dtype="bfloat16",
                             device="cpu")
    pix, _ = tf.decode_wave(_jpegs(np.random.RandomState(7), 2))
    a = tf.featurize_pixel_wave(pix)[0].numpy()
    b = bf.featurize_pixel_wave(pix)[0]
    assert b.dtype == torch.float32
    cos = (a * b.numpy()).sum(1) / (np.linalg.norm(a, axis=1)
                                    * np.linalg.norm(b.numpy(), axis=1))
    assert (cos > 0.99).all(), cos
    dd = SentibankFeaturizer(params=tf.params, device_decode=True,
                             device="cpu")
    assert dd.device_decode and not tf.device_decode
    from columbiaimagesearch_tpu_torch.native import imgpipe

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(imgpipe, "coeffs_available", lambda: False)
        mp.setattr(imgpipe, "coeffs_build_error", lambda: "g++: not found")
        with pytest.raises(RuntimeError, match="g\\+\\+: not found"):
            SentibankFeaturizer(params=tf.params, device_decode=True,
                                device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        SentibankFeaturizer(params=tf.params, compute_dtype="float16")


def test_featurizer_autoloads_weights(tmp_path, monkeypatch):
    sd = init_params(seed=2)
    path = str(tmp_path / "sentibank.npz")
    save_weights_npz(sd, path)
    monkeypatch.setenv("SENTIBANK_WEIGHTS", path)
    f = SentibankFeaturizer(device="cpu")
    assert f.pretrained and torch.equal(f.params["fc7.weight"],
                                        sd["fc7.weight"])
    monkeypatch.setenv("SENTIBANK_WEIGHTS", str(tmp_path / "missing.npz"))
    assert not SentibankFeaturizer(device="cpu").pretrained


# ------------------------------------------------------------------- card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8])
def test_fc7_on_card_matches_cpu(cuda_device, n):
    """Same weights, same pixels: the card's fc7 (TF32 off) equals the CPU
    forward at rtol/atol 2e-3."""
    sd = init_params(seed=0)
    rng = np.random.RandomState(n)
    pix = rng.randint(0, 255, (n, 256, 256, 3), dtype=np.uint8)
    cpu = SentibankFeaturizer(params=sd, device="cpu")
    card = SentibankFeaturizer(params=sd, device=cuda_device)
    want = cpu.featurize_pixel_wave(pix)[0].numpy()
    got, got_n = card.featurize_pixel_wave(pix)
    assert got_n == n and got.device.type == "cuda"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=2e-3,
                               atol=2e-3)


@pytest.mark.cuda
def test_model_pickled_on_cpu_loads_on_card(cuda_device):
    from columbiaimagesearch_tpu_torch.index.model import LOPQModelPCA

    rng = np.random.RandomState(0)
    V, F, S, Dh = 4, 2, 8, 4
    m = LOPQModelPCA(rng.randn(2, V, Dh), rng.randn(2, V, Dh, Dh),
                     rng.randn(2, V, Dh), rng.randn(2, F, S, Dh // F),
                     rng.randn(12, 2 * Dh), rng.randn(12), True,
                     device="cpu")
    host = pickle.loads(pickle.dumps(m))
    assert host.device.type == "cpu"          # unpickled on the host
    back = host.to(cuda_device)                # placed as the facade does
    assert back.device.type == "cuda" and back.pca_P.device.type == "cuda"
    np.testing.assert_array_equal(back.Rs.cpu().numpy(), m.Rs.numpy())
    assert back.renorm is True
