"""Device JPEG decode in the port (native/csrc/jpegcoef.cpp through
native/imgpipe.py, models/jpeg_device.py, the featurizer's coefficient
route) against the JAX package.

- The port's coefficient reader needs no libjpeg; the JAX package's
  (``imgpipe_read_coeffs_batch``) is libjpeg-turbo's
  ``jpeg_read_coefficients``. Quantized coefficients are fixed by the
  bitstream, so the two are held **bit-equal** (ycoef, ccoef, qtab, dims,
  status) on a corpus of baseline, progressive, optimized, restart-marker,
  odd-size, other-subsampling, non-JPEG, truncated and hand-edited files,
  at every msub and at 1 and 4 threads.
- ``decode_jpeg_coeffs`` against JAX's on the same coefficients: floats
  within 1e-3 levels; after rounding, at most 0.1% of the values one level
  apart (the matmul order differs from XLA's); against the host full
  decode within JAX's bounds (mean < 3 levels, p99 < 12,
  tests/test_jpeg_device.py:100-117).
- The featurizer's coefficient route against JAX's on the same weights
  (fc7 rtol/atol 2e-3, as test_torch_sentibank.py holds the full-width
  fc7: the one-level rounding flips above move a few small fc7 values by
  ~1e-3) and against the port's pixel route (statuses equal, cosine >
  0.995, JAX's bound).
"""

import io
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from columbiaimagesearch_tpu_torch.models import jpeg_device as tjd
from columbiaimagesearch_tpu_torch.native import imgpipe as tip


@pytest.fixture(scope="module")
def jip():
    from columbiaimagesearch_tpu.native import imgpipe

    from tests.test_torch_sentibank import steady_jax_imgpipe

    steady_jax_imgpipe()
    assert imgpipe.coeffs_available()
    return imgpipe


def _img(rng, h, w, gray=False):
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([(xx * 3 + yy) % 256, (yy * 2) % 256,
                  (xx + yy * 5) % 256], -1).astype(np.float64)
    a = np.clip(a + rng.normal(0, 20, a.shape), 0, 255).astype(np.uint8)
    return a[..., 0].copy() if gray else a


def _enc(a, fmt="JPEG", **kw):
    b = io.BytesIO()
    Image.fromarray(a).save(b, fmt, **kw)
    return b.getvalue()


def _segments(b):
    """(marker, bytes) of each segment after SOI; the last is SOS + data."""
    out, i = [], 2
    while i < len(b):
        m = b[i + 1]
        if m == 0xDA:
            out.append((m, b[i:]))
            break
        n = (b[i + 2] << 8) | b[i + 3]
        out.append((m, b[i:i + 2 + n]))
        i += 2 + n
    return out


def _join(segs):
    return b"\xff\xd8" + b"".join(s for _, s in segs)


def _strip(b, marker):
    return _join([(m, s) for m, s in _segments(b) if m != marker])


def _adobe(b, transform):
    """APP0 (JFIF) replaced by an Adobe APP14 with ``transform``."""
    data = b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([transform])
    seg = b"\xff\xee" + struct.pack(">H", len(data) + 2) + data
    return _join([(0xEE, seg)] + [(m, s) for m, s in _segments(b)
                                  if m != 0xE0])


def _ids(b, new):
    """Component ids 1, 2, 3 renamed to ``new`` in SOF and SOS."""
    out = []
    for m, s in _segments(b):
        s = bytearray(s)
        if m in (0xC0, 0xC2):
            for k in range(3):
                s[10 + 3 * k] = new[k]
        if m == 0xDA:
            for k in range(s[4]):
                s[5 + 2 * k] = new[s[5 + 2 * k] - 1]
        out.append((m, bytes(s)))
    return _join(out)


def _dqt16(b):
    """Every quantization table rewritten with 16-bit entries."""
    out = []
    for m, s in _segments(b):
        if m == 0xDB:
            body, nb, i = s[4:], b"", 0
            while i < len(body):
                nb += bytes([0x10 | body[i]]) + b"".join(
                    struct.pack(">H", v) for v in body[i + 1:i + 65])
                i += 65
            s = b"\xff\xdb" + struct.pack(">H", len(nb) + 2) + nb
        out.append((m, s))
    return _join(out)


def _sof(b, marker=None, precision=None):
    s = bytearray(b)
    i = s.find(b"\xff\xc0")
    if marker is not None:
        s[i + 1] = marker
    if precision is not None:
        s[i + 4] = precision
    return bytes(s)


def _before_second_scan(b, segment):
    """``segment`` inserted before the second SOS of a multi-scan file."""
    i = b.find(b"\xff\xda", b.find(b"\xff\xda") + 2)
    return b[:i] + segment + b[i:]


def _corpus():
    rng = np.random.default_rng(0)
    c = {}
    for q in (50, 75, 95):
        c[f"baseline_q{q}"] = _enc(_img(rng, 96, 128), quality=q)
    c["progressive"] = _enc(_img(rng, 96, 128), quality=80, progressive=True)
    c["optimized"] = _enc(_img(rng, 96, 128), quality=80, optimize=True)
    c["odd_130x202"] = _enc(_img(rng, 130, 202), quality=80)
    c["odd_37x53"] = _enc(_img(rng, 37, 53), quality=80)
    c["odd_37x53_prog"] = _enc(_img(rng, 37, 53), quality=80,
                               progressive=True)
    c["restart_blocks"] = _enc(_img(rng, 96, 128), quality=80,
                               restart_marker_blocks=3)
    c["restart_rows_prog"] = _enc(_img(rng, 96, 128), quality=80,
                                  restart_marker_rows=1, progressive=True)
    c["restart_every_mcu"] = _enc(_img(rng, 130, 202), quality=80,
                                  restart_marker_blocks=1)
    c["444"] = _enc(_img(rng, 96, 128), quality=80, subsampling=0)
    c["422"] = _enc(_img(rng, 96, 128), quality=80, subsampling=1)
    c["gray"] = _enc(_img(rng, 96, 128, gray=True), quality=80)
    c["png"] = _enc(_img(rng, 32, 32), "PNG")
    c["garbage"] = bytes(rng.integers(0, 256, 300, dtype=np.uint8))
    c["garbage_soi"] = b"\xff\xd8" + bytes(rng.integers(0, 256, 300,
                                                        dtype=np.uint8))
    c["empty"] = b""
    full = _enc(_img(rng, 130, 202), quality=80)
    prog = _enc(_img(rng, 130, 202), quality=80, progressive=True)
    sos = full.find(b"\xff\xda")
    n = (full[sos + 2] << 8) | full[sos + 3]
    c["cut_after_sos"] = full[:sos + 2 + n]
    c["cut_7_after_sos"] = full[:sos + 2 + n + 7]
    c["cut_mid_scan"] = full[:len(full) // 2]
    c["cut_prog_half"] = prog[:len(prog) // 2]
    c["cut_prog_80pct"] = prog[:len(prog) * 4 // 5]
    c["too_large"] = _enc(_img(rng, 400, 400), quality=80)
    base = _enc(_img(rng, 96, 128), quality=80)
    c["no_jfif"] = _strip(base, 0xE0)
    c["adobe_rgb"] = _adobe(base, 0)
    c["adobe_ycc"] = _adobe(base, 1)
    c["adobe_unknown"] = _adobe(base, 2)
    c["ids_rgb"] = _ids(_strip(base, 0xE0), [82, 71, 66])
    c["ids_rgb_jfif"] = _ids(base, [82, 71, 66])
    c["ids_other"] = _ids(_strip(base, 0xE0), [5, 6, 7])
    c["no_dht"] = _strip(base, 0xC4)
    c["no_dht_prog"] = _strip(c["progressive"], 0xC4)
    c["no_dqt"] = _strip(base, 0xDB)
    c["dqt16"] = _dqt16(base)
    c["dqt16_prog"] = _dqt16(c["progressive"])
    c["sof1"] = _sof(base, marker=0xC1)
    c["sof3_lossless"] = _sof(base, marker=0xC3)
    c["sof5_hierarchical"] = _sof(base, marker=0xC5)
    c["precision12"] = _sof(base, precision=12)
    # A table redefined after the first scan: the reader reports the last
    # one defined, as JAX reads cinfo.quant_tbl_ptrs after the whole read.
    c["dqt_between_scans"] = _before_second_scan(
        c["progressive"], b"\xff\xdb\x00\x43\x00"
        + bytes((k % 50) + 1 for k in range(64)))
    # A restart interval the later scans do not honour: libjpeg's resync.
    c["dri_between_scans"] = _before_second_scan(
        c["progressive"], b"\xff\xdd\x00\x04\x00\x03")
    c["dup_soi"] = base[:2] + base
    c["unknown_marker"] = base[:2] + b"\xff\x02" + base[2:]
    c["comment"] = base[:2] + b"\xff\xfe\x00\x05abc" + base[2:]
    c["junk_before_marker"] = base[:2] + b"\x12\x34" + base[2:]
    return c


CORPUS = _corpus()


def test_corpus_covers_every_status(jip):
    st = jip.read_coeffs_batch(list(CORPUS.values()), 4, 18, 26)[4]
    assert set(st.tolist()) == {0, -1, -2, -3, -4}


@pytest.mark.parametrize("msub", range(1, 9))
def test_reader_bit_equal_to_libjpeg(jip, msub):
    bufs = list(CORPUS.values())
    for threads in (1, 4):
        want = jip.read_coeffs_batch(bufs, msub, 18, 26, n_threads=threads)
        got = tip.read_coeffs_batch(bufs, msub, 18, 26, n_threads=threads)
        for name, w, g in zip(("ycoef", "ccoef", "qtab", "dims", "status"),
                              want, got):
            assert w.dtype == g.dtype and w.shape == g.shape, name
            bad = [k for k, a, b in zip(CORPUS, w, g)
                   if not np.array_equal(a, b)]
            assert not bad, (name, threads, bad)


def test_reader_bit_equal_on_corrupted_files(jip):
    """Random byte edits of a baseline, a progressive and a restart file:
    libjpeg's warnings (bad Huffman codes, wrong restart markers,
    premature ends) all keep their data, so the coefficients must agree
    wherever it does not fail."""
    rng = np.random.default_rng(1)
    srcs = [CORPUS["baseline_q75"], CORPUS["progressive"],
            CORPUS["restart_blocks"]]
    muts = []
    for k in range(240):
        b = bytearray(srcs[k % 3])
        for _ in range(rng.integers(1, 4)):
            b[rng.integers(2, len(b))] = rng.integers(0, 256)
        muts.append(bytes(b))
    want = jip.read_coeffs_batch(muts, 8, 12, 16, n_threads=4)
    got = tip.read_coeffs_batch(muts, 8, 12, 16, n_threads=4)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    assert (want[4] == 0).sum() > 100 and (want[4] == -1).sum() > 10


def test_arithmetic_frames_take_the_pixel_route(jip):
    """SOF9 (arithmetic coding): libjpeg-turbo decodes it, the port's
    reader returns -3 (the pixel route); the only frame type whose status
    differs (ROADMAP.md Queue 3)."""
    arith = _sof(CORPUS["baseline_q75"], marker=0xC9)
    assert jip.read_coeffs_batch([arith], 4, 12, 16)[4][0] == 0
    assert tip.read_coeffs_batch([arith], 4, 12, 16)[4][0] == -3


def test_dims_match_the_header_parse():
    bufs = [CORPUS[k] for k in ("baseline_q50", "odd_130x202", "odd_37x53",
                                "progressive", "restart_every_mcu")]
    _, _, _, dims, st = tip.read_coeffs_batch(bufs, 8, 18, 26)
    assert (st == 0).all()
    for b, d in zip(bufs, dims):
        h, w = tip.jpeg_dims(b)
        assert list(d) == [h, w, -(-h // 8), -(-w // 8), -(-h // 16),
                           -(-w // 16)]


def test_weights_and_msub_match_jax():
    from columbiaimagesearch_tpu.models import jpeg_device as jjd

    for m in range(1, 9):
        np.testing.assert_array_equal(tjd.idct_box_matrix(m),
                                      jjd.idct_box_matrix(m))
    for i, o in ((300, 64), (480, 256), (37, 256)):
        np.testing.assert_array_equal(tjd.lanczos_matrix(i, o),
                                      jjd.lanczos_matrix(i, o))
    for hw in ((480, 640), (512, 512), (2048, 2048), (260, 800), (37, 53)):
        assert tjd.pick_msub(*hw) == jjd.pick_msub(*hw)


@pytest.mark.parametrize("hw,msub", [((480, 640), 5), ((130, 202), 8),
                                     ((96, 128), 3)])
def test_reconstruction_matches_jax(jip, hw, msub):
    from columbiaimagesearch_tpu.models import jpeg_device as jjd

    rng = np.random.default_rng(2)
    h, w = hw
    bufs = [_enc(_img(rng, h, w), quality=q) for q in (75, 90)]
    bh, bw = -(-h // 8), -(-w // 8)
    bh += bh & 1
    bw += bw & 1
    yc, cc, qt, _, st = tip.read_coeffs_batch(bufs, msub, bh, bw)
    assert (st == 0).all()
    want = np.asarray(jjd.CoeffDecoder(target=256).decode(
        yc, cc, qt, msub=msub, h=h, w=w))
    got = tjd.CoeffDecoder("cpu", target=256).decode(
        yc, cc, qt, msub=msub, h=h, w=w)
    assert got.shape == (2, 256, 256, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    off = torch.round(got).numpy() != np.round(want)
    assert off.mean() <= 1e-3, off.mean()


def test_reconstruction_near_the_host_decode():
    """JAX's image and bounds (tests/test_jpeg_device.py:38-45,100-117):
    the msub/8 truncation drops the top of the spectrum by design."""
    r = np.random.RandomState(1)
    x = np.linspace(0, 11, 640)
    a = (120 + 70 * np.sin(x)[None, :, None]
         + 35 * r.rand(480, 640, 3)).clip(0, 255).astype(np.uint8)
    jpg = _enc(a, quality=90, subsampling=2)
    msub = tjd.pick_msub(480, 640)
    yc, cc, qt, dims, st = tip.read_coeffs_batch([jpg], msub, 60, 80)
    assert st[0] == 0 and list(dims[0]) == [480, 640, 60, 80, 30, 40]
    out = tjd.CoeffDecoder("cpu").decode(yc, cc, qt, msub=msub, h=480,
                                         w=640).numpy()
    from columbiaimagesearch_tpu_torch.models.preprocess import resize_host

    host = resize_host(np.asarray(Image.open(io.BytesIO(jpg))
                                  .convert("RGB"))).astype(np.float32)
    diff = np.abs(out[0] - host)
    assert diff.mean() < 3.0, diff.mean()
    assert np.percentile(diff, 99) < 12.0


def _mixed_wave(seed):
    """A wave whose dominant size is 200x280: baseline, progressive and
    restart JPEGs of it, plus a PNG, a minority size, a 4:4:4 JPEG and a
    broken buffer mid-wave (these take the pixel route)."""
    rng = np.random.default_rng(seed)
    bufs = [_enc(_img(rng, 200, 280), quality=90),
            _enc(_img(rng, 200, 280), quality=75, progressive=True),
            _enc(_img(rng, 120, 90), quality=90),
            _enc(_img(rng, 200, 280), quality=90, restart_marker_blocks=2),
            _enc(_img(rng, 100, 150), "PNG"),
            _enc(_img(rng, 200, 280), quality=90, subsampling=0),
            b"broken"]
    return bufs


@pytest.fixture(scope="module")
def featurizers():
    from columbiaimagesearch_tpu.models.sentibank import (
        SentibankFeaturizer as JaxFeaturizer,
    )

    from columbiaimagesearch_tpu_torch.models.sentibank import (
        LAYERS,
        SentibankFeaturizer,
        init_params,
    )

    params = init_params(seed=0)
    flax = {}
    for layer in LAYERS:      # OIHW -> HWIO, [out, in] -> [in, out]
        w = params[f"{layer}.weight"].numpy()
        flax[layer] = {"kernel": (np.transpose(w, (2, 3, 1, 0))
                                  if w.ndim == 4 else w.T),
                       "bias": params[f"{layer}.bias"].numpy()}
    jf = JaxFeaturizer(params=flax, device_decode=True)
    dev = SentibankFeaturizer(params=params, device_decode=True,
                              device="cpu")
    pix = SentibankFeaturizer(params=params, device_decode=False,
                              device="cpu")
    return jf, dev, pix


def test_featurizer_device_route_matches_jax(featurizers, jip):
    jf, dev, _ = featurizers
    bufs = _mixed_wave(4)
    want, st_w = jf.featurize_buffers(bufs)
    before = dict(dev.route_counts)
    got, st_g = dev.featurize_buffers(bufs)
    assert [int(s) for s in st_g] == [int(s) for s in st_w]
    assert [i for i, s in enumerate(st_g) if int(s)] == [6]
    assert dev.route_counts["coeffs"] - before["coeffs"] == 3
    assert dev.route_counts["pixels"] - before["pixels"] == 4
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-3)


def test_featurizer_device_route_matches_pixel_route(featurizers):
    _, dev, pix = featurizers
    bufs = _mixed_wave(5)
    fd, st_d = dev.featurize_buffers(bufs)
    fp, st_p = pix.featurize_buffers(bufs)
    assert [int(s) for s in st_d] == [int(s) for s in st_p]
    ok = np.asarray(st_p) == 0
    cos = (fd[ok] * fp[ok]).sum(1) / (np.linalg.norm(fd[ok], axis=1)
                                      * np.linalg.norm(fp[ok], axis=1))
    assert (cos > 0.995).all(), cos
    # the pixel-route rows of the mixed wave are the pixel route's own
    for i in (2, 4, 5):
        np.testing.assert_allclose(fd[i], fp[i], rtol=1e-5, atol=1e-6)


def test_pipelined_chunks_keep_the_coefficient_route(featurizers):
    """Past PIPELINE_CHUNK the decode-ahead thread prepares coefficient
    waves; the result equals one wave a chunk."""
    _, dev, _ = featurizers
    bufs = _mixed_wave(6)[:4]
    dev.PIPELINE_CHUNK = 2
    try:
        piped, st = dev.featurize_buffers(bufs)
    finally:
        del dev.PIPELINE_CHUNK
    whole = np.concatenate([dev.featurize_buffers(bufs[i:i + 2])[0]
                            for i in (0, 2)])
    assert [int(s) for s in st] == [0] * 4
    np.testing.assert_allclose(piped, whole, rtol=1e-6, atol=1e-6)


def test_get_featurizer_defaults_to_device_decode(monkeypatch):
    import inspect

    from columbiaimagesearch_tpu.extraction import extractor as jext

    from columbiaimagesearch_tpu_torch.extraction import extractor

    assert inspect.signature(extractor.get_featurizer).parameters[
        "device_decode"].default is True
    assert inspect.signature(jext.get_featurizer).parameters[
        "device_decode"].default is True
    f = extractor.get_featurizer("sentibank", device="cpu")
    assert f.device_decode
    monkeypatch.setattr(tip, "coeffs_available", lambda: False)
    with pytest.raises(RuntimeError, match="did not build"):
        extractor.get_featurizer("sentibank", device="cpu")
