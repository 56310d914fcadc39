"""The port's DeepSentibank against the benchmark's plain reference
(``portbench/reference/sentibank_plain.py``: plain torch and PIL, float64)
on seeded weights at the published widths, over four small JPEGs: the
pixel route's fc7 on the same input rows, the coefficient route's input
rows against the reference's PIL decode within the served cell's decode
limits, and the bfloat16 featurizer failing the forward tolerance."""

import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from columbiaimagesearch_tpu_torch.models.sentibank import (
    SentibankFeaturizer,
    init_params,
)
from portbench.reference import sentibank_plain as ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMITS = os.path.join(REPO, "portbench", "limits",
                      "release_served_10Mi.http_closed32.json")
OFF, CROP = ref.OFF, ref.CROP
#: largest relative L2 error of a float32 fc7 against the float64 forward:
#: float32 sums of up to 9,216 products a layer over seven layers read
#: ~6e-7 here; rounding the products' inputs to TF32 reads ~7e-4, to
#: bfloat16 ~7e-3 (the served cell's limit, 2e-5, lies between)
FC7_RTOL = 1e-5


def _jpegs():
    """Four baseline 4:2:0 JPEGs of 120 x 160 (blocks, gradients and
    noise), as encoded bytes."""
    out = []
    rng = np.random.RandomState(5)
    yy, xx = np.mgrid[0:120, 0:160]
    for k in range(4):
        img = np.empty((120, 160, 3))
        for c in range(3):
            img[..., c] = 100 + 60 * np.sin(yy / (9 + 3 * k + c)) \
                + 50 * np.cos(xx / (13 + 2 * k))
        y0, x0 = rng.randint(0, 60), rng.randint(0, 80)
        img[y0:y0 + 40, x0:x0 + 60] += rng.randint(-90, 90, 3)
        img += rng.randn(*img.shape) * 3
        b = io.BytesIO()
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            b, format="JPEG", quality=85, subsampling=2)
        out.append(b.getvalue())
    return out


@pytest.fixture(scope="module")
def weights():
    sd = init_params(seed=0)
    plain = ref.init_weights(0)
    # the reference draws the program's seeded net itself
    assert all(torch.equal(v, sd[k]) for k, v in plain.items())
    return sd, plain


@pytest.fixture(scope="module")
def jpegs():
    return _jpegs()


def _rel_err(got, want):
    g = torch.as_tensor(got).to(torch.float64)
    return (torch.linalg.vector_norm(g - want, dim=1)
            / torch.linalg.vector_norm(want, dim=1))


def test_pixel_route_fc7_is_the_reference_forward(weights, jpegs):
    sd, plain = weights
    f = SentibankFeaturizer(params=sd, device="cpu")
    stack, status = f.decode_wave(jpegs)
    assert not any(status)
    got, n = f.featurize_pixel_wave(stack)
    assert n == 4
    rows = torch.from_numpy(np.ascontiguousarray(
        stack[:, OFF:OFF + CROP, OFF:OFF + CROP]))
    want = ref.Net(plain, torch.device("cpu")).fc7(rows)
    err = _rel_err(got, want)
    assert float(err.max()) < FC7_RTOL, err
    # the control: the same forward with its inputs rounded to TF32
    ctl = ref.Net(plain, torch.device("cpu"), "tf32").fc7(rows)
    assert float(_rel_err(ctl, want).min()) > 10 * FC7_RTOL


def test_coefficient_route_rows_are_the_plain_decode(weights, jpegs):
    """The device route's input rows (IDCT, chroma, Lanczos on the
    coefficients) against PIL's full decode and Lanczos resize of the same
    bytes: the mean and 99th-percentile absolute level within the served
    cell's limits; the decode without chroma outside them."""
    with open(LIMITS) as fh:
        limits = json.load(fh)
    sd, _ = weights
    f = SentibankFeaturizer(params=sd, device="cpu", device_decode=True)
    stack, status = f.wave_pixels(f.prepare_wave(jpegs))
    assert not any(status) and f.route_counts == {"coeffs": 4, "pixels": 0}
    got = stack[:, OFF:OFF + CROP, OFF:OFF + CROP].numpy().astype(np.int32)

    def levels(decode):
        want = np.stack([decode(b) for b in jpegs]).astype(np.int32)
        d = np.abs(got - want)
        return d.mean(), np.percentile(d, 99)

    mean, p99 = levels(ref.decode)
    assert mean <= limits["decode_mean"] and p99 <= limits["decode_p99"]
    assert mean > 0          # another reconstruction, not PIL's pixels
    mean, p99 = levels(ref.decode_control)
    assert mean > limits["decode_mean"] and p99 > limits["decode_p99"]


def test_bfloat16_fails_the_forward_tolerance(weights, jpegs):
    sd, plain = weights
    f = SentibankFeaturizer(params=sd, device="cpu",
                            compute_dtype="bfloat16")
    stack, _ = f.decode_wave(jpegs[:2])
    got, _ = f.featurize_pixel_wave(stack)
    rows = torch.from_numpy(np.ascontiguousarray(
        stack[:, OFF:OFF + CROP, OFF:OFF + CROP]))
    want = ref.Net(plain, torch.device("cpu")).fc7(rows)
    assert float(_rel_err(got, want).min()) > 10 * FC7_RTOL
