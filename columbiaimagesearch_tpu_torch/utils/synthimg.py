"""Procedural image synthesis on the device (port of
columbiaimagesearch_tpu/utils/synthimg.py:1-74).

Benchmarks need image corpora whose CNN features look like a photo
corpus's (sparse, non-negative, anisotropic fc7), which random noise does
not give. Each image is a low-frequency colour field, three sinusoidal
gratings of random orientation, frequency and phase, and two gaussian
blobs.

The random draw is split from the rendering: :func:`draw_params` draws
the parameters from an explicit ``torch.Generator`` and
:func:`render_from_params` renders them, so a test can render the
parameters ``jax.random`` draws (synthimg.py:34-57) and compare images.
The port's stream differs from JAX's. Images may be rectangular
(``height`` x ``width``); a square ``side`` is the JAX renderer's.
"""

import math

import torch

from columbiaimagesearch_tpu_torch.device import resolve_device

#: per-image parameter shapes (synthimg.py:35-51)
PARAM_SHAPES = {"base": (1, 1, 3), "grad_dir": (2, 3), "ang": (3,),
                "freq": (3,), "phase": (3,), "amp": (3, 3), "c": (2, 2),
                "s": (2,)}


def draw_params(n: int, generator: torch.Generator, device=None):
    """The random parameters of ``n`` images, drawn in float32 on the
    generator's device and moved to ``device`` (default: stay there),
    with the distributions of synthimg.py:35-51 (uniform colour base,
    normal gradient directions,
    gratings with angle U[0, pi), frequency U[2, 40), phase U[0, 2 pi),
    amplitudes U[0, 50); blob centres U[0, 1), widths U[0.01, 0.08))."""
    g = generator
    gdev = g.device

    def u(*shape, lo=0.0, hi=1.0):
        return torch.rand((n,) + shape, generator=g, device=gdev) \
            * (hi - lo) + lo

    p = {"base": u(1, 1, 3, hi=255.0),
         "grad_dir": torch.randn((n, 2, 3), generator=g, device=gdev),
         "ang": u(3, hi=math.pi),
         "freq": u(3, lo=2.0, hi=40.0),
         "phase": u(3, hi=2 * math.pi),
         "amp": u(3, 3, hi=50.0),
         "c": u(2, 2),
         "s": u(2, lo=0.01, hi=0.08)}
    return {k: v.to(device or gdev) for k, v in p.items()}


def render_from_params(params, height: int = 256, width: int = None):
    """[n, height, width, 3] uint8 images from :func:`draw_params`-shaped
    parameters (float32 tensors on one device; the math of
    synthimg.py:36-57, rendered there).

    :param width: defaults to ``height`` (the JAX renderer's square)
    """
    width = height if width is None else width
    dev = params["base"].device
    yy, xx = torch.meshgrid(torch.linspace(0, 1, height, device=dev),
                            torch.linspace(0, 1, width, device=dev),
                            indexing="ij")
    yy, xx = yy[None], xx[None]                          # [1, h, w]
    n3 = lambda t: t[:, None, None, :]                  # [n, 3] -> bcast
    n1 = lambda t: t[:, None, None]                     # [n] -> bcast
    gd = params["grad_dir"]
    img = n3(params["base"][:, 0, 0]) + 60.0 * (
        yy[..., None] * n3(gd[:, 0]) + xx[..., None] * n3(gd[:, 1]))
    ang, freq, phase = params["ang"], params["freq"], params["phase"]
    for g in range(3):
        wave = torch.sin(2 * math.pi * n1(freq[:, g])
                         * (xx * torch.cos(n1(ang[:, g]))
                            + yy * torch.sin(n1(ang[:, g])))
                         + n1(phase[:, g]))
        img = img + wave[..., None] * n3(params["amp"][:, g])
    c, s = params["c"], params["s"]
    for b in range(2):
        blob = torch.exp(-(((xx - n1(c[:, b, 0])) ** 2
                            + (yy - n1(c[:, b, 1])) ** 2)
                           / (2 * n1(s[:, b]))))
        img = img + 80.0 * blob[..., None]
    return img.clamp(0, 255).to(torch.uint8)


def make_render_one(side: int = 256, *, height: int = None,
                    width: int = None, device=None):
    """(generator) -> one [h, w, 3] uint8 image on ``device`` (default:
    the first card; raises without one) (synthimg.py:23-59);
    ``height``/``width`` default to ``side``."""
    device = resolve_device(device)
    h = side if height is None else height
    w = side if width is None else width

    def one_image(generator):
        return render_from_params(draw_params(1, generator, device), h, w)[0]

    return one_image


def make_render_batch(batch: int, side: int = 256, *, height: int = None,
                      width: int = None, device=None):
    """(generator) -> [batch, h, w, 3] uint8 images on ``device``
    (default: the first card; raises without one) (synthimg.py:62-74).
    The generator may live on the CPU or on ``device``."""
    device = resolve_device(device)
    h = side if height is None else height
    w = side if width is None else width

    def render(generator):
        return render_from_params(draw_params(batch, generator, device), h,
                                  w)

    return render
