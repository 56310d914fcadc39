"""Device JPEG reconstruction: dequantization, IDCT, chroma upsampling,
colour conversion and the Lanczos resize as batched torch ops on the card
(port of columbiaimagesearch_tpu/models/jpeg_device.py:1-180).

The host entropy-decodes each JPEG to quantized DCT coefficients
(``native.imgpipe.read_coeffs_batch``, the port's libjpeg-free reader);
everything after that is dense work:

- dequantization (elementwise) and an 8x8 IDCT restricted to the
  low-frequency ``msub`` x ``msub`` corner, fused with an exact
  box-average 8 -> msub downscale (the msub/8-scale reconstruction
  libjpeg's ``scale_num/scale_denom`` makes), as two [M, msub]
  contractions per block;
- nearest 4:2:0 chroma upsampling, BT.601 YCbCr -> RGB, clipping;
- a PIL-compatible Lanczos-3 resize to the staging size as two dense
  [target, H] / [target, W] matmuls.

The JAX package runs these as XLA matmuls at ``Precision.HIGHEST``, not in
a Pallas kernel; here they are torch ops in true fp32 (TF32 is off, see
``device.py``). A batch shares one (msub, h, w) bucket.
"""

import numpy as np
import torch

# ---------------------------------------------------------------- weights


def idct_box_matrix(msub: int) -> np.ndarray:
    """1-D operator [M, msub] (M = msub) mapping a block's low-frequency
    coefficient column to M output samples: the exact 8-point IDCT of the
    truncated spectrum followed by an exact box-average 8 -> M downscale
    (jpeg_device.py:42-63)."""
    u = np.arange(8)
    c = np.where(u == 0, 1.0 / np.sqrt(2.0), 1.0)
    x = np.arange(8)
    A = 0.5 * c[:, None] * np.cos((2 * x[None, :] + 1) * u[:, None]
                                  * np.pi / 16.0)      # [u, x] -> s = A^T F
    M = msub
    P = np.zeros((M, 8))
    step = 8.0 / M
    for i in range(M):
        lo, hi = i * step, (i + 1) * step
        for xx in range(8):
            ov = max(0.0, min(hi, xx + 1.0) - max(lo, xx))
            P[i, xx] = ov / step
    return (P @ A[:msub].T).astype(np.float32)         # [M, msub]


def lanczos_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense PIL-compatible Lanczos-3 resample operator [out, in], weights
    in double and normalized per output pixel (jpeg_device.py:66-87)."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = 3.0 * fscale
    W = np.zeros((out_size, in_size))
    for o in range(out_size):
        center = (o + 0.5) * scale
        xmin = max(0, int(center - support + 0.5))
        xmax = min(in_size, int(center + support + 0.5))
        xs = np.arange(xmin, xmax)
        t = (xs - center + 0.5) / fscale
        w = np.sinc(t) * np.sinc(t / 3.0)
        w[(t <= -3.0) | (t >= 3.0)] = 0.0
        s = w.sum()
        W[o, xmin:xmax] = w / s if s != 0.0 else w
    return W.astype(np.float32)


def pick_msub(h: int, w: int, target: int = 256) -> int:
    """Smallest msub/8 scale whose short side still covers the resize
    target (jpeg_device.py:172-180)."""
    base = min(h, w)
    for m in range(1, 9):
        if base * m >= target * 8:
            return m
    return 8


# ----------------------------------------------------------------- device


def _plane_from_blocks(coef, q, D):
    """[n, BH, BW, msub*msub] int16 + [n, m2] quant -> [n, BH*M, BW*M]
    plane, level-shifted to the 0..255 domain."""
    n, BH, BW, _m2 = coef.shape
    M, m = D.shape
    F = coef.to(torch.float32) * q[:, None, None, :]
    F = F.reshape(n, BH, BW, m, m)
    # s_block = D F D^T, as two contractions
    s = torch.matmul(D, F)                              # [n, BH, BW, M, m]
    s = torch.matmul(s, D.T)                            # [n, BH, BW, M, M]
    return s.permute(0, 1, 3, 2, 4).reshape(n, BH * M, BW * M) + 128.0


def decode_jpeg_coeffs(ycoef, ccoef, qtab, D, Wv, Wh, *, msub, h, w):
    """Reconstruct a coefficient batch to [n, target, target, 3] float32
    RGB (0..255) on the device of the inputs (jpeg_device.py:106-149).

    :param ycoef: [n, BH, BW, msub*msub] int16 (natural-order corner)
    :param ccoef: [n, 2, BH//2, BW//2, msub*msub] int16
    :param qtab: [n, 2, msub*msub] dequantization tables (luma, chroma),
        any integer dtype
    :param D: [M, msub] float32 :func:`idct_box_matrix`
    :param Wv: [target, hs] float32 :func:`lanczos_matrix` (hs, target),
        hs = ceil(h * msub / 8)
    :param Wh: [target, ws] likewise for the width
    :param h, w: true pixel dims of every image in the batch
    """
    q = qtab.to(torch.float32)
    Y = _plane_from_blocks(ycoef, q[:, 0], D)
    Cb = _plane_from_blocks(ccoef[:, 0], q[:, 1], D)
    Cr = _plane_from_blocks(ccoef[:, 1], q[:, 1], D)
    # 4:2:0 chroma to the luma grid (x2 nearest)
    Cb = Cb.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    Cr = Cr.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    hs = -(-h * msub // 8)                 # libjpeg's scaled output size
    ws = -(-w * msub // 8)
    Y, Cb, Cr = Y[:, :hs, :ws], Cb[:, :hs, :ws], Cr[:, :hs, :ws]
    # BT.601 (libjpeg jdcolor.c constants)
    Cb = Cb - 128.0
    Cr = Cr - 128.0
    rgb = torch.stack([Y + 1.402 * Cr,
                       Y - 0.344136 * Cb - 0.714136 * Cr,
                       Y + 1.772 * Cb], dim=-1)         # [n, hs, ws, 3]
    rgb = rgb.clamp(0.0, 255.0)
    out = torch.einsum("oh,nhwc->nowc", Wv, rgb)
    out = torch.einsum("pw,nowc->nopc", Wh, out)
    return out.clamp(0.0, 255.0)


class CoeffDecoder:
    """Cached per-bucket weights on one device for
    :func:`decode_jpeg_coeffs` (jpeg_device.py:152-169)."""

    def __init__(self, device, target: int = 256):
        self.device = torch.device(device)
        self.target = target
        self._cache = {}

    def weights(self, msub: int, h: int, w: int):
        key = (msub, h, w)
        if key not in self._cache:
            hs = -(-h * msub // 8)
            ws = -(-w * msub // 8)
            self._cache[key] = tuple(
                torch.from_numpy(a).to(self.device)
                for a in (idct_box_matrix(msub),
                          lanczos_matrix(hs, self.target),
                          lanczos_matrix(ws, self.target)))
        return self._cache[key]

    def decode(self, ycoef, ccoef, qtab, *, msub, h, w):
        """Host (numpy) or device coefficient arrays -> [n, target,
        target, 3] float32 on this decoder's device."""
        D, Wv, Wh = self.weights(msub, h, w)

        def dev(a):
            if isinstance(a, np.ndarray):
                a = torch.from_numpy(np.ascontiguousarray(
                    a.astype(np.int32) if a.dtype == np.uint16 else a))
            return a.to(self.device, non_blocking=True)

        return decode_jpeg_coeffs(dev(ycoef), dev(ccoef), dev(qtab),
                                  D, Wv, Wh, msub=msub, h=h, w=w)
