"""Caffe-semantics layers on NCHW tensors (port of
columbiaimagesearch_tpu/models/layers.py:7-54).

Both run as plain PyTorch ops; the JAX package runs them through XLA,
outside any Pallas kernel.
"""

import torch
import torch.nn.functional as F


def lrn(x, local_size: int = 5, alpha: float = 1e-4, beta: float = 0.75,
        k: float = 1.0):
    """Across-channel Local Response Normalization, Caffe semantics:
    ``out = x / (k + (alpha / n) * sum_window(x^2))^beta``, the window
    ``local_size`` channels centred on each channel, zero past the edges
    (layers.py:7-28).

    :param x: [N, C, H, W]
    """
    half = local_size // 2
    C = x.shape[1]
    sq = F.pad(x * x, (0, 0, 0, 0, half, half))
    window_sum = sq[:, 0:C]
    for i in range(1, local_size):
        window_sum = window_sum + sq[:, i:i + C]
    return x / (k + (alpha / local_size) * window_sum) ** beta


def caffe_max_pool(x, window: int = 3, stride: int = 2):
    """Max pool with Caffe's ceil-mode output size,
    ``ceil((H - k) / s) + 1``: the bottom and right edges are padded with
    -inf as far as that needs (layers.py:31-54).

    :param x: [N, C, H, W]
    """
    h, w = x.shape[2], x.shape[3]
    oh = -(-(h - window) // stride) + 1
    ow = -(-(w - window) // stride) + 1
    pad_h = max((oh - 1) * stride + window - h, 0)
    pad_w = max((ow - 1) * stride + window - w, 0)
    if pad_h or pad_w:
        x = F.pad(x, (0, pad_w, 0, pad_h), value=float("-inf"))
    return F.max_pool2d(x, window, stride)
