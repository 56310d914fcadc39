"""Image preprocessing for the Sentibank featurizer (port of
columbiaimagesearch_tpu/models/preprocess.py:20-104).

Reference semantics (featurizer/sbpycaffe_img_featurizer.py:41-50,103-134):
load RGB -> Lanczos resize to 256x256 (uint8) -> central 227x227 crop ->
RGB->BGR -> subtract the (cropped) mean image; pixels stay in 0..255. The
variable-size resize runs on the host (PIL); crop, channel swap and mean
subtraction run on the device and emit the net's NCHW layout, so a batch
crosses PCIe once as uint8.
"""

import numpy as np
import torch

from columbiaimagesearch_tpu_torch.device import resolve_device

TARGET = 256
CROP = 227
# Central crop offset (reference lines 72-76): (256 - 227) // 2.
OFF = (TARGET - CROP) // 2

# Caffe ImageNet per-channel means (BGR); used when the original mean-image
# file is not supplied. ``load_mean_npy`` gives exact parity when it is.
IMAGENET_BGR_MEAN = (104.00698793, 116.66876762, 122.67891434)


def default_mean_image():
    """[227, 227, 3] BGR mean in 0..255 scale."""
    mean = np.zeros((CROP, CROP, 3), dtype=np.float32)
    mean[...] = IMAGENET_BGR_MEAN
    return mean


def load_mean_npy(path):
    """Load a Caffe mean .npy ([3, 256, 256] CHW BGR) and central-crop it
    to [227, 227, 3] HWC (reference: sbpycaffe_img_featurizer.py:69-80)."""
    m = np.load(path)
    if m.ndim == 3 and m.shape[0] == 3:
        m = np.transpose(m, (1, 2, 0))  # -> HWC BGR
    return m[OFF:OFF + CROP, OFF:OFF + CROP, :].astype(np.float32)


def resize_host(img):
    """Host-side Lanczos resize of one RGB uint8 image to 256x256 (PIL's
    Lanczos, which scipy.misc.imresize wrapped in the reference)."""
    from PIL import Image

    img = np.asarray(img)
    if img.ndim == 2:  # grayscale -> RGB (reference BW fix)
        img = np.stack([img] * 3, axis=-1)
    if img.shape[2] == 4:  # RGBA -> RGB
        img = img[:, :, :3]
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    pil = Image.fromarray(img)
    return np.asarray(pil.resize((TARGET, TARGET), Image.LANCZOS))


def preprocess_device(x_uint8, mean):
    """Crop + BGR swap + mean subtraction on the device of ``x_uint8``.

    :param x_uint8: [N, 256, 256, 3] uint8 RGB tensor
    :param mean: [227, 227, 3] float32 BGR mean (0..255 scale), tensor on
        the same device
    :returns: [N, 3, 227, 227] float32 BGR, mean-subtracted (NCHW)
    """
    x = x_uint8[:, OFF:OFF + CROP, OFF:OFF + CROP, :].to(torch.float32)
    x = x.flip(-1) - mean[None]  # RGB -> BGR, then the mean
    return x.permute(0, 3, 1, 2).contiguous()


def _to_device(stack, mean, device):
    return (torch.from_numpy(np.ascontiguousarray(stack)).to(device),
            torch.as_tensor(mean, dtype=torch.float32).to(device))


def preprocess_batch(imgs, mean, device=None):
    """Host resize + device crop/swap/mean-sub.

    :param imgs: iterable of HxWx3 uint8 RGB arrays (any sizes)
    :param device: default: the first card (raises without one; pass
        ``"cpu"`` for the CPU)
    :returns: [N, 3, 227, 227] float32 tensor on ``device``
    """
    device = resolve_device(device)
    stack = np.stack([resize_host(im) for im in imgs])
    return preprocess_device(*_to_device(stack, mean, device))


def preprocess_buffers(buffers, mean, n_threads: int = 0,
                       dct_scale: bool = True, device=None):
    """Encoded buffers -> net input through the native decode+resize
    pipeline (native/imgpipe.cpp; PIL per image where it is not built).

    :param device: default: the first card (raises without one)
    :returns: ([N, 3, 227, 227] float32 tensor on ``device``, status [N]
        int32 — 0 = ok, nonzero rows are zero images)
    """
    device = resolve_device(device)
    from columbiaimagesearch_tpu_torch.native.imgpipe import (
        decode_resize_batch,
    )

    stack, status = decode_resize_batch(buffers, TARGET, n_threads=n_threads,
                                        dct_scale=dct_scale)
    return preprocess_device(*_to_device(stack, mean, device)), status
