"""Plain reference of DeepSentibank's fc7 and of its input, for the served
cells' correctness check. Plain PyTorch and PIL; it imports nothing of the
program.

The net (Chen et al., *DeepSentiBank*, arXiv:1410.8586; layers as the
upstream ``cufacesearch/featurizer/data/pycaffe_sentibank.prototxt``): an
AlexNet of five convolutions and two fully connected layers, each followed
by a ReLU, with across-channel LRN after the first two pools; the feature
is the post-ReLU fc7, 4,096 wide:

====== ============================== ===============================
layer  weights                        after it
====== ============================== ===============================
conv1  96 x 3 x 11 x 11, stride 4     ReLU, max pool 3/2, LRN 5
conv2  256 x 48 x 5 x 5, pad 2, 2 grp ReLU, max pool 3/2, LRN 5
conv3  384 x 256 x 3 x 3, pad 1       ReLU
conv4  384 x 192 x 3 x 3, pad 1, 2 gr ReLU
conv5  256 x 192 x 3 x 3, pad 1, 2 gr ReLU, max pool 3/2
fc6    4,096 x 9,216                  ReLU
fc7    4,096 x 4,096                  ReLU: the feature
====== ============================== ===============================

Pools are Caffe's (ceil mode: ``ceil((H - 3) / 2) + 1`` outputs); LRN is
Caffe's ACROSS_CHANNELS, ``x / (1 + alpha / 5 * sum of x^2 over the 5
nearest channels) ^ beta`` with alpha 1e-4, beta 0.75.

The input (upstream ``sbpycaffe_img_featurizer.py:41-50,103-134``): the
image as RGB, resized to 256 x 256 with PIL's Lanczos filter (what
``scipy.misc.imresize`` did), the central 227 x 227, channels in BGR
order, minus the mean, in 0..255.

Departures from the published description, each forced by what is public:

- The mean is the ImageNet per-channel BGR mean (104.00698793,
  116.66876762, 122.67891434) over every pixel, not the upstream
  ``imagenet_mean.npy`` image, which is not public.
- The weights are a seeded draw (:func:`init_weights`), not the trained
  DeepSentibank weights, which are not public either. The draw is the same
  LeCun-normal draw, from one CPU ``torch.Generator``, as the program's
  seeded weights, so that a run can give both the same net.
- fc8 (the 2,089 ANP classes) is not computed: the feature is fc7.

``precision="float64"`` computes the net in float64. ``"tf32"`` is the
control: float32 whose convolution and matrix-product inputs are rounded
to TF32 (10 mantissa bits, as the card's TF32 mode does), the step below
the float32 with TF32 off that the configuration states. The module turns
the card's TF32 modes off for every float32 product.
"""

import io

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.lopq_search import round_tf32

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: (name, out channels, in channels a group, kernel, stride, padding,
#: groups) of each convolution
CONVS = (("conv1", 96, 3, 11, 4, 0, 1),
         ("conv2", 256, 48, 5, 1, 2, 2),
         ("conv3", 384, 256, 3, 1, 1, 1),
         ("conv4", 384, 192, 3, 1, 1, 2),
         ("conv5", 256, 192, 3, 1, 1, 2))
#: (name, out, in) of each fully connected layer up to fc7
FCS = (("fc6", 4096, 256 * 6 * 6), ("fc7", 4096, 4096))
#: the prototxt's LRN: local_size, alpha, beta
LRN = (5, 1e-4, 0.75)
RESIZE, CROP = 256, 227
OFF = (RESIZE - CROP) // 2
MEAN_BGR = (104.00698793, 116.66876762, 122.67891434)


def init_weights(seed):
    """{``<layer>.weight``, ``<layer>.bias``} of conv1 to fc7, float32 on
    the CPU: LeCun-normal weights (std ``1 / sqrt(fan_in)``, drawn in layer
    order from one ``torch.Generator`` seeded with ``seed``) and zero
    biases."""
    g = torch.Generator()
    g.manual_seed(int(seed))
    out = {}
    for name, oc, ic, k, *_ in CONVS:
        out[name + ".weight"] = torch.randn(oc, ic, k, k, generator=g) \
            / float(ic * k * k) ** 0.5
        out[name + ".bias"] = torch.zeros(oc)
    for name, o, i in FCS:
        out[name + ".weight"] = torch.randn(o, i, generator=g) \
            / float(i) ** 0.5
        out[name + ".bias"] = torch.zeros(o)
    return out


def decode(jpeg):
    """The net's input pixels of one encoded image: [227, 227, 3] uint8
    RGB, the central crop of the 256 x 256 Lanczos resize."""
    from PIL import Image

    img = Image.open(io.BytesIO(jpeg)).convert("RGB")
    a = np.asarray(img.resize((RESIZE, RESIZE), Image.LANCZOS))
    return a[OFF:OFF + CROP, OFF:OFF + CROP]


def decode_control(jpeg):
    """The decode check's control: :func:`decode` without chroma (the luma
    plane in all three channels), a reconstruction that drops the colour
    planes."""
    from PIL import Image

    img = Image.open(io.BytesIO(jpeg)).convert("L").convert("RGB")
    a = np.asarray(img.resize((RESIZE, RESIZE), Image.LANCZOS))
    return a[OFF:OFF + CROP, OFF:OFF + CROP]


def lrn(x, size, alpha, beta):
    """Caffe's across-channel LRN by a running sum over the channels."""
    half = size // 2
    sq = F.pad(x * x, (0, 0, 0, 0, half + 1, half))
    c = torch.cumsum(sq, dim=1)
    window = c[:, size:] - c[:, :-size]
    return x / (1.0 + alpha / size * window) ** beta


class Net:
    """The fc7 forward at one precision, its weights on ``dev``."""

    def __init__(self, weights, dev, precision="float64"):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64
        self.w = {k: self._in(v.to(dev, self.dtype))
                  for k, v in weights.items()}
        self.mean = torch.tensor(MEAN_BGR, dtype=self.dtype, device=dev)

    def _in(self, x):
        return round_tf32(x) if self.tf32 else x

    def inputs(self, pixels):
        """[n, 227, 227, 3] uint8 RGB -> [n, 3, 227, 227]: BGR minus the
        mean."""
        x = pixels.to(self.dtype).flip(-1) - self.mean
        return x.permute(0, 3, 1, 2).contiguous()

    def fc7(self, pixels):
        """[n, 227, 227, 3] uint8 RGB (on the weights' device) -> post-ReLU
        fc7 [n, 4096] in the net's precision."""
        w = self.w
        x = self.inputs(pixels)
        for name, _, _, _, stride, pad, groups in CONVS:
            x = torch.relu(F.conv2d(self._in(x), w[name + ".weight"],
                                    w[name + ".bias"], stride=stride,
                                    padding=pad, groups=groups))
            if name in ("conv1", "conv2", "conv5"):
                x = F.max_pool2d(x, 3, 2, ceil_mode=True)
            if name in ("conv1", "conv2"):
                x = lrn(x, *LRN)
        x = x.flatten(1)
        for name, _, _ in FCS:
            x = torch.relu(F.linear(self._in(x), w[name + ".weight"],
                                    w[name + ".bias"]))
        return x


def fc7_in_chunks(net, pixels, chunk=64):
    """:meth:`Net.fc7` of [n, 227, 227, 3] uint8 (any device) over chunks
    of rows, on the net's device."""
    dev = net.mean.device
    return torch.cat([net.fc7(pixels[lo:lo + chunk].to(dev))
                      for lo in range(0, pixels.shape[0], chunk)])
