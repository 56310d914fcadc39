"""Batched 128-d face embedder in PyTorch (port of
columbiaimagesearch_tpu/models/face.py:24-205).

The reference embeds faces with dlib's ``face_recognition_model_v1``
(reference: cufacesearch/featurizer/dlib_featurizer.py:50-105); this is the
JAX package's trainable stand-in for it, a residual net over 150x150 chips:

- a 7x7/2 stem conv (32) + GroupNorm + ReLU + 3x3/2 max pool, then 13
  residual blocks (3 x 32, down 64 + 3 x 64, down 128 + 2 x 128, down 256
  + 2 x 256; the JAX docstring's "256x4" is not what its code builds),
  global average pool and a bias-free fc to 128-d;
- each GroupNorm is one group over all channels with flax's epsilon 1e-6;
  down blocks project the skip with a 2x2/2 average pool ("SAME": padding
  counted, added after) and a 1x1 conv;
- chips are cut on the host from detection boxes with 25% context padding
  (:func:`extract_chip`), normalized on the device as (x - RGB_MEAN) / 256;
- features leave as float64 at the host boundary (featsio.py:24-39).

The convolutions run as cuDNN ``conv2d`` in fp32 (TF32 off, device.py); the
JAX package runs them through XLA, outside any Pallas kernel.

Weights: the port's state dict (``stem``, ``stem_norm``, ``blocks.<i>.
conv1|norm1|conv2|norm2|proj``, ``fc128``) in PyTorch layouts.
:func:`from_flax_params` carries the JAX parameters across (flax names
submodules in call order: ``Conv_0``, ``GroupNorm_0``, ``_ResBlock_<i>`` with
``Conv_0``, ``GroupNorm_0``, ``Conv_1``, ``GroupNorm_1`` and, in down
blocks, ``Conv_2``; ``fc128``), and :func:`save_weights_npz` /
:func:`load_weights_npz` use the JAX npz keys (``<module>.<param>``, flax
layouts), so one file serves both packages.
"""

import os

import numpy as np
import torch
import torch.nn.functional as F

from columbiaimagesearch_tpu_torch.device import resolve_device

CHIP_SIZE = 150
EMBED_DIM = 128
# dlib input_rgb_image average pixel values.
RGB_MEAN = (122.782, 117.001, 104.298)
GN_EPS = 1e-6

#: (features, down) of the 13 residual blocks, forward order (face.py:60-70)
BLOCKS = ((32, False), (32, False), (32, False),
          (64, True), (64, False), (64, False), (64, False),
          (128, True), (128, False), (128, False),
          (256, True), (256, False), (256, False))


def _avg_pool_same(x):
    """``nn.avg_pool(x, (2, 2), strides=(2, 2), padding="SAME")``: the
    padding (zero, counted in the mean) goes after, as XLA's SAME does."""
    ph, pw = x.shape[2] % 2, x.shape[3] % 2
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph))
    return F.avg_pool2d(x, 2, stride=2)


class _ResBlock(torch.nn.Module):
    def __init__(self, cin, features, down, **kw):
        super().__init__()
        self.down = down
        self.conv1 = torch.nn.Conv2d(cin, features, 3, stride=2 if down
                                     else 1, padding=1, bias=False, **kw)
        self.norm1 = torch.nn.GroupNorm(1, features, eps=GN_EPS, **kw)
        self.conv2 = torch.nn.Conv2d(features, features, 3, padding=1,
                                     bias=False, **kw)
        self.norm2 = torch.nn.GroupNorm(1, features, eps=GN_EPS, **kw)
        self.proj = (torch.nn.Conv2d(cin, features, 1, bias=False, **kw)
                     if down or cin != features else None)

    def forward(self, x):
        y = torch.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        if self.proj is not None:
            x = self.proj(_avg_pool_same(x) if self.down else x)
        return torch.relu(x + y)


class FaceResNet(torch.nn.Module):
    """The JAX ``FaceResNet`` topology. Input: [N, 3, 150, 150] float32,
    already (x - mean) / 256 normalized; output [N, 128]."""

    def __init__(self, device="cpu", dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.stem = torch.nn.Conv2d(3, 32, 7, stride=2, padding=3,
                                    bias=False, **kw)
        self.stem_norm = torch.nn.GroupNorm(1, 32, eps=GN_EPS, **kw)
        blocks, cin = [], 32
        for features, down in BLOCKS:
            blocks.append(_ResBlock(cin, features, down, **kw))
            cin = features
        self.blocks = torch.nn.ModuleList(blocks)
        self.fc128 = torch.nn.Linear(256, EMBED_DIM, bias=False, **kw)
        self.requires_grad_(False)

    @classmethod
    def from_state_dict(cls, state_dict, device="cpu"):
        """The net on ``device`` with the weights of a state dict (see the
        module docstring). No random init runs."""
        net = cls(device="meta")
        net.load_state_dict({k: torch.as_tensor(v).to(device=device,
                                                       dtype=torch.float32)
                             for k, v in state_dict.items()}, assign=True)
        return net.requires_grad_(False)

    def forward(self, x):
        x = torch.relu(self.stem_norm(self.stem(x)))
        # nn.max_pool(3x3/2, "SAME") at 75 pads one -inf row/col each side
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for block in self.blocks:
            x = block(x)
        return self.fc128(x.mean(dim=(2, 3)))


def face_embeddings(net, chips):
    """[N, 150, 150, 3] float32 (0..255 RGB) tensor on the net's device ->
    [N, 128] float32 (face.py:76-81)."""
    mean = torch.tensor(RGB_MEAN, dtype=torch.float32, device=chips.device)
    x = (chips.to(torch.float32) - mean) / 256.0
    return net(x.permute(0, 3, 1, 2))


# ------------------------------------------------------------------ weights


def _state_keys():
    """(port key, flax path, kind) of every parameter; kind is "conv"
    (HWIO <-> OIHW), "dense" ([in, out] <-> [out, in]) or "vec"."""
    out = [("stem.weight", "Conv_0.kernel", "conv"),
           ("stem_norm.weight", "GroupNorm_0.scale", "vec"),
           ("stem_norm.bias", "GroupNorm_0.bias", "vec")]
    cin = 32
    for i, (features, down) in enumerate(BLOCKS):
        p, f = f"blocks.{i}.", f"_ResBlock_{i}."
        out += [(p + "conv1.weight", f + "Conv_0.kernel", "conv"),
                (p + "norm1.weight", f + "GroupNorm_0.scale", "vec"),
                (p + "norm1.bias", f + "GroupNorm_0.bias", "vec"),
                (p + "conv2.weight", f + "Conv_1.kernel", "conv"),
                (p + "norm2.weight", f + "GroupNorm_1.scale", "vec"),
                (p + "norm2.bias", f + "GroupNorm_1.bias", "vec")]
        if down or cin != features:
            out.append((p + "proj.weight", f + "Conv_2.kernel", "conv"))
        cin = features
    out.append(("fc128.weight", "fc128.kernel", "dense"))
    return out


def _to_port(arr, kind):
    arr = np.asarray(arr, dtype=np.float32)
    if kind == "conv":
        arr = np.transpose(arr, (3, 2, 0, 1))
    elif kind == "dense":
        arr = arr.T
    return torch.from_numpy(np.array(arr, order="C"))       # a writable copy


def _to_flax(t, kind):
    arr = torch.as_tensor(t).detach().cpu().numpy()
    if kind == "conv":
        return np.transpose(arr, (2, 3, 1, 0))
    return arr.T if kind == "dense" else arr


def _flax_get(params, path):
    node = params
    for part in path.split("."):
        node = node[part]
    return node


def from_flax_params(params):
    """The JAX package's (nested) params, any array type numpy reads ->
    the port's state dict."""
    return {key: _to_port(_flax_get(params, path), kind)
            for key, path, kind in _state_keys()}


def init_params(seed: int = 0):
    """Random weights from an explicit ``torch.Generator``: LeCun normal
    kernels (flax's default), GroupNorm scale 1 and bias 0. The values
    differ from the JAX package's ``init_params`` (another RNG)."""
    g = torch.Generator()
    g.manual_seed(int(seed))
    shapes = {k: v.shape for k, v in FaceResNet(device="meta")
              .state_dict().items()}
    sd = {}
    for key, path, kind in _state_keys():
        shape = shapes[key]
        if kind == "vec":
            sd[key] = (torch.ones(shape) if path.endswith(".scale")
                       else torch.zeros(shape))
        else:
            fan_in = int(np.prod(shape[1:]))
            sd[key] = torch.randn(shape, generator=g) / float(fan_in) ** 0.5
    return sd


WEIGHTS_ENV = "FACE_WEIGHTS"


def default_weights_path():
    """$FACE_WEIGHTS (the variable the JAX package reads too) or
    ``<package>/models/weights/face.npz`` (face.py:90-101)."""
    env = os.environ.get(WEIGHTS_ENV)
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "weights", "face.npz")


def save_weights_npz(params, path):
    """Persist a state dict as the JAX package's flat npz (keys
    ``<module>.<param>``, flax layouts)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{p: _to_flax(params[k], kind)
                      for k, p, kind in _state_keys()})


def load_weights_npz(path):
    """Load an npz in the JAX key layout (either package's
    ``save_weights_npz``) as the port's state dict."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return {key: _to_port(flat[path_], kind)
            for key, path_, kind in _state_keys()}


def load_default_weights():
    """Weights from the conventional path, or None."""
    path = default_weights_path()
    if path and os.path.exists(path):
        return load_weights_npz(path)
    return None


def extract_chip(img, bbox, padding: float = 0.25):
    """Cut a face chip from a bbox dict with dlib-style context padding and
    resize it to 150x150 on the host (face.py:144-167)."""
    from PIL import Image

    img = np.asarray(img)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    h, w = img.shape[:2]
    left, top = float(bbox["left"]), float(bbox["top"])
    right, bottom = float(bbox["right"]), float(bbox["bottom"])
    bw, bh = right - left, bottom - top
    left = int(max(0, round(left - padding * bw)))
    top = int(max(0, round(top - padding * bh)))
    right = int(min(w, round(right + padding * bw)))
    bottom = int(min(h, round(bottom + padding * bh)))
    if right <= left or bottom <= top:
        chip = np.zeros((CHIP_SIZE, CHIP_SIZE, 3), dtype=np.uint8)
    else:
        crop = img[top:bottom, left:right, :3].astype(np.uint8)
        chip = np.asarray(Image.fromarray(crop).resize(
            (CHIP_SIZE, CHIP_SIZE), Image.BILINEAR))
    return chip


class FaceEmbedder:
    """Featurizer facade with the reference's contract
    (``featurize(img, bbox) -> 128-d float64``; reference:
    featurizer/dlib_featurizer.py:86-105) plus the batched paths of
    face.py:170-205.

    The forward runs under ``torch.inference_mode`` itself: serving calls
    ``featurize_batch`` from the HTTP handlers' threads, and grad mode is
    per thread.
    """

    feat_size = EMBED_DIM
    feat_type = "dlib"

    def __init__(self, params=None, seed: int = 0, aligner=None,
                 device=None):
        """:param params: state dict (see the module docstring); None
            loads :func:`load_default_weights`, else seeded random weights
        :param aligner: optional ``FaceAligner`` (models/face_align.py):
            chips are then landmark-aligned instead of padded bbox crops
        :param device: torch device; default: the first card (raises when
            there is none: pass ``device="cpu"`` for the CPU)
        """
        self.device = resolve_device(device)
        if params is None:
            params = load_default_weights()
        self.pretrained = params is not None
        self.params = params if params is not None else init_params(seed)
        self.net = FaceResNet.from_state_dict(self.params, self.device)
        self.aligner = aligner

    @torch.inference_mode()
    def embed(self, chips):
        """[N, 150, 150, 3] chips (uint8 or float, array or tensor) ->
        [N, 128] float32 on the device."""
        if not isinstance(chips, torch.Tensor):
            chips = torch.from_numpy(np.asarray(chips, dtype=np.float32))
        return face_embeddings(self.net, chips.to(self.device))

    def featurize(self, img, bbox):
        return self.featurize_batch(img, [bbox])[0]

    def featurize_batch(self, img, bboxes):
        """One image, many bboxes -> [len(bboxes), 128] float64."""
        if self.aligner is not None:
            chips = self.aligner.align(img, bboxes)
        else:
            chips = np.stack([extract_chip(img, b) for b in bboxes])
        return self.featurize_chips(chips)

    def featurize_chips(self, chips):
        """[N, 150, 150, 3] uint8/float -> [N, 128] float64 (bulk path)."""
        return self.embed(chips).cpu().numpy().astype(np.float64)
