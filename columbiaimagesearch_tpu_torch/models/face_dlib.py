"""Exact-topology dlib face_recognition_model_v1 in PyTorch, inference only
(port of columbiaimagesearch_tpu/models/face_dlib.py:37-269).

The generic embedder (models/face.py) uses GroupNorm and 1x1 projections
and cannot load real dlib weights. This variant reproduces dlib's 29-conv
metric ResNet layer for layer (reference contract:
cufacesearch/featurizer/dlib_featurizer.py:50-105):

- affine layers (per-channel scale and shift, dlib's folded batch norm);
- dlib's convolution padding: k//2 at stride 1, none when strided (the
  7x7/2 stem and every down-sampling 3x3/2 conv run VALID);
- dlib's residual add: tensors of different shapes add as though
  zero-padded, top-left aligned, to the elementwise max of their dims;
- identity skips, 2x2/2 VALID average pooling on down blocks;
- global average pool, then a bias-free fc to 128-d.

Parameters keep the JAX package's pytree and layouts (HWIO kernels,
[256, 128] fc), so its npz files load unchanged; the forward transposes
the kernels to OIHW. :func:`load_dlib_weights` reads dlib's native tensor
layout. Parsing dlib's ``.dat`` container is out of scope, as in the JAX
package.
"""

import os

import numpy as np
import torch
import torch.nn.functional as F

from columbiaimagesearch_tpu_torch.device import resolve_device

CHIP_SIZE = 150
EMBED_DIM = 128
RGB_MEAN = (122.782, 117.001, 104.298)

#: (channels, is_down_block) of the 14 residual blocks, forward order
#: (face_dlib.py:41-49): 14 blocks x 2 convs + the stem = 29 convs.
BLOCKS = ((32, False), (32, False), (32, False),
          (32, True), (64, False), (64, False), (64, False),
          (64, True), (128, False), (128, False),
          (128, True), (256, False), (256, False),
          (256, True))


def _conv(x, w, stride):
    """dlib conv on NCHW ``x`` with an HWIO kernel ``w``: padding k//2 at
    stride 1, VALID when strided."""
    k = w.shape[0]
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride,
                    padding=k // 2 if stride == 1 else 0)


def _affine(x, g, b):
    return x * g[None, :, None, None] + b[None, :, None, None]


def _dlib_add(a, b):
    """Add as though zero-padded (top-left aligned) to the max dims — dlib's
    tt::add semantics for mismatched NCHW tensors."""
    C = max(a.shape[1], b.shape[1])
    H = max(a.shape[2], b.shape[2])
    W = max(a.shape[3], b.shape[3])

    def pad_to(t):
        return F.pad(t, (0, W - t.shape[3], 0, H - t.shape[2],
                         0, C - t.shape[1]))

    return pad_to(a) + pad_to(b)


def _block(x, p, down):
    """dlib block: affine(conv 3x3/1(relu(affine(conv 3x3/stride(x))))),
    then relu(skip (+) block) with an average-pooled skip on down blocks."""
    stride = 2 if down else 1
    y = torch.relu(_affine(_conv(x, p["w1"], stride), p["g1"], p["b1"]))
    y = _affine(_conv(y, p["w2"], 1), p["g2"], p["b2"])
    skip = F.avg_pool2d(x, 2, stride=2) if down else x
    return torch.relu(_dlib_add(skip, y))


def dlib_face_embeddings(params, chips):
    """[N, 150, 150, 3] float32 (0..255 RGB) tensor -> [N, 128] float32,
    with ``params`` as tensors on the chips' device
    (face_dlib.py:96-112). Input scaling is dlib's: (x - mean) / 256."""
    mean = torch.tensor(RGB_MEAN, dtype=torch.float32, device=chips.device)
    x = ((chips.to(torch.float32) - mean) / 256.0).permute(0, 3, 1, 2)
    x = _conv(x, params["stem"]["w"], 2)                       # 150 -> 72
    x = torch.relu(_affine(x, params["stem"]["g"], params["stem"]["b"]))
    x = F.max_pool2d(x, 3, stride=2)                           # 72 -> 35
    for i, (_, down) in enumerate(BLOCKS):
        x = _block(x, params["blocks"][i], down)
    return x.mean(dim=(2, 3)) @ params["fc"]                    # bias-free


def _tree_to(params, device):
    """The params pytree (any arrays numpy reads) as float32 tensors."""
    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(device)

    return {"stem": {k: t(v) for k, v in params["stem"].items()},
            "blocks": [{k: t(v) for k, v in blk.items()}
                       for blk in params["blocks"]],
            "fc": t(params["fc"])}


def init_params(seed: int = 0):
    """Random params in the model's own (HWIO) layout, numpy; the same
    values as the JAX package's ``init_params`` (one numpy RNG)."""
    rng = np.random.RandomState(seed)

    def conv(kh, kw, cin, cout):
        fan = kh * kw * cin
        return (rng.randn(kh, kw, cin, cout) / np.sqrt(fan)).astype(
            np.float32)

    params = {"stem": {"w": conv(7, 7, 3, 32),
                       "g": np.ones(32, np.float32),
                       "b": np.zeros(32, np.float32)}}
    blocks = []
    cin = 32
    for n, _down in BLOCKS:
        blocks.append({
            "w1": conv(3, 3, cin, n),
            "g1": np.ones(n, np.float32), "b1": np.zeros(n, np.float32),
            "w2": conv(3, 3, n, n),
            "g2": np.ones(n, np.float32), "b2": np.zeros(n, np.float32),
        })
        cin = max(cin, n)
    params["blocks"] = blocks
    params["fc"] = (rng.randn(256, EMBED_DIM) / 16.0).astype(np.float32)
    return params


def load_dlib_weights(blobs):
    """dlib-layout blobs -> model params (face_dlib.py:142-174).

    :param blobs: ``con0`` .. ``con28`` [num_filters, in_ch, kh, kw]
        (con0 is the 7x7 stem), ``affine0`` .. ``affine28`` (gamma [ch],
        beta [ch]) pairs, ``fc`` [256, 128] (input-major, bias-free)
    :returns: params pytree (numpy, HWIO kernels)
    """
    def conv(i):
        w = np.asarray(blobs[f"con{i}"], dtype=np.float32)
        return np.transpose(w, (2, 3, 1, 0))        # -> [kh, kw, in, out]

    def aff(i):
        g, b = blobs[f"affine{i}"]
        return np.asarray(g, np.float32), np.asarray(b, np.float32)

    g0, b0 = aff(0)
    params = {"stem": {"w": conv(0), "g": g0, "b": b0}}
    blocks = []
    ci = 1
    for _ in BLOCKS:
        g1, b1 = aff(ci)
        g2, b2 = aff(ci + 1)
        blocks.append({"w1": conv(ci), "g1": g1, "b1": b1,
                       "w2": conv(ci + 1), "g2": g2, "b2": b2})
        ci += 2
    params["blocks"] = blocks
    params["fc"] = np.asarray(blobs["fc"], np.float32)
    return params


WEIGHTS_ENV = "DLIB_FACE_WEIGHTS"


def default_weights_path():
    """$DLIB_FACE_WEIGHTS (the variable the JAX package reads too) or
    ``<package>/models/weights/dlib_face.npz`` (face_dlib.py:180-192)."""
    env = os.environ.get(WEIGHTS_ENV)
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "weights", "dlib_face.npz")


def save_params_npz(params, path):
    """Persist params as the JAX package's flat npz (keys ``stem/w``,
    ``blocks/3/w1``, ``fc``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def host(v):
        return (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))

    flat = {"fc": host(params["fc"])}
    for k, v in params["stem"].items():
        flat[f"stem/{k}"] = host(v)
    for i, blk in enumerate(params["blocks"]):
        for k, v in blk.items():
            flat[f"blocks/{i}/{k}"] = host(v)
    np.savez(path, **flat)


def load_params_npz(path):
    """Load params persisted by either package's ``save_params_npz``
    (numpy)."""
    with np.load(path) as z:
        n_blocks = 1 + max(int(k.split("/")[1]) for k in z.files
                           if k.startswith("blocks/"))
        params = {"fc": z["fc"], "stem": {},
                  "blocks": [{} for _ in range(n_blocks)]}
        for key in z.files:
            if key.startswith("stem/"):
                params["stem"][key.split("/")[1]] = z[key]
            elif key.startswith("blocks/"):
                _, i, k = key.split("/")
                params["blocks"][int(i)][k] = z[key]
    return params


def load_default_weights():
    """Pretrained weights from the conventional path, or None."""
    path = default_weights_path()
    if path and os.path.exists(path):
        return load_params_npz(path)
    return None


class DlibExactFaceEmbedder:
    """FaceEmbedder-compatible facade over the import-exact net
    (``featurize(img, bbox) -> 128-d float64``; face_dlib.py:237-269).
    The forward runs under ``torch.inference_mode`` on ``device``
    (default: the first card; raises without one)."""

    feat_size = EMBED_DIM
    feat_type = "dlib"

    def __init__(self, params=None, seed: int = 0, aligner=None,
                 device=None):
        self.device = resolve_device(device)
        if params is None:
            params = load_default_weights()
        self.pretrained = params is not None
        self.params = _tree_to(params if params is not None
                               else init_params(seed), self.device)
        self.aligner = aligner

    @torch.inference_mode()
    def embed(self, chips):
        """[N, 150, 150, 3] chips -> [N, 128] float32 on the device."""
        if not isinstance(chips, torch.Tensor):
            chips = torch.from_numpy(np.asarray(chips, dtype=np.float32))
        return dlib_face_embeddings(self.params, chips.to(self.device))

    def featurize(self, img, bbox):
        return self.featurize_batch(img, [bbox])[0]

    def featurize_batch(self, img, bboxes):
        from columbiaimagesearch_tpu_torch.models.face import extract_chip

        if self.aligner is not None:
            chips = self.aligner.align(img, bboxes)
        else:
            chips = np.stack([extract_chip(img, b) for b in bboxes])
        return self.featurize_chips(chips)

    def featurize_chips(self, chips):
        return self.embed(chips).cpu().numpy().astype(np.float64)
