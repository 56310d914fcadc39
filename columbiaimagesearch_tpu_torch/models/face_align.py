"""Face alignment in PyTorch: landmark regression, its training, and the
similarity-warped chip (port of columbiaimagesearch_tpu/models/face_align.py:
30-305).

The reference aligns faces with dlib's 68-landmark shape predictor before
embedding (reference: cufacesearch/featurizer/dlib_featurizer.py:68-105).
As in the JAX package:

- :func:`predict_landmarks` runs ``LandmarkNet``, a small conv regressor
  of 5 or 68 points on a 64x64 grayscale crop (four 3x3/2 convs, two dense
  layers, a sigmoid);
- :func:`estimate_similarity` is the closed-form Umeyama fit (numpy);
- :func:`warp_affine` is the batched inverse-map bilinear warp, the same
  gather-and-blend arithmetic as face_align.py:201-235 (not
  ``grid_sample``, whose corner conventions differ);
- :class:`FaceAligner` chains them into 150x150 chips for the embedders.

``LandmarkNet``'s parameters keep the flax pytree (``Conv_0``..``Conv_3``,
``Dense_0``, ``Dense_1``, each ``kernel``/``bias`` in flax layouts), so the
JAX package's parameters load unchanged. :func:`train_landmark_net` trains
them on the device with Adam, on crops from
:func:`make_landmark_training_set` (face_align.py:75-109, 139-174).
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from columbiaimagesearch_tpu_torch.device import resolve_device
from columbiaimagesearch_tpu_torch.models.face import CHIP_SIZE

LM_INPUT = 64   # landmark net input side
N_POINTS = 5
_CONV_FEATS = (16, 32, 64, 128)

# Canonical 5-point template (ArcFace convention, 112x112) scaled to the
# 150x150 chip: left eye, right eye, nose tip, left mouth, right mouth.
_TEMPLATE_112 = np.array([
    [38.2946, 51.6963], [73.5318, 51.5014], [56.0252, 71.7366],
    [41.5493, 92.3655], [70.7299, 92.2041]], dtype=np.float32)
CANONICAL_POINTS = _TEMPLATE_112 * (CHIP_SIZE / 112.0)


def predict_landmarks(params, crops, n_points: int = N_POINTS):
    """[N, 64, 64, 1] float32 (0..1) tensor -> [N, n_points, 2] points in
    [0, 1] crop coordinates (face_align.py:41-66). ``params``: the flax
    pytree as tensors on the crops' device."""
    x = crops.permute(0, 3, 1, 2)
    for i in range(len(_CONV_FEATS)):
        p = params[f"Conv_{i}"]
        x = torch.relu(F.conv2d(x, p["kernel"].permute(3, 2, 0, 1),
                                p["bias"], stride=2, padding=1))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # flax's NHWC order
    x = torch.relu(x @ params["Dense_0"]["kernel"] + params["Dense_0"]["bias"])
    pts = x @ params["Dense_1"]["kernel"] + params["Dense_1"]["bias"]
    return torch.sigmoid(pts).reshape(-1, n_points, 2)


def init_landmark_params(seed: int = 0, n_points: int = N_POINTS):
    """Random ``LandmarkNet`` params (numpy, flax layouts): LeCun normal
    kernels and zero biases, flax's defaults. The values differ from the
    JAX package's ``init_landmark_params`` (another RNG)."""
    rng = np.random.RandomState(seed)

    def dense(fan_in, shape):
        return {"kernel": (rng.randn(*shape) / np.sqrt(fan_in)).astype(
            np.float32), "bias": np.zeros(shape[-1], np.float32)}

    params, cin = {}, 1
    for i, feats in enumerate(_CONV_FEATS):
        params[f"Conv_{i}"] = dense(9 * cin, (3, 3, cin, feats))
        cin = feats
    flat = (LM_INPUT // 16) ** 2 * cin
    params["Dense_0"] = dense(flat, (flat, 128))
    params["Dense_1"] = dense(128, (128, 2 * n_points))
    return params


def _params_to(params, device):
    return {name: {k: torch.from_numpy(np.array(v, dtype=np.float32))
                   .to(device) for k, v in layer.items()}
            for name, layer in params.items()}


def train_landmark_net(params, crops, points, steps=500, lr=1e-3,
                       batch=64, seed=0, device=None):
    """MSE landmark regression (face_align.py:75-109) on ``device``
    (default: the first card; raises without one): ``steps`` Adam steps
    (``torch.optim.Adam``, betas (0.9, 0.999), eps 1e-8: optax.adam's
    defaults) on minibatches of ``batch`` rows drawn with replacement
    from a ``torch.Generator`` seeded with ``seed`` (the JAX draw uses
    ``jax.random``, so the batches differ).

    :param params: the flax pytree :func:`init_landmark_params` returns
        (numpy or tensors)
    :param crops: [N, 64, 64, 1] float32 in [0, 1]
    :param points: [N, n_points, 2] targets in [0, 1] crop coordinates
        (the head size is taken from this shape)
    :returns: (trained params as numpy in the same pytree, last loss)
    """
    dev = resolve_device(device)
    crops = torch.as_tensor(np.asarray(crops, np.float32)).to(dev)
    points = torch.as_tensor(np.asarray(points, np.float32)).to(dev)
    n_points = int(points.shape[1])
    p = {name: {k: torch.as_tensor(np.array(v, dtype=np.float32)).to(dev)
                .requires_grad_(True) for k, v in layer.items()}
         for name, layer in params.items()}
    leaves = [t for layer in p.values() for t in layer.values()]
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    loss = None
    with torch.enable_grad():
        for _ in range(steps):
            idx = torch.randint(0, crops.shape[0], (batch,), generator=g,
                                device=dev)
            pred = predict_landmarks(p, crops[idx], n_points=n_points)
            loss = torch.mean((pred - points[idx]) ** 2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    out = {name: {k: v.detach().cpu().numpy() for k, v in layer.items()}
           for name, layer in p.items()}
    return out, float(loss.detach()) if loss is not None else None


def make_landmark_training_set(identities, n_per_identity: int = 4,
                               seed: int = 0, n_points: int = 68):
    """Rendered 64x64 crops and exact landmark targets of the procedural
    faces in detector-style jittered boxes (copy of face_align.py:139-174,
    numpy + PIL). Returns (crops [N, 64, 64, 1] float32 0..1,
    targets [N, n_points, 2] in [0, 1] crop coordinates)."""
    from PIL import Image

    from columbiaimagesearch_tpu_torch.models import face_synth

    rng = np.random.RandomState(seed)
    crops, targets = [], []
    for identity in identities:
        img, bbox = face_synth.render_face(identity)
        pts = face_synth.landmarks68(identity)
        if n_points == N_POINTS:
            pts = key5_from_68(pts)
        elif n_points != 68:
            raise ValueError(f"n_points must be 5 or 68, got {n_points}")
        l, t, r, b = bbox
        w, h = r - l, b - t
        for _ in range(n_per_identity):
            jl = max(0, int(l + rng.uniform(-0.08, 0.08) * w))
            jt = max(0, int(t + rng.uniform(-0.08, 0.08) * h))
            jr = min(img.shape[1], int(r + rng.uniform(-0.08, 0.08) * w))
            jb = min(img.shape[0], int(b + rng.uniform(-0.08, 0.08) * h))
            crop = img[jt:jb, jl:jr]
            crop64 = np.asarray(
                Image.fromarray(crop.astype(np.uint8)).resize(
                    (LM_INPUT, LM_INPUT), Image.BILINEAR), np.float32)
            tgt = (pts - [jl, jt]) / [max(jr - jl, 1), max(jb - jt, 1)]
            # Jaw points sit ON the face bbox; inward jitter pushes them
            # just outside the crop, which a sigmoid head cannot reach.
            tgt = np.clip(tgt, 0.001, 0.999)
            crops.append(crop64[..., None] / 255.0)
            targets.append(tgt.astype(np.float32))
    return np.stack(crops), np.stack(targets)


def key5_from_68(pts):
    """5-point (eye centers, nose tip, mouth corners) summary of an
    ibug-68 shape (face_align.py:112-118)."""
    pts = np.asarray(pts, dtype=np.float64)
    return np.stack([pts[36:42].mean(0), pts[42:48].mean(0), pts[30],
                     pts[48], pts[54]])


@functools.lru_cache(maxsize=1)
def canonical_points_68():
    """[68, 2] mean procedural shape in 150x150 chip coordinates, mapped
    through its 5 key points onto :data:`CANONICAL_POINTS`
    (face_align.py:121-136)."""
    from columbiaimagesearch_tpu_torch.models.face_synth import landmarks68

    mean = np.mean([landmarks68(i, size=1) for i in range(200)], axis=0)
    A = estimate_similarity(key5_from_68(mean), CANONICAL_POINTS)
    return (mean @ A[:, :2].T + A[:, 2]).astype(np.float32)


def estimate_similarity(src_pts, dst_pts):
    """Umeyama closed-form similarity (s, R, t): dst ~= s R src + t
    (face_align.py:177-197).

    :returns: [2, 3] matrix A mapping src -> dst homogeneous coords
    """
    src = np.asarray(src_pts, dtype=np.float64)
    dst = np.asarray(dst_pts, dtype=np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    U, S, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, d])
    R = U @ D @ Vt
    var_s = (sc ** 2).sum() / len(src)
    s = (S * np.diag(D)).sum() / max(var_s, 1e-12)
    t = mu_d - s * R @ mu_s
    A = np.zeros((2, 3), dtype=np.float32)
    A[:, :2] = s * R
    A[:, 2] = t
    return A


def warp_affine(imgs, A_inv, out_h: int, out_w: int):
    """Batched inverse-map bilinear warp (face_align.py:200-234).

    :param imgs: [N, H, W, C] float32 tensor
    :param A_inv: [N, 2, 3] tensor mapping OUTPUT coords -> INPUT coords
    :returns: [N, out_h, out_w, C] float32
    """
    N, H, W, C = imgs.shape
    dev = imgs.device
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")          # [oh, ow]
    grid = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    src = torch.einsum("nij,hwj->nhwi", A_inv.to(torch.float32), grid)
    sx = src[..., 0].clamp(0.0, W - 1.001)
    sy = src[..., 1].clamp(0.0, H - 1.001)
    x0 = torch.floor(sx).to(torch.int64)
    y0 = torch.floor(sy).to(torch.int64)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    flat = imgs.reshape(N, H * W, C)

    def gather(yi, xi):
        idx = (yi * W + xi).reshape(N, -1, 1).expand(N, out_h * out_w, C)
        return flat.gather(1, idx).reshape(N, out_h, out_w, C)

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


class FaceAligner:
    """bbox -> aligned 150x150 chip via landmarks + similarity warp
    (face_align.py:237-305); the landmark net and the warp run on
    ``device`` (default: the first card; raises without one)."""

    def __init__(self, params=None, seed: int = 0,
                 n_points: int = N_POINTS, device=None):
        if n_points not in (N_POINTS, 68):
            raise ValueError(
                f"n_points must be {N_POINTS} or 68, got {n_points}")
        self.device = resolve_device(device)
        self.n_points = n_points
        self.template = (CANONICAL_POINTS if n_points == N_POINTS
                         else canonical_points_68())
        self.params = _params_to(
            params if params is not None
            else init_landmark_params(seed, n_points=n_points), self.device)

    def _crop64(self, img, bbox):
        from PIL import Image

        img = np.asarray(img)
        if img.ndim == 3:
            gray = img.astype(np.float32).mean(axis=2)
        else:
            gray = img.astype(np.float32)
        h, w = gray.shape
        l = max(0, int(bbox["left"]))
        t = max(0, int(bbox["top"]))
        r = min(w, int(bbox["right"]))
        b = min(h, int(bbox["bottom"]))
        if r <= l or b <= t:
            return np.zeros((LM_INPUT, LM_INPUT), np.float32), (0, 0, 1, 1)
        crop = gray[t:b, l:r]
        crop64 = np.asarray(Image.fromarray(crop.astype(np.uint8)).resize(
            (LM_INPUT, LM_INPUT), Image.BILINEAR), dtype=np.float32)
        return crop64, (l, t, r - l, b - t)

    @torch.inference_mode()
    def align(self, img, bboxes):
        """One image, many bboxes -> [n, 150, 150, 3] aligned chips
        (float32 numpy)."""
        img = np.asarray(img)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        crops, geoms = [], []
        for bbox in bboxes:
            c, g = self._crop64(img, bbox)
            crops.append(c)
            geoms.append(g)
        crops = np.stack(crops)[..., None] / 255.0
        pts = predict_landmarks(
            self.params, torch.from_numpy(crops.astype(np.float32)).to(
                self.device), n_points=self.n_points).cpu().numpy()
        A_invs = []
        for p, (l, t, cw, ch) in zip(pts, geoms):
            src = p * np.array([cw, ch]) + np.array([l, t])  # image coords
            A = estimate_similarity(src, self.template)
            M = np.eye(3, dtype=np.float64)
            M[:2] = A
            A_invs.append(np.linalg.inv(M)[:2].astype(np.float32))
        imgs = torch.from_numpy(img.astype(np.float32)).to(self.device)
        chips = warp_affine(imgs[None].expand(len(bboxes), *imgs.shape),
                            torch.from_numpy(np.stack(A_invs)).to(
                                self.device), CHIP_SIZE, CHIP_SIZE)
        return chips.cpu().numpy()
