"""Sliding-window face detector (conv-HOG + linear template) in PyTorch
(port of columbiaimagesearch_tpu/models/face_detector.py:28-267).

The reference detects faces with dlib's HOG + linear-SVM detector over an
image pyramid (reference: cufacesearch/detector/dlib_detector.py:10-35).
The JAX package expresses one pyramid level as device ops, and so does
the port:

- gradients and unsigned orientation energies are elementwise ops, HOG
  cells an 8x8 mean, block normalization a local reduce
  (:func:`hog_features`);
- the 10x10-cell linear template is one VALID ``conv2d`` in fp32 giving
  the score of every window position (:func:`score_map`);
- the pyramid (PIL resizes, ratio 5/6) and the non-maximum suppression
  run on the host.

Each level is zero-padded to a bucket size (:func:`_bucket`) before HOG,
as in the JAX detector. Nothing compiles per shape here, but the padding
is part of the result: the gradient of the level's last row and column
sees the zero pad, and windows that touch the pad are masked.

The template loads from ``$FACE_TEMPLATE``, else from the port's own
``models/weights/face_template.npz`` (a copy of the JAX package's trained
artifact); :meth:`ConvHOGFaceDetector.train` fits one on the device and
:meth:`ConvHOGFaceDetector.save_template` writes it there.
"""

import os

import numpy as np
import torch
import torch.nn.functional as F

from columbiaimagesearch_tpu_torch.device import resolve_device

CELL = 8           # pixels per HOG cell
N_ORIENT = 8       # orientation channels
WINDOW = 80        # detection window in pixels
TCELLS = WINDOW // CELL  # template size in cells
PYRAMID_RATIO = 5.0 / 6.0
DEFAULT_UPSAMPLING = 1

_ANGLES = np.pi * np.arange(N_ORIENT) / N_ORIENT


def hog_features(img):
    """[H, W] float32 grayscale tensor -> [H//8, W//8, N_ORIENT] HOG-like
    cells (face_detector.py:38-53)."""
    gx = torch.zeros_like(img)
    gx[:, 1:-1] = img[:, 2:] - img[:, :-2]
    gy = torch.zeros_like(img)
    gy[1:-1, :] = img[2:, :] - img[:-2, :]
    cos = torch.tensor(np.cos(_ANGLES), dtype=torch.float32,
                       device=img.device)
    sin = torch.tensor(np.sin(_ANGLES), dtype=torch.float32,
                       device=img.device)
    # Unsigned orientation energy: |g . d_theta| per channel.
    proj = torch.abs(gx[..., None] * cos + gy[..., None] * sin)  # [H, W, O]
    H, W = img.shape
    ch, cw = H // CELL, W // CELL
    cells = proj[:ch * CELL, :cw * CELL].reshape(ch, CELL, cw, CELL,
                                                  N_ORIENT).mean(dim=(1, 3))
    # Block normalization: divide by local energy.
    energy = torch.sqrt((cells * cells).sum(dim=-1, keepdim=True) + 1e-4)
    return cells / energy


def score_map(feats, template, bias):
    """Dense window scores: one VALID conv of the [10, 10, O] template over
    [ch, cw, O] cells -> [ch - 9, cw - 9] (face_detector.py:56-64)."""
    out = F.conv2d(feats.permute(2, 0, 1)[None],
                   template.permute(2, 0, 1)[None])
    return out[0, 0] + bias


def _bucket(size: int) -> int:
    """The JAX detector's static padded sizes (face_detector.py:67-72)."""
    b = 96
    while b < size:
        b = int(b * 1.5)
    return b


def default_template_path():
    """$FACE_TEMPLATE (the variable the JAX package reads too) or
    ``<package>/models/weights/face_template.npz``."""
    env = os.environ.get("FACE_TEMPLATE")
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "weights", "face_template.npz")


class ConvHOGFaceDetector:
    """Sliding-window detector with the reference detector's contract.

    ``run`` is split into its host and device halves (:meth:`pyramid`,
    :meth:`score_maps`, :meth:`collect`) so each can be timed alone."""

    def __init__(self, template=None, bias=None, threshold=0.5,
                 nms_iou=0.4, min_size=WINDOW, device=None):
        """:param device: torch device of the HOG and score convolution;
            default: the first card (raises when there is none: pass
            ``device="cpu"`` for the CPU)"""
        self.device = resolve_device(device)
        if template is None:
            loaded = self._load_default()
            if loaded is not None:
                template, file_bias = loaded
                if bias is None:
                    bias = file_bias
        if template is None:
            rng = np.random.RandomState(0)
            template = 0.01 * rng.randn(TCELLS, TCELLS, N_ORIENT)
        self.template = torch.as_tensor(np.asarray(template, np.float32)).to(
            self.device)
        self.bias = float(bias) if bias is not None else 0.0
        self.threshold = threshold
        self.nms_iou = nms_iou
        self.min_size = min_size

    @staticmethod
    def _load_default():
        path = default_template_path()
        if path and os.path.exists(path):
            with np.load(path) as z:
                return z["template"], float(z["bias"])
        return None

    def save_template(self, path=None):
        """Write ``template`` and ``bias`` to ``path`` (default:
        :func:`default_template_path`, where :meth:`_load_default` reads
        them) as the JAX package's npz (face_detector.py:120-127): the
        same keys, a float32 template and a float32 bias. Returns the
        path."""
        path = path or default_template_path()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, template=self.template.detach().cpu().numpy(),
                 bias=np.float32(self.bias))
        return path

    def train(self, pos_imgs, neg_imgs, steps=300, lr=0.05, seed=0,
              neg_weight=1.0):
        """Fit the linear template on this detector's device
        (face_detector.py:195-245): HOG features of 80x80 window crops
        through :func:`hog_features`, then class-balanced logistic
        regression with a ``1e-4 * ||w||^2`` penalty by ``steps`` steps of
        full-batch gradient descent (autograd) from zero. Each class
        weighs half of the mean whatever the pool sizes, and
        ``neg_weight`` scales the negatives further: unbalanced, a
        positive-heavy pool drags the bias up and flat windows score
        above zero. ``seed`` is unused (the descent is deterministic), as
        in the JAX method. Sets ``template`` and ``bias``; returns self."""
        del seed
        dev = self.device

        def feats_of(stack):
            out = []
            for im in stack:
                a = np.array(im, dtype=np.float32)
                if a.ndim == 3:
                    a = a.mean(axis=2)
                out.append(hog_features(torch.from_numpy(a).to(dev))
                           [:TCELLS, :TCELLS, :].reshape(-1))
            return torch.stack(out)

        Xp, Xn = feats_of(pos_imgs), feats_of(neg_imgs)
        X = torch.cat([Xp, Xn])
        y = torch.cat([torch.ones(len(Xp)), torch.zeros(len(Xn))]).to(dev)
        sw = np.concatenate([
            np.full(len(Xp), 0.5 / max(len(Xp), 1)),
            np.full(len(Xn), 0.5 * neg_weight / max(len(Xn), 1)),
        ]).astype(np.float32)
        sw = torch.from_numpy(sw / sw.sum()).to(dev)
        w = torch.zeros(X.shape[1], device=dev, requires_grad=True)
        b = torch.zeros((), device=dev, requires_grad=True)
        with torch.enable_grad():
            for _ in range(steps):
                logits = X @ w + b
                loss = (sw * (torch.clamp(logits, min=0) - logits * y
                              + torch.log1p(torch.exp(-logits.abs())))
                        ).sum() + 1e-4 * (w * w).sum()
                gw, gb = torch.autograd.grad(loss, (w, b))
                with torch.no_grad():
                    w -= lr * gw
                    b -= lr * gb
        self.template = w.detach().reshape(TCELLS, TCELLS, N_ORIENT)
        self.bias = float(b.detach())
        return self

    # ----------------------------------------------------------- detection

    def pyramid(self, img, up_sample=DEFAULT_UPSAMPLING):
        """Host half: the grayscale pyramid levels, each (pixels [h, w]
        float32, pyramid scale, upsampling scale), in the JAX detector's
        order and sizes."""
        from PIL import Image

        img = np.asarray(img)
        if img.ndim == 3:
            img = img.astype(np.float32).mean(axis=2)
        else:
            img = img.astype(np.float32)
        scale0 = 2.0 ** int(up_sample)
        if scale0 != 1.0:
            h, w = img.shape
            img = np.asarray(Image.fromarray(img).resize(
                (int(w * scale0), int(h * scale0)), Image.BILINEAR))
        levels = []
        scale = 1.0
        cur = img
        while min(cur.shape) >= self.min_size:
            levels.append((cur, scale, scale0))
            scale *= PYRAMID_RATIO
            nh = int(round(img.shape[0] * scale))
            nw = int(round(img.shape[1] * scale))
            if min(nh, nw) < self.min_size:
                break
            cur = np.asarray(Image.fromarray(img).resize((nw, nh),
                                                         Image.BILINEAR))
        return levels

    @torch.inference_mode()
    def score_maps(self, levels):
        """Device half: each level zero-padded to its bucket, HOG and the
        template convolution; the score maps come back as numpy."""
        out = []
        for cur, *_scales in levels:
            bh, bw = _bucket(cur.shape[0]), _bucket(cur.shape[1])
            padded = torch.zeros((bh, bw), dtype=torch.float32,
                                 device=self.device)
            # PIL's arrays are read-only: from_numpy takes a writable copy
            padded[:cur.shape[0], :cur.shape[1]] = torch.from_numpy(
                np.array(cur)).to(self.device)
            out.append(score_map(hog_features(padded), self.template,
                                 self.bias))
        return [s.cpu().numpy() for s in out]

    def collect(self, levels, smaps):
        """Host half: windows above the threshold that do not touch the
        padding, mapped to image pixels, then NMS. Returns (boxes,
        scores) as dlib's ``detector.run`` does."""
        boxes, scores = [], []
        for (cur, scale, scale0), smap in zip(levels, smaps):
            max_cy = (cur.shape[0] // CELL) - TCELLS
            max_cx = (cur.shape[1] // CELL) - TCELLS
            ys, xs = np.nonzero(smap > self.threshold)
            for y, x in zip(ys, xs):
                if y > max_cy or x > max_cx:
                    continue
                px, py = x * CELL, y * CELL
                boxes.append(np.array([px, py, px + WINDOW, py + WINDOW])
                             / scale / scale0)
                scores.append(float(smap[y, x]))
        if not boxes:
            return [], []
        boxes = np.stack(boxes)
        scores = np.asarray(scores)
        keep = _nms(boxes, scores, self.nms_iou)
        return boxes[keep], scores[keep]

    def run(self, img, up_sample=DEFAULT_UPSAMPLING):
        """Detect; returns (bboxes, scores) like dlib's ``detector.run``."""
        levels = self.pyramid(img, up_sample)
        return self.collect(levels, self.score_maps(levels))

    def detect_from_img(self, img, up_sample=DEFAULT_UPSAMPLING):
        """Reference contract (detector/dlib_detector.py:22-35): list of
        bbox dicts with score."""
        boxes, scores = self.run(img, up_sample)
        return [
            {"left": int(round(b[0])), "top": int(round(b[1])),
             "right": int(round(b[2])), "bottom": int(round(b[3])),
             "score": float(s)}
            for b, s in zip(boxes, scores)
        ]


def _nms(boxes, scores, iou_th):
    """Greedy non-maximum suppression on the host (face_detector.py:
    248-267)."""
    order = np.argsort(scores)[::-1]
    keep = []
    while len(order):
        i = order[0]
        keep.append(i)
        if len(order) == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
        a1 = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        a2 = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / np.maximum(a1 + a2 - inter, 1e-9)
        order = rest[iou <= iou_th]
    return np.asarray(keep, dtype=int)
