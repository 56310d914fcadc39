"""Procedural face renderer + scene compositor for detector train/eval
(a copy of columbiaimagesearch_tpu/models/face_synth.py; numpy only).

The reference ships dlib's pretrained HOG+SVM frontal face detector
(reference: cufacesearch/cufacesearch/detector/dlib_detector.py:10-35),
trained on thousands of annotated photos. This environment has zero egress,
so generalization evidence for the TPU-native ConvHOGFaceDetector is built
offline instead: a parametric face renderer draws distinct "identities"
(sampled geometry/skin/hair/lighting), a compositor places held-out
identities into cluttered scenes with hard negatives, and the PR-curve
harness in scripts/eval_face_detector.py evaluates detection on scenes whose
identities were never seen in training.

Everything is numpy, seeded, and deterministic: train/eval disjointness is
by identity id (derived RNG streams), not by file bookkeeping.

Rendering model (all antialiased via 2x supersampling):
  head       — shaded ellipse with per-identity skin tone and aspect
  hair       — darker cap above the forehead line (optional, varied shape)
  eyes/brows — dark ellipses + brow bars; per-identity spacing/size/tilt
  nose       — vertical shading wedge + nostril dots
  mouth      — dark rounded bar with per-identity width/curve
  lighting   — lambertian-ish directional gradient over the face
Hard negatives intentionally share low-order statistics with faces
(shaded ellipses with off-structure interiors, clock-like discs, texture
patches) so the template cannot pass by detecting "any smooth blob".
"""

import numpy as np

FACE_CANVAS = 160  # renderer canvas; face spans ~central 60%
_SS = 2            # supersampling factor


def _identity_rng(identity: int) -> np.random.RandomState:
    """Per-identity parameter stream, independent of scene placement."""
    return np.random.RandomState((0xFACE ^ (identity * 2654435761 % (1 << 31))) % (1 << 31))


def sample_identity(identity: int) -> dict:
    """Draw the per-identity parameter set (geometry, tone, hair, light)."""
    r = _identity_rng(identity)
    return {
        "skin": r.uniform(120, 225),
        "face_w": r.uniform(0.52, 0.68),      # fraction of canvas
        "face_h": r.uniform(0.70, 0.88),
        "eye_y": r.uniform(0.40, 0.47),       # fraction of face height
        "eye_dx": r.uniform(0.20, 0.27),      # half-spacing, fraction face w
        "eye_w": r.uniform(0.065, 0.105),
        "eye_h_ratio": r.uniform(0.45, 0.75),
        "eye_dark": r.uniform(20, 70),
        "brow_dy": r.uniform(0.065, 0.11),
        "brow_th": r.uniform(0.018, 0.042),
        "brow_dark": r.uniform(25, 85),
        "brow_tilt": r.uniform(-0.12, 0.12),
        "nose_len": r.uniform(0.16, 0.24),
        "nose_w": r.uniform(0.045, 0.08),
        "mouth_y": r.uniform(0.70, 0.78),
        "mouth_w": r.uniform(0.16, 0.26),
        "mouth_h": r.uniform(0.02, 0.045),
        "mouth_dark": r.uniform(30, 90),
        "mouth_curve": r.uniform(-0.25, 0.35),
        "hair": r.rand() < 0.8,
        "hair_dark": r.uniform(15, 90),
        "hair_drop": r.uniform(0.10, 0.22),   # how far hair covers forehead
        "light_dir": r.uniform(-1.0, 1.0),    # lateral lighting component
        "light_amp": r.uniform(0.08, 0.30),
        "cheek_shade": r.uniform(0.05, 0.20),
    }


def _ellipse(yy, xx, cy, cx, ry, rx):
    return ((yy - cy) / max(ry, 1e-6)) ** 2 + ((xx - cx) / max(rx, 1e-6)) ** 2


def render_face(identity: int, size: int = FACE_CANVAS):
    """Render one identity. Returns (img [size,size] float32 0..255,
    bbox [l,t,r,b] of the face in pixels)."""
    p = sample_identity(identity)
    S = size * _SS
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float32) / S  # in [0,1)
    img = np.zeros((S, S), dtype=np.float32)

    cx, cy = 0.5, 0.52
    rw, rh = p["face_w"] / 2, p["face_h"] / 2
    face = _ellipse(yy, xx, cy, cx, rh, rw) <= 1.0

    # Shaded skin: directional light + darker cheeks/boundary.
    d = _ellipse(yy, xx, cy, cx, rh, rw)
    shade = 1.0 - p["cheek_shade"] * np.clip(d, 0, 1)
    shade *= 1.0 + p["light_amp"] * (p["light_dir"] * (xx - cx) - (yy - cy))
    img[face] = (p["skin"] * shade)[face]

    def paint(mask, value):
        img[face & mask] = value

    # Hair cap.
    if p["hair"]:
        hair_line = cy - rh + p["hair_drop"] * 2 * rh
        paint(yy < hair_line, p["hair_dark"])

    ey = cy - rh + p["eye_y"] * 2 * rh
    for sgn in (-1, 1):
        ex = cx + sgn * p["eye_dx"] * 2 * rw
        # Brow: tilted dark bar above the eye.
        by = ey - p["brow_dy"]
        tilt = sgn * p["brow_tilt"]
        bar = (np.abs((yy - by) - tilt * (xx - ex)) < p["brow_th"]) & \
              (np.abs(xx - ex) < p["eye_w"] * 1.5) & \
              (sgn * (xx - cx) > 0.015)  # stay on this eye's side
        paint(bar, p["brow_dark"])
        # Eye: dark ellipse with a brighter sclera ring.
        e_out = _ellipse(yy, xx, ey, ex, p["eye_w"] * p["eye_h_ratio"],
                         p["eye_w"])
        paint(e_out <= 1.0, 235.0)
        paint(e_out <= 0.45, p["eye_dark"])

    # Nose: subtle vertical shading wedge + nostrils.
    ny0, ny1 = ey + 0.02, ey + p["nose_len"]
    wedge = ((yy > ny0) & (yy < ny1)
             & (np.abs(xx - cx) < p["nose_w"] * (yy - ny0) / (ny1 - ny0)))
    img[face & wedge] *= 0.88
    for sgn in (-1, 1):
        paint(_ellipse(yy, xx, ny1, cx + sgn * p["nose_w"] * 0.7,
                       0.012, 0.016) <= 1.0, 60.0)

    # Mouth: dark rounded bar with curvature.
    my = cy - rh + p["mouth_y"] * 2 * rh
    rel = (xx - cx) / max(p["mouth_w"], 1e-6)
    curve = p["mouth_curve"] * 0.03 * (rel ** 2)
    bar = (np.abs(yy - my - curve) < p["mouth_h"]) & (np.abs(rel) < 1.0)
    paint(bar, p["mouth_dark"])

    # Downsample (box) for antialiasing.
    img = img.reshape(size, _SS, size, _SS).mean(axis=(1, 3))
    bbox = [int((cx - rw) * size), int((cy - rh) * size),
            int((cx + rw) * size), int((cy + rh) * size)]
    return img.astype(np.float32), bbox


def landmarks68(identity: int, size: int = FACE_CANVAS):
    """Analytic ibug-68 landmarks for :func:`render_face`'s geometry.

    The reference aligns faces with dlib's 68-point shape predictor
    (reference: cufacesearch/cufacesearch/featurizer/dlib_featurizer.py:
    50-105); its training set is annotated photos. Here the renderer IS
    the annotation: every landmark position is a closed-form function of
    the identity parameters, so 68-point training data is exact and free.
    Ordering follows the ibug convention (0-16 jaw, 17-26 brows, 27-35
    nose, 36-47 eyes, 48-67 lips); coordinates are (x, y) pixels on the
    ``size`` x ``size`` canvas, matching ``render_face(identity, size)``.
    """
    p = sample_identity(identity)
    cx, cy = 0.5, 0.52
    rw, rh = p["face_w"] / 2, p["face_h"] / 2
    ey = cy - rh + p["eye_y"] * 2 * rh
    pts = np.zeros((68, 2), dtype=np.float64)

    # 0-16 jaw: along the face ellipse from eye level (left), through the
    # chin, back up to eye level (right). Ellipse param: x = cx + rw sin t,
    # y = cy + rh cos t; t = 0 is the chin bottom.
    t_eye = np.arccos(np.clip((ey - cy) / rh, -1.0, 1.0))
    ts = np.linspace(-t_eye, t_eye, 17)
    pts[0:17, 0] = cx + rw * np.sin(ts)
    pts[0:17, 1] = cy + rh * np.cos(ts)

    # 17-26 brows: 5 points along each tilted brow bar (centerline
    # y = by + tilt (x - ex); bar half-span 1.5 eye_w).
    by_off = p["brow_dy"]
    for sgn, sl in ((-1, slice(17, 22)), (1, slice(22, 27))):
        ex = cx + sgn * p["eye_dx"] * 2 * rw
        xs = ex + np.linspace(-1.2, 1.2, 5) * p["eye_w"]
        pts[sl, 0] = xs
        pts[sl, 1] = (ey - by_off) + sgn * p["brow_tilt"] * (xs - ex)

    # 27-30 nose bridge (top -> tip), 31-35 nose base with nostrils at
    # cx +- 0.7 nose_w (the renderer's nostril dot centers).
    ny0, ny1 = ey + 0.02, ey + p["nose_len"]
    pts[27:31, 0] = cx
    pts[27:31, 1] = np.linspace(ny0, ny1, 4)
    pts[31:36, 0] = cx + np.linspace(-0.7, 0.7, 5) * p["nose_w"]
    pts[31:36, 1] = ny1

    # 36-47 eyes: 6 points on each sclera ellipse (rx = eye_w,
    # ry = eye_w * eye_h_ratio). ibug runs leftmost corner, 2 top,
    # rightmost corner, 2 bottom for both eyes in image coords.
    rx, ry = p["eye_w"], p["eye_w"] * p["eye_h_ratio"]
    angles = np.deg2rad([180.0, 135.0, 45.0, 0.0, -45.0, -135.0])
    for sgn, sl in ((-1, slice(36, 42)), (1, slice(42, 48))):
        ex = cx + sgn * p["eye_dx"] * 2 * rw
        pts[sl, 0] = ex + rx * np.cos(angles)
        pts[sl, 1] = ey - ry * np.sin(angles)

    # 48-67 lips around the mouth bar: centerline y = my + curve(rel),
    # rel = (x - cx)/mouth_w, curve = mouth_curve * 0.03 * rel^2; outer
    # lip extends mouth_h above/below, inner lip half that.
    my, mw, mh = (cy - rh + p["mouth_y"] * 2 * rh), p["mouth_w"], p["mouth_h"]

    def lip(rel, v_sign, depth):
        x = cx + rel * mw
        y = my + p["mouth_curve"] * 0.03 * rel ** 2 \
            + v_sign * depth * np.sqrt(np.maximum(1.0 - rel ** 2, 0.0))
        return x, y

    rel_top = np.linspace(-1.0, 1.0, 7)          # 48..54
    xs, ys = lip(rel_top, -1.0, mh)
    pts[48:55, 0], pts[48:55, 1] = xs, ys
    rel_bot = np.linspace(1.0, -1.0, 7)[1:-1]    # 55..59 (right -> left)
    xs, ys = lip(rel_bot, 1.0, mh)
    pts[55:60, 0], pts[55:60, 1] = xs, ys
    rel_itop = np.linspace(-1.0, 1.0, 5)         # 60..64
    xs, ys = lip(rel_itop, -1.0, mh * 0.5)
    pts[60:65, 0], pts[60:65, 1] = xs, ys
    rel_ibot = np.linspace(1.0, -1.0, 5)[1:-1]   # 65..67
    xs, ys = lip(rel_ibot, 1.0, mh * 0.5)
    pts[65:68, 0], pts[65:68, 1] = xs, ys

    return (pts * size).astype(np.float32)


# --------------------------------------------------------------- negatives

def render_hard_negative(kind: int, seed: int, size: int = FACE_CANVAS):
    """Face-free patches that share low-order statistics with faces."""
    r = np.random.RandomState((0xBAD ^ (seed * 40503 + kind)) % (1 << 31))
    S = size
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float32) / S
    kind = kind % 6
    if kind == 5:  # flat / near-flat patch: pins the template's bias so
        #            zero-gradient windows score below threshold
        img = np.full((S, S), r.uniform(0, 255), np.float32)
        if r.rand() < 0.5:
            img += r.uniform(-4, 4) * yy + r.uniform(-4, 4) * xx \
                + r.normal(0, 1.0, (S, S))
    elif kind == 0:  # featureless shaded ellipse (blob control)
        img = np.full((S, S), r.uniform(60, 200), np.float32)
        m = _ellipse(yy, xx, 0.5, 0.5, r.uniform(0.3, 0.45),
                     r.uniform(0.25, 0.4)) <= 1.0
        img[m] = r.uniform(100, 220) * (1 - 0.2 * yy[m])
    elif kind == 1:  # clock-like disc: circle + radial bars
        img = np.full((S, S), r.uniform(40, 120), np.float32)
        d = _ellipse(yy, xx, 0.5, 0.5, 0.38, 0.38)
        img[d <= 1.0] = 210.0
        ang = np.arctan2(yy - 0.5, xx - 0.5)
        for a in r.uniform(-np.pi, np.pi, 3):
            img[(d <= 0.9) & (np.abs(np.sin(ang - a)) < 0.05)] = 50.0
    elif kind == 2:  # stripe / checker texture
        f = r.uniform(4, 18)
        ph = r.uniform(0, np.pi)
        img = 120 + 90 * np.sin(2 * np.pi * f * (xx + r.uniform(-1, 1) * yy)
                                + ph)
    elif kind == 3:  # smooth random blobs (low-pass noise)
        n = r.randn(S // 8 + 1, S // 8 + 1)
        img = np.kron(n, np.ones((8, 8)))[:S, :S]
        img = 128 + 64 * (img / (np.abs(img).max() + 1e-6))
    else:  # window/door: rectangles with internal crossbars
        img = np.full((S, S), r.uniform(90, 180), np.float32)
        x0, y0 = r.uniform(0.15, 0.3, 2)
        x1, y1 = r.uniform(0.7, 0.85, 2)
        m = (xx > x0) & (xx < x1) & (yy > y0) & (yy < y1)
        img[m] = 230.0
        img[m & (np.abs(xx - (x0 + x1) / 2) < 0.02)] = 60.0
        img[m & (np.abs(yy - (y0 + y1) / 2) < 0.02)] = 60.0
    return np.clip(img, 0, 255).astype(np.float32)


def _background(rng, h, w):
    """Cluttered grayscale background: gradient + low-pass noise + stripes."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    g = rng.uniform(60, 180) + rng.uniform(-40, 40) * yy / h \
        + rng.uniform(-40, 40) * xx / w
    n = rng.randn(h // 16 + 1, w // 16 + 1)
    g = g + 25 * np.kron(n, np.ones((16, 16)))[:h, :w]
    if rng.rand() < 0.5:
        f = rng.uniform(2, 8)
        g = g + 18 * np.sin(2 * np.pi * f * xx / w + rng.uniform(0, 6))
    return np.clip(g, 0, 255).astype(np.float32)


def make_scene(scene_seed: int, identities, h: int = 480, w: int = 640,
               n_faces=None, n_distractors=3, min_face=90, max_face=220):
    """Composite faces from ``identities`` into a cluttered scene.

    Returns (img [h,w] float32, gt_boxes list of [l,t,r,b]). Faces are
    non-overlapping, pasted with a soft elliptical matte so the head-to-
    background boundary is the face's own contour, not a square seam.
    """
    from PIL import Image

    rng = np.random.RandomState((0x5CE9E ^ (scene_seed * 7919)) % (1 << 31))
    img = _background(rng, h, w)
    if n_faces is None:
        n_faces = rng.randint(1, 4)

    # Distractors first (so faces can occlude them, never vice versa).
    for k in range(n_distractors):
        s = rng.randint(70, 180)
        patch = render_hard_negative(rng.randint(5), rng.randint(1 << 30),
                                     size=s)
        y0 = rng.randint(0, h - s)
        x0 = rng.randint(0, w - s)
        a = rng.uniform(0.7, 1.0)
        img[y0:y0 + s, x0:x0 + s] = (
            a * patch + (1 - a) * img[y0:y0 + s, x0:x0 + s])

    gt = []
    occupied = []
    ids = list(identities)
    rng.shuffle(ids)
    for identity in ids[:n_faces]:
        face, fb = render_face(identity)
        size = rng.randint(min_face, max_face + 1)
        pil = Image.fromarray(face)
        if rng.rand() < 0.5:
            pil = pil.rotate(rng.uniform(-8, 8), resample=Image.BILINEAR,
                             fillcolor=float(np.median(face)))
        face_s = np.asarray(pil.resize((size, size), Image.BILINEAR),
                            dtype=np.float32)
        scale = size / float(FACE_CANVAS)
        bb = [int(round(v * scale)) for v in fb]
        for _ in range(40):
            y0 = rng.randint(0, h - size)
            x0 = rng.randint(0, w - size)
            box = [x0 + bb[0], y0 + bb[1], x0 + bb[2], y0 + bb[3]]
            if all(_iou(box, o) < 0.05 for o in occupied):
                break
        else:
            continue
        # Soft elliptical matte that hugs the head contour from the inside
        # (anything wider would leak the renderer's black canvas as a halo).
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
        d = _ellipse(yy, xx, (bb[1] + bb[3]) / 2 / size,
                     (bb[0] + bb[2]) / 2 / size,
                     (bb[3] - bb[1]) / 2 / size,
                     (bb[2] - bb[0]) / 2 / size)
        matte = np.clip((1.0 - d) / 0.08, 0, 1)
        reg = img[y0:y0 + size, x0:x0 + size]
        img[y0:y0 + size, x0:x0 + size] = matte * face_s + (1 - matte) * reg
        occupied.append(box)
        gt.append(box)

    return np.clip(img, 0, 255).astype(np.float32), gt


def _iou(a, b):
    ix = max(0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = ((a[2] - a[0]) * (a[3] - a[1])
          + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / max(ua, 1e-9)
