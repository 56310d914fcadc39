"""PR-curve evaluation of the conv-HOG face detector on REAL-IMAGE
composites, on the card (port of scripts/eval_face_real_composite.py:
1-222): no procedural renderer anywhere in the eval data.

Scenes are built entirely from the bundled portrait
(tests/data/grace_hopper.jpg):
- positives: the real face region pasted (feather-blended) at varied
  scales (window 50..160 px), small rotations, and partial occlusions,
  onto mosaics of real NON-face crops of the same photo;
- negatives: mosaic-only scenes (real fabric/background/insignia
  texture): any detection there is a false positive.

This is one identity, labeled as such in the artifact. The default
template trains on this portrait's crops (``train_face_template`` adds
the bundled annotations unless ``--synth-only``), so with it this
measures the training identity's operating point; pass ``--template
<synth-only .npz>`` for the held-out-identity number.

Usage:
    python -m columbiaimagesearch_tpu_torch.models.eval_face_real_composite \\
        [--template T.npz] [--out FILE] [--cpu]

The result has the schema of ``benchmarks/r05_face_real_composite_eval
.json``. The detector runs on the first card (no card: raises) unless
``--cpu``.
"""

import argparse
import sys

import numpy as np

from columbiaimagesearch_tpu_torch.models.eval_face_detector import (
    GRACE,
    GRACE_BBOX,
    evaluate,
    iou,
    load_detector,
    operating_point,
    pr_curve,
    thin_curve,
    write_result,
)


def _bg_patch(rng, gray, face_keepout, h, w):
    """Random non-face crop of the photo (reflected for variety)."""
    H, W = gray.shape
    for _ in range(100):
        y = rng.randint(0, max(H - h, 1))
        x = rng.randint(0, max(W - w, 1))
        box = (x, y, x + w, y + h)
        if iou(box, face_keepout) < 0.02:
            p = gray[y:y + h, x:x + w].copy()
            if rng.rand() < 0.5:
                p = p[:, ::-1]
            if rng.rand() < 0.5:
                p = p[::-1, :]
            return p
    return gray[:h, :w].copy()


def _mosaic(rng, gray, face_keepout, H=360, W=480, tile=120):
    """Background scene: a grid of real non-face crops."""
    out = np.zeros((H, W), np.float32)
    for y in range(0, H, tile):
        for x in range(0, W, tile):
            h = min(tile, H - y)
            w = min(tile, W - x)
            out[y:y + h, x:x + w] = _bg_patch(rng, gray, face_keepout, h, w)
    return out


def _paste_face(rng, scene, face, size, occlude_frac, gray, face_keepout):
    """Feather-blend the real face into the scene at a random position;
    returns the ground-truth box."""
    from PIL import Image

    H, W = scene.shape
    ang = rng.uniform(-10, 10)
    chip = Image.fromarray(face.astype(np.uint8)).resize(
        (size, size), Image.BILINEAR).rotate(ang, Image.BILINEAR)
    chip = np.asarray(chip, np.float32)
    y = rng.randint(0, H - size)
    x = rng.randint(0, W - size)
    # Feathered alpha so the detector cannot cue on paste borders.
    ramp = np.minimum(np.arange(size) + 1, size - np.arange(size))
    feather = np.minimum(ramp[:, None], ramp[None, :]) / (0.12 * size)
    alpha = np.clip(feather, 0.0, 1.0)
    region = scene[y:y + size, x:x + size]
    scene[y:y + size, x:x + size] = alpha * chip + (1 - alpha) * region
    if occlude_frac > 0:
        oh = int(size * occlude_frac)
        ow = int(size * rng.uniform(0.3, 0.9))
        oy = y + rng.randint(0, size - oh)
        ox = x + rng.randint(0, size - ow)
        scene[oy:oy + oh, ox:ox + ow] = _bg_patch(
            rng, gray, face_keepout, oh, ow)
    return [x, y, x + size, y + size]


def build_scenes(n_pos=30, n_neg=15, seed=0):
    """``n_pos`` scenes with one or two pasted faces and ``n_neg``
    face-free mosaics: [(uint8 scene, ground-truth boxes)]."""
    from PIL import Image

    img = np.asarray(Image.open(GRACE).convert("L"), np.float32)
    l, t, r, b = GRACE_BBOX
    # Keep-out with margin so no "background" crop contains face parts.
    m = 40
    keepout = (l - m, t - m, r + m, b + m)
    face = img[t:b, l:r]
    side = min(face.shape)
    face = face[:side, :side]

    rng = np.random.RandomState(seed)
    specs = []
    sizes = [50, 80, 110, 140, 160]
    for i in range(n_pos):
        scene = _mosaic(rng, img, keepout)
        gt = []
        for _ in range(1 + (i % 2)):
            size = sizes[rng.randint(len(sizes))]
            occ = 0.0 if rng.rand() < 0.5 else rng.uniform(0.1, 0.25)
            gt.append(_paste_face(rng, scene, face, size, occ, img,
                                  keepout))
        specs.append((scene.astype(np.uint8), gt))
    for _ in range(n_neg):
        specs.append((_mosaic(rng, img, keepout).astype(np.uint8), []))
    return specs


def main(argv=None):
    """Evaluate; returns the result dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--pos-scenes", type=int, default=30)
    ap.add_argument("--neg-scenes", type=int, default=15)
    ap.add_argument("--iou", type=float, default=0.5)
    ap.add_argument("--up-sample", type=int, default=1,
                    help="pyramid up-sampling (1 reaches 50 px faces "
                         "with the 80 px window)")
    ap.add_argument("--template", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run the detector on the CPU (default: the first "
                         "card; raises without one)")
    args = ap.parse_args(argv)

    from columbiaimagesearch_tpu_torch.device import default_device

    det = load_detector(args.template, "cpu" if args.cpu
                        else default_device())
    specs = build_scenes(args.pos_scenes, args.neg_scenes)
    n_faces = sum(len(gt) for _, gt in specs)
    print(f"evaluating on {len(specs)} real-composite scenes "
          f"({n_faces} faces, {args.neg_scenes} negative-only)",
          file=sys.stderr)

    scores, tp, n_gt = evaluate(det, specs, iou_th=args.iou,
                                up_sample=args.up_sample)
    recall, precision, th, ap_v = pr_curve(scores, tp, n_gt)
    op_p, op_r = operating_point(recall, precision, th, det.threshold)

    result = {
        "metric": "face_detector_real_composite_ap",
        "value": round(ap_v, 4),
        "unit": f"AP@IoU{args.iou} (real-photo composites, no renderer)",
        "vs_baseline": None,
        "extra": {
            "n_scenes": len(specs),
            "n_faces": n_gt,
            "neg_only_scenes": args.neg_scenes,
            "identities": 1,
            # The default template trains on this portrait's crops too
            # (train_face_template synth mode, portrait_boost): only a
            # --synth-only template makes this a held-out-identity
            # measurement. Record which one this is.
            "template": args.template or ("shipped default (this "
                                          "portrait's crops ARE in its "
                                          "training set)"),
            "source": "tests/data/grace_hopper.jpg; positives pasted at "
                      "50-160 px with rotation and 0-25% occlusion on "
                      "real non-face mosaics",
            "operating_point": {"threshold": det.threshold,
                                "precision": round(op_p, 4),
                                "recall": round(op_r, 4)},
            "pr_curve_recall_precision_threshold": thin_curve(
                recall, precision, th),
        },
    }
    write_result(result, args.out)
    return result


if __name__ == "__main__":
    main()
