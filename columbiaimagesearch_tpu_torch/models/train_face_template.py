"""Train the conv-HOG face-detector template on the card from annotated
face images (port of scripts/train_face_template.py:1-403).

The reference ships dlib's pretrained HOG+SVM face detector (reference:
cufacesearch/detector/dlib_detector.py:10-35, auto-downloaded models in
featurizer/dlib_featurizer.py:1-47). Here the detector's linear template
is trained from annotated photos (jittered positive crops + low-overlap
negative crops, logistic regression on the card,
``ConvHOGFaceDetector.train``) and persisted with
``ConvHOGFaceDetector.save_template`` to the path the detector loads by
default (``$FACE_TEMPLATE``, else the port's
``models/weights/face_template.npz``), or to ``--out``.

Usage:
    python -m columbiaimagesearch_tpu_torch.models.train_face_template \\
        [--annotations faces.json] [--synth N] [--out path.npz] [--cpu]

``faces.json``: {"<image path>": [left, top, right, bottom], ...}.
Default: the bundled public-domain Grace Hopper portrait and its
annotation. The arguments and printed lines are the JAX script's; the
detector runs on the first card (no card: raises) unless ``--cpu``.
"""

import argparse
import importlib.util
import json
import os
import sys

import numpy as np

from columbiaimagesearch_tpu_torch.models.face_detector import WINDOW

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_ANNOTATIONS = {
    os.path.join(REPO, "tests", "data", "grace_hopper.jpg"):
        [175, 140, 360, 380],
}


def _gray(path):
    """An image file as a float32 grayscale array (the RGB mean)."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"),
                      dtype=np.float32).mean(axis=2)


def _window(a):
    """A grayscale patch resized to WINDOW x WINDOW (bilinear), float32."""
    from PIL import Image

    return np.asarray(Image.fromarray(a).resize((WINDOW, WINDOW),
                                                Image.BILINEAR),
                      dtype=np.float32)


def crops_for(img_gray, bbox, rng):
    """Jittered positive crops + low-overlap negative crops for one image
    (scripts/train_face_template.py:37-66)."""
    H, W = img_gray.shape
    l, t, r, b = bbox

    def crop(x0, y0, x1, y1):
        return _window(img_gray[max(y0, 0):min(y1, H), max(x0, 0):min(x1, W)])

    pos, neg = [], []
    for dx in (-12, 0, 12):
        for dy in (-12, 0, 12):
            for grow in (-15, 0, 15):
                pos.append(crop(l + dx - grow, t + dy - grow,
                                r + dx + grow, b + dy + grow))
    while len(neg) < 120:
        s = rng.randint(60, max(61, min(H, W) // 2))
        x0 = rng.randint(0, W - s)
        y0 = rng.randint(0, H - s)
        ix = max(0, min(x0 + s, r) - max(x0, l))
        iy = max(0, min(y0 + s, b) - max(y0, t))
        if ix * iy > 0.25 * s * s:
            continue
        neg.append(crop(x0, y0, x0 + s, y0 + s))
    return pos, neg


def augment_positives(pos, rng, per_crop=2):
    """Rotation/mirror/gamma variants of positive crops
    (scripts/train_face_template.py:69-93): the deployed detector must
    hold under small in-plane rotations and tone shifts."""
    from PIL import Image

    out = list(pos)
    for crop in pos:
        for _ in range(per_crop):
            img = crop
            kind = rng.randint(3)
            if kind == 0:
                ang = rng.choice([-1, 1]) * rng.uniform(4, 10)
                img = np.asarray(Image.fromarray(img).rotate(
                    ang, resample=Image.BILINEAR,
                    fillcolor=float(np.median(img))), dtype=np.float32)
            elif kind == 1:
                img = img[:, ::-1].copy()
            else:
                g = rng.choice([0.6, 1.5])
                img = (255.0 * (np.clip(img, 0, 255) / 255.0) ** g
                       ).astype(np.float32)
            out.append(img)
    return out


def synth_training_set(n_identities, rng):
    """Positive/negative crops from the procedural face set
    (``models/face_synth.py``; scripts/train_face_template.py:96-140):
    7 jittered head crops of each TRAIN identity, hard-negative patches,
    and 12 crops of each face-free scene."""
    from columbiaimagesearch_tpu_torch.models.face_synth import (
        make_scene,
        render_face,
        render_hard_negative,
    )

    pos, neg = [], []
    for ident in range(n_identities):
        img, (l, t, r, b) = render_face(ident)
        H, W = img.shape
        for dx, dy, grow in ((0, 0, 0), (-8, 0, 0), (8, 0, 0), (0, -8, 8),
                             (0, 8, -8), (0, 0, 14), (0, 0, -10)):
            x0, y0 = l + dx - grow, t + dy - grow
            x1, y1 = r + dx + grow, b + dy + grow
            pos.append(_window(img[max(y0, 0):min(y1, H),
                                   max(x0, 0):min(x1, W)]))
    for k in range(6):
        for s in range(3 * max(1, n_identities // 4)):
            neg.append(_window(render_hard_negative(k, s)))
    # Face-free scene crops (background + distractor statistics).
    for seed in range(max(2, n_identities // 8)):
        scene, _ = make_scene(900000 + seed, [], n_faces=0,
                              n_distractors=5)
        for _ in range(12):
            s = rng.randint(70, 220)
            y0 = rng.randint(0, scene.shape[0] - s)
            x0 = rng.randint(0, scene.shape[1] - s)
            neg.append(_window(scene[y0:y0 + s, x0:x0 + s]))
    return pos, neg


def _package_dir(name):
    """The directory of an installed package, or None (not imported)."""
    spec = importlib.util.find_spec(name)
    if spec is None or not spec.submodule_search_locations:
        return None
    return spec.submodule_search_locations[0]


def real_negative_corpus():
    """Face-free real photographs bundled with installed packages (pygame's
    documentation images, matplotlib's sample data), the negative-training
    corpus of scripts/train_face_template.py:143-169 located through the
    packages rather than a fixed site-packages path. DISJOINT from the
    negatives tests/test_face_real.py holds out (camera_rgb.jpg,
    intro_freedom.jpg, china.jpg, flower.jpg)."""
    paths = []
    pygame = _package_dir("pygame")
    if pygame:
        img = os.path.join(pygame, "docs", "generated", "_images")
        paths += [os.path.join(img, f) for f in (
            "camera_average.jpg", "camera_background.jpg",
            "camera_green.jpg", "camera_hsv.jpg", "camera_mask.jpg",
            "camera_thresh.jpg", "camera_thresholded.jpg",
            "camera_yuv.jpg", "intro_blade.jpg", "pygame_lofi.png",
            "pygame_logo.png")]
    mpl = _package_dir("matplotlib")
    if mpl:
        sample = os.path.join(mpl, "mpl-data", "sample_data")
        paths += [os.path.join(sample, f) for f in (
            "logo2.png", "Minduka_Present_Blue_Pack.png")]
    return paths


def real_negative_images():
    """Grayscale float arrays for every corpus photo present."""
    return [_gray(p) for p in real_negative_corpus() if os.path.exists(p)]


def random_crops(img, rng, n, lo=70, hi=240):
    """n random square crops of a grayscale image, resized to WINDOW."""
    H, W = img.shape
    out = []
    for _ in range(n):
        s = rng.randint(lo, min(hi, min(H, W)))
        y0 = rng.randint(0, H - s + 1)
        x0 = rng.randint(0, W - s + 1)
        out.append(_window(img[y0:y0 + s, x0:x0 + s]))
    return out


def _mine_image(det, img, per_img, mined):
    """Append det's top-scoring windows over one face-free image."""
    boxes, scores = det.run(img, up_sample=0)
    order = np.argsort(scores)[::-1][:per_img] if len(scores) else []
    for i in order:
        x0, y0, x1, y1 = [int(round(v)) for v in boxes[i]]
        x0, y0 = max(x0, 0), max(y0, 0)
        patch = img[y0:y1, x0:x1]
        if patch.size == 0:
            continue
        mined.append(_window(np.asarray(patch, dtype=np.uint8)))


def real_mosaic_negatives(n_scenes=12, seed0=5000):
    """Face-free mosaic scenes of real non-face crops of the bundled
    portrait(s) (scripts/train_face_template.py:216-239). Seeds are
    DISJOINT from the real-composite eval's scene stream
    (``eval_face_real_composite`` uses RandomState(0))."""
    from PIL import Image

    from columbiaimagesearch_tpu_torch.models.eval_face_real_composite import (
        _mosaic,
    )

    scenes = []
    for path, bbox in DEFAULT_ANNOTATIONS.items():
        gray = np.asarray(Image.open(path).convert("L"), np.float32)
        l, t, r, b = bbox
        m = 40
        keepout = (l - m, t - m, r + m, b + m)
        for i in range(n_scenes):
            rng = np.random.RandomState(seed0 + i)
            scenes.append(_mosaic(rng, gray, keepout))
    return scenes


def mine_hard_negatives(det, n_scenes, rng, per_scene=8, real_imgs=()):
    """Run the current template over face-free scenes and the real-photo
    negatives; return the top-scoring false positives as new negatives
    (scripts/train_face_template.py:242-257). ``rng`` is unused, as in
    the JAX script."""
    del rng
    from columbiaimagesearch_tpu_torch.models.face_synth import make_scene

    mined = []
    old_th = det.threshold
    det.threshold = -1.0
    try:
        for seed in range(n_scenes):
            scene, _ = make_scene(950000 + seed, [], n_faces=0,
                                  n_distractors=5)
            _mine_image(det, scene.astype(np.float32).mean(axis=2)
                        if scene.ndim == 3 else scene, per_scene, mined)
        for img in real_imgs:
            _mine_image(det, img, per_scene, mined)
    finally:
        det.threshold = old_th
    return mined


def main(argv=None):
    """Train and save a template; returns (the detector, the path)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--annotations", default=None,
                    help="JSON {image_path: [l, t, r, b]}")
    ap.add_argument("--synth", type=int, default=None, metavar="N",
                    help="train on N procedural identities "
                         "(models/face_synth.py) instead of annotated "
                         "photos; eval identities in "
                         "models/eval_face_detector.py start at N")
    ap.add_argument("--mine-rounds", type=int, default=2,
                    help="hard-negative mining rounds over face-free "
                         "scenes (synth mode)")
    ap.add_argument("--synth-only", action="store_true",
                    help="synth mode: exclude the bundled annotated "
                         "portrait(s) from training (pure-synthetic "
                         "template, for generalization studies)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--neg-weight", type=float, default=1.5,
                    help="extra weight on the negative class in the "
                         "balanced logistic loss (precision knob)")
    ap.add_argument("--portrait-boost", type=int, default=6,
                    help="synth mode: repeat factor for the bundled real "
                         "portrait's positive crops (recall-on-real knob)")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the first card; "
                         "raises without one)")
    args = ap.parse_args(argv)

    from columbiaimagesearch_tpu_torch.device import default_device
    from columbiaimagesearch_tpu_torch.models.face_detector import (
        ConvHOGFaceDetector,
    )

    device = "cpu" if args.cpu else default_device()
    rng = np.random.RandomState(0)
    if args.synth:
        pos, neg = synth_training_set(args.synth, rng)
        if not args.synth_only:
            # The bundled annotated portrait(s) join the positive pool,
            # repeated --portrait-boost times: its HOG statistics differ
            # from the procedural renders', and its few crops would
            # otherwise be swamped ~30:1 by synth positives.
            for path, bbox in DEFAULT_ANNOTATIONS.items():
                p, n = crops_for(_gray(path), bbox, rng)
                pos += p * args.portrait_boost
                neg += n
        pos = augment_positives(pos, rng)
        real_imgs = real_negative_images()
        for img in real_imgs:
            neg += random_crops(img, rng, n=24)
        # Deployment-domain hard negatives: mosaics of the portrait's own
        # non-face texture; they join both the base negative pool and the
        # mining image set.
        mosaics = real_mosaic_negatives()
        for img in mosaics:
            neg += random_crops(img, rng, n=16, lo=60, hi=200)
        real_imgs = list(real_imgs) + mosaics
        print(f"training on {len(pos)} positives / {len(neg)} negatives "
              f"from {args.synth} procedural identities"
              f"{'' if args.synth_only else ' + bundled portraits'}"
              f" + {len(real_imgs)} real face-free photos "
              "(rot/flip/gamma augmented, class-balanced)",
              file=sys.stderr)
        det = ConvHOGFaceDetector(threshold=0.0, device=device)
        det.train(pos, neg, steps=args.steps, neg_weight=args.neg_weight)
        for rnd in range(args.mine_rounds):
            mined = mine_hard_negatives(det, n_scenes=6, rng=rng,
                                        real_imgs=real_imgs)
            if not mined:
                break
            neg += mined
            print(f"mining round {rnd}: +{len(mined)} hard negatives "
                  f"({len(neg)} total)", file=sys.stderr)
            det.train(pos, neg, steps=args.steps,
                      neg_weight=args.neg_weight)
        # Zero-feature gate: a flat window's HOG is all-zero, so its score
        # is exactly the bias. It must sit below the shipped threshold
        # (0.5) with margin, or featureless regions fire.
        print(f"flat-window score (bias) = {det.bias:+.3f}",
              file=sys.stderr)
        if det.bias > 0.0:
            print("WARNING: bias > 0 — flat regions may fire at low "
                  "thresholds; increase --neg-weight", file=sys.stderr)
        out = det.save_template(args.out)
        print(f"saved template -> {out}", file=sys.stderr)
        return det, out

    if args.annotations:
        with open(args.annotations) as f:
            annotations = json.load(f)
    else:
        annotations = DEFAULT_ANNOTATIONS

    pos, neg = [], []
    for path, bbox in annotations.items():
        p, n = crops_for(_gray(path), bbox, rng)
        pos += p
        neg += n
    print(f"training on {len(pos)} positives / {len(neg)} negatives "
          f"from {len(annotations)} annotated images", file=sys.stderr)

    det = ConvHOGFaceDetector(threshold=0.0, device=device)
    det.train(pos, neg, steps=args.steps)
    out = det.save_template(args.out)
    print(f"saved template -> {out}", file=sys.stderr)

    # sanity: the trained template must localize each training face
    from PIL import Image

    from columbiaimagesearch_tpu_torch.models.eval_face_detector import iou

    det.threshold = 0.5
    for path, bbox in annotations.items():
        img = np.asarray(Image.open(path).convert("RGB"))
        boxes, _scores = det.run(img, up_sample=0)
        best = max((iou(bx, bbox) for bx in boxes), default=0.0)
        print(f"{os.path.basename(path)}: {len(boxes)} detections, "
              f"best IoU {best:.2f}", file=sys.stderr)
        if best < 0.4:
            raise SystemExit(f"template failed to localize face in {path}")
    return det, out


if __name__ == "__main__":
    main()
