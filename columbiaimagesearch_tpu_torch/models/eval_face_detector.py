"""PR-curve evaluation of the conv-HOG face detector on held-out scenes,
on the card (port of scripts/eval_face_detector.py:1-172).

Generalization evidence for the detector (reference contract:
cufacesearch/cufacesearch/detector/dlib_detector.py:10-35): the template
is trained on procedural identities ``0..train_n-1``
(``models/train_face_template.py --synth``), and evaluated here on
composited scenes whose faces come from DISJOINT identities
``train_n..train_n+eval_n`` with distractors and cluttered backgrounds
(``models/face_synth.py``), plus the bundled real portrait (never in synth
training).

Outputs one JSON line (and ``--out``, relative to the repository root):
average precision, the PR curve, the operating point at the shipped
threshold, and the real-photo IoU, in the schema of
``benchmarks/r04_face_detector_eval.json``.

Usage:
    python -m columbiaimagesearch_tpu_torch.models.eval_face_detector \\
        [--train-n 120] [--eval-n 40] [--scenes 40] [--template T.npz]
        [--out FILE] [--cpu]

The detector runs on the first card (no card: raises) unless ``--cpu``.
"""

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GRACE = os.path.join(REPO, "tests", "data", "grace_hopper.jpg")
GRACE_BBOX = [175, 140, 360, 380]


def iou(a, b):
    """Intersection over union of two [l, t, r, b] boxes."""
    ix = max(0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = ((a[2] - a[0]) * (a[3] - a[1])
          + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / max(ua, 1e-9)


def evaluate(det, scene_specs, iou_th=0.5, floor=-1.0, up_sample=0):
    """Greedy per-scene matching at a score floor; returns (scores,
    is_tp flags, total ground-truth count) for the PR curve
    (scripts/eval_face_detector.py:45-72). ``up_sample`` is the pyramid's
    (the JAX real-composite script sets it by patching ``run``)."""
    old_th = det.threshold
    det.threshold = floor
    all_scores, all_tp, n_gt = [], [], 0
    try:
        for scene, gt in scene_specs:
            boxes, scores = det.run(scene, up_sample=up_sample)
            n_gt += len(gt)
            order = np.argsort(scores)[::-1] if len(scores) else []
            taken = set()
            for i in order:
                best_j, best_iou = -1, iou_th
                for j, g in enumerate(gt):
                    if j in taken:
                        continue
                    v = iou(boxes[i], g)
                    if v >= best_iou:
                        best_j, best_iou = j, v
                if best_j >= 0:
                    taken.add(best_j)
                    all_tp.append(1)
                else:
                    all_tp.append(0)
                all_scores.append(float(scores[i]))
    finally:
        det.threshold = old_th
    return np.asarray(all_scores), np.asarray(all_tp), n_gt


def pr_curve(scores, tp, n_gt):
    """(recall, precision, thresholds, AP): AP is the precision envelope
    integrated over recall (scripts/eval_face_detector.py:75-88)."""
    order = np.argsort(scores)[::-1]
    tp_c = np.cumsum(tp[order])
    fp_c = np.cumsum(1 - tp[order])
    recall = tp_c / max(n_gt, 1)
    precision = tp_c / np.maximum(tp_c + fp_c, 1)
    ap = 0.0
    prev_r = 0.0
    for r, p in zip(recall, np.maximum.accumulate(precision[::-1])[::-1]):
        ap += (r - prev_r) * p
        prev_r = r
    return recall, precision, scores[order], float(ap)


def operating_point(recall, precision, th, threshold):
    """(precision, recall) at the shipped threshold."""
    mask = th >= threshold
    op_r = float(recall[mask][-1]) if mask.any() else 0.0
    op_p = float(precision[mask][-1]) if mask.any() else 1.0
    return op_p, op_r


def thin_curve(recall, precision, th):
    """Every k-th point of the curve (about 64), rounded as in the
    artifact."""
    k = max(1, len(recall) // 64)
    return [[round(float(r), 4), round(float(p), 4), round(float(t), 3)]
            for r, p, t in zip(recall[::k], precision[::k], th[::k])]


def load_detector(template, device):
    """The detector from a template npz, or the shipped one."""
    from columbiaimagesearch_tpu_torch.models.face_detector import (
        ConvHOGFaceDetector,
    )

    if template:
        with np.load(template) as z:
            return ConvHOGFaceDetector(template=z["template"],
                                       bias=float(z["bias"]), device=device)
    return ConvHOGFaceDetector(device=device)


def write_result(result, out):
    """Print the JSON line; write it to ``out`` (relative to the
    repository root) when given."""
    line = json.dumps(result)
    print(line, flush=True)
    if out:
        with open(os.path.join(REPO, out), "w") as f:
            f.write(line + "\n")
        print(f"wrote {out}", file=sys.stderr)


def main(argv=None):
    """Evaluate; returns the result dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-n", type=int, default=120,
                    help="identities the template was trained on "
                         "(eval pool starts after them)")
    ap.add_argument("--eval-n", type=int, default=40)
    ap.add_argument("--scenes", type=int, default=40)
    ap.add_argument("--iou", type=float, default=0.5)
    ap.add_argument("--template", default=None,
                    help="template npz (default: the shipped one)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run the detector on the CPU (default: the first "
                         "card; raises without one)")
    args = ap.parse_args(argv)

    from PIL import Image

    from columbiaimagesearch_tpu_torch.device import default_device
    from columbiaimagesearch_tpu_torch.models.face_synth import make_scene

    det = load_detector(args.template, "cpu" if args.cpu
                        else default_device())
    eval_ids = list(range(args.train_n, args.train_n + args.eval_n))
    specs = [make_scene(1000 + s, eval_ids) for s in range(args.scenes)]
    n_faces = sum(len(gt) for _, gt in specs)
    print(f"evaluating on {args.scenes} scenes / {n_faces} held-out faces "
          f"(identities {eval_ids[0]}..{eval_ids[-1]})", file=sys.stderr)

    scores, tp, n_gt = evaluate(det, specs, iou_th=args.iou)
    recall, precision, th, ap_v = pr_curve(scores, tp, n_gt)
    op_p, op_r = operating_point(recall, precision, th, det.threshold)

    # Real-photo check: the portrait was never in synthetic training.
    grace = np.asarray(Image.open(GRACE).convert("RGB"))
    gb, _gs = det.run(grace, up_sample=0)
    grace_iou = max((iou(b, GRACE_BBOX) for b in gb), default=0.0)

    result = {
        "metric": "face_detector_held_out_ap",
        "value": round(ap_v, 4),
        "unit": f"AP@IoU{args.iou} (identity-disjoint scenes)",
        "vs_baseline": None,
        "extra": {
            "n_scenes": args.scenes,
            "n_faces": n_gt,
            "train_identities": args.train_n,
            "eval_identities": [eval_ids[0], eval_ids[-1]],
            "operating_point": {"threshold": det.threshold,
                                "precision": round(op_p, 4),
                                "recall": round(op_r, 4)},
            "pr_curve_recall_precision_threshold": thin_curve(
                recall, precision, th),
            "real_photo_best_iou": round(float(grace_iou), 3),
            "real_photo_detections": len(gb),
        },
    }
    write_result(result, args.out)
    return result


if __name__ == "__main__":
    main()
