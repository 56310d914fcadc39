"""Weights-drop readiness: convert pretrained weights and run the parity
gate on the card (port of scripts/drop_weights.py:1-292).

The reference auto-downloads its pretrained artifacts (DeepSentibank
caffemodel: featurizer/sbpycaffe_img_featurizer.py:1-6,57-67; dlib face
ResNet: featurizer/dlib_featurizer.py:1-47) and validates deployments by
re-computing a stored feature and checking the norm of the difference
(reference method: cufacesearch/tests/test_compare_sbcmdlinetf.py:1-40).
This is the command to run the moment a weights artifact is provisioned:

    # DeepSentibank (a caffe-blob npz exported with pycaffe -- keys
    # conv1..conv5, fc6, fc7, fc8-t, each a (W, b) pair as W+".w"/".b"
    # arrays -- or a torch state-dict .pt, or an already-converted flat npz)
    python -m columbiaimagesearch_tpu_torch.models.drop_weights \\
        --sentibank /path/sentibank_blobs.npz [--stored-feats stored.npz]

    # dlib face ResNet (npz with con0..con28 [out,in,kh,kw], affine<i>_g /
    # affine<i>_b pairs, fc [256,128])
    python -m columbiaimagesearch_tpu_torch.models.drop_weights \\
        --dlib-face /path/dlib_blobs.npz

    # end-to-end dry run with synthetic weights (no artifacts needed)
    python -m columbiaimagesearch_tpu_torch.models.drop_weights --dry-run

Steps per model: convert -> save to the conventional auto-load path (the
flat npz both packages read) -> recompute features on the bundled image
-> gate:
  * if --stored-feats gives a reference feature (key ``sentibank`` /
    ``dlib_face``), ||stored - recomputed|| below ``NORM_TOL``;
  * always: finiteness, non-zero norm, batch-vs-single consistency.
Exit code 0 = the drop is live and parity-gated. The featurizers run on
the first card (no card: raises) unless ``--cpu``; a failed gate raises
``GateError``.
"""

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SAMPLE_IMG = os.path.join(REPO, "tests", "data", "grace_hopper.jpg")
SAMPLE_BBOX = {"left": 175, "top": 140, "right": 360, "bottom": 380}
# The reference's de-facto pass bound: it prints the diff norm and treats
# ~0 as pass; stored features are L2-normalized (featsio.py:13-22), so 1e-3
# on a unit vector is far below any real-weight mismatch signature.
NORM_TOL = 1e-3


class GateError(RuntimeError):
    """A dropped artifact failed its gate."""


def log(msg):
    print(f"[drop_weights] {msg}", file=sys.stderr, flush=True)


def _gate(ok, msg):
    if not ok:
        raise GateError(msg)


# ------------------------------------------------------------- sentibank

def load_sentibank_any(path):
    """A caffe-blob npz, a flat converted npz, or a torch .pt -> the
    port's Sentibank state dict."""
    from columbiaimagesearch_tpu_torch.models.sentibank import (
        _CAFFE_LAYER_MAP,
        load_caffe_weights,
        load_torch_weights,
        load_weights_npz,
    )

    if path.endswith((".pt", ".pth")):
        import torch

        return load_torch_weights(torch.load(path, map_location="cpu",
                                             weights_only=True))
    with np.load(path) as z:
        files = set(z.files)
        converted = any("/" in f for f in files)
        if not converted and "conv1.w" in files:  # caffe blob export
            return load_caffe_weights({
                name: (z[f"{name}.w"], z[f"{name}.b"])
                for name in _CAFFE_LAYER_MAP})
        if not converted:
            raise SystemExit(
                f"unrecognized sentibank npz keys: {sorted(files)[:6]}...")
    return load_weights_npz(path)


def gate_sentibank(weights_path, stored_feats, device):
    """Convert, save to the auto-load path, recompute the sample image's
    fc7 on ``device`` and gate it."""
    from columbiaimagesearch_tpu_torch.extraction.featsio import (
        featB64decode,
    )
    from columbiaimagesearch_tpu_torch.models.sentibank import (
        SentibankFeaturizer,
        default_weights_path,
        save_weights_npz,
    )

    params = load_sentibank_any(weights_path)
    out = default_weights_path()
    save_weights_npz(params, out)
    log(f"sentibank: converted + saved -> {out}")

    fz = SentibankFeaturizer(device=device)   # auto-loads the dropped weights
    _gate(fz.pretrained, "featurizer did not pick up the dropped weights")
    with open(SAMPLE_IMG, "rb") as f:
        buf = f.read()
    feats, status = fz.featurize_buffers([buf])
    _gate(int(status[0]) == 0, f"sample image failed to decode: {status}")
    feat = feats[0]
    _gate(np.all(np.isfinite(feat)), "non-finite fc7")
    _gate(np.linalg.norm(feat) > 0, "zero fc7")
    batch, _ = fz.featurize_buffers([buf, buf, buf])
    _gate(np.allclose(batch[0], batch[2], atol=1e-3),
          "batch position changes the feature")

    if stored_feats is not None and "sentibank" in stored_feats:
        stored = stored_feats["sentibank"]
        if stored.dtype.kind in "SU":    # b64 cell exactly as HBase stores it
            stored = featB64decode(stored.item(), "sbpycaffe")
        rec = feat / max(np.linalg.norm(feat), 1e-12)
        diff = float(np.linalg.norm(stored.astype(np.float32) - rec))
        log(f"sentibank stored-vs-recomputed ||diff|| = {diff:.2e} "
            f"(reference method test_compare_sbcmdlinetf.py)")
        _gate(diff < NORM_TOL, f"sentibank parity FAILED: {diff}")
    else:
        log("sentibank: no stored feature provided; structural gate only")
    log("sentibank: GATE PASSED")
    return feat


# ------------------------------------------------------------- dlib face

def load_dlib_any(path):
    """A dlib blob npz or a converted npz -> the face ResNet's params
    (numpy)."""
    from columbiaimagesearch_tpu_torch.models.face_dlib import (
        BLOCKS,
        load_dlib_weights,
        load_params_npz,
    )

    with np.load(path) as z:
        files = set(z.files)
        if "stem/w" not in files and "con0" in files:   # dlib blob export
            blobs = {}
            for i in range(1 + 2 * len(BLOCKS)):
                blobs[f"con{i}"] = z[f"con{i}"]
                blobs[f"affine{i}"] = (z[f"affine{i}_g"], z[f"affine{i}_b"])
            blobs["fc"] = z["fc"]
            return load_dlib_weights(blobs)
        if "stem/w" not in files:                 # not a converted npz
            raise SystemExit(
                f"unrecognized dlib npz keys: {sorted(files)[:6]}...")
    return load_params_npz(path)


def gate_dlib(weights_path, stored_feats, device):
    """Convert, save to the auto-load path, recompute the sample face's
    embedding on ``device`` and gate it."""
    from PIL import Image

    from columbiaimagesearch_tpu_torch.models.face_dlib import (
        DlibExactFaceEmbedder,
        default_weights_path,
        save_params_npz,
    )

    params = load_dlib_any(weights_path)
    out = default_weights_path()
    save_params_npz(params, out)
    log(f"dlib face: converted + saved -> {out}")

    emb = DlibExactFaceEmbedder(device=device)   # auto-loads the drop
    _gate(emb.pretrained, "embedder did not pick up the dropped weights")
    img = np.asarray(Image.open(SAMPLE_IMG).convert("RGB"))
    feat = np.asarray(emb.featurize(img, SAMPLE_BBOX))
    _gate(feat.shape == (128,), f"embedding shape {feat.shape}")
    _gate(feat.dtype == np.float64,                # reference contract
          f"embedding dtype {feat.dtype}")
    _gate(np.all(np.isfinite(feat)) and np.linalg.norm(feat) > 0,
          "non-finite or zero embedding")

    if stored_feats is not None and "dlib_face" in stored_feats:
        stored = np.asarray(stored_feats["dlib_face"], dtype=np.float64)
        rec = feat / max(np.linalg.norm(feat), 1e-12)
        diff = float(np.linalg.norm(stored - rec))
        log(f"dlib stored-vs-recomputed ||diff|| = {diff:.2e}")
        _gate(diff < NORM_TOL, f"dlib parity FAILED: {diff}")
    else:
        log("dlib face: no stored feature provided; structural gate only")
    log("dlib face: GATE PASSED")
    return feat


# --------------------------------------------------------------- dry run

def write_dry_run_blobs(tmpdir, seed=0):
    """Random blob files in both drop formats, from the port's
    ``init_params(0)`` of each model (Sentibank weights perturbed by
    0.001 N(0, 1) from ``RandomState(seed)``). Returns their paths."""
    from columbiaimagesearch_tpu_torch.models import face_dlib, sentibank

    rng = np.random.RandomState(seed)
    sd = sentibank.init_params(seed=0)       # caffe layouts already
    blobs = {}
    for caffe_name, name in sentibank._CAFFE_LAYER_MAP.items():
        w = sd[f"{name}.weight"].numpy()
        blobs[f"{caffe_name}.w"] = w + 0.001 * rng.randn(*w.shape)
        blobs[f"{caffe_name}.b"] = sd[f"{name}.bias"].numpy()
    sb_path = os.path.join(tmpdir, "sentibank_blobs.npz")
    np.savez(sb_path, **blobs)

    dl = face_dlib.init_params(seed=0)

    def oihw(w):
        return np.transpose(np.asarray(w), (3, 2, 0, 1))

    dblobs = {"fc": np.asarray(dl["fc"]), "con0": oihw(dl["stem"]["w"]),
              "affine0_g": np.asarray(dl["stem"]["g"]),
              "affine0_b": np.asarray(dl["stem"]["b"])}
    ci = 1
    for blk in dl["blocks"]:
        for j, (wk, gk, bk) in enumerate((("w1", "g1", "b1"),
                                          ("w2", "g2", "b2"))):
            dblobs[f"con{ci + j}"] = oihw(blk[wk])
            dblobs[f"affine{ci + j}_g"] = np.asarray(blk[gk])
            dblobs[f"affine{ci + j}_b"] = np.asarray(blk[bk])
        ci += 2
    dl_path = os.path.join(tmpdir, "dlib_blobs.npz")
    np.savez(dl_path, **dblobs)
    return sb_path, dl_path


def dry_run(tmpdir, device):
    """Synthesize blob files in both drop formats and run the full
    convert->save->load->featurize->gate path, first structurally, then
    against self-recorded features (the machinery end to end without real
    artifacts). The auto-load paths point into ``tmpdir`` meanwhile and
    are restored after."""
    from columbiaimagesearch_tpu_torch.models import face_dlib, sentibank

    sb_path, dl_path = write_dry_run_blobs(tmpdir)
    saved = {k: os.environ.get(k)
             for k in (sentibank.WEIGHTS_ENV, face_dlib.WEIGHTS_ENV)}
    os.environ[sentibank.WEIGHTS_ENV] = os.path.join(tmpdir, "sb.npz")
    os.environ[face_dlib.WEIGHTS_ENV] = os.path.join(tmpdir, "dl.npz")
    try:
        feat = gate_sentibank(sb_path, None, device)
        dfeat = gate_dlib(dl_path, None, device)
        # Second pass WITH stored features (self-recorded): the parity
        # branch.
        stored_path = os.path.join(tmpdir, "stored.npz")
        np.savez(stored_path, sentibank=feat / np.linalg.norm(feat),
                 dlib_face=dfeat / np.linalg.norm(dfeat))
        with np.load(stored_path) as z:
            stored = dict(z)
        gate_sentibank(sb_path, stored, device)
        gate_dlib(dl_path, stored, device)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log("dry run: all gates exercised end-to-end")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sentibank", help="sentibank weights artifact")
    ap.add_argument("--dlib-face", help="dlib face-resnet weights artifact")
    ap.add_argument("--stored-feats",
                    help="npz with keys 'sentibank'/'dlib_face': features "
                         "your existing deployment stored for "
                         "tests/data/grace_hopper.jpg (L2-normalized)")
    ap.add_argument("--dry-run", action="store_true",
                    help="exercise the whole path with synthetic weights")
    ap.add_argument("--cpu", action="store_true",
                    help="run the featurizers on the CPU (default: the "
                         "first card; raises without one)")
    args = ap.parse_args(argv)

    from columbiaimagesearch_tpu_torch.device import default_device

    device = "cpu" if args.cpu else default_device()
    if args.dry_run:
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            dry_run(td, device)
        return
    if not args.sentibank and not args.dlib_face:
        raise SystemExit("nothing to do: pass --sentibank/--dlib-face "
                         "(or --dry-run)")
    stored = None
    if args.stored_feats:
        with np.load(args.stored_feats) as z:
            stored = dict(z)
    if args.sentibank:
        gate_sentibank(args.sentibank, stored, device)
    if args.dlib_face:
        gate_dlib(args.dlib_face, stored, device)


if __name__ == "__main__":
    main()
