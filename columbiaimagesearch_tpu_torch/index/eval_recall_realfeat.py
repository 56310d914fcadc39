"""Recall on a realistic feature distribution, the extraction pipeline end
to end on the card (port of scripts/eval_recall_realfeat.py:1-216).

The synthetic-cluster harness (``index/eval_recall.py``) measures the
index on gaussian mixtures; production serves CNN activations: sparse,
non-negative, anisotropic. Here procedurally structured images are made
on the card (``utils/synthimg.py``: gratings, blobs, colour fields), fc7
comes from the Sentibank topology with randomly initialized weights
(``init_params(0)``: the pretrained caffemodel is not in the repository),
an ``LOPQModelPCA`` is fit in the release configuration's shape (pca 256,
M=8, S=256; reference: conf/conf_search_sbpycaffe_release.json:9-15), the
features are indexed, and recall@{1,10,100} of the probed searcher
(adaptive probe), the probed searcher with the device rerank (PCA space)
and with a host rerank in the raw space is measured against brute-force
ground truth in the raw normalized space, the reference's eval method
(reference: lopq/lopq/eval.py:92-142).

Usage: python -m columbiaimagesearch_tpu_torch.index.eval_recall_realfeat \\
           --n 200000 --queries 100 [--cpu] [--out FILE]

The arguments and the artifact's schema are the JAX script's; everything
runs on the first card (no card: raises) unless ``--cpu``. The images
come from a ``torch.Generator`` seeded 0 (another stream than JAX's
``PRNGKey(0)``), and the port's ``init_params(0)`` are other random
weights than JAX's, so the features, and the recalls, are the port's own.
The default artifact path is the JAX script's with ``_torch`` before
``.json``, so a run does not overwrite the JAX package's artifact.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from columbiaimagesearch_tpu_torch.device import default_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: neighbours kept a query by the ground truth
GT_K = 128


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv=None):
    """The JAX script's arguments (scripts/eval_recall_realfeat.py:
    39-53)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--train-n", type=int, default=100_000)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--V", type=int, default=1024)
    ap.add_argument("--M", type=int, default=8)
    ap.add_argument("--pca-dims", type=int, default=256)
    ap.add_argument("--quota", type=int, default=10_000)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the first card; "
                         "raises without one)")
    return ap.parse_args(argv)


def extract_features(n, batch, device, t0=None):
    """``n`` L2-normalized fc7 rows (host float32) of images rendered on
    ``device`` in waves of ``batch`` from a generator seeded 0, through
    the Sentibank topology with ``init_params(0)``."""
    from columbiaimagesearch_tpu_torch.models.sentibank import (
        SentibankFeaturizer,
        init_params,
    )
    from columbiaimagesearch_tpu_torch.utils.synthimg import (
        make_render_batch,
    )

    t0 = time.time() if t0 is None else t0
    fz = SentibankFeaturizer(params=init_params(0), device=device)
    render = make_render_batch(batch, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(0)
    parts = []
    done = 0
    while done < n:
        f, _ = fz.featurize_pixel_wave(render(g))
        # featsio convention: L2-normalize before store (featsio.py:13-22)
        f = f / torch.clamp(torch.linalg.vector_norm(f, dim=1, keepdim=True),
                            min=1e-30)
        parts.append(f.cpu().numpy())
        done += batch
        if done % (batch * 32) == 0:
            log(f"[{time.time()-t0:.0f}s] extracted {done}")
    return np.concatenate(parts)[:n]


def ground_truth(X, Q, device, chunk=1 << 18):
    """The ``GT_K`` nearest rows of each query in the raw space, fp32 on
    ``device`` a chunk at a time, merged with a stable sort
    (scripts/eval_recall_realfeat.py:111-134). Returns [nq, GT_K] int64."""
    qd = torch.from_numpy(Q).to(device)
    best_d = np.full((len(Q), GT_K), np.inf, np.float32)
    best_i = np.zeros((len(Q), GT_K), np.int64)
    for s0 in range(0, len(X), chunk):
        Xc = torch.from_numpy(X[s0:s0 + chunk]).to(device)
        d = (Xc * Xc).sum(dim=1)[None, :] - 2.0 * (qd @ Xc.T)
        dd, ii = torch.topk(d, min(GT_K, Xc.shape[0]), dim=1, largest=False,
                            sorted=True)
        alld = np.concatenate([best_d, dd.cpu().numpy()], axis=1)
        alli = np.concatenate([best_i, ii.cpu().numpy() + s0], axis=1)
        sel = np.argsort(alld, axis=1, kind="stable")[:, :GT_K]
        best_d = np.take_along_axis(alld, sel, axis=1)
        best_i = np.take_along_axis(alli, sel, axis=1)
    return best_i


def recall_row(method, answers, nns, **extra):
    """recall@{1,10,100} of ``answers`` against ``nns``."""
    hits = {1: 0, 10: 0, 100: 0}
    for qi, ids in enumerate(answers):
        for k in hits:
            if nns[qi] in ids[:k]:
                hits[k] += 1
    row = {"method": method,
           **{f"recall@{k}": hits[k] / len(answers) for k in hits}, **extra}
    log(json.dumps(row))
    return row


def run(args):
    """Every stage; returns (the artifact, the state: ``model``, ``X``,
    ``Q``, ``nns``)."""
    from columbiaimagesearch_tpu_torch.index.model import LOPQModelPCA
    from columbiaimagesearch_tpu_torch.index.searcher import (
        LOPQSearcherTorch,
    )

    device = torch.device("cpu") if args.cpu else default_device()
    t0 = time.time()
    log(f"device: {device}")
    F = extract_features(args.n + args.queries, args.batch, device, t0)
    X, Q = F[:args.n], F[args.n:args.n + args.queries]
    log(f"[{time.time()-t0:.0f}s] features: X {X.shape} "
        f"(sparsity {float((X == 0).mean()):.2f}) queries {Q.shape}")
    nns = ground_truth(X, Q, device)[:, 0]
    log(f"[{time.time()-t0:.0f}s] ground truth done")

    log(f"[{time.time()-t0:.0f}s] fitting lopq_pca pca{args.pca_dims} "
        f"V={args.V} M={args.M} on {args.train_n}")
    model = LOPQModelPCA.fit(X[:args.train_n], pca_dims=args.pca_dims,
                             n_init=1, random_state=0, V=args.V, M=args.M,
                             subquantizer_clusters=256, device=device)
    Xp = model.apply_PCA(X)
    coarse, fine = model.predict_batch(X)
    log(f"[{time.time()-t0:.0f}s] encoded; indexing")
    s = LOPQSearcherTorch(model)
    s.add_codes((coarse, fine), ids=list(range(args.n)), feats=Xp)
    del Xp

    runs = []

    def search(q, **kw):
        res, _ = s.search(q, quota=args.quota, with_dists=True, **kw)
        return [r.id for r in res]

    log(f"[{time.time()-t0:.0f}s] probed search (default adaptive probe)")
    runs.append(recall_row(
        f"probed_quota{args.quota}",
        [search(q, limit=100) for q in Q], nns, probe="adaptive"))

    log(f"[{time.time()-t0:.0f}s] probed + DEVICE rerank (PCA space)")
    runs.append(recall_row(
        f"probed_quota{args.quota}_device_rerank1000",
        [search(q, limit=1000, rerank_nb=1000)[:100] for q in Q], nns,
        probe="adaptive", rerank_space="pca"))

    log(f"[{time.time()-t0:.0f}s] probed + HOST rerank (raw space)")

    def probed_rerank_raw(q):
        cand = np.asarray(search(q, limit=1000))
        if not len(cand):
            return []
        exact = np.linalg.norm(X[cand] - q[None, :], axis=1)
        return cand[np.argsort(exact, kind="stable")][:100].tolist()

    runs.append(recall_row(
        f"probed_quota{args.quota}_raw_rerank1000",
        [probed_rerank_raw(q) for q in Q], nns, probe="adaptive",
        rerank_space="raw"))

    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    artifact = {
        "config": {
            "n": args.n, "queries": args.queries, "V": args.V,
            "M": args.M, "pca_dims": args.pca_dims, "quota": args.quota,
            "feature_source": "sentibank fc7, randomly initialized "
                              "(init_params(0) of the port) topology — "
                              "NOT pretrained weights (the caffemodel is "
                              "not in the repository); structured images "
                              "made on the device",
            "gt_space": "raw normalized 4096-d (reference eval.py method)",
            "device": device_name,
        },
        "runs": runs,
    }
    return artifact, dict(model=model, X=X, Q=Q, nns=nns)


def main(argv=None):
    """Run the evaluation and write its artifact; returns the artifact."""
    args = parse_args(argv)
    t0 = time.time()
    artifact, _state = run(args)
    path = args.out or os.path.join(
        REPO, "benchmarks",
        f"r03_recall_realfeat_{args.n // 1000}k_torch.json")
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
    log(f"[{time.time()-t0:.0f}s] wrote {path}")
    return artifact


if __name__ == "__main__":
    main()
