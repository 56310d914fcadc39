"""Offline index build on the card: feature files -> trained model +
persistent codes (port of scripts/build_index.py:1-93).

The role of the reference's Spark build-lopq-index workflow (vestigial in
the reference: lopq spark train_model/compute_codes linked from
lopq/lopq/model.py:914-917) as a single-machine job: load features
(.npy/.npz/.fvecs), train LOPQ (or LOPQ+PCA) on the card, encode every
row there, and persist the model (the storer) and the codes (the native
code store) for the searcher.

Usage:
  python -m columbiaimagesearch_tpu_torch.index.build_index \\
      --features feats.npy --out ./data \\
      --model-type lopq_pca --V 4096 --M 8 --pca-dims 256

The arguments and printed lines are the JAX script's; ``--cpu`` (not in
the JAX script, which runs wherever JAX does) trains and encodes on the
CPU, and without it the first card is used (no card: raises). The model
goes into ``LocalStorer(<out>/storer)`` under
``offline_<type>-V<V>-M<M>`` (a pickle of the port's model), the codes
into ``<out>/<model_str>.codes`` in the native code store's format, which
both packages read; ``LOPQSearcherTorch(model,
codestore_path=<out>/<model_str>.codes)`` serves them.
"""

import argparse
import os
import time

import numpy as np


def load_features(path):
    """[N, D] features from ``.npy``, the first array of an ``.npz``, or
    ``.fvecs`` (scripts/build_index.py:22-34)."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        with np.load(path) as d:
            return d[d.files[0]]
    if path.endswith(".fvecs"):
        from columbiaimagesearch_tpu_torch.utils.xvecs import load_xvecs

        return load_xvecs(path, "f")
    raise ValueError(f"unsupported feature file {path}")


def encode_rows(model, X):
    """Every row's cell (c0 * V + c1, uint32) and fine codes (uint8),
    encoded on the model's device."""
    coarse, fine = model.predict_batch(X)
    cells = coarse[:, 0].astype(np.uint32) * model.V + coarse[:, 1]
    return cells, fine.astype(np.uint8)


def write_codes(path, cells, fine, ids, lap=None):
    """Append the rows to the native code store at ``path`` (created if
    missing), sync and close it; ``lap(name)`` is called after the append
    and after the sync."""
    from columbiaimagesearch_tpu_torch.native.codestore import CodeStore

    lap = lap or (lambda name: None)
    cs = CodeStore(path, m=fine.shape[1])
    try:
        cs.append(cells, fine, ids)
        lap("append")
        cs.sync()
        lap("sync")
    finally:
        cs.close()


def main(argv=None):
    """Build the index; returns the model string, the codes path and the
    seconds of each stage (load, train, save, encode, append, sync)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--features", required=True)
    ap.add_argument("--ids", help="optional .txt with one id per row")
    ap.add_argument("--out", default="./data")
    ap.add_argument("--model-type", choices=["lopq", "lopq_pca"],
                    default="lopq")
    ap.add_argument("--V", type=int, default=256)
    ap.add_argument("--M", type=int, default=8)
    ap.add_argument("--subq", type=int, default=256)
    ap.add_argument("--pca-dims", type=int, default=256)
    ap.add_argument("--nb-train", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="train and encode on the CPU (default: the first "
                         "card; raises without one)")
    args = ap.parse_args(argv)

    import torch

    from columbiaimagesearch_tpu_torch.device import default_device
    from columbiaimagesearch_tpu_torch.index.model import (
        LOPQModel,
        LOPQModelPCA,
    )
    from columbiaimagesearch_tpu_torch.store.storer import LocalStorer

    dev = torch.device("cpu") if args.cpu else default_device()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    stages = {}
    last = [time.time()]

    def lap(name):
        sync()
        now = time.time()
        stages[name] = now - last[0]
        last[0] = now

    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    X = np.asarray(load_features(args.features), dtype=np.float32)
    if args.ids:
        with open(args.ids) as f:
            ids = f.read().split()
    else:
        ids = [str(i) for i in range(len(X))]
    lap("load")
    print(f"[{time.time()-t0:.1f}s] {X.shape[0]} features dim {X.shape[1]}")

    train = X[: args.nb_train]
    kw = dict(n_init=1, random_state=args.seed, V=args.V, M=args.M,
              subquantizer_clusters=args.subq, device=dev)
    if args.model_type == "lopq":
        model = LOPQModel.fit(train, **kw)
    else:
        model = LOPQModelPCA.fit(train, pca_dims=args.pca_dims, **kw)
    lap("train")
    print(f"[{time.time()-t0:.1f}s] trained {args.model_type}")

    storer = LocalStorer(os.path.join(args.out, "storer"))
    model_str = f"offline_{args.model_type}-V{args.V}-M{args.M}"
    storer.save(model_str, model)
    lap("save")

    cells, fine = encode_rows(model, X)
    lap("encode")
    codes = os.path.join(args.out, f"{model_str}.codes")
    write_codes(codes, cells, fine, ids, lap)
    print(f"[{time.time()-t0:.1f}s] encoded + persisted {len(X)} codes "
          f"-> {args.out}/{model_str}.codes")
    return dict(model_str=model_str, codes=codes, stages=stages)


if __name__ == "__main__":
    main()
