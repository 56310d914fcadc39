"""The port runs without JAX: a fresh interpreter imports every module of
``columbiaimagesearch_tpu_torch``, answers tiny CPU searches (probed, PCA,
exhaustive, the raw-feature fast path, one ``SearcherLOPQ`` facade
search, a 2-shard ``ShardedLOPQSearcher``, the host ``LOPQSearcher`` and a
wide-V searcher), encodes with the cluster-blocked encoder and
dedups with ``dedup_first_mask``, trains tiny ``LOPQModel`` and ``LOPQModelPCA`` models and
evaluates one, writes and reads a ``.mat`` model, renders synthetic
images, runs the face embedder and the detector's device half, trains the
detector template and the landmark net a few steps, and never
loads ``jax``, ``flax``, the JAX package or pandas — nor PIL, which only
the image routes import, lazily. Then one checker + processor pass of the
ingest pipeline over three images on the CPU, the device-decode route on
three JPEGs, ``chip_smoke`` imported, a searcher backed by the native
code store, and the operator tools imported, with ``build_index`` and
``generate_conf`` run on the CPU, still without JAX or ``scripts``. ``chip_smoke.py`` imports nothing of JAX
in any function either (its source is parsed)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import os
import sys
import numpy as np
import torch

import columbiaimagesearch_tpu_torch
from columbiaimagesearch_tpu_torch.index import (csr, encode, eval,
                                                  exhaustive_adc, lut, model,
                                                  probe, query, searcher)
from columbiaimagesearch_tpu_torch.ops import (eigen_alloc, kmeans, pca,
                                               rotations)
from columbiaimagesearch_tpu_torch.utils import xvecs
from columbiaimagesearch_tpu_torch.kernels import build
from columbiaimagesearch_tpu_torch import (api, common, extraction, imgio,
                                           models, native, searcher as fac,
                                           store)
from columbiaimagesearch_tpu_torch.api import app, microbatch, run_search_api
from columbiaimagesearch_tpu_torch.common import factory
from columbiaimagesearch_tpu_torch.extraction import extractor
from columbiaimagesearch_tpu_torch.models import (face, face_align,
                                                   face_detector, face_dlib,
                                                   face_synth, layers,
                                                   preprocess, sentibank)
from columbiaimagesearch_tpu_torch.native import codestore, imgpipe
from columbiaimagesearch_tpu_torch.common import profiling
from columbiaimagesearch_tpu_torch import pipeline
from columbiaimagesearch_tpu_torch.pipeline import (bus_printer, cdr_ingester,
                                                    checker, downloader,
                                                    ingest, kafka_backend,
                                                    kinesis_backend,
                                                    processor, run_images_pusher,
                                                    run_processing)
from columbiaimagesearch_tpu_torch.searcher import (generic_searcher,
                                                    searcher_lopq)
from columbiaimagesearch_tpu_torch import parallel
from columbiaimagesearch_tpu_torch.parallel import mesh, sharded
from columbiaimagesearch_tpu_torch.index import multisequence, proto, protos
from columbiaimagesearch_tpu_torch.models import jpeg_device
from columbiaimagesearch_tpu_torch.utils import synthimg

rng = np.random.RandomState(0)
V, F, S, Dh = 8, 2, 16, 8
Rs = np.stack([np.stack([np.linalg.qr(rng.randn(Dh, Dh))[0]
                         for _ in range(V)]) for _ in range(2)])
m = model.LOPQModel(rng.randn(2, V, Dh), Rs, 0.1 * rng.randn(2, V, Dh),
                    rng.randn(2, F, S, Dh // F), device="cpu")
s = searcher.LOPQSearcherTorch(m)
X = rng.randn(500, 2 * Dh).astype(np.float32)
s.add_data(X, store_feats=True)
res, visited = s.search(X[7], quota=50, limit=5, with_dists=True,
                        rerank_nb=20)
assert res[0].id == 7 and res[0].dist == 0.0, res
P = np.linalg.qr(rng.randn(3 * Dh, 2 * Dh))[0]
pm = model.LOPQModelPCA(m.Cs, m.Rs, m.mus, m.subs, P, np.zeros(3 * Dh),
                        device="cpu")
ps = searcher.LOPQSearcherTorch(pm)
ps.add_data(X @ P.T, store_feats=True)
pres, _ = ps.search(X[7] @ P.T, quota=50, limit=5, with_dists=True,
                    rerank_nb=20)
assert pres[0].id == 7 and pres[0].dist < 1e-6, pres
ex = exhaustive_adc.ExhaustiveADCSearcher(m)
coarse, fine = m.predict_batch(X)
ex.add_codes_from_dict({i: (tuple(c), tuple(f))
                        for i, (c, f) in enumerate(zip(coarse, fine))})
eres, evisited = ex.search(X[7], quota=5, with_dists=True)
assert len(eres) == 5 and evisited == V * V, (eres, evisited)
fast = s.search_device_feats(torch.from_numpy(X[7:9]) * 3.0, quota=50,
                             limit=5, rerank_nb=20)
Xn = X[7:9] / np.linalg.norm(X[7:9], axis=1, keepdims=True)
host = s.search_batch(Xn, quota=50, limit=5, with_dists=True,
                      with_codes=False, rerank_nb=20)
assert [[r.id for r in q] for q, _ in fast] == \
    [[r.id for r in q] for q, _ in host], (fast, host)
kv = store.KVIndexer(path=":memory:")
facade = fac.SearcherLOPQ(model=m, model_type="lopq", V=V, M=2 * F,
                          subquantizer_clusters=S, featurizer=object(),
                          indexer=kv, storer=store.MemoryStorer(),
                          reranking=True, rerank_nb=20,
                          store_rerank_feats=True, device="cpu")
Xu = X / np.linalg.norm(X, axis=1, keepdims=True)
facade.searcher.add_codes(m.predict_batch(Xu),
                          [f"s{i}" for i in range(500)], feats=Xu)
out = facade.search_from_feats([("q", None)], [X[11]], {"max_returned": 3})
assert out["AllSimilarImages"][0]["SimilarImages"]["ImageSha1s"][0] == "s11"
tm = model.LOPQModel.fit(X, n_init=1, random_state=0, V=4, M=4,
                         subquantizer_clusters=8, device="cpu")
assert eval.get_subquantizer_distortion(X, tm).shape == (4,)
two = sharded.ShardedLOPQSearcher(
    m, mesh=mesh.make_mesh(axis=mesh.SHARD_AXIS, devices=["cpu", "cpu"]))
two.add_codes(m.predict_batch(X), feats=X)
sres, _ = two.search(X[7], quota=50, limit=5, with_dists=True,
                     rerank_nb=20)
assert sres[0].id == 7 and sres[0].dist == 0.0, sres
hres, _ = searcher.LOPQSearcher(m).search(X[7], quota=10)
tpm = model.LOPQModelPCA.fit(X @ P.T, pca_dims=2 * Dh, n_init=1,
                             random_state=0, V=4, M=4,
                             subquantizer_clusters=8, device="cpu")
assert tuple(tpm.pca_P.shape) == (3 * Dh, 2 * Dh)
emb = face.FaceEmbedder(device="cpu")
e = emb.featurize_chips(np.zeros((1, 150, 150, 3), np.uint8))
assert e.shape == (1, 128) and e.dtype == np.float64, e.shape
smaps = face_detector.ConvHOGFaceDetector(device="cpu").score_maps(
    [(np.zeros((96, 96), np.float32), 1.0, 1.0)])
assert smaps[0].shape == (3, 3), smaps[0].shape
wide = searcher.LOPQSearcherTorch(m)
wide.WIDE_V_THRESHOLD = V
wide.add_data(X, store_feats=True)
wres, _ = wide.search(X[7], quota=50, limit=5, with_dists=True, rerank_nb=20)
assert wide._dev["cell_start"] is None and wres[0].id == 7, wres
work0 = os.environ["NOJAX_TMP"]
m.export_mat(os.path.join(work0, "m.mat"))
back = model.LOPQModel.load_mat(os.path.join(work0, "m.mat"), device="cpu")
assert torch.equal(back.Rs, m.Rs)
bc, bf = encode.lopq_encode_blocked(m.Cs, m.Rs, m.mus, m.subs,
                                    torch.from_numpy(X), V,
                                    encode.blocks_needed(len(X), V))
pc, pf = m.predict_batch(X)
assert (bc.numpy() == pc).all() and (bf.numpy() == pf).all()
from columbiaimagesearch_tpu_torch.utils.codes import dedup_first_mask
assert dedup_first_mask([1, 1, 2], ["a", "a", "a"]).tolist() == [
    True, False, True]
imgs = synthimg.make_render_batch(2, height=48, width=64, device="cpu")(
    torch.Generator().manual_seed(0))
assert imgs.shape == (2, 48, 64, 3)
det = face_detector.ConvHOGFaceDetector(device="cpu")
det.train([np.full((80, 80), 100.0, np.float32)],
          [np.zeros((80, 80), np.float32)], steps=3)
lp, _ = face_align.train_landmark_net(
    face_align.init_landmark_params(0), np.zeros((2, 64, 64, 1), np.float32),
    np.full((2, 5, 2), 0.5, np.float32), steps=2, batch=2, device="cpu")
assert lut.build_luts.launches == 0
assert exhaustive_adc.adc_scan_all.launches == 0
bad = [k for k in sys.modules if k == "jax" or k.startswith("jax.")
       or k.split(".")[0] in ("flax", "pandas", "PIL")
       or k == "columbiaimagesearch_tpu"
       or k.startswith("columbiaimagesearch_tpu.")]
assert not bad, bad
import tempfile
from PIL import Image
work = tempfile.mkdtemp(dir=os.environ["NOJAX_TMP"])
os.makedirs(os.path.join(work, "imgs"))
for i in range(3):
    Image.fromarray(rng.randint(0, 255, (40, 50, 3)).astype(np.uint8)).save(
        os.path.join(work, "imgs", f"i{i}.png"))
conf = {"CHECK_input_dir": os.path.join(work, "imgs"),
        "CHECK_batch_update_size": 2, "PROC_nb_threads": 2,
        "KVI_db_path": os.path.join(work, "kv.db")}
kv = factory.build_indexer(conf)
created = factory.build_checker(conf, indexer=kv).run_once()
done = factory.build_processor(conf, indexer=kv, device="cpu").run_once()
assert len(created) == 2 and sorted(done) == sorted(created), (created, done)
sids, fts = kv.get_features_from_sha1s(
    [r for r, _ in kv.scan_from_row(kv.table_sha1infos_name)],
    "sentibank_feat_full_image")
assert len(sids) == 3 and fts[0].shape == (4096,)
import io
jpgs = []
for i in range(3):
    b = io.BytesIO()
    Image.fromarray(rng.randint(0, 255, (48, 64, 3)).astype(np.uint8)).save(
        b, "JPEG")
    jpgs.append(b.getvalue())
f = extractor.get_featurizer("sentibank", device="cpu")
fts, st = f.featurize_buffers(jpgs)
assert f.device_decode and f.route_counts["coeffs"] == 3 and list(st) == [0] * 3
import chip_smoke
cs = searcher.LOPQSearcherTorch(m, codestore_path=os.path.join(work, "c.cs"))
cs.add_data(X[:100])
cs._codestore.close()
assert searcher.LOPQSearcherTorch(
    m, codestore_path=os.path.join(work, "c.cs")).get_nb_indexed() == 100
from columbiaimagesearch_tpu_torch.common import generate_conf
from columbiaimagesearch_tpu_torch.index import (build_index, eval_recall,
                                                  eval_recall_realfeat)
from columbiaimagesearch_tpu_torch.models import (drop_weights,
                                                   eval_face_detector,
                                                   eval_face_real_composite,
                                                   train_face_template)
np.save(os.path.join(work, "f.npy"), X)
import contextlib
with contextlib.redirect_stdout(sys.stderr):   # its progress lines
    built = build_index.main(["--features", os.path.join(work, "f.npy"),
                              "--out", os.path.join(work, "bi"), "--V", "4",
                              "--M", "4", "--subq", "16", "--cpu"])
bm = store.LocalStorer(os.path.join(work, "bi", "storer")).load(
    built["model_str"])
bs = searcher.LOPQSearcherTorch(bm, codestore_path=built["codes"])
assert bs.get_nb_indexed() == 500 and bs.search(X[3], quota=50)[0]
os.environ["LOPQ_V"] = "256"
conf = generate_conf.main(["searcher", "-o", os.path.join(work, "c.json")])
assert '"SEARCHLOPQ_lopq_V": "256"' in open(conf).read()
bad = [k for k in sys.modules if k == "jax" or k.startswith("jax.")
       or k.split(".")[0] in ("flax", "pandas", "scripts")
       or k == "columbiaimagesearch_tpu"
       or k.startswith("columbiaimagesearch_tpu.")]
assert not bad, bad
print("ok", visited)
"""


def test_chip_smoke_imports_no_jax():
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert "columbiaimagesearch_tpu_torch" in {n.split(".")[0] for n in names}
    bad = [n for n in names if n.split(".")[0] in ("jax", "flax", "optax",
                                                   "columbiaimagesearch_tpu")]
    assert not bad, bad


def test_port_imports_and_searches_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, NOJAX_TMP=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")
