"""Face search end to end on the port: detect -> embed -> store -> query
(the port of tests/test_face_search_e2e.py at a tiny size, V=4, M=4).

The JAX pipeline's ``ExtractionProcessor`` is not ported, so the port's
``GenericExtractor("face", "face", input_type="face")`` writes the
KVIndexer rows through ``process_batch``. Scenes are ``face_synth``
renders the shipped detector template finds faces in, at a threshold of
2.0 (the template fires on ~10 windows of such a scene at its 0.5
default; the strong ones keep the CPU forwards short). The embedder runs
with seeded random weights (no trained face weights are in the repo).

- The JAX facade and the port's, on copies of one sqlite db and the same
  model, given the same detections and features, format the same output
  (distances allclose at rtol 1e-4, atol 1e-5: fp32 sums in another
  order).
- A coalesced face wave answers as sequential requests do; one face
  ``byB64`` request goes through ``make_server``.
- ``conf/conf_search_face_local.json`` builds through ``build_searcher(...,
  device="cpu")`` and answers a face query whose probe ladder climbs to
  its 256 x 256 rung.
"""

import base64
import copy
import io
import json
import os
import shutil
import threading
import urllib.request
from urllib.parse import urlencode

import numpy as np
import pytest
from PIL import Image

from columbiaimagesearch_tpu_torch.extraction.detector import FaceDetector
from columbiaimagesearch_tpu_torch.extraction.extractor import (
    GenericExtractor,
    build_extr_str,
)
from columbiaimagesearch_tpu_torch.extraction.featsio import featB64decode
from columbiaimagesearch_tpu_torch.imgio.imgio import get_SHA1_from_data
from columbiaimagesearch_tpu_torch.index.model import LOPQModel
from columbiaimagesearch_tpu_torch.models.face_detector import (
    ConvHOGFaceDetector,
)
from columbiaimagesearch_tpu_torch.models.face_synth import make_scene
from columbiaimagesearch_tpu_torch.searcher.searcher_lopq import SearcherLOPQ
from columbiaimagesearch_tpu_torch.store import KVIndexer, MemoryStorer

from tests.oracle_lopq import random_params
from tests.test_torch_facade import _params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXTR = build_extr_str("face", "face", "face")
V, M, S = 4, 4, 8
N_SCENES = 4
THRESHOLD = 2.0


class _Stub:
    """The JAX facade is handed the port's detections and features: it
    builds no detector or featurizer of its own."""


def _push(kv, cols, sha1s):
    rows = {sha1: dict(c, **{"info:s3_url": f"http://imgs/{sha1}.png"})
            for sha1, c in zip(sha1s, cols)}
    kv.push_dict_rows(rows, kv.table_sha1infos_name)
    update_id, _ = kv.get_next_update_id(extr_type=EXTR)
    kv.push_dict_rows({update_id: {kv.get_col_listsha1s(): ",".join(sha1s),
                                   kv.get_col_upcreate(): "now"}},
                      kv.table_updateinfos_name)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Scenes as PNG files, their rows in a sqlite db (written by the
    port's extractor), the extractor and the stored face features."""
    root = tmp_path_factory.mktemp("faces")
    paths, bufs = [], []
    for s in range(N_SCENES):
        gray, _ = make_scene(s, range(3 * s, 3 * s + 3), h=240, w=320,
                             max_face=150)
        p = str(root / f"scene_{s}.png")
        Image.fromarray(np.stack([gray.astype(np.uint8)] * 3, -1)).save(p)
        paths.append(p)
        with open(p, "rb") as f:
            bufs.append(f.read())
    sha1s = [get_SHA1_from_data(b) for b in bufs]
    detector = FaceDetector(ConvHOGFaceDetector(threshold=THRESHOLD,
                                                device="cpu"))
    extractor = GenericExtractor("face", "face", input_type="face",
                                 detector=detector, device="cpu")
    cols = extractor.process_batch([io.BytesIO(b) for b in bufs])
    db = str(root / "base.db")
    kv = KVIndexer(path=db)
    _push(kv, cols, sha1s)
    kv._shared.close()
    feats = np.stack([featB64decode(v, "face") for c in cols
                      for k, v in c.items() if k.count("_") > 4
                      and not k.endswith("_processed")])
    return dict(root=root, db=db, paths=paths, bufs=bufs, sha1s=sha1s,
                extractor=extractor, cols=cols, feats=feats)


def test_extractor_writes_bbox_columns(env):
    """One feature column per detected face, suffixed
    left_top_right_bottom_score, each a 128-d unit vector."""
    for c in env["cols"]:
        assert c[f"ext:{EXTR}_processed"] == "1"
        feat_cols = [k for k in c if k.startswith(f"ext:{EXTR}_")
                     and not k.endswith("_processed")]
        assert feat_cols
        assert all(len(k.split(f"{EXTR}_")[1].split("_")) == 5
                   for k in feat_cols)
    assert env["feats"].shape[1] == 128
    np.testing.assert_allclose(np.linalg.norm(env["feats"], axis=1), 1.0,
                               rtol=1e-5)


def _facades(env, tag, **kw):
    """(JAX facade, port facade) over copies of the db with one model."""
    from columbiaimagesearch_tpu.index.model import LOPQModel as JaxModel
    from columbiaimagesearch_tpu.searcher.searcher_lopq import (
        SearcherLOPQ as JaxSearcherLOPQ,
    )
    from columbiaimagesearch_tpu.store import (
        KVIndexer as JaxKVIndexer,
        MemoryStorer as JaxMemoryStorer,
    )

    params = _params(np.random.RandomState(4), env["feats"], V=V, M=M, S=S)
    base = dict(model_type="lopq", V=V, M=M, subquantizer_clusters=S,
                detector_type="face", featurizer_type="face",
                input_type="face", reranking=True, rerank_nb=50)
    base.update(kw)
    dbs = [str(env["root"] / f"{tag}_{w}.db") for w in ("jax", "port")]
    for d in dbs:
        shutil.copy(env["db"], d)
    js = JaxSearcherLOPQ(model=JaxModel(parameters=params), detector=_Stub(),
                         featurizer=_Stub(), indexer=JaxKVIndexer(path=dbs[0]),
                         storer=JaxMemoryStorer(), **base)
    ts = SearcherLOPQ(model=LOPQModel.from_numpy(*params, device="cpu"),
                      detector=env["extractor"].detector,
                      featurizer=env["extractor"].featurizer,
                      indexer=KVIndexer(path=dbs[1]), storer=MemoryStorer(),
                      device="cpu", **base)
    return js, ts


def _assert_same_output(want, got):
    """Face outputs equal, distances allclose (rtol 1e-4, atol 1e-5)."""
    want, got = copy.deepcopy(want), copy.deepcopy(got)
    for w, g in zip(want["AllSimilarFaces"], got["AllSimilarFaces"]):
        dw = w["SimilarFaces"].pop("Distances")
        dg = g["SimilarFaces"].pop("Distances")
        np.testing.assert_allclose(dg, dw, rtol=1e-4, atol=1e-5)
    assert got == want


def test_face_facade_matches_jax(env):
    js, ts = _facades(env, "parity")
    n_faces = len(env["feats"])
    assert ts.get_nb_indexed() == js.get_nb_indexed() == n_faces
    det, emb = env["extractor"].detector, env["extractor"].featurizer
    for qi in (1, 3):
        img = np.asarray(Image.open(env["paths"][qi]).convert("RGB"))
        boxes = det.detect_from_img(img)
        feats = list(emb.featurize_batch(img, boxes))
        dets = [(env["sha1s"][qi], boxes, None, "png", 320, 240)]
        opts = {"max_returned": 3}
        want = js.search_from_feats(dets, [feats], dict(opts))
        got = ts.search_from_feats(dets, [feats], dict(opts))
        _assert_same_output(want, got)
        # each detected face finds itself first (the same image and box)
        for j, entry in enumerate(got["AllSimilarFaces"]):
            block = entry["SimilarFaces"]
            assert block["ImageSha1s"][0] == env["sha1s"][qi]
            assert block["Distances"][0] < 1e-5
            assert block["Faces"][0] == {k: boxes[j][k] for k in
                                         ("left", "top", "right", "bottom")}


def test_face_coalesced_matches_sequential_and_http(env):
    """Concurrent byPATH queries through a coalescing facade answer as the
    sequential facade does (every (image, face) pair of the bundle rides
    one wave), and one face byB64 request goes through ``make_server``."""
    from columbiaimagesearch_tpu_torch.api.app import make_server

    targets = env["paths"][:3]
    _, seq = _facades(env, "seq")
    # Detection and embedding run in each caller's thread before the
    # submit, and take up to seconds on a loaded CPU: a wide window that
    # flushes as soon as all requests are in makes the wave coalesce.
    _, coal = _facades(env, "coal", coalesce_window_ms=10_000.0,
                       coalesce_max_batch=len(targets))
    opts = {"max_returned": 3}
    expected = {p: seq.search_image_path_list([p], dict(opts))
                for p in targets}
    results, errs = {}, []
    gate = threading.Event()

    def worker(p):
        gate.wait()
        try:
            results[p] = coal.search_image_path_list([p], dict(opts))
        except Exception as inst:  # noqa: BLE001 — reported below
            errs.append((p, inst))

    threads = [threading.Thread(target=worker, args=(p,)) for p in targets]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join(timeout=300)
    assert not errs, errs
    assert not any(t.is_alive() for t in threads)
    for p in targets:
        for g, w in zip(results[p]["AllSimilarFaces"],
                        expected[p]["AllSimilarFaces"]):
            assert g["SimilarFaces"]["ImageSha1s"] == \
                w["SimilarFaces"]["ImageSha1s"]
            assert g["SimilarFaces"]["Faces"] == w["SimilarFaces"]["Faces"]
            np.testing.assert_allclose(g["SimilarFaces"]["Distances"],
                                       w["SimilarFaces"]["Distances"],
                                       rtol=0, atol=1e-6)
    assert max(coal.request_batcher.batch_sizes) > 1
    coal.request_batcher.close()

    server = make_server(seq, endpoint="cuimgsearch", port=0,
                         host="127.0.0.1")
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        body = urlencode({"data": base64.b64encode(env["bufs"][2]).decode(),
                          "options": json.dumps(opts)}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/cuimgsearch/byB64", data=body,
            method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            reply = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
    assert reply["NumberFaces"] >= 1
    for entry in reply["AllSimilarFaces"]:
        assert entry["SimilarFaces"]["ImageSha1s"][0] == env["sha1s"][2]


def test_face_conf_builds_and_escalates_to_rung_256(env, tmp_path):
    """conf/conf_search_face_local.json as shipped (lopq, V=256, M=8,
    S=256, face detector and featurizer, reranking on), on the CPU: the
    model from the storer, 3000 rows at random cells through add_codes,
    the faces the facade's own detector and embedder extract from one
    scene through a KVIndexer update and load_codes. The
    index is below the quota, so each query's region must hold every row:
    rung 64 and the strip rung (128, 8) fall short and the ladder climbs
    to the full 256 x 256 square."""
    from columbiaimagesearch_tpu_torch.common.factory import (
        build_indexer,
        build_searcher,
        build_storer,
    )

    with open(os.path.join(REPO, "conf", "conf_search_face_local.json")) as f:
        conf = json.load(f)
    conf["KVI_db_path"] = str(tmp_path / "faces.db")
    conf["ST_base_path"] = str(tmp_path / "storer")
    rng = np.random.RandomState(6)
    params = random_params(rng, V=256, M=8, S=256, D=128)
    model = LOPQModel.from_numpy(*params, device="cpu")
    build_storer(conf).save(f"{EXTR}_lopq-subq256-V256-M8", model)
    facade = build_searcher(conf, device="cpu")
    assert facade.searcher is not None and facade.reranking
    n = 3000
    facade.searcher.add_codes((rng.randint(0, 256, (n, 2)),
                               rng.randint(0, 256, (n, 8))))
    cols = GenericExtractor("face", "face", input_type="face",
                            detector=facade.detector,
                            featurizer=facade.featurizer).process_batch(
        [io.BytesIO(env["bufs"][3])])
    n_faces = sum(k.count("_") > 4 and not k.endswith("_processed")
                  for k in cols[0])
    _push(build_indexer(conf), cols, env["sha1s"][3:4])
    assert facade.load_codes() == n_faces
    assert facade.get_nb_indexed() == n + n_faces
    out = facade.search_image_path_list([env["paths"][3]],
                                        {"max_returned": 5})
    assert out["NumberFaces"] >= 1
    for entry in out["AllSimilarFaces"]:
        assert entry["SimilarFaces"]["ImageSha1s"][0] == env["sha1s"][3]
    start, frac_short, settled_at = \
        facade.searcher.probe_stats["wave_log"][-1][:3]
    assert (start, frac_short, settled_at) == (0, 1.0, 2)
    assert facade.searcher._probe_ladder()[settled_at] == 256
