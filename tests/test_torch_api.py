"""The serving front end of the port (api/, the image routes of searcher/,
models/, native/) against the JAX package, and the micro-batching cases of
tests/test_microbatch.py on the port.

Both facades run DeepSentibank at full width on the same weights (the
port's seeded ``init_params``, carried to the JAX package through the
shared npz layout) over a ``lopq_pca`` model 4096 -> 32 with the rerank
store resident, the release configuration's shape. Responses must be
equal apart from ``Timing`` and uptime, with distances allclose at rtol
1e-4, atol 1e-5 (fc7 differs in the last float digits between the two
forwards).
"""

import base64
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from urllib.parse import urlencode

import numpy as np
import pytest
from PIL import Image

from columbiaimagesearch_tpu_torch.api.app import SearchAPI, make_server
from columbiaimagesearch_tpu_torch.api.microbatch import MicroBatcher
from columbiaimagesearch_tpu_torch.index.model import LOPQModelPCA
from columbiaimagesearch_tpu_torch.models.sentibank import (
    SentibankFeaturizer,
    init_params,
    save_weights_npz,
)
from columbiaimagesearch_tpu_torch.searcher.searcher_lopq import SearcherLOPQ
from columbiaimagesearch_tpu_torch.store import KVIndexer, MemoryStorer

from tests.test_torch_facade import _assert_outputs_equal, _fill, _pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------- unit


def test_batcher_coalesces_concurrent_submits():
    seen = []
    gate = threading.Event()

    def batch_fn(items):
        seen.append(list(items))
        return [x * 10 for x in items]

    b = MicroBatcher(batch_fn, max_batch=8, window_ms=80.0)
    try:
        results = {}

        def worker(x):
            gate.wait()
            results[x] = b.submit(x)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        gate.set()
        for t in threads:
            t.join(timeout=30)
        assert results == {i: i * 10 for i in range(6)}
        assert max(b.batch_sizes) > 1
        assert sum(b.batch_sizes) == 6
    finally:
        b.close()


def test_batcher_max_batch_respected():
    b = MicroBatcher(lambda items: items, max_batch=2, window_ms=200.0)
    try:
        out = []
        threads = [threading.Thread(target=lambda i=i: out.append(b.submit(i)))
                   for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert sorted(out) == [0, 1, 2, 3, 4]
        assert all(s <= 2 for s in b.batch_sizes)
    finally:
        b.close()


def test_batcher_per_item_and_batch_errors():
    def batch_fn(items):
        if "boom_all" in items:
            raise RuntimeError("whole batch")
        return [ValueError(x) if x == "bad" else x for x in items]

    b = MicroBatcher(batch_fn, max_batch=4, window_ms=5.0)
    try:
        assert b.submit("ok") == "ok"
        with pytest.raises(ValueError):
            b.submit("bad")
        with pytest.raises(RuntimeError):
            b.submit("boom_all")
        assert b.submit("still ok") == "still ok"
    finally:
        b.close()


def test_batcher_close_rejects_new_submits():
    b = MicroBatcher(lambda items: items, max_batch=2, window_ms=1.0)
    b.close()
    with pytest.raises(RuntimeError):
        b.submit(1)


# ------------------------------------------------------------- fixtures


def _make_img(group, seed):
    r = np.random.RandomState(1000 * group + seed)
    base = np.zeros((80, 80, 3), np.uint8)
    base[..., group % 3] = 60 + 20 * group
    base[15 + group:60, 10:70, (group + 1) % 3] = 200
    noise = r.randint(0, 30, base.shape, dtype=np.uint8)
    return np.clip(base.astype(int) + noise, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """16 PNG images, both featurizers on one set of weights, the images'
    fc7 in a sqlite KVIndexer, and a PCA model over them."""
    from columbiaimagesearch_tpu.models.sentibank import (
        SentibankFeaturizer as JaxFeaturizer,
        load_weights_npz as jax_load_npz,
    )

    from tests.test_torch_facade import _params
    from tests.test_torch_sentibank import steady_jax_imgpipe

    # both facades must decode through the native library (see the helper)
    steady_jax_imgpipe()
    root = tmp_path_factory.mktemp("api")
    paths = []
    for g in range(4):
        for s in range(4):
            p = root / f"img_{g}_{s}.png"
            Image.fromarray(_make_img(g, s)).save(p)
            paths.append(str(p))
    sd = init_params(seed=0)
    npz = str(root / "sentibank.npz")
    save_weights_npz(sd, npz)
    tf = SentibankFeaturizer(params=sd, device="cpu")
    jf = JaxFeaturizer(params=jax_load_npz(npz))
    bufs = [open(p, "rb").read() for p in paths]
    feats, status = tf.featurize_buffers(bufs)
    assert not any(status)
    X = feats / np.linalg.norm(feats, axis=1, keepdims=True)
    rng = np.random.RandomState(0)
    P = np.linalg.qr(rng.randn(4096, 32))[0].astype(np.float32)
    mu = X.mean(0).astype(np.float32)
    Xp = (X - mu) @ P
    params = _params(rng, np.repeat(Xp, 4, axis=0), V=4, M=4, S=16)
    sha1s = [__import__("hashlib").sha1(b).hexdigest().upper()
             for b in bufs]
    db = str(root / "base.db")
    kv = KVIndexer(path=db)
    _fill(kv, X, sha1s)
    kv._shared.close()
    return dict(root=root, paths=paths, bufs=bufs, sd=sd, npz=npz, tf=tf,
                jf=jf, store=(root, db, params, X, sha1s), pca=(P, mu),
                sha1s=sha1s)


@pytest.fixture(scope="module")
def facades(env):
    kw = dict(reranking=True, rerank_nb=20, store_rerank_feats=True,
              skip_get_sim_info=False, sim_limit=5)
    js, ts = _pair(env["store"], kw, pca=env["pca"],
                   featurizers=(env["jf"], env["tf"]))
    assert ts.get_nb_indexed() == js.get_nb_indexed() == 16
    return js, ts


def test_search_image_path_list_matches_jax(env, facades):
    js, ts = facades
    opts = {"max_returned": 4}
    want = js.search_image_path_list(env["paths"][:3], dict(opts))
    got = ts.search_image_path_list(env["paths"][:3], dict(opts))
    _assert_outputs_equal(want, got)
    for i, entry in enumerate(got["AllSimilarImages"]):
        assert entry["SimilarImages"]["ImageSha1s"][0] == env["sha1s"][i]


def test_api_byB64_and_status_match_jax(env, facades):
    from columbiaimagesearch_tpu.api.app import SearchAPI as JaxSearchAPI

    js, ts = facades
    b64 = ",".join(base64.b64encode(b).decode() for b in env["bufs"][4:6])
    opts = json.dumps({"max_returned": 3, "bogus": 1})
    jcode, want = JaxSearchAPI(js).process("byB64", b64, opts)
    tcode, got = SearchAPI(ts).process("byB64", b64, opts)
    assert tcode == jcode == 200
    assert got.pop("Timing") >= 0 and want.pop("Timing") >= 0
    assert got["Errors"] == want["Errors"] == [
        {"option": "unknown option bogus"}]
    _assert_outputs_equal(want, got)
    jcode, jst = JaxSearchAPI(js).process("status")
    tcode, tst = SearchAPI(ts).process("status")
    for d in (jst, tst):
        for k in ("API_start_time", "API_uptime", "last_refresh"):
            d.pop(k)
    assert tcode == jcode == 200 and tst == jst
    assert SearchAPI(ts).process("nope", "x")[0] == 400


# ---------------------------------------------------- coalesced serving


@pytest.fixture(scope="module")
def serving_pair(env):
    """A sequential and a coalescing port facade over one model, codes and
    rerank store (the JAX test's fixture, tests/test_microbatch.py:115)."""
    root, _db, params, X, sha1s = env["store"]
    P, mu = env["pca"]

    def build(**kw):
        m = LOPQModelPCA.from_numpy(*params, P, mu, device="cpu")
        s = SearcherLOPQ(
            model_type="lopq_pca", V=4, M=4, subquantizer_clusters=16,
            pca_dims=32, model=m, detector_type="full",
            featurizer=env["tf"], indexer=KVIndexer(path=":memory:"),
            storer=MemoryStorer(), file_input=True, reranking=True,
            rerank_nb=20, device="cpu", **kw)
        s.searcher.add_codes(m.predict_batch(X), ids=sha1s,
                             feats=m.apply_PCA(X))
        return s

    seq, coal = build(), build(coalesce_window_ms=60.0, coalesce_max_batch=8)
    yield seq, coal, env["paths"]
    coal.request_batcher.close()


def test_coalesced_serving_matches_sequential(serving_pair):
    seq, coal, paths = serving_pair
    opts = {"max_returned": 3}
    expected = [seq.search_image_path_list([p], dict(opts)) for p in paths]
    server = make_server(coal, endpoint="cuimgsearch", port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        def query(path):
            qs = urlencode({"data": path, "options": json.dumps(opts)})
            url = f"http://127.0.0.1:{port}/cuimgsearch/byPATH?{qs}"
            with urllib.request.urlopen(url, timeout=120) as r:
                return json.loads(r.read())

        results, errs = {}, []

        def worker(i):
            try:
                results[i] = query(paths[i])
            except Exception as inst:  # noqa: BLE001
                errs.append((i, inst))

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(paths))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errs, errs
        for i in range(len(paths)):
            got = results[i]["AllSimilarImages"][0]["SimilarImages"]
            want = expected[i]["AllSimilarImages"][0]["SimilarImages"]
            assert got["ImageSha1s"] == want["ImageSha1s"], i
            # another wave size: fc7 differs in its last float digits
            np.testing.assert_allclose(got["Distances"], want["Distances"],
                                       rtol=1e-4, atol=1e-5)
            assert got["ImageSha1s"][0] == \
                expected[i]["AllSimilarImages"][0]["QuerySha1"]
        assert max(coal.request_batcher.batch_sizes) > 1
    finally:
        server.shutdown()
        server.server_close()


def test_coalesced_mixed_options_grouped_not_mixed_up(serving_pair):
    _, coal, paths = serving_pair
    reqs = [(paths[1], {"max_returned": 2}),
            (paths[2], {"max_returned": 5}),
            (paths[3], {"max_returned": 2})]
    results = {}
    gate = threading.Event()

    def worker(i, p, o):
        gate.wait()
        results[i] = coal.search_image_path_list([p], dict(o))

    threads = [threading.Thread(target=worker, args=(i, p, o))
               for i, (p, o) in enumerate(reqs)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join(timeout=300)
    assert len(results) == 3
    for i, (_, o) in enumerate(reqs):
        block = results[i]["AllSimilarImages"][0]["SimilarImages"]
        assert len(block["ImageSha1s"]) == o["max_returned"]


def test_serve_batch_isolates_bad_request(serving_pair):
    _, coal, paths = serving_pair
    results, errors = {}, {}
    gate = threading.Event()

    def good():
        gate.wait()
        results["good"] = coal.search_image_path_list(
            [paths[0]], {"max_returned": 2})

    def bad():
        gate.wait()
        try:
            coal.search_image_path_list(["/nonexistent/img.png"],
                                        {"max_returned": 2})
        except Exception as inst:  # noqa: BLE001
            errors["bad"] = inst

    threads = [threading.Thread(target=good), threading.Thread(target=bad)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join(timeout=300)
    assert isinstance(errors["bad"], FileNotFoundError)
    block = results["good"]["AllSimilarImages"][0]["SimilarImages"]
    assert len(block["ImageSha1s"]) == 2


def test_serve_batch_isolates_undecodable_image(serving_pair, tmp_path):
    """A file no decoder reads fails its own request only; the request
    coalesced with it in the same wave is answered."""
    from columbiaimagesearch_tpu_torch.imgio.imgio import (
        get_buffer_from_filepath,
    )

    _, coal, paths = serving_pair
    junk = tmp_path / "junk.jpg"
    junk.write_bytes(b"\xff\xd8 not an image at all" * 8)
    reqs = [coal._prepare_request([p], get_buffer_from_filepath,
                                  {"max_returned": 2}, True)
            for p in (paths[0], str(junk))]
    assert "prep" in reqs[0] and "prep" not in reqs[1]
    good, bad = coal._serve_batch(reqs)
    assert isinstance(bad, Exception)
    assert len(good["AllSimilarImages"][0]["SimilarImages"]["ImageSha1s"]) \
        == 2


def test_device_error_is_the_requests_error_not_a_rerun(serving_pair):
    """An error of the wave forward is returned to each request of the
    wave; no other route reruns it (the JAX facade swallows it,
    generic_searcher.py:362)."""
    _, coal, paths = serving_pair
    calls = []

    def broken(stack):
        calls.append(len(stack))
        raise RuntimeError("CUDA error: an illegal memory access")

    fz = coal.featurizer
    fz.featurize_pixel_wave = broken
    try:
        with pytest.raises(RuntimeError, match="illegal memory access"):
            coal.search_image_path_list([paths[0]], {"max_returned": 2})
    finally:
        del fz.featurize_pixel_wave
    assert calls == [1]


def test_wave_uses_handler_decoded_pixels(serving_pair):
    seq, coal, paths = serving_pair
    opts = {"max_returned": 3}
    calls = []
    orig = coal.featurizer.featurize_pixel_wave

    def counting(stack):
        calls.append(len(stack))
        return orig(stack)

    coal.featurizer.featurize_pixel_wave = counting
    try:
        out = coal.search_image_path_list([paths[0]], dict(opts))
    finally:
        del coal.featurizer.featurize_pixel_wave
    assert calls, "coalesced wave did not take the pixel route"
    assert out == seq.search_image_path_list([paths[0]], dict(opts))


def test_prewarm_serving_drives_every_wave_size(serving_pair):
    seq, _, paths = serving_pair
    waves = seq.searcher.probe_stats["waves"]
    assert seq.prewarm_serving(3) == [1, 2, 4]
    assert seq.searcher.probe_stats["waves"] > waves   # two serving passes
    out = seq.search_image_path_list([paths[5]], {"max_returned": 2})
    assert out["AllSimilarImages"][0]["SimilarImages"]["ImageSha1s"]


def test_run_search_api_serves_status(env, tmp_path):
    """``python -m columbiaimagesearch_tpu_torch.api.run_search_api -c``
    builds the facade from a conf and answers over HTTP."""
    conf = {"SEARCHLOPQ_model_type": "lopq", "SEARCHLOPQ_lopq_V": 4,
            "SEARCHLOPQ_lopq_M": 4, "SEARCHLOPQ_lopq_subq": 16,
            "SEARCHLOPQ_prewarm_waves": 0,
            "KVI_db_path": str(tmp_path / "kv.db"),
            "ST_storer_type": "local",
            "ST_base_path": str(tmp_path / "storer")}
    conf_path = tmp_path / "conf.json"
    conf_path.write_text(json.dumps(conf))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "columbiaimagesearch_tpu_torch.api."
         "run_search_api", "-c", str(conf_path), "-p", str(port),
         "--host", "127.0.0.1", "--device", "cpu"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, SENTIBANK_WEIGHTS=env["npz"]),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/cuimgsearch/status",
                        timeout=5) as r:
                    status = json.loads(r.read())
                break
            except OSError:
                assert proc.poll() is None and time.time() < deadline, \
                    proc.stdout.read() if proc.poll() is not None else ""
                time.sleep(0.5)
        assert status["status"] == "OK" and status["nb_indexed"] == "0"
        assert status["model_str"] == \
            "sentibank_feat_full_image_lopq-subq16-V4-M4"
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()


class _StubSearcher:
    def status(self):
        return {"nb_indexed": 0}


def _burst(make, n=64):
    """``n`` concurrent /status requests; returns (errors, latencies s)."""
    server = make(_StubSearcher(), port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    gate = threading.Event()
    lat, errs = [], []

    def client():
        gate.wait()
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/cuimgsearch/status",
                    timeout=30) as r:
                json.loads(r.read())
            lat.append(time.perf_counter() - t0)
        except OSError as inst:
            errs.append(inst)

    threads = [threading.Thread(target=client) for _ in range(n)]
    try:
        urllib.request.urlopen(                     # first-request imports
            f"http://127.0.0.1:{port}/cuimgsearch/status", timeout=30).close()
        for t in threads:
            t.start()
        gate.set()
        for t in threads:
            t.join(timeout=60)
    finally:
        server.shutdown()
        server.server_close()
    return errs, lat


def test_server_takes_a_burst_of_concurrent_connections():
    """64 clients connecting at once are all answered without a TCP connect
    retry (>= 1 s) or a reset: the listen backlog is not socketserver's
    default of 5, which the JAX ``make_server`` keeps (ROADMAP Queue 3)."""
    errs, lat = _burst(make_server)
    assert not errs and len(lat) == 64
    assert max(lat) < 0.9, sorted(lat)[-3:]
