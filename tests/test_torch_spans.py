"""The port's search-path spans (``common/profiling.py`` ``span`` and its
``gc.callbacks`` hook) under the CPU profiler: which ``cis.`` spans a wave
opens and how they nest (through both of the single-device searcher's
entry points and the sharded index's, which share one wave path), the
collections' spans, nothing entered while no profiler records, and the
same answers with the profiler on and off."""

import gc
import json

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch.common import profiling
from columbiaimagesearch_tpu_torch.index.model import LOPQModel
from columbiaimagesearch_tpu_torch.index.searcher import LOPQSearcherTorch
from columbiaimagesearch_tpu_torch.parallel.mesh import SHARD_AXIS, make_mesh
from columbiaimagesearch_tpu_torch.parallel.sharded import ShardedLOPQIndex

from tests.oracle_lopq import random_params

V, M, S, D = 16, 8, 32, 64
N = 4000


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.RandomState(23)
    params = random_params(rng, V=V, M=M, S=S, D=D)
    coarse = rng.randint(0, V, (N, 2))
    fine = rng.randint(0, S, (N, M))
    feats = rng.randn(N, D).astype(np.float32)
    queries = rng.randn(6, D).astype(np.float32)
    return params, coarse, fine, feats, queries


def _searcher(corpus, with_feats=False):
    params, coarse, fine, feats, _ = corpus
    s = LOPQSearcherTorch(LOPQModel.from_numpy(*params, device="cpu"))
    s.add_codes((coarse, fine), feats=feats if with_feats else None)
    return s


def _entry(corpus, entry, with_feats=False):
    """(searcher, wave call) of an entry point: one of the single-device
    searcher's, or ``search_batch`` of a sharded index on two CPU shards
    (its pairs always carry distances)."""
    if entry != "sharded":
        s = _searcher(corpus, with_feats)
        return s, getattr(s, entry)
    params, coarse, fine, feats, _ = corpus
    idx = ShardedLOPQIndex(LOPQModel.from_numpy(*params, device="cpu"),
                           mesh=make_mesh(axis=SHARD_AXIS,
                                          devices=["cpu"] * 2))
    idx.build(coarse, fine, feats=feats if with_feats else None)

    def call(queries, with_dists=True, **kw):
        return idx.search_batch(queries, **kw)
    return idx, call


@pytest.fixture
def no_gc():
    """Collections only where a test asks for them, so that no
    ``cis.gc.*`` span falls into the nesting checks."""
    was = gc.isenabled()
    gc.disable()
    yield
    if was:
        gc.enable()


def _traced(tmp_path, fn):
    """``fn()`` under the CPU profiler: (its value, the trace's ``cis.``
    spans as (name, start, end), by start)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e["name"].startswith("cis.")),
                   key=lambda s: (s[1], -s[2]))
    return out, spans


def _tree(spans):
    """Each span's name with its parent's (the innermost span holding
    it), as (name, parent name or None), in order of start."""
    out, stack = [], []
    for name, a, b in spans:
        while stack and stack[-1][2] < b:
            stack.pop()
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, a, b))
    return out


def _wave_tree(tree):
    """The distinct (span, parent) pairs of a wave and the count of each
    name."""
    names = [n for n, _ in tree]
    return set(tree), {n: names.count(n) for n in set(names)}


ENTRIES = ["search_batch", "search_device_feats", "sharded"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_grid_wave_spans(corpus, entry, tmp_path, no_gc):
    s, call = _entry(corpus, entry)
    queries = corpus[-1]
    _, spans = _traced(tmp_path, lambda: call(queries, quota=300, limit=20,
                                              with_dists=True))
    pairs, counts = _wave_tree(_tree(spans))
    assert s.probe_stats["waves"] == 1
    assert s.probe_stats.get("brute_waves", 0) == 0
    assert counts["cis.search"] == 1 and counts["cis.ladder"] == 1
    assert counts["cis.results"] == 1
    assert counts["cis.dispatch"] >= 1
    assert counts["cis.fetch"] == counts["cis.dispatch"]
    assert pairs == {("cis.search", None), ("cis.ladder", "cis.search"),
                     ("cis.dispatch", "cis.ladder"),
                     ("cis.fetch", "cis.dispatch"),
                     ("cis.results", "cis.search")}


@pytest.mark.parametrize("entry", ENTRIES)
def test_brute_wave_spans(corpus, entry, tmp_path, no_gc):
    s, call = _entry(corpus, entry, with_feats=True)
    queries = corpus[-1]
    _, spans = _traced(tmp_path, lambda: call(
        queries, quota=300, limit=20, with_dists=True, rerank_nb=50))
    pairs, counts = _wave_tree(_tree(spans))
    assert s.probe_stats["brute_waves"] == 1
    assert counts == {"cis.search": 1, "cis.dispatch": 1, "cis.fetch": 1,
                      "cis.results": 1}
    assert pairs == {("cis.search", None), ("cis.dispatch", "cis.search"),
                     ("cis.fetch", "cis.dispatch"),
                     ("cis.results", "cis.search")}


def test_full_collection_is_one_span(tmp_path, no_gc):
    _, spans = _traced(tmp_path, gc.collect)
    assert [n for n, _, _ in spans] == ["cis.gc.2"]
    _, spans = _traced(tmp_path, lambda: gc.collect(0))
    assert [n for n, _, _ in spans] == ["cis.gc.0"]


def test_the_hook_is_installed_once():
    assert gc.callbacks.count(profiling._gc_span) == 1


def test_the_flag_follows_the_profiler():
    assert not profiling._recording()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling._recording()
    assert not profiling._recording()


def test_a_session_starting_or_ending_in_a_collection(no_gc):
    """The hook exits only what it entered: a collection that started
    before the session opens no span, and one that started inside it
    closes its span after the session ended."""
    info = {"generation": 0}
    profiling._gc_span("start", info)          # no session yet
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling._gc_span("stop", info)
        assert profiling._gc_open == []
        profiling._gc_span("start", info)
        assert len(profiling._gc_open) == 1
    profiling._gc_span("stop", info)           # the session has ended
    assert profiling._gc_open == []


def test_nothing_entered_without_a_profiler(corpus, monkeypatch):
    entered = []

    def refuse(*args, **kwargs):
        entered.append(args)
        raise AssertionError("a span was entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        refuse)
    assert not profiling._recording()
    queries = corpus[-1]
    s = _searcher(corpus, with_feats=True)
    s.search_batch(queries, quota=300, limit=20, with_dists=True)
    s.search_batch(queries, quota=300, limit=20, with_dists=True,
                   rerank_nb=50)
    s.search_device_feats(queries, quota=300, limit=20)
    gc.collect()    # a hook's exception would not propagate: read `entered`
    assert entered == []
    assert profiling.span("cis.search") is profiling.span("cis.results")


def test_the_profiler_leaves_answers_alone(corpus, tmp_path):
    queries = corpus[-1]

    def waves(s):
        return [s.search_batch(queries, quota=300, limit=20,
                               with_dists=True),
                s.search_batch(queries, quota=300, limit=20,
                               with_dists=True, rerank_nb=50),
                s.search_device_feats(queries, quota=300, limit=20,
                                      rerank_nb=50)]

    off = waves(_searcher(corpus, with_feats=True))
    on, spans = _traced(tmp_path,
                        lambda: waves(_searcher(corpus, with_feats=True)))
    assert [n for n, _, _ in spans].count("cis.search") == 3
    assert on == off


# ------------------------------------------------------------ served path


@pytest.fixture(scope="module")
def served():
    """A coalescing facade on the CPU (DeepSentibank at full width on the
    coefficient route, a ``lopq_pca`` model 4096 -> 64 with the rerank
    store) behind ``make_server``, and three small JPEGs."""
    import io
    import threading

    from PIL import Image

    from columbiaimagesearch_tpu_torch.api.app import make_server
    from columbiaimagesearch_tpu_torch.index.model import LOPQModelPCA
    from columbiaimagesearch_tpu_torch.models.sentibank import (
        SentibankFeaturizer,
        init_params,
    )
    from columbiaimagesearch_tpu_torch.searcher.searcher_lopq import (
        SearcherLOPQ,
    )
    from columbiaimagesearch_tpu_torch.store import KVIndexer, MemoryStorer

    rng = np.random.RandomState(29)
    params = random_params(rng, V=V, M=M, S=S, D=D)
    P = np.linalg.qr(rng.randn(4096, D))[0].astype(np.float32)
    mu = np.zeros(4096, np.float32)
    model = LOPQModelPCA.from_numpy(*params, P, mu, device="cpu")
    facade = SearcherLOPQ(
        model_type="lopq_pca", V=V, M=M, subquantizer_clusters=S,
        pca_dims=D, model=model, detector_type="full",
        featurizer=SentibankFeaturizer(params=init_params(0), device="cpu",
                                       device_decode=True),
        indexer=KVIndexer(path=":memory:"), storer=MemoryStorer(),
        reranking=True, rerank_nb=50, sim_limit=5, skip_get_sim_info=True,
        coalesce_window_ms=50.0, coalesce_max_batch=8, device="cpu")
    facade.searcher.add_codes(
        (rng.randint(0, V, (N, 2)), rng.randint(0, S, (N, M))),
        feats=rng.randn(N, D).astype(np.float32))
    jpegs = []
    for k in range(3):
        b = io.BytesIO()
        Image.fromarray(rng.randint(0, 255, (64, 96, 3)).astype(np.uint8)) \
            .save(b, format="JPEG", quality=85, subsampling=2)
        jpegs.append(b.getvalue())
    server = make_server(facade, port=0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield facade, server.server_address[1], jpegs
    server.shutdown()
    server.server_close()
    facade.request_batcher.close()


def _post_all(port, jpegs):
    """The JPEGs posted at once to ``byB64``, one a thread; the replies."""
    import base64
    import threading
    import urllib.parse
    import urllib.request

    out = [None] * len(jpegs)

    def post(i):
        body = urllib.parse.urlencode(
            {"data": base64.b64encode(jpegs[i]).decode()}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/cuimgsearch/byB64", data=body,
            method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            out[i] = json.loads(r.read())

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(jpegs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return out


def _by_thread(events):
    """{thread: [(name, start, end)] by start} of the ``cis.`` spans."""
    out = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e["name"].startswith("cis.")):
            out.setdefault(e["tid"], []).append(
                (e["name"], e["ts"], e["ts"] + e["dur"]))
    return {t: sorted(s, key=lambda x: (x[1], -x[2]))
            for t, s in out.items()}


def test_served_spans_on_every_thread(served, tmp_path, no_gc):
    """Under a profiler of every thread, each request is ``cis.http`` on its
    handler's thread holding ``cis.decode`` then ``cis.queue``; each
    coalesced wave is ``cis.featurize``, ``cis.search`` and one
    ``cis.assemble`` a request on the coalescer's thread, outside any
    other span there."""
    from torch._C._profiler import _ExperimentalConfig

    facade, port, jpegs = served
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=_ExperimentalConfig(
                profile_all_threads=True)) as prof:
        replies = _post_all(port, jpegs)
    for r in replies:
        assert len(r["AllSimilarImages"][0]["SimilarImages"]
                   ["ImageSha1s"]) == 5
    path = tmp_path / "served.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        threads = _by_thread(json.load(f)["traceEvents"])
    handlers = [s for s in threads.values() if s[0][0] == "cis.http"]
    assert len(handlers) == len(jpegs)
    for spans in handlers:
        assert [n for n, _, _ in spans] == ["cis.http", "cis.decode",
                                            "cis.queue"]
        assert _tree(spans) == [("cis.http", None),
                                ("cis.decode", "cis.http"),
                                ("cis.queue", "cis.http")]
        assert spans[1][2] <= spans[2][1]          # decode, then the wait
    workers = [s for s in threads.values()
               if any(n == "cis.featurize" for n, _, _ in s)]
    assert len(workers) == 1
    tree = _tree(workers[0])
    names = [n for n, _ in tree]
    waves = names.count("cis.featurize")
    assert waves == names.count("cis.search") >= 1
    assert names.count("cis.assemble") == len(jpegs)
    tops = [n for n, parent in tree if parent is None]
    assert {"cis.featurize", "cis.search", "cis.assemble"} == set(tops)
    assert tops.index("cis.featurize") < tops.index("cis.search") \
        < tops.index("cis.assemble")
    assert sum(facade.request_batcher.batch_sizes[-waves:]) == len(jpegs)


def test_the_flag_holds_on_every_thread():
    """The span's flag is process-wide: another thread reads it set while
    this one's profiler runs."""
    import threading

    seen = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        t = threading.Thread(target=lambda: seen.append(
            profiling._recording()))
        t.start()
        t.join()
    assert seen == [True] and not profiling._recording()


def test_served_path_enters_nothing_without_a_profiler(served, monkeypatch):
    facade, port, jpegs = served

    def refuse(*args, **kwargs):
        raise AssertionError("a span was entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not profiling._recording()
    replies = _post_all(port, jpegs)
    assert all(r is not None and "AllSimilarImages" in r for r in replies)
    shared = profiling.span("cis.search")
    for name in ("cis.http", "cis.decode", "cis.queue", "cis.featurize",
                 "cis.assemble"):
        assert profiling.span(name) is shared
