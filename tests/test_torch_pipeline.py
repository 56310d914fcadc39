"""The ingest pipeline of the port (``pipeline/checker.py``,
``pipeline/processor.py``, ``pipeline/ingest.py``) against the JAX
package's, on the scenario of tests/test_pipeline_api.py::pipeline_env at
a smaller size: 16 PNGs of 80x80, one duplicate (the same bytes under
another name) and one PNG truncated inside its pixel data (the header
reads, the decode fails in the native and the PIL decoder alike), with
``batch_update_size`` 6, through each package's checker and processor on
the same Sentibank weights (Caffe blobs through each package's
``load_caffe_weights``), both on the CPU.

Update ids carry the checker's pid and a timestamp, and the update rows
carry timestamps: both are masked. fc7 columns are base64 float32
(``normfeatB64encode``) and are compared decoded, at the fc7 tolerance of
tests/test_torch_sentibank.py (rtol 2e-3, atol 2e-4).
"""

import shutil

import numpy as np
import pytest
from PIL import Image

from columbiaimagesearch_tpu_torch.extraction.extractor import GenericExtractor
from columbiaimagesearch_tpu_torch.extraction.featsio import featB64decode
from columbiaimagesearch_tpu_torch.models.sentibank import (
    SentibankFeaturizer,
    load_caffe_weights,
)
from columbiaimagesearch_tpu_torch.pipeline import (
    ExtractionChecker,
    ExtractionProcessor,
    LocalDirIngester,
    MemoryBus,
    MemoryBusIngester,
    MemoryBusPusher,
)
from columbiaimagesearch_tpu_torch.pipeline import processor as processor_mod
from columbiaimagesearch_tpu_torch.searcher.searcher_lopq import SearcherLOPQ
from columbiaimagesearch_tpu_torch.store import KVIndexer, MemoryStorer

from tests.test_pipeline_api import make_img
from tests.test_torch_sentibank import steady_jax_imgpipe

EXTR = "sentibank_feat_full_image"
FC7_RTOL, FC7_ATOL = 2e-3, 2e-4
BATCH = 6


def _mask(update_id):
    """An update id without its ``-pid<pid>-<time>`` suffix."""
    return update_id.rsplit("-", 2)[0]


def _write_images(root):
    paths = []
    for g in range(4):
        for s in range(4):
            p = root / f"img_{g}_{s}.png"
            Image.fromarray(make_img(g, s)).save(p)
            paths.append(str(p))
    shutil.copy(paths[5], root / "img_dup.png")
    data = (root / "img_3_3.png").read_bytes()
    (root / "img_zbad.png").write_bytes(data[:len(data) // 2])
    return paths


@pytest.fixture(scope="module")
def featurizers():
    from columbiaimagesearch_tpu.models.sentibank import (
        SentibankFeaturizer as JaxFeaturizer,
        load_caffe_weights as jax_load_caffe,
    )

    from tests.test_sentibank_weights import _deterministic_caffe_blobs

    steady_jax_imgpipe()
    blobs = _deterministic_caffe_blobs(seed=1)
    return (JaxFeaturizer(params=jax_load_caffe(blobs)),
            SentibankFeaturizer(params=load_caffe_weights(blobs),
                                device="cpu"))


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory, featurizers):
    """Each package's checker and processor over the same directory: the
    processor takes one update with ``run_once(max_updates=1)``, then the
    rest."""
    from columbiaimagesearch_tpu.extraction import (
        GenericExtractor as JaxExtractor,
    )
    from columbiaimagesearch_tpu.pipeline import (
        ExtractionChecker as JaxChecker,
        ExtractionProcessor as JaxProcessor,
        LocalDirIngester as JaxDirIngester,
        MemoryBus as JaxBus,
        MemoryBusPusher as JaxBusPusher,
    )
    from columbiaimagesearch_tpu.store import KVIndexer as JaxKVIndexer

    root = tmp_path_factory.mktemp("pipe_imgs")
    paths = _write_images(root)
    out = {}
    for name, kv_cls, bus_cls, pusher_cls, checker_cls, ing_cls, \
            proc_cls, extr_cls, fz in (
            ("jax", JaxKVIndexer, JaxBus, JaxBusPusher, JaxChecker,
             JaxDirIngester, JaxProcessor, JaxExtractor, featurizers[0]),
            ("port", KVIndexer, MemoryBus, MemoryBusPusher,
             ExtractionChecker, LocalDirIngester, ExtractionProcessor,
             GenericExtractor, featurizers[1])):
        kv = kv_cls(path=":memory:")
        bus = bus_cls()
        checker = checker_cls(kv, EXTR, ing_cls(str(root)),
                              pusher=pusher_cls(bus, "updates"),
                              batch_update_size=BATCH)
        created = checker.run_once()
        processor = proc_cls(kv, extr_cls("full", "sentibank",
                                          featurizer=fz), nb_threads=3)
        first = processor.run_once(max_updates=1)
        rest = processor.run_once()
        out[name] = dict(kv=kv, bus=bus, checker=checker,
                         processor=processor, created=created,
                         first=first, rest=rest)
    return out, paths


def _update_rows(kv):
    return [(r, c) for b in kv.get_updates_from_date("1970-01-01",
                                                     extr_type=EXTR)
            for r, c in b]


def _image_rows(kv):
    return dict(kv.scan_from_row(kv.table_sha1infos_name, maxrows=1000))


def test_updates_match_jax(pipelines):
    """The same updates (ids up to pid and time), the same sha1 lists in
    the same order, the same bus messages and update columns."""
    out, _ = pipelines
    j, t = out["jax"], out["port"]
    assert len(t["created"]) == 3          # 17 distinct images / 6
    assert [_mask(u) for u in t["created"]] == \
        [_mask(u) for u in j["created"]]
    assert all("-pid" in u for u in t["created"])
    assert [_mask(u) for u in t["first"]] == [_mask(u) for u in j["first"]]
    assert len(t["first"]) == 1
    assert sorted(t["first"] + t["rest"]) == sorted(t["created"])
    jrows, trows = _update_rows(j["kv"]), _update_rows(t["kv"])
    assert [_mask(r) for r, _ in trows] == [_mask(r) for r, _ in jrows]
    for (_, jc), (_, tc) in zip(jrows, trows):
        assert sorted(tc) == sorted(jc)
        col = t["kv"].get_col_listsha1s()
        assert tc[col] == jc[col]
        assert tc[t["kv"].get_col_upcomp()] == b"1"
    jmsgs = list(MemoryBusIngester(j["bus"], "updates").get_msg_json())
    tmsgs = list(MemoryBusIngester(t["bus"], "updates").get_msg_json())
    assert [{_mask(k): v for k, v in m.items()} for m in tmsgs] == \
        [{_mask(k): v for k, v in m.items()} for m in jmsgs]


def test_image_columns_match_jax(pipelines):
    """The same image rows and columns; fc7 within the fc7 tolerance; the
    truncated PNG has the failed column in both."""
    out, paths = pipelines
    jrows, trows = _image_rows(out["jax"]["kv"]), _image_rows(out["port"]["kv"])
    assert sorted(trows) == sorted(jrows) and len(trows) == 17
    n_feat, n_failed = 0, 0
    for sha1, tc in trows.items():
        jc = jrows[sha1]
        assert sorted(tc) == sorted(jc)
        for col, tv in tc.items():
            jv = jc[col]
            if col.endswith("_updateid"):
                assert _mask(tv.decode()) == _mask(jv.decode())
            elif col == f"ext:{EXTR}":
                np.testing.assert_allclose(featB64decode(tv, "sentibank"),
                                           featB64decode(jv, "sentibank"),
                                           rtol=FC7_RTOL, atol=FC7_ATOL)
                n_feat += 1
            else:
                assert tv == jv, col
        if f"ext:{EXTR}_failed" in tc:
            assert tc[f"ext:{EXTR}_failed"] == b"1"
            assert tc["info:img_path"].decode().endswith("img_zbad.png")
            n_failed += 1
    assert (n_feat, n_failed) == (16, 1)


def test_second_pass_and_check_missing_match_jax(pipelines):
    """A second pass creates and claims nothing; ``check_missing`` redoes
    the update holding the undecodable image (it has no extraction) in
    both packages."""
    out, _ = pipelines
    redone = {}
    for name in ("jax", "port"):
        p = out[name]
        assert p["checker"].run_once() == []
        assert p["processor"].run_once() == []
        redone[name] = p["processor"].check_missing()
    assert len(redone["port"]) == 1
    assert [_mask(u) for u in redone["port"]] == \
        [_mask(u) for u in redone["jax"]]


@pytest.mark.parametrize("case", ["fresh", "stale", "processed"])
def test_claims_match_jax(pipelines, monkeypatch, case):
    """A fresh ``started`` claim blocks a second processor, one older than
    ``time_elapsed_failed`` does not, a processed update never is
    claimable; the clock is the processor module's ``time.time``."""
    from columbiaimagesearch_tpu.pipeline import processor as jax_proc_mod

    out, _ = pipelines
    now = 1_800_000_000.0
    age = {"fresh": 3599.0, "stale": 3601.0, "processed": 10.0}[case]
    answers = {}
    for name, mod in (("jax", jax_proc_mod), ("port", processor_mod)):
        p = out[name]
        kv = p["kv"]
        monkeypatch.setattr(mod.time, "time", lambda: now)
        uid = f"index_update_{EXTR}_2099-01-01_000"
        cols = {kv.get_col_listsha1s(): "", kv.get_col_upcreate(): "x",
                kv.get_col_upstart(): str(now - age)}
        if case == "processed":
            cols[kv.get_col_upproc()] = "1"
        kv.push_dict_rows({uid: cols}, kv.table_updateinfos_name)
        rows = kv.get_rows_by_batch([uid], kv.table_updateinfos_name)
        answers[name] = p["processor"].is_update_claimable(rows[0][1])
        kv.delete_row(kv.table_updateinfos_name, uid)
        monkeypatch.undo()
    assert answers["port"] == answers["jax"] == (case == "stale")


def test_update_ids_unique_across_restarts(tmp_path):
    """Two checker generations on one sqlite file never reuse an update id
    nor its sequence part (tests/test_pipeline_api.py, on the port)."""
    root = tmp_path / "imgs"
    root.mkdir()
    for g in range(2):
        for s in range(4):
            Image.fromarray(make_img(g, s)).save(root / f"r{g}_{s}.png")
    db = str(tmp_path / "kv.sqlite")
    ids1 = ExtractionChecker(KVIndexer(path=db), EXTR,
                             LocalDirIngester(str(root)),
                             batch_update_size=2).run_once()
    assert len(ids1) == 4
    for g in range(2):
        for s in range(4):
            Image.fromarray(make_img(g + 4, s + 50)).save(
                root / f"r2_{g}_{s}.png")
    kv2 = KVIndexer(path=db)
    ids2 = ExtractionChecker(kv2, EXTR, LocalDirIngester(str(root)),
                             batch_update_size=2).run_once()
    assert len(ids2) == 4 and not set(ids1) & set(ids2)
    rows = {r for r, _ in _update_rows(kv2)}
    assert set(ids1) | set(ids2) <= rows
    assert not {_mask(u) for u in ids1} & {_mask(u) for u in ids2}


def test_facade_over_pipeline_store_matches_jax(pipelines, featurizers):
    """The port's ``SearcherLOPQ`` over the port pipeline's store and the
    JAX facade over the JAX pipeline's, on one model's parameters, answer
    three path queries with the same ids, each image first."""
    from columbiaimagesearch_tpu.index.model import LOPQModel as JaxModel
    from columbiaimagesearch_tpu.searcher.searcher_lopq import (
        SearcherLOPQ as JaxSearcherLOPQ,
    )
    from columbiaimagesearch_tpu.store import MemoryStorer as JaxMemoryStorer

    from columbiaimagesearch_tpu_torch.imgio.imgio import (
        get_buffer_from_filepath,
        get_SHA1_from_buffer,
    )
    from columbiaimagesearch_tpu_torch.index.model import LOPQModel

    from tests.test_torch_facade import _params

    out, paths = pipelines
    kv = out["port"]["kv"]
    sha1s = sorted(_image_rows(kv))
    _, feats = kv.get_features_from_sha1s(sha1s, EXTR)
    params = _params(np.random.RandomState(5), np.stack(feats), V=4, M=4,
                     S=16)
    kw = dict(model_type="lopq", V=4, M=4, subquantizer_clusters=16,
              detector_type="full", featurizer_type="sentibank",
              reranking=True, rerank_nb=20, sim_limit=5)
    js = JaxSearcherLOPQ(model=JaxModel(parameters=params),
                         indexer=out["jax"]["kv"], storer=JaxMemoryStorer(),
                         featurizer=featurizers[0], **kw)
    ts = SearcherLOPQ(model=LOPQModel.from_numpy(*params, device="cpu"),
                      indexer=kv, storer=MemoryStorer(),
                      featurizer=featurizers[1], device="cpu", **kw)
    assert ts.get_nb_indexed() == js.get_nb_indexed() == 16
    for i in (0, 7, 13):
        want = js.search_image_path_list([paths[i]], {"max_returned": 3})
        got = ts.search_image_path_list([paths[i]], {"max_returned": 3})
        bw = want["AllSimilarImages"][0]["SimilarImages"]
        bg = got["AllSimilarImages"][0]["SimilarImages"]
        assert bg["ImageSha1s"] == bw["ImageSha1s"]
        assert bg["ImageSha1s"][0] == get_SHA1_from_buffer(
            get_buffer_from_filepath(paths[i]))
        np.testing.assert_allclose(bg["Distances"], bw["Distances"],
                                   rtol=FC7_RTOL, atol=FC7_ATOL)

