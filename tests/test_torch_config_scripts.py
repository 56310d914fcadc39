"""The port's pipeline builders (``common/factory.py``), env-var conf
generators and entry points (``pipeline/run_processing.py``,
``pipeline/run_images_pusher.py``, ``pipeline/bus_printer.py``) against
the JAX package's factory and the copies in ``scripts/``, on the shipped
confs with their paths rewritten into a temporary directory."""

import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from columbiaimagesearch_tpu_torch.common import factory
from columbiaimagesearch_tpu_torch.pipeline import (
    bus_printer,
    run_images_pusher,
    run_processing,
)
from columbiaimagesearch_tpu_torch.pipeline.ingest import (
    LocalDirIngester,
    MemoryBus,
    MemoryBusIngester,
    MemoryBusPusher,
)

EXTR = "sentibank_feat_full_image"
CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "conf")


def _conf(name, **paths):
    with open(os.path.join(CONF, name)) as f:
        conf = json.load(f)
    conf.update(paths)
    return conf


def _images(root, n=8):
    root.mkdir()
    for i in range(n):
        r = np.random.RandomState(100 + i)
        img = np.zeros((64, 64, 3), np.uint8)
        img[..., i % 3] = 50 + 20 * i
        img += r.randint(0, 20, img.shape).astype(np.uint8)
        Image.fromarray(img).save(root / f"im_{i}.png")
    return root


def test_ingester_and_pusher_builders_on_shipped_confs(tmp_path):
    from columbiaimagesearch_tpu.common import factory as jax_factory

    root = _images(tmp_path / "in")
    conf = _conf("conf_ingester_local.json", IMG_ING_input_path=str(root),
                 IMG_PUSH_journal_path=str(tmp_path / "bus.jsonl"))
    ing = factory.build_ingester(conf)
    pusher = factory.build_pusher(conf)
    assert isinstance(ing, LocalDirIngester) and ing.root == str(root)
    assert isinstance(pusher, MemoryBusPusher) and pusher.topic == "images"
    assert pusher.bus.journal_path == str(tmp_path / "bus.jsonl")
    pusher.bus._jf.close()
    want = list(jax_factory.build_ingester(conf).get_msg_json())
    assert list(ing.get_msg_json()) == want and len(want) == 8
    # The Kinesis conf needs boto3, which is not installed: both raise.
    conf = _conf("conf_ingester_kinesis.json",
                 IMG_ING_shard_infos_filename=str(tmp_path / "shards.json"))
    for build in (factory.build_ingester, factory.build_pusher):
        with pytest.raises(ImportError, match="boto3"):
            build(conf)
    with pytest.raises(ValueError):
        factory.build_ingester({"IMG_ING_input_type": "nope"})
    with pytest.raises(ValueError):
        factory.build_pusher({"IMG_PUSH_image_pushing_type": "nope"})
    assert factory._decode_servers('["k0:9093", "k1:9093"]') == \
        ["k0:9093", "k1:9093"]
    assert factory._decode_servers("k0:9093") == "k0:9093"


def test_checker_and_processor_builders_on_shipped_conf(tmp_path):
    from columbiaimagesearch_tpu.common import factory as jax_factory

    root = _images(tmp_path / "in")
    conf = _conf("conf_extraction_local.json", CHECK_input_dir=str(root),
                 KVI_db_path=str(tmp_path / "kv.db"))
    jax_checker = jax_factory.build_checker(conf)
    checker = factory.build_checker(conf)
    assert isinstance(checker.ingester, LocalDirIngester)
    for attr in ("extr_str", "batch_update_size", "max_delay"):
        assert getattr(checker, attr) == getattr(jax_checker, attr)
    assert (checker.extr_str, checker.batch_update_size) == (EXTR, 1000)
    assert checker.indexer.path == str(tmp_path / "kv.db")
    proc = factory.build_processor(conf, device="cpu")
    assert (proc.extr_str, proc.nb_threads) == (EXTR, 8)
    assert proc.extractor.featurizer.device.type == "cpu"
    # Without a card the default device raises; the CPU runs only when
    # the caller names it.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        factory.build_processor(conf)
    # The checker's delegate: ingest_type names a backend under IMG_ING_.
    conf.update(CHECK_ingest_type="kafka", IMG_ING_input_type="kafka",
                IMG_ING_topic_name="imgs")
    with pytest.raises(ImportError, match="kafka-python"):
        factory.build_checker(conf)


@pytest.mark.parametrize("env", [
    {"extr_type": "face", "detector_type": "face", "input_type": "face",
     "input_dir": "/x", "ingest_type": "local", "BATCH_UPDATE_SIZE": "7",
     "db_path": "/y.db", "nb_threads": "3"},
    {"input_type": "local", "input_path": "/imgs", "source_zip": "/a.zip",
     "images_topic": "imgs"},
    {"input_type": "kafka", "input_topic": "crawl",
     "input_consumer_group": "g1", "kafka_servers": '["k0:9093"]',
     "image_pushing_type": "kafka", "images_topic": "imgs"},
    {"input_type": "kinesis", "input_stream": "s-in",
     "region_name": "us-east-1", "endpoint_url": "http://k:4567",
     "shard_infos_filename": "/s.json", "image_pushing_type": "kinesis",
     "images_stream": "s-out", "create_stream": "1", "nb_shards": "4"},
])
def test_conf_generators_match_jax(env):
    from columbiaimagesearch_tpu.common import factory as jax_factory

    for name in ("generate_conf_ingester", "generate_conf_extractor",
                 "generate_conf_searcher"):
        assert getattr(factory, name)(env) == \
            getattr(jax_factory, name)(env)


def test_run_processing_once_on_the_cpu(tmp_path):
    """One pass of the entry point fills the store; a second creates and
    processes nothing; without ``--device cpu`` it raises at once here
    (no card), before the retry loop."""
    from columbiaimagesearch_tpu_torch.store import KVIndexer

    root = _images(tmp_path / "in", n=5)
    conf = _conf("conf_extraction_local.json", CHECK_input_dir=str(root),
                 KVI_db_path=str(tmp_path / "kv.db"),
                 CHECK_batch_update_size=2)
    path = tmp_path / "extr.json"
    path.write_text(json.dumps(conf))
    run_processing.main(["-c", str(path), "--once", "--device", "cpu"])
    kv = KVIndexer(path=str(tmp_path / "kv.db"))
    updates = [c for b in kv.get_updates_from_date("1970-01-01")
               for _, c in b]
    assert len(updates) == 3
    assert all(kv.get_col_upcomp() in c for c in updates)
    rows = [r for r, _ in kv.scan_from_row(kv.table_sha1infos_name)]
    sha1s, feats = kv.get_features_from_sha1s(rows, EXTR)
    assert len(sha1s) == 5 and feats[0].shape == (4096,)
    run_processing.main(["-c", str(path), "--once", "--device", "cpu"])
    assert len([c for b in kv.get_updates_from_date("1970-01-01")
                for _, c in b]) == 3
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_processing.main(["-c", str(path), "--once"])


def test_images_pusher_and_bus_printer_match_scripts(tmp_path, monkeypatch,
                                                     capsys):
    """``run_images_pusher --once`` journals the same messages as
    scripts/run_images_pusher.py; ``bus_printer`` prints what
    scripts/bus_printer.py prints."""
    from scripts import bus_printer as jax_printer
    from scripts import run_images_pusher as jax_pusher

    root = _images(tmp_path / "in", n=4)
    journals = {}
    for name, main in (("jax", None), ("port", run_images_pusher.main)):
        journal = str(tmp_path / f"{name}_bus.jsonl")
        conf = _conf("conf_ingester_local.json",
                     IMG_ING_input_path=str(root),
                     IMG_PUSH_journal_path=journal)
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(conf))
        if main is None:
            monkeypatch.setattr(sys, "argv", ["run_images_pusher.py", "-c",
                                              str(path), "--once"])
            jax_pusher.main()
        else:
            main(["-c", str(path), "--once"])
        journals[name] = journal
    bus = {n: MemoryBus(journal_path=j) for n, j in journals.items()}
    msgs = {n: list(MemoryBusIngester(b, "images").get_msg_json())
            for n, b in bus.items()}
    assert msgs["port"] == msgs["jax"] and len(msgs["port"]) == 4
    for b in bus.values():
        b._jf.close()
    capsys.readouterr()
    printed = {}
    for name, run in (
            ("jax", lambda argv: (monkeypatch.setattr(
                sys, "argv", ["bus_printer.py"] + argv), jax_printer.main())),
            ("port", bus_printer.main)):
        run(["--journal", journals[name], "--max-print", "2",
             "--fields", "sha1"])
        printed[name] = capsys.readouterr().out
    assert printed["port"] == printed["jax"]
    assert printed["port"].count("[BusPrinter: msg]") == 2
