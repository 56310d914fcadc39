"""The port's ``CDRIngester`` (``pipeline/cdr_ingester.py``) against the
JAX package's, each with its own copy of the in-memory ES fake of
tests/test_cdr_ingester.py: scroll pagination, retries with a pause, the
documents pushed onto the bus and the conf reader give equal outputs.
Without ``client=`` and without the ``elasticsearch`` package (not
installed) it raises an ``ImportError`` naming the package.
"""

import pytest

from columbiaimagesearch_tpu_torch.pipeline.cdr_ingester import CDRIngester
from columbiaimagesearch_tpu_torch.pipeline.ingest import (
    MemoryBus,
    MemoryBusPusher,
)

from tests.test_cdr_ingester import FakeES, _docs


def _classes():
    from columbiaimagesearch_tpu.pipeline.cdr_ingester import (
        CDRIngester as JaxCDRIngester,
    )
    from columbiaimagesearch_tpu.pipeline.ingest import (
        MemoryBus as JaxBus,
        MemoryBusPusher as JaxPusher,
    )

    return {"jax": (JaxCDRIngester, JaxBus, JaxPusher),
            "port": (CDRIngester, MemoryBus, MemoryBusPusher)}


@pytest.mark.parametrize("case", [
    dict(n=20, page=3, batch=10),
    dict(n=4, page=3, batch=10),
    dict(n=8, page=3, batch=8, fail_first_search=True,
         fail_scroll_ids={"s3"}),
])
def test_get_batch_matches_jax(case):
    out = {}
    for name, (cls, _, _) in _classes().items():
        es = FakeES(_docs(case["n"]), page=case["page"],
                    fail_first_search=case.get("fail_first_search", False),
                    fail_scroll_ids=case.get("fail_scroll_ids", ()))
        sleeps = []
        hits = cls(pusher=None, batch_size=case["batch"], client=es,
                   sleep_fn=sleeps.append).get_batch()
        out[name] = (hits, sleeps, es.search_calls, es.scroll_calls)
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) == min(case["n"], case["batch"])


def test_push_batch_and_from_conf_match_jax():
    conf = {"ES_es_index": "memex-domains", "ES_es_doc_type": "domain",
            "ES_es_instance": "es.example.org", "ES_es_user": "u",
            "ES_es_pass": "p", "ES_obj_stored_prefix": "https://s3/bucket/",
            "ES_batch_size": 5}
    out = {}
    for name, (cls, bus_cls, pusher_cls) in _classes().items():
        bus = bus_cls()
        ing = cls.from_conf(conf, pusher=pusher_cls(bus, "cdr"),
                            client=FakeES(_docs(5), page=2))
        out[name] = (ing.push_batch(), bus.topics["cdr"], ing.els_index,
                     ing.batch_size, ing.get_prefix())
    assert out["port"] == out["jax"]
    assert out["port"][0] == 5 and out["port"][3] == 5


def test_missing_elasticsearch_raises_naming_it():
    ing = CDRIngester(pusher=None, es_instance="es.example.org")
    with pytest.raises(ImportError, match="elasticsearch"):
        ing.get_batch()
