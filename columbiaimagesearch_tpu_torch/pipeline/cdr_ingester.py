"""CDR ElasticSearch -> bus bridge (gated: requires an ES client).

Copy of columbiaimagesearch_tpu/pipeline/cdr_ingester.py:1-153.

Functional port of the reference's deprecated ``CDRIngester``
(reference: cufacesearch/cufacesearch/ingester/kafka_cdr_ingester.py:1-120):
scroll-paginate crawled CDR documents out of an ElasticSearch index and
push each document's ``_source`` onto the image bus, where the normal
downloader/processor pipeline picks them up. The reference hardwires a
``KafkaProducer``; here the output is ANY :class:`GenericPusher`
(MemoryBus locally, Kafka/Kinesis in broker deployments), and the ES
client is injectable so the scroll/retry logic is testable without a
cluster (the ``elasticsearch`` package is not a dependency of the package).

Retry semantics match the reference: both the initial search and every
scroll page retry forever on client exceptions with a fixed pause —
the source is a flaky long-lived crawl store and the bridge is a
crash-only batch job.
"""

import time

from columbiaimagesearch_tpu_torch.common.conf_reader import ConfReader

DEFAULT_BATCH_SIZE = 10
RETRY_SLEEP_S = 10.0


def _require_elasticsearch():
    try:
        import elasticsearch

        return elasticsearch
    except ImportError as err:
        raise ImportError(
            "CDRIngester requires the 'elasticsearch' package and a "
            "reachable cluster; inject `client=` for tests.") from err


class CDRIngester:
    """Scroll a CDR index and push documents to the bus.

    :param pusher: any ``GenericPusher`` (``send(msg)``); the reference's
        KafkaProducer role.
    :param client: injectable ES-like client exposing ``search(...)`` and
        ``scroll(scroll_id=..., scroll=...)``; built lazily from the
        connection params when omitted.
    :param obj_stored_prefix: prefix under which crawled objects were
        stored (the reference reads it from conf; technically the ES
        ``_meta`` mapping owns it, kafka_cdr_ingester.py:30-32).
    """

    def __init__(self, pusher, es_index=None, es_doc_type=None,
                 es_instance=None, es_user=None, es_pass=None,
                 obj_stored_prefix=None, batch_size=DEFAULT_BATCH_SIZE,
                 client=None, verbose=0, sleep_fn=time.sleep):
        self.pusher = pusher
        self.els_index = es_index
        self.els_doc_type = es_doc_type
        self.els_instance = es_instance
        self.els_user = es_user
        self.els_pass = es_pass
        self.obj_stored_prefix = obj_stored_prefix
        self.batch_size = int(batch_size)
        self.verbose = verbose
        self._client = client
        self._sleep = sleep_fn
        self.pp = "CDRIngester"

    @classmethod
    def from_conf(cls, global_conf, pusher, prefix="ES_", **kw):
        """Build from the prefix-JSON conf contract
        (reference: kafka_cdr_ingester.py:15-32 reads the same keys)."""
        r = ConfReader(global_conf, prefix=prefix)
        return cls(
            pusher,
            es_index=r.get_required_param("es_index"),
            es_doc_type=r.get_required_param("es_doc_type"),
            es_instance=r.get_required_param("es_instance"),
            es_user=r.get_required_param("es_user"),
            es_pass=r.get_required_param("es_pass"),
            obj_stored_prefix=r.get_required_param("obj_stored_prefix"),
            batch_size=r.get_param("batch_size", DEFAULT_BATCH_SIZE),
            verbose=r.get_param("verbose", 0), **kw)

    def get_prefix(self):
        return self.obj_stored_prefix

    def _ensure_client(self):
        if self._client is None:
            es = _require_elasticsearch()
            self._client = es.Elasticsearch(
                "https://%s:%s@%s" % (self.els_user, self.els_pass,
                                      self.els_instance))
        return self._client

    def _retry(self, what, fn):
        """Retry a flaky ES call forever with the reference's fixed pause
        (kafka_cdr_ingester.py:73-86,97-111). Programming errors
        (TypeError/AttributeError/NameError — e.g. a client API mismatch,
        not a flaky cluster) surface immediately instead of becoming a
        silent infinite loop; transient errors always log, so a stalled
        bridge is diagnosable at verbose=0."""
        while True:
            try:
                return fn()
            except (TypeError, AttributeError, NameError):
                raise
            except Exception as err:  # noqa: BLE001 — ES client errors vary
                print("[%s: log] ElasticSearch error during %s "
                      "(retrying in %ss): %s"
                      % (self.pp, what, RETRY_SLEEP_S, err))
                self._sleep(RETRY_SLEEP_S)

    def get_batch(self, team="HG"):
        """Return up to ``batch_size`` CDR hit dicts for a crawling team
        (reference: kafka_cdr_ingester.py:65-115)."""
        es = self._ensure_client()
        query = {"query": {"match": {"team": team}},
                 "size": self.batch_size}
        response = self._retry("search", lambda: es.search(
            index=self.els_index, doc_type=self.els_doc_type, body=query,
            scroll="5m"))
        hits = list(response.get("hits", {}).get("hits", []))
        scroll_id = response.get("_scroll_id")
        while scroll_id and len(hits) < self.batch_size:
            response = self._retry("scroll", lambda: es.scroll(
                scroll_id=scroll_id, scroll="5m"))
            page = response.get("hits", {}).get("hits", [])
            if not page:
                break
            hits.extend(page)
            scroll_id = response.get("_scroll_id")
        return hits[: self.batch_size]

    def push_batch(self, team="HG"):
        """Pull one batch and push each document's ``_source`` to the bus
        (reference: kafka_cdr_ingester.py:116-120). Returns the count.

        Sends the dict as-is: serialization is the pusher backend's
        concern (KafkaPusher's value_serializer json-encodes; MemoryBus
        carries dicts natively), unlike the reference which hardwires
        ``json.dumps(...).encode()`` for its KafkaProducer."""
        docs = self.get_batch(team=team)
        if self.verbose > 0:
            print("[%s.push_batch: info] Got %d documents."
                  % (self.pp, len(docs)))
        n = 0
        for doc in docs:
            src = doc.get("_source")
            if src is None:
                continue
            self.pusher.send(src)
            n += 1
        return n
