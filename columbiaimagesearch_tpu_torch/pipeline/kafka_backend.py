"""Kafka ingester/pusher backends (gated: requires kafka-python).

Copy of columbiaimagesearch_tpu/pipeline/kafka_backend.py:1-81.

Functional ports of the reference's Kafka plumbing
(reference: cufacesearch/ingester/kafka_ingester.py:20-251,
pusher/kafka_pusher.py:22-148) behind the same two-method bus contract as
the in-process backends (``get_msg_json`` / ``send``). kafka-python is not
a dependency of the package, so these classes import lazily and raise a clear
error when the dependency is missing; they are exercised in deployments
that have a broker.
"""

import json

from columbiaimagesearch_tpu_torch.common.profiling import ThroughputStats
from columbiaimagesearch_tpu_torch.pipeline.ingest import GenericIngester, GenericPusher


def _require_kafka():
    try:
        import kafka  # noqa: F401

        return kafka
    except ImportError as err:
        raise ImportError(
            "KafkaIngester/KafkaPusher require the 'kafka-python' package "
            "and a reachable broker; use MemoryBus locally.") from err


class KafkaIngester(GenericIngester):
    """Consumer-group reader with offset commits and periodic stats
    (the reference commits every poll and prints stats per 1000 messages)."""

    def __init__(self, topic, servers=None, group=None, consumer_options=None,
                 poll_timeout_ms=10_000, verbose=0, consumer=None):
        if consumer is not None:
            # Injected consumer (tests use an in-memory fake; production can
            # pass a pre-configured KafkaConsumer, e.g. with SSL certs).
            self.consumer = consumer
        else:
            kafka = _require_kafka()
            opts = dict(consumer_options or {})
            self.consumer = kafka.KafkaConsumer(
                topic, bootstrap_servers=servers, group_id=group,
                value_deserializer=lambda v: json.loads(v.decode()),
                enable_auto_commit=False, **opts)
        self.poll_timeout_ms = poll_timeout_ms
        self.stats = ThroughputStats("KafkaIngester", report_every=1000)
        self.verbose = verbose

    def get_msg_json(self):
        while True:
            polled = self.consumer.poll(timeout_ms=self.poll_timeout_ms)
            if not polled:
                return
            for records in polled.values():
                for record in records:
                    self.stats.toc_ok()
                    yield record.value
            self.consumer.commit()


class KafkaPusher(GenericPusher):
    def __init__(self, topic, servers=None, producer_options=None,
                 producer=None):
        self.topic = topic
        if producer is not None:
            self.producer = producer
        else:
            kafka = _require_kafka()
            opts = dict(producer_options or {})
            self.producer = kafka.KafkaProducer(
                bootstrap_servers=servers,
                value_serializer=lambda v: json.dumps(v).encode(), **opts)
        self.stats = ThroughputStats("KafkaPusher", report_every=1000)

    def send(self, msg):
        self.producer.send(self.topic, msg)
        self.stats.toc_ok()

    def flush(self):
        self.producer.flush()
