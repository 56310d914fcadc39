"""The port's bus backends (``pipeline/kafka_backend.py``,
``pipeline/kinesis_backend.py``, ``pipeline/ingest.py``'s ``MemoryBus``)
against the JAX package's, both driven through the in-memory fakes of
tests/test_bus_backends.py: each case runs once per package on its own
fake and the outputs (messages in order, commits, journals) must be equal.
Neither ``kafka-python`` nor ``boto3`` is installed, so building a
backend without an injected client raises an ``ImportError`` that names
the package, in both.
"""

import itertools
import json

import pytest

from columbiaimagesearch_tpu_torch.pipeline import ingest as t_ingest
from columbiaimagesearch_tpu_torch.pipeline import kafka_backend as t_kafka
from columbiaimagesearch_tpu_torch.pipeline import kinesis_backend as t_kin

from tests.test_bus_backends import (
    FakeKafkaConsumer,
    FakeKafkaProducer,
    FakeKinesisClient,
)


def _packages():
    from columbiaimagesearch_tpu.pipeline import ingest as j_ingest
    from columbiaimagesearch_tpu.pipeline import kafka_backend as j_kafka
    from columbiaimagesearch_tpu.pipeline import kinesis_backend as j_kin

    return {"jax": (j_ingest, j_kafka, j_kin),
            "port": (t_ingest, t_kafka, t_kin)}


def _both(run):
    """``run(ingest, kafka, kinesis, tag)`` for each package; returns the
    port's result after checking it equals the JAX package's."""
    out = {name: run(*mods, name) for name, mods in _packages().items()}
    assert out["port"] == out["jax"]
    return out["port"]


def test_kafka_ingester_and_pusher_match_jax():
    def run(_, kafka, __, ___):
        consumer = FakeKafkaConsumer([[{"sha1": "a"}, {"sha1": "b"}],
                                      [{"sha1": "c"}]])
        ing = kafka.KafkaIngester("topic", consumer=consumer)
        first = [m["sha1"] for m in ing.get_msg_json()]
        again = list(ing.get_msg_json())
        prod = FakeKafkaProducer()
        p = kafka.KafkaPusher("updates", producer=prod)
        p.send({"update_id": "u1"})
        p.send({"update_id": "u2"})
        p.flush()
        return first, again, consumer.commits, prod.sent, prod.flushed

    first, again, commits, sent, flushed = _both(run)
    assert first == ["a", "b", "c"] and again == [] and commits == 2
    assert len(sent) == 2 and flushed == 1


def test_kinesis_roundtrip_resume_and_journal_match_jax(tmp_path):
    def run(_, __, kin, tag):
        client = FakeKinesisClient(shards=2)
        journal = str(tmp_path / f"{tag}_shards.json")
        p = kin.KinesisPusher("s", client=client)
        for i in range(5):
            p.send({"sha1": f"old{i}"})
        got1 = sorted(m["sha1"] for m in kin.KinesisIngester(
            "s", shard_infos_filename=journal, client=client).get_msg_json())
        for i in range(3):
            p.send({"sha1": f"new{i}"})
        got2 = sorted(m["sha1"] for m in kin.KinesisIngester(
            "s", shard_infos_filename=journal, client=client).get_msg_json())
        with open(journal) as f:
            infos = json.load(f)
        last = {s: recs[-1]["SequenceNumber"]
                for s, recs in client.shards.items() if recs}
        return got1, got2, infos == last

    got1, got2, journal_ok = _both(run)
    assert got1 == sorted(f"old{i}" for i in range(5))
    assert got2 == ["new0", "new1", "new2"] and journal_ok


def test_kinesis_expired_iterator_and_create_stream_match_jax():
    def run(_, __, kin, ___):
        client = FakeKinesisClient(shards=1)
        p = kin.KinesisPusher("s", client=client)
        p.send({"sha1": "x"})
        p.send({"sha1": "y"})
        client.expired.add("shardId-000000000000:0")
        orig, calls = client.get_records, {"n": 0}

        def flaky(ShardIterator, Limit=100):
            calls["n"] += 1
            if calls["n"] == 1:
                try:
                    return orig(ShardIterator, Limit)
                finally:
                    client.expired.clear()
            return orig(ShardIterator, Limit)

        client.get_records = flaky
        got = sorted(m["sha1"] for m in kin.KinesisIngester(
            "s", client=client).get_msg_json())
        made = FakeKinesisClient()
        kin.KinesisPusher("mystream", create_stream=True, nb_shards=4,
                          client=made)
        return got, calls["n"], made.created

    got, n_calls, created = _both(run)
    assert got == ["x", "y"] and n_calls >= 2
    assert created == [("mystream", 4)]


def test_memory_bus_journal_replay_and_compact_match_jax(tmp_path):
    """Messages and committed offsets survive a restart from the journal,
    and a compacted journal replays to the same state."""
    def run(ingest, _, __, tag):
        path = str(tmp_path / f"{tag}_bus.jsonl")
        bus = ingest.MemoryBus(journal_path=path)
        pusher = ingest.MemoryBusPusher(bus, "images")
        for i in range(5):
            pusher.send({"sha1": f"h{i}"})
        ing = ingest.MemoryBusIngester(bus, "images", "g")
        first = [m["sha1"] for m in itertools.islice(ing.get_msg_json(), 2)]
        bus._jf.close()
        bus2 = ingest.MemoryBus(journal_path=path)
        rest = [m["sha1"] for m in
                ingest.MemoryBusIngester(bus2, "images", "g").get_msg_json()]
        bus2.compact()
        bus2._jf.close()
        bus3 = ingest.MemoryBus(journal_path=path)
        with open(path) as f:
            n_lines = sum(1 for _ in f)
        state = (bus3.topics, bus3.offsets)
        bus3._jf.close()
        return first, rest, n_lines, state

    first, rest, n_lines, (topics, offsets) = _both(run)
    assert first == ["h0", "h1"] and rest == ["h2", "h3", "h4"]
    assert n_lines == 1 and offsets == {"images:g": 5}
    assert len(topics["images"]) == 5


@pytest.mark.parametrize("which", ["kafka_ingester", "kafka_pusher",
                                   "kinesis_ingester", "kinesis_pusher"])
def test_missing_package_raises_naming_it(which):
    cls, arg, name = {
        "kafka_ingester": (t_kafka.KafkaIngester, "topic", "kafka-python"),
        "kafka_pusher": (t_kafka.KafkaPusher, "topic", "kafka-python"),
        "kinesis_ingester": (t_kin.KinesisIngester, "s", "boto3"),
        "kinesis_pusher": (t_kin.KinesisPusher, "s", "boto3"),
    }[which]
    with pytest.raises(ImportError, match=name):
        cls(arg)
