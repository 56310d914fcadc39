"""Kinesis ingester/pusher backends (gated: requires boto3).

Copy of columbiaimagesearch_tpu/pipeline/kinesis_backend.py:1-113.

Functional ports of the reference's Kinesis plumbing
(reference: cufacesearch/ingester/kinesis_ingester.py:16-361 — shard
discovery, sequence-number resume journaled to a JSON file, expired-iterator
recovery; pusher/kinesis_pusher.py:24-150 — put_records with random
partition keys and optional stream creation) behind the common bus contract.
boto3 is not a dependency of the package; classes import lazily with a clear
error and are exercised in AWS deployments.
"""

import json
import os
import random

from columbiaimagesearch_tpu_torch.pipeline.ingest import GenericIngester, GenericPusher


def _require_boto3():
    try:
        import boto3  # noqa: F401

        return boto3
    except ImportError as err:
        raise ImportError(
            "KinesisIngester/KinesisPusher require 'boto3' and AWS "
            "credentials; use MemoryBus locally.") from err


class KinesisIngester(GenericIngester):
    def __init__(self, stream, region=None, endpoint_url=None,
                 shard_infos_filename=None, verbose=0, client=None):
        if client is not None:
            # Injected client (tests use an in-memory fake; production can
            # pass a pre-configured boto3 kinesis client).
            self.client = client
        else:
            boto3 = _require_boto3()
            self.client = boto3.client("kinesis", region_name=region,
                                       endpoint_url=endpoint_url)
        self.stream = stream
        self.shard_infos_filename = shard_infos_filename
        self.shard_infos = {}
        if shard_infos_filename and os.path.exists(shard_infos_filename):
            with open(shard_infos_filename) as f:
                self.shard_infos = json.load(f)
        self.verbose = verbose

    def _journal(self):
        if self.shard_infos_filename:
            with open(self.shard_infos_filename, "w") as f:
                json.dump(self.shard_infos, f)

    def _iterator(self, shard_id):
        sqn = self.shard_infos.get(shard_id)
        if sqn:
            it = self.client.get_shard_iterator(
                StreamName=self.stream, ShardId=shard_id,
                ShardIteratorType="AFTER_SEQUENCE_NUMBER",
                StartingSequenceNumber=sqn)
        else:
            it = self.client.get_shard_iterator(
                StreamName=self.stream, ShardId=shard_id,
                ShardIteratorType="TRIM_HORIZON")
        return it["ShardIterator"]

    def get_msg_json(self):
        shards = self.client.describe_stream(
            StreamName=self.stream)["StreamDescription"]["Shards"]
        for shard in shards:
            shard_id = shard["ShardId"]
            iterator = self._iterator(shard_id)
            while iterator:
                try:
                    out = self.client.get_records(ShardIterator=iterator,
                                                  Limit=100)
                except self.client.exceptions.ExpiredIteratorException:
                    iterator = self._iterator(shard_id)
                    continue
                records = out.get("Records", [])
                if not records:
                    break
                for rec in records:
                    self.shard_infos[shard_id] = rec["SequenceNumber"]
                    yield json.loads(rec["Data"])
                self._journal()
                iterator = out.get("NextShardIterator")


class KinesisPusher(GenericPusher):
    def __init__(self, stream, region=None, endpoint_url=None,
                 create_stream=False, nb_shards=1, client=None):
        if client is not None:
            self.client = client
        else:
            boto3 = _require_boto3()
            self.client = boto3.client("kinesis", region_name=region,
                                       endpoint_url=endpoint_url)
        self.stream = stream
        if create_stream:
            try:
                self.client.create_stream(StreamName=stream,
                                          ShardCount=nb_shards)
            except Exception:
                pass  # already exists

    def send(self, msg):
        self.client.put_records(
            StreamName=self.stream,
            Records=[{
                "Data": json.dumps(msg).encode(),
                "PartitionKey": f"{random.getrandbits(80):020x}",
            }])
