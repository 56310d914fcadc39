"""Conf-driven assembly of the full stack from flat prefix-JSON configs
(port of columbiaimagesearch_tpu/common/factory.py:1-339: the serving
builders ``build_indexer``, ``build_storer``, ``build_extractor`` and
``build_searcher``, the pipeline builders ``build_ingester``,
``build_pusher``, ``build_checker`` and ``build_processor``, and the
env-var generators). ``build_extractor``, ``build_searcher`` and
``build_processor`` take a ``device`` (default: the first card; raises
without one).

The role of the reference's per-component ConfReader constructors and the
env-var conf generators (reference: setup/ConfGenerator/create_conf_
{ingester,extractor,searcher}.py; conf/*.json): one flat JSON dict wires
every component through key prefixes. Reference prefixes are kept where the
component survives (``SEARCHLOPQ_``, ``ST_``, ``EXTR_``); the HBase prefix
``HBI_`` becomes ``KVI_`` for the embedded store.

Example conf (see conf/ for full samples):

    {
      "SEARCHLOPQ_model_type": "lopq_pca",
      "SEARCHLOPQ_lopq_V": 4096, "SEARCHLOPQ_lopq_M": 8,
      "SEARCHLOPQ_lopq_subq": 256, "SEARCHLOPQ_lopq_pcadims": 256,
      "SEARCHLOPQ_nb_train": 2000000, "SEARCHLOPQ_reranking": true,
      "SEARCHLOPQ_featurizer_type": "sentibank",
      "KVI_db_path": "/data/cuimgsearch.db",
      "ST_storer_type": "local", "ST_base_path": "/data/storer"
    }
"""

import os

from columbiaimagesearch_tpu_torch.common.conf_reader import ConfReader


def build_indexer(conf, prefix="KVI_"):
    from columbiaimagesearch_tpu_torch.store.kvindexer import KVIndexer

    r = ConfReader(conf, prefix)
    return KVIndexer(
        path=r.get_param("db_path", ":memory:"),
        table_sha1infos=r.get_param("table_sha1infos", "images"),
        table_updateinfos=r.get_param("table_updateinfos", "updates"),
        batch_update_size=int(r.get_param("batch_update_size", 1000)))


def build_storer(conf, prefix="ST_"):
    from columbiaimagesearch_tpu_torch.store.storer import get_storer

    r = ConfReader(conf, prefix)
    return get_storer(r.get_param("storer_type", "local"),
                      base_path=r.get_param("base_path", "./storer_data"))


def build_extractor(conf, prefix="EXTR_", device=None):
    from columbiaimagesearch_tpu_torch.extraction.extractor import GenericExtractor

    r = ConfReader(conf, prefix)
    return GenericExtractor(
        detector_type=r.get_param("detector_type", "full"),
        featurizer_type=r.get_param("featurizer_type", "sentibank"),
        input_type=r.get_param("input_type", "image"), device=device)


def build_searcher(conf, prefix="SEARCHLOPQ_", indexer=None, storer=None,
                   device=None):
    """The ``SearcherLOPQ`` facade of ``conf``, on ``device`` (default: the
    first card; raises without one)."""
    from columbiaimagesearch_tpu_torch.searcher.searcher_lopq import SearcherLOPQ

    r = ConfReader(conf, prefix)
    if indexer is None:
        indexer = build_indexer(conf, r.get_param("indexer_prefix", "KVI_"))
    if storer is None:
        storer = build_storer(conf, r.get_param("storer_prefix", "ST_"))
    return SearcherLOPQ(
        model_type=r.get_param("model_type", "lopq"),
        V=int(r.get_param("lopq_V", 256)),
        M=int(r.get_param("lopq_M", 8)),
        subquantizer_clusters=int(r.get_param("lopq_subq", 256)),
        pca_dims=int(r.get_param("lopq_pcadims", 256)),
        nb_train=int(r.get_param("nb_train", 100000)),
        nb_min_train=int(r.get_param("nb_min_train", 1000)),
        nb_train_pca=int(r.get_param("nb_train_pca", 50000)),
        train_at_init=bool(r.get_param("train_at_init", False)),
        detector_type=r.get_param("detector_type", "full"),
        featurizer_type=r.get_param("featurizer_type", "sentibank"),
        input_type=r.get_param("input_type", "image"),
        sim_limit=int(r.get_param("sim_limit", 100)),
        near_dup=bool(r.get_param("near_dup", False)),
        near_dup_th=float(r.get_param("near_dup_th", 0.8)),
        reranking=bool(r.get_param("reranking", False)),
        rerank_nb=int(r.get_param("rerank_nb", 1000)),
        file_input=bool(r.get_param("file_input", False)),
        sharded=bool(r.get_param("sharded", False)),
        exact=bool(r.get_param("exact", False)),
        codestore_path=r.get_param("codestore_path"),
        # Device-resident rerank store (index-space features on the card)
        # — makes `reranking: true` (the reference release config) run on
        # the device instead of detouring through the indexer.
        store_rerank_feats=bool(r.get_param("store_rerank_feats", False)),
        # "auto" (default) plans float32 or bfloat16 from the rows and the
        # card's memory; "float32" and "bfloat16" force a dtype.
        rerank_dtype=r.get_param("rerank_dtype", "auto"),
        # Expected index size (rows): pre-sizes device buffers so
        # production refreshes append in place.
        capacity_hint=int(r.get_param("capacity_hint", 0)),
        # Cross-request micro-batching window (ms); None/absent = off
        # (api/microbatch.py).
        coalesce_window_ms=(
            float(r.get_param("coalesce_window_ms"))
            if r.get_param("coalesce_window_ms") is not None else None),
        coalesce_max_batch=int(r.get_param("coalesce_max_batch", 32)),
        indexer=indexer, storer=storer,
        verbose=int(r.get_param("verbose", 0)), device=device)


def _decode_servers(servers):
    """Kafka broker lists arrive from env as JSON-encoded strings
    (reference create_conf_ingester.py kafka_servers); decode to a list."""
    if isinstance(servers, str) and servers.lstrip().startswith("["):
        import json

        return json.loads(servers)
    return servers


def build_ingester(conf, prefix="IMG_ING_"):
    """Conf -> image ingester: local dir / Kafka / Kinesis
    (the role of the reference's ingester conf wiring,
    ingester/kafka_ingester.py:20-60, kinesis_ingester.py:16-69)."""
    r = ConfReader(conf, prefix)
    input_type = r.get_param("input_type", "local")
    if input_type == "local":
        from columbiaimagesearch_tpu_torch.pipeline.ingest import (
            LocalDirIngester,
        )

        return LocalDirIngester(
            r.get_required_param("input_path"),
            source_archive=r.get_param("source_zip",
                                       r.get_param("source_archive")))
    elif input_type == "kafka":
        from columbiaimagesearch_tpu_torch.pipeline.kafka_backend import (
            KafkaIngester,
        )

        return KafkaIngester(
            r.get_required_param("topic_name"),
            servers=_decode_servers(r.get_param("servers")),
            group=r.get_param("consumer_group"),
            consumer_options=r.get_param("consumer_options"))
    elif input_type == "kinesis":
        from columbiaimagesearch_tpu_torch.pipeline.kinesis_backend import (
            KinesisIngester,
        )

        return KinesisIngester(
            r.get_required_param("stream_name"),
            region=r.get_param("region_name"),
            endpoint_url=r.get_param("endpoint_url"),
            shard_infos_filename=r.get_param("shard_infos_filename"))
    raise ValueError(f"Unknown input_type: {input_type}")


def build_pusher(conf, prefix="IMG_PUSH_", bus=None):
    """Conf -> message pusher: memory bus / Kafka / Kinesis
    (reference: pusher/kafka_pusher.py:22-148, kinesis_pusher.py:24-150)."""
    r = ConfReader(conf, prefix)
    pushing_type = r.get_param("image_pushing_type",
                               r.get_param("pushing_type", "memory"))
    if pushing_type == "memory":
        from columbiaimagesearch_tpu_torch.pipeline.ingest import (
            MemoryBus,
            MemoryBusPusher,
        )

        bus = bus if bus is not None else MemoryBus(
            journal_path=r.get_param("journal_path"))
        return MemoryBusPusher(bus, r.get_param("topic_name", "images"))
    elif pushing_type == "kafka":
        from columbiaimagesearch_tpu_torch.pipeline.kafka_backend import (
            KafkaPusher,
        )

        return KafkaPusher(r.get_required_param("topic_name"),
                           servers=_decode_servers(r.get_param("servers")))
    elif pushing_type == "kinesis":
        from columbiaimagesearch_tpu_torch.pipeline.kinesis_backend import (
            KinesisPusher,
        )

        return KinesisPusher(
            r.get_required_param("stream_name"),
            region=r.get_param("region_name"),
            endpoint_url=r.get_param("endpoint_url"),
            create_stream=bool(r.get_param("create_stream", False)),
            nb_shards=int(r.get_param("nb_shards", 1)))
    raise ValueError(f"Unknown pushing_type: {pushing_type}")


def build_checker(conf, prefix="CHECK_", indexer=None, ingester=None,
                  pusher=None):
    from columbiaimagesearch_tpu_torch.extraction.extractor import (
        build_extr_str,
    )
    from columbiaimagesearch_tpu_torch.pipeline.checker import (
        ExtractionChecker,
    )
    from columbiaimagesearch_tpu_torch.pipeline.ingest import LocalDirIngester

    r = ConfReader(conf, prefix)
    if indexer is None:
        indexer = build_indexer(conf, r.get_param("indexer_prefix", "KVI_"))
    if ingester is None:
        # ingest_type selects where image messages come from: "local"
        # walks CHECK_input_dir; "kafka"/"kinesis"/"memory" delegate to
        # build_ingester under the IMG_ING_ prefix (the reference's
        # checker consumes its images topic the same way,
        # updater/extraction_checker.py:86-101).
        ingest_type = r.get_param("ingest_type", "local")
        if ingest_type == "local":
            ingester = LocalDirIngester(r.get_required_param("input_dir"))
        else:
            ingester = build_ingester(
                conf, r.get_param("ingester_prefix", "IMG_ING_"))
    extr_str = build_extr_str(r.get_param("featurizer_type", "sentibank"),
                              r.get_param("detector_type", "full"),
                              r.get_param("input_type", "image"))
    return ExtractionChecker(
        indexer, extr_str, ingester, pusher=pusher,
        batch_update_size=int(r.get_param("batch_update_size", 1000)),
        max_delay=int(r.get_param("max_delay", 600)))


def build_processor(conf, prefix="PROC_", indexer=None, extractor=None,
                    device=None):
    """The ``ExtractionProcessor`` of ``conf``; its extractor (built from
    the ``EXTR_`` keys unless given) runs on ``device`` (default: the
    first card; raises without one)."""
    from columbiaimagesearch_tpu_torch.pipeline.processor import (
        ExtractionProcessor,
    )

    r = ConfReader(conf, prefix)
    if indexer is None:
        indexer = build_indexer(conf, r.get_param("indexer_prefix", "KVI_"))
    if extractor is None:
        extractor = build_extractor(
            conf, r.get_param("extractor_prefix", "EXTR_"), device=device)
    return ExtractionProcessor(
        indexer, extractor,
        nb_threads=int(r.get_param("nb_threads", 8)))


# ----------------------------------------------------------- env generators

def generate_conf_searcher(env=None):
    """env vars -> searcher conf dict
    (reference: setup/ConfGenerator/create_conf_searcher.py:72-105)."""
    env = env if env is not None else os.environ
    conf = {}
    mapping = {
        "model_type": "SEARCHLOPQ_model_type",
        "lopq_V": "SEARCHLOPQ_lopq_V",
        "lopq_M": "SEARCHLOPQ_lopq_M",
        "lopq_subq": "SEARCHLOPQ_lopq_subq",
        "lopq_pcadims": "SEARCHLOPQ_lopq_pcadims",
        "nb_train": "SEARCHLOPQ_nb_train",
        "nb_train_pca": "SEARCHLOPQ_nb_train_pca",
        "reranking": "SEARCHLOPQ_reranking",
        "store_rerank_feats": "SEARCHLOPQ_store_rerank_feats",
        "coalesce_window_ms": "SEARCHLOPQ_coalesce_window_ms",
        "coalesce_max_batch": "SEARCHLOPQ_coalesce_max_batch",
        "extr_type": "SEARCHLOPQ_featurizer_type",
        "input_type": "SEARCHLOPQ_input_type",
        "storer_type": "ST_storer_type",
        "storer_base_path": "ST_base_path",
        "db_path": "KVI_db_path",
    }
    for envk, confk in mapping.items():
        for candidate in (envk, envk.upper()):
            if candidate in env:
                conf[confk] = env[candidate]
                break
    return conf


def generate_conf_ingester(env=None):
    """env vars -> ingester/pusher conf dict
    (reference: setup/ConfGenerator/create_conf_ingester.py: required
    input_type/images_topic, local input_path/source_zip, kafka
    input_topic/input_consumer_group/kafka_servers, kinesis
    input_stream/region_name/endpoint_url, pusher image_pushing_type +
    images_topic/images_stream/create_stream/nb_shards)."""
    env = env if env is not None else os.environ

    def get(*names, default=None):
        for n in names:
            for candidate in (n, n.upper()):
                if candidate in env:
                    return env[candidate]
        return default

    conf = {}
    input_type = get("input_type", default="local")
    conf["IMG_ING_input_type"] = input_type
    if input_type == "local":
        conf["IMG_ING_input_path"] = get(
            "input_path", default="./data/input_images/")
        if get("source_zip"):
            conf["IMG_ING_source_zip"] = get("source_zip")
    elif input_type == "kafka":
        conf["IMG_ING_topic_name"] = get("input_topic")
        conf["IMG_ING_consumer_group"] = get("input_consumer_group")
        if get("kafka_servers"):
            conf["IMG_ING_servers"] = get("kafka_servers")
    elif input_type == "kinesis":
        conf["IMG_ING_stream_name"] = get("input_stream")
        conf["IMG_ING_region_name"] = get("region_name")
        if get("endpoint_url"):
            conf["IMG_ING_endpoint_url"] = get("endpoint_url")
        if get("shard_infos_filename"):
            conf["IMG_ING_shard_infos_filename"] = get("shard_infos_filename")

    pushing_type = get("image_pushing_type", default="memory")
    conf["IMG_PUSH_image_pushing_type"] = pushing_type
    if pushing_type == "kafka":
        conf["IMG_PUSH_topic_name"] = get("images_topic")
        if get("kafka_servers"):
            conf["IMG_PUSH_servers"] = get("kafka_servers")
    elif pushing_type == "kinesis":
        conf["IMG_PUSH_stream_name"] = get("images_stream")
        conf["IMG_PUSH_region_name"] = get("region_name")
        if get("endpoint_url"):
            conf["IMG_PUSH_endpoint_url"] = get("endpoint_url")
        conf["IMG_PUSH_create_stream"] = bool(int(get("create_stream",
                                                      default="0")))
        conf["IMG_PUSH_nb_shards"] = int(get("nb_shards", default="1"))
    else:
        conf["IMG_PUSH_topic_name"] = get("images_topic", default="images")
    return conf


def generate_conf_extractor(env=None):
    """(reference: setup/ConfGenerator/create_conf_extractor.py)"""
    env = env if env is not None else os.environ
    conf = {}
    mapping = {
        "extr_type": "EXTR_featurizer_type",
        "detector_type": "EXTR_detector_type",
        "input_type": "EXTR_input_type",
        "input_dir": "CHECK_input_dir",
        "ingest_type": "CHECK_ingest_type",
        "batch_update_size": "CHECK_batch_update_size",
        "db_path": "KVI_db_path",
        "nb_threads": "PROC_nb_threads",
    }
    for envk, confk in mapping.items():
        for candidate in (envk, envk.upper()):
            if candidate in env:
                conf[confk] = env[candidate]
                break
    return conf
