"""Conf-driven assembly of the serving stack from flat prefix-JSON configs
(port of columbiaimagesearch_tpu/common/factory.py:28-106, 233-261:
``build_indexer``, ``build_storer``, ``build_extractor``,
``build_searcher``, ``generate_conf_searcher``). The ingest, pusher,
checker and processor builders wait for the pipeline slice (ROADMAP.md,
still to port #15).

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
        # "auto" (default) and "float32" serve an exact float32 store;
        # the bfloat16 store is not ported yet.
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
