"""LOPQ searcher orchestration: model lifecycle, incremental indexing, query
(port of columbiaimagesearch_tpu/searcher/searcher_lopq.py:1-646).

Re-design of the reference's SearcherLOPQHBase
(reference: cufacesearch/searcher/searcher_lopqhbase.py:25-1067):

- model lifecycle: load the pickled model from the storer (the port's
  models pickle as numpy in the JAX npz layout and unpickle on the host)
  and place it, or the model handed in, on the facade's ``device``
  (default: the first card; raises without one, so a missing card never
  turns into a silent CPU run); else, with ``train_at_init``, harvest
  training features from the indexer's updates, train (``lopq`` /
  ``lopq_pca``) on that device and save the model in the storer;
- incremental ``load_codes``: per-update code dicts cached in the storer
  (``<model_str>_codes/<update_id>``), an indexed-updates set persisted so
  restarts resume where they left off;
- the query path ``search_from_feats`` keeps the reference semantics —
  L2-normalize, quota = min(1000*max_returned, 10000), optional exact
  reranking with re-sort, near-dup threshold filter, s3_url info fetch —
  with reranking on the device when the feature store is resident.

Backends: ``LOPQSearcherTorch`` (the probed multi-index), with
``sharded=True`` the row-sharded ``parallel.sharded.ShardedLOPQSearcher``
over every visible card (one CPU shard on a CPU facade), or with
``exact=True`` (which wins) the port's ``ExhaustiveADCSearcher``. The face
configuration (``detector_type="face"``, ``featurizer_type="face"``,
conf/conf_search_face_local.json) runs on the port's conv-HOG detector and
FaceResNet embedder (models/face_detector.py, models/face.py): each
detected face is a query of the wave, with ids ``<sha1>_<bbox>``.
``codestore_path`` backs the probed searcher with the native code store
(searcher_lopq.py:52, 134); ``rerank_dtype`` ("auto", "float32",
"bfloat16") and ``capacity_hint`` go to the probed and sharded searchers.
"""

import time

import numpy as np
import torch

from columbiaimagesearch_tpu_torch.common.profiling import span
from columbiaimagesearch_tpu_torch.index.model import LOPQModel, LOPQModelPCA
from columbiaimagesearch_tpu_torch.index.searcher import LOPQSearcherTorch
from columbiaimagesearch_tpu_torch.searcher.generic_searcher import GenericSearcher

START_DATE = "1970-01-01"


def _host(f):
    """A query feature as a float32 numpy array (tensors on any device)."""
    if isinstance(f, torch.Tensor):
        f = f.detach().cpu().numpy()
    return np.asarray(f, dtype=np.float32)


class SearcherLOPQ(GenericSearcher):
    def __init__(self, model_type="lopq", V=256, M=8,
                 subquantizer_clusters=256, pca_dims=256, nb_train=100000,
                 nb_min_train=1000, nb_train_pca=50000, model=None,
                 train_at_init=False, probe_width=None, sharded=False,
                 exact=False, codestore_path=None, store_rerank_feats=False,
                 rerank_dtype="auto", capacity_hint=0, **kwargs):
        self.sharded = sharded
        self.exact = exact
        #: keep index-space features resident on the device at indexing
        #: time so reranking runs there (reference production config
        #: serves with reranking on, conf_search_sbpycaffe_release.json:16)
        self.store_rerank_feats = store_rerank_feats
        #: rerank-store dtype: "float32", "bfloat16" or "auto" (float32
        #: while one store copy fits the device, see LOPQSearcherTorch)
        self.rerank_dtype = rerank_dtype
        #: expected index size; pre-sizes device buffers so production
        #: refreshes append in place
        self.capacity_hint = int(capacity_hint)
        self.codestore_path = codestore_path
        self.model_type = model_type
        self.V = V
        self.M = M
        self.subquantizer_clusters = subquantizer_clusters
        self.pca_dims = pca_dims
        self.nb_train = nb_train
        self.nb_min_train = nb_min_train
        self.nb_train_pca = nb_train_pca
        self.model = model
        self.train_at_init = train_at_init
        self.probe_width = probe_width
        self.searcher = None
        self.indexed_updates = set()
        self.last_refresh = time.time()
        super().__init__(**kwargs)

    # ----------------------------------------------------------- model str

    def get_model_params_str(self):
        """(reference: searcher_lopqhbase.py model string convention)"""
        if self.model_type == "lopq_pca":
            return f"-pca{self.pca_dims}-subq{self.subquantizer_clusters}" \
                   f"-V{self.V}-M{self.M}"
        return f"-subq{self.subquantizer_clusters}-V{self.V}-M{self.M}"

    def build_model_str(self):
        return (self.build_extr_str() + "_" + self.model_type
                + self.get_model_params_str())

    def _codes_key(self, update_id):
        return self.build_model_str() + "_codes/" + update_id

    def _indexed_key(self):
        return self.build_model_str() + "_indexed_updates"

    # -------------------------------------------------------- init / train

    def init_searcher(self):
        """Load or (optionally) train the model, then build the device
        searcher and load codes (reference: searcher_lopqhbase.py:104-223)."""
        model_str = self.build_model_str()
        if self.model is None and self.storer is not None:
            self.model = self.storer.load(model_str)
        if self.model is None and self.train_at_init:
            self.train_index()
        if self.model is not None:
            self.model = self.model.to(self.device)
            self._init_device_searcher()
            saved = (self.storer.load(self._indexed_key())
                     if self.storer is not None else None)
            if saved:
                self.indexed_updates = set(saved)
                # Re-add cached codes for known updates.
                for update_id in sorted(self.indexed_updates):
                    codes = (self.storer.load(self._codes_key(update_id))
                             if self.storer is not None else None)
                    if codes:
                        self.searcher.add_codes_from_dict(codes)
            self.load_codes()

    def _init_device_searcher(self):
        if self.exact:
            # Probe-free exact search (the exhaustive-ADC scan kernel).
            from columbiaimagesearch_tpu_torch.index.exhaustive_adc import (
                ExhaustiveADCSearcher,
            )

            self.searcher = ExhaustiveADCSearcher(self.model)
            return
        if self.sharded:
            # Row-shard the index over every visible card (the facade's
            # own device when it is the CPU).
            from columbiaimagesearch_tpu_torch.parallel.mesh import (
                SHARD_AXIS,
                make_mesh,
            )
            from columbiaimagesearch_tpu_torch.parallel.sharded import (
                ShardedLOPQSearcher,
            )

            mesh = make_mesh(axis=SHARD_AXIS,
                             devices=(None if self.device.type == "cuda"
                                      else [self.device]))
            self.searcher = ShardedLOPQSearcher(
                self.model, mesh=mesh, probe_width=self.probe_width,
                rerank_dtype=self.rerank_dtype,
                capacity_hint=self.capacity_hint)
            return
        self.searcher = LOPQSearcherTorch(
            self.model, probe_width=self.probe_width,
            codestore_path=self.codestore_path,
            rerank_dtype=self.rerank_dtype,
            capacity_hint=self.capacity_hint)

    def get_train_features(self, nb_features, start_date=START_DATE):
        """Harvest features from the indexer's updates
        (reference: searcher_lopqhbase.py:288-395)."""
        feats = []
        total = 0
        extr_str = self.build_extr_str()
        if self.indexer is None:
            return []
        for batch in self.indexer.get_updates_from_date(start_date,
                                                        extr_type=extr_str):
            for update_id, cols in batch:
                col_list = self.indexer.get_col_listsha1s()
                if col_list not in cols:
                    continue
                sha1s = cols[col_list]
                if isinstance(sha1s, bytes):
                    sha1s = sha1s.decode()
                sha1s = sha1s.split(",")
                _, fts = self.indexer.get_features_from_sha1s(
                    sha1s, extr_str, self.featurizer_type)
                feats.extend(fts)
                total += len(fts)
                if total >= nb_features:
                    return feats[:nb_features]
        return feats

    def train_index(self):
        """Train the LOPQ model on harvested features on the facade's
        device and save it in the storer
        (reference: searcher_lopqhbase.py:397-474)."""
        feats = self.get_train_features(self.nb_train)
        if len(feats) < self.nb_min_train:
            raise RuntimeError(
                f"Not enough features to train: {len(feats)} < "
                f"{self.nb_min_train}")
        data = np.ascontiguousarray(np.vstack(feats).astype(np.float32))
        kw = dict(n_init=1, random_state=0, V=self.V, M=self.M,
                  subquantizer_clusters=self.subquantizer_clusters,
                  device=self.device)
        if self.model_type == "lopq":
            model = LOPQModel.fit(data, **kw)
        elif self.model_type == "lopq_pca":
            model = LOPQModelPCA.fit(data, pca_dims=self.pca_dims,
                                     pca_subsample=self.nb_train_pca, **kw)
        else:
            raise ValueError(f"Unknown model_type {self.model_type}")
        self.model = model
        if self.storer is not None:
            self.storer.save(self.build_model_str(), model)

    # ------------------------------------------------------------ indexing

    def compute_codes(self, update_id, sha1s):
        """Encode one update's features and cache the code dict
        (reference: searcher_lopqhbase.py:482-524)."""
        out = self._compute_update(update_id, sha1s)
        return out[0] if out else {}

    def _compute_update(self, update_id, sha1s):
        """Encode one update; returns (codes_dict, sids, coarse, fine,
        index_space_feats) or None. The index-space features feed the
        device rerank store when ``store_rerank_feats`` is on."""
        extr_str = self.build_extr_str()
        sids, feats = self.indexer.get_features_from_sha1s(
            sha1s, extr_str, self.featurizer_type)
        if not sids:
            return None
        data = np.vstack(feats).astype(np.float32)
        coarse, fine = self.model.predict_batch(data)
        # One host conversion, not a scalar read per code element.
        co, fi = coarse.tolist(), fine.tolist()
        codes = {sid: (tuple(co[i]), tuple(fi[i]))
                 for i, sid in enumerate(sids)}
        if self.storer is not None:
            self.storer.save(self._codes_key(update_id), codes)
        feats_idx = (self.model.apply_PCA(data)
                     if isinstance(self.model, LOPQModelPCA) else data)
        return codes, sids, coarse, fine, feats_idx

    def _add_codes_dict(self, codes):
        """Add a cached codes dict, preserving the device rerank store
        when possible: with ``store_rerank_feats`` on, try to fetch the
        index-space features for the dict's ids first — a featureless add
        would irreversibly drop the whole store (LOPQSearcherTorch keeps it
        only while every indexed row has a feature)."""
        if (self.store_rerank_feats and self.indexer is not None
                and getattr(self.searcher, "has_rerank_feats", False)):
            sids_want = list(codes.keys())
            try:
                sids, feats = self.indexer.get_features_from_sha1s(
                    sids_want, self.build_extr_str(), self.featurizer_type)
            except Exception:
                sids, feats = [], []
            if sids and len(sids) == len(sids_want):
                data = np.vstack(feats).astype(np.float32)
                feats_idx = (self.model.apply_PCA(data)
                             if isinstance(self.model, LOPQModelPCA)
                             else data)
                coarse = np.asarray([codes[s][0] for s in sids])
                fine = np.asarray([codes[s][1] for s in sids])
                self.searcher.add_codes((coarse, fine), sids,
                                        feats=feats_idx)
                return
            print(f"[{self.pp}: warning] cached-codes add without "
                  f"features drops the device rerank store "
                  f"({len(sids)}/{len(sids_want)} features recoverable); "
                  "reranking falls back to the indexer path")
        self.searcher.add_codes_from_dict(codes)

    def load_codes(self, start_date=START_DATE):
        """Incrementally index new updates
        (reference: searcher_lopqhbase.py:655-770)."""
        if self.searcher is None or self.indexer is None:
            return 0
        added = 0
        extr_str = self.build_extr_str()
        for batch in self.indexer.get_updates_from_date(start_date,
                                                        extr_type=extr_str):
            for update_id, cols in batch:
                if update_id in self.indexed_updates:
                    continue
                col_list = self.indexer.get_col_listsha1s()
                sha1s = cols.get(col_list)
                if isinstance(sha1s, bytes):
                    sha1s = sha1s.decode()
                if self.store_rerank_feats and sha1s:
                    # Rerank store needs the features, so the cached code
                    # dict is not enough — recompute from the indexer and
                    # add codes + index-space features together.
                    out = self._compute_update(update_id, sha1s.split(","))
                    if out:
                        _, sids, coarse, fine, feats_idx = out
                        self.searcher.add_codes((coarse, fine), sids,
                                                feats=feats_idx)
                        added += len(sids)
                        self.indexed_updates.add(update_id)
                        continue
                    # Features unfetchable: fall through to the cached-
                    # codes path below so the rows still get indexed
                    # (a featureless add may drop the device rerank
                    # store — _add_codes_dict tries to recover the
                    # features from the indexer first).
                codes = (self.storer.load(self._codes_key(update_id))
                         if self.storer is not None else None)
                if not codes:
                    if not sha1s:
                        continue
                    codes = self.compute_codes(update_id, sha1s.split(","))
                if codes:
                    self._add_codes_dict(codes)
                    added += len(codes)
                self.indexed_updates.add(update_id)
        if added and self.storer is not None:
            self.storer.save(self._indexed_key(),
                             sorted(self.indexed_updates))
        self.last_refresh = time.time()
        return added

    def get_nb_indexed(self):
        return self.searcher.get_nb_indexed() if self.searcher else 0

    # --------------------------------------------------------------- query

    def _search_many(self, feat_list, quota, max_returned, reranking,
                     rerank_nb, filter_near_dup, near_dup_th, split_ids,
                     X_dev=None, n_valid=None):
        """Search a wave of query features.

        ``X_dev``: the wave as ONE device tensor (optionally padded;
        ``n_valid`` marks the real row count) straight from the serving
        wave route — skips the per-row slices and the stack.

        Concurrent queries in one request (or one serving wave) are routed
        through the backend's ``search_batch`` when it has one — one device
        launch for the whole wave instead of a dispatch per query (the role
        of the reference's gunicorn worker pool, api/gunicorn_api.py:21-75,
        played by device batching instead of processes).
        """
        # Device-resident rerank: when every indexed row has a feature on
        # the device (see LOPQSearcherTorch.add_codes feats), the exact
        # rerank runs there — the reference's production reranking path
        # (searcher_lopqhbase.py:862-912) without the indexer round-trip.
        # Results then arrive already re-sorted by exact distance, so
        # _rank_results only filters/truncates — and the device emits
        # only max_returned rows (rerank_nb is a separate depth knob,
        # index/searcher._query_geometry). The host rerank needs all
        # rerank_nb rows back instead.
        device_rerank = bool(
            reranking and getattr(self.searcher, "has_rerank_feats", False))
        limit = (max_returned if (not reranking or device_rerank)
                 else max(max_returned, rerank_nb))
        dev_rerank_nb = rerank_nb if device_rerank else None
        if (X_dev is None and feat_list
                and all(isinstance(f, torch.Tensor) for f in feat_list)):
            X_dev = torch.stack([f.reshape(-1) for f in feat_list])
        if X_dev is not None:
            if ((not reranking or device_rerank)
                    and hasattr(self.searcher, "search_device_feats")):
                # Raw features straight from the featurizer forward:
                # normalize, PCA and query on the device.
                waves = self.searcher.search_device_feats(
                    X_dev, quota=quota, limit=limit,
                    rerank_nb=dev_rerank_nb, n_valid=n_valid)
                return [
                    self._rank_results(None, results, visited, max_returned,
                                       False, rerank_nb, filter_near_dup,
                                       near_dup_th, split_ids)
                    for results, visited in waves
                ]
            # Config can't ride the fused route (e.g. host rerank):
            # materialize the wave rows and continue down the normal path.
            nv = int(n_valid if n_valid is not None else X_dev.shape[0])
            feat_list = [X_dev[i] for i in range(nv)]
        if len(feat_list) > 1 and hasattr(self.searcher, "search_batch"):
            X = np.asarray([np.squeeze(_host(f)) for f in feat_list])
            Xn = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True),
                                1e-30)
            kw = {"rerank_nb": dev_rerank_nb} if device_rerank else {}
            waves = self.searcher.search_batch(
                Xn, quota=quota, limit=limit, with_dists=True,
                with_codes=False, **kw)
            return [
                self._rank_results(Xn[i], results, visited, max_returned,
                                   reranking and not device_rerank,
                                   rerank_nb, filter_near_dup,
                                   near_dup_th, split_ids)
                for i, (results, visited) in enumerate(waves)
            ]
        return [
            self._search_one(f, quota, max_returned, reranking, rerank_nb,
                             filter_near_dup, near_dup_th, split_ids)
            for f in feat_list
        ]

    def _search_one(self, feat, quota, max_returned, reranking, rerank_nb,
                    filter_near_dup, near_dup_th, split_ids):
        """One query feature -> (ids, dists, visited)."""
        feat = _host(feat)
        normed = np.squeeze(feat / np.linalg.norm(feat))
        device_rerank = bool(
            reranking and getattr(self.searcher, "has_rerank_feats", False))
        limit = (max_returned if (not reranking or device_rerank)
                 else max(max_returned, rerank_nb))
        kw = {"rerank_nb": rerank_nb} if device_rerank else {}
        results, visited = self.searcher.search(
            normed, quota=quota, limit=limit, with_dists=True, **kw)
        return self._rank_results(normed, results, visited, max_returned,
                                  reranking and not device_rerank,
                                  rerank_nb, filter_near_dup,
                                  near_dup_th, split_ids)

    def _rank_results(self, normed, results, visited, max_returned,
                      reranking, rerank_nb, filter_near_dup, near_dup_th,
                      split_ids):
        """Rerank / near-dup filter / truncate one query's raw results."""
        dists = {r.id: r.dist for r in results}
        order = [r.id for r in results]

        if reranking and results:
            order = order[:rerank_nb]
            sha1s = [str(rid).split("_")[0] if split_ids else str(rid)
                     for rid in order]
            extr_str = self.build_extr_str()
            try:
                sids, fts = self.indexer.get_features_from_sha1s(
                    sha1s, extr_str, self.featurizer_type)
                if sids:
                    # One batched exact-distance computation for all
                    # candidates (vs the reference's per-result np norm).
                    fmat = np.vstack(fts).astype(np.float32)
                    exact = np.linalg.norm(fmat - normed[None, :], axis=1)
                    exact_map = dict(zip(sids, exact))
                    for rid in order:
                        if rid in exact_map:
                            dists[rid] = float(exact_map[rid])
            except Exception as inst:
                print(f"[{self.pp}: error] rerank failed: {inst}")

        ids_out, dists_out = [], []
        for ires, rid in enumerate(order):
            d = dists[rid]
            if filter_near_dup and d > near_dup_th:
                continue
            if max_returned and len(ids_out) >= max_returned and not reranking:
                break
            ids_out.append(rid)
            dists_out.append(float(d))
        if reranking:
            sidx = np.argsort(dists_out, kind="stable")
            ids_out = [ids_out[i] for i in sidx][:max_returned]
            dists_out = [dists_out[i] for i in sidx][:max_returned]
        return ids_out, dists_out, visited

    def _info_rows(self, sha1s):
        """Fetch output-info rows, preserving query order with sha1-only
        fallbacks (reference: searcher_lopqhbase.py:917-944)."""
        if self.skip_get_sim_info or self.indexer is None or not sha1s:
            return [(s,) for s in sha1s]
        try:
            rows = self.indexer.get_columns_from_sha1_rows(
                sha1s, self.needed_output_columns)
        except Exception:
            rows = []
        by_key = {r[0]: r for r in rows}
        return [by_key.get(s, (s,)) for s in sha1s]

    def _query_params(self, options_dict):
        """Resolve the per-request query parameters (reference:
        searcher_lopqhbase.py:783-820 option handling)."""
        options_dict = options_dict or {}
        return (min(1000 * int(options_dict.get("max_returned",
                                                self.sim_limit)), 10000),
                int(options_dict.get("max_returned", self.sim_limit)),
                bool(options_dict.get("reranking", self.reranking)),
                int(options_dict.get("rerank_nb", self.rerank_nb)),
                bool(options_dict.get("near_dup", self.near_dup)),
                float(options_dict.get("near_dup_th", self.near_dup_th)))

    def _assemble_simple(self, dets, feats, answers, options_dict):
        """Non-detector answers -> formatted output (one request; the span
        ``cis.assemble``)."""
        with span("cis.assemble"):
            all_sim_images, all_sim_dets, all_sim_score = [], [], []
            w = 0
            for _ in range(len(feats)):
                if self.searcher is None:
                    all_sim_images.append([[]])
                    all_sim_dets.append([])
                    all_sim_score.append([[]])
                    continue
                ids, dd, _ = answers[w]
                w += 1
                sha1s = [str(r) for r in ids]
                all_sim_images.append([self._info_rows(sha1s)])
                all_sim_dets.append([])
                all_sim_score.append([dd])
            return self.do.format_output(dets, all_sim_images, all_sim_dets,
                                         all_sim_score, options_dict,
                                         self.input_type)

    def search_from_feats_multi(self, requests, wave=None, spans=None):
        """Coalesced serving: one `_search_many` device wave for every
        same-parameter request in the batch, then per-request output
        assembly (so batch-wide counters in the response stay per-request
        correct). Called by ``GenericSearcher._serve_batch`` when request
        coalescing is on. Face-path requests coalesce too: every
        (image, face) pair across the bundle rides one wave.

        :param requests: list of (dets, feats, options_dict)
        :param wave: optional (device feats, n_valid) straight from
            ``featurize_wave`` — the whole bundle's forward output as ONE
            device tensor. With ``spans`` (per-request (row_offset, n)
            into it, None where a request isn't wave-backed) the query
            wave is taken from it directly instead of re-stacking per-row
            slices.
        :returns: one formatted output dict per request, in order
        """
        detector = self.detector is not None
        groups = {}
        for ri, (_, _, options) in enumerate(requests):
            key = (self._query_params(options),
                   bool(options.get("detect_only")) if detector else False)
            groups.setdefault(key, []).append(ri)
        answers_by_req = {}
        for (params, detect_only), rids in groups.items():
            (quota, max_returned, reranking, rerank_nb,
             filter_near_dup, near_dup_th) = params
            use_wave = (wave is not None and not detector and not detect_only
                        and self.searcher is not None and spans is not None
                        and all(spans[ri] is not None for ri in rids))
            if use_wave:
                rows, wv, sp = [], [], []
                for ri in rids:
                    at, n = spans[ri]
                    start = len(rows)
                    rows.extend(range(at, at + n))
                    sp.append((start, len(rows)))
                w_dev, n_w = wave
                if rows == list(range(n_w)):
                    X_dev, nv = w_dev, n_w  # the wave rides whole
                else:
                    X_dev = w_dev.index_select(0, torch.as_tensor(
                        rows, device=w_dev.device))
                    nv = len(rows)
                answers = self._search_many(
                    [], quota, max_returned, reranking, rerank_nb,
                    filter_near_dup, near_dup_th, split_ids=False,
                    X_dev=X_dev, n_valid=nv)
                for ri, span in zip(rids, sp):
                    answers_by_req[ri] = answers[span[0]:span[1]]
                continue
            wave_l, spans_l = [], []
            for ri in rids:
                dets, feats, _ = requests[ri]
                start = len(wave_l)
                if self.searcher is not None and not detect_only:
                    if detector:
                        coords = [(i, j) for i in range(len(dets))
                                  for j in range(len(dets[i][1]))]
                        wave_l.extend(feats[i][j] for i, j in coords)
                        spans_l.append((start, coords))
                        continue
                    wave_l.extend(feats)
                spans_l.append((start, len(wave_l)))
            answers = self._search_many(wave_l, quota, max_returned,
                                        reranking, rerank_nb,
                                        filter_near_dup, near_dup_th,
                                        split_ids=detector)
            for ri, span in zip(rids, spans_l):
                if detector and isinstance(span[1], list):
                    start, coords = span
                    answers_by_req[ri] = dict(
                        zip(coords, answers[start:start + len(coords)]))
                elif detector:
                    answers_by_req[ri] = {}
                else:
                    answers_by_req[ri] = answers[span[0]:span[1]]
        if detector:
            return [self._assemble_faces(dets, feats,
                                         answers_by_req[ri], options)
                    for ri, (dets, feats, options) in enumerate(requests)]
        return [self._assemble_simple(dets, feats, answers_by_req[ri],
                                      options)
                for ri, (dets, feats, options) in enumerate(requests)]

    def _assemble_faces(self, dets, feats, answers, options_dict):
        """Face-path answers (dict keyed (image_idx, face_idx)) ->
        formatted output (one request; the span ``cis.assemble``)."""
        del feats
        with span("cis.assemble"):
            all_sim_images, all_sim_dets, all_sim_score = [], [], []
            for i in range(len(dets)):
                sim_images, sim_dets, sim_score = [], [], []
                for j in range(len(dets[i][1])):
                    if (i, j) not in answers:
                        sim_images.append([])
                        sim_dets.append([])
                        sim_score.append([])
                        continue
                    ids, dd, _ = answers[(i, j)]
                    img_sha1s = [str(r).split("_")[0] for r in ids]
                    sim_images.append(self._info_rows(img_sha1s))
                    sim_dets.append([str(r) for r in ids])
                    sim_score.append(dd)
                all_sim_images.append(sim_images)
                all_sim_dets.append(sim_dets)
                all_sim_score.append(sim_score)
            return self.do.format_output(dets, all_sim_images, all_sim_dets,
                                         all_sim_score, options_dict,
                                         self.input_type)

    def search_from_feats(self, dets, feats, options_dict=None):
        """(reference: searcher_lopqhbase.py:783-1067)"""
        options_dict = options_dict or {}
        (quota, max_returned, reranking, rerank_nb, filter_near_dup,
         near_dup_th) = self._query_params(options_dict)

        if self.detector is not None:
            # Flatten (image, face) pairs into one wave -> one device launch.
            coords, wave = [], []
            for i in range(len(dets)):
                for j in range(len(dets[i][1])):
                    if options_dict.get("detect_only") or self.searcher is None:
                        continue
                    coords.append((i, j))
                    wave.append(feats[i][j])
            answers = dict(zip(coords, self._search_many(
                wave, quota, max_returned, reranking, rerank_nb,
                filter_near_dup, near_dup_th, split_ids=True)))
            return self._assemble_faces(dets, feats, answers, options_dict)
        else:
            wave = [feats[i] for i in range(len(feats))
                    if self.searcher is not None]
            answers = self._search_many(
                wave, quota, max_returned, reranking, rerank_nb,
                filter_near_dup, near_dup_th, split_ids=False)
            return self._assemble_simple(dets, feats, answers, options_dict)

    # -------------------------------------------------------------- status

    def status(self):
        """(reference: api/api.py:321-338 /status content)"""
        d = {
            "nb_indexed": self.get_nb_indexed(),
            "last_refresh": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.localtime(self.last_refresh)),
            "model_str": self.build_model_str(),
            "indexed_updates": len(self.indexed_updates),
        }
        # Probe-ladder observability (device backends): serving waves,
        # queries escalated past their start rung, current tier hint.
        stats = getattr(self.searcher, "probe_stats", None)
        if stats is not None:
            d["probe_waves"] = stats["waves"]
            d["probe_escalated_queries"] = stats["escalated_queries"]
            d["probe_tier_hint"] = getattr(self.searcher, "_tier_hint", 0)
        return d
