"""Generic searcher: component assembly + query entry points (port of
columbiaimagesearch_tpu/searcher/generic_searcher.py:1-422).

Same surface and knobs as the reference
(reference: cufacesearch/searcher/generic_searcher.py:9-425): sim_limit,
quota, near_dup(_th), reranking/rerank_nb, input_type, file_input,
skip_get_sim_info; entry points ``search_image{URL,B64,_path}_list`` that
detect/featurize each query then delegate to ``search_from_feats``.

Configuration is typed constructor arguments instead of the reference's
prefix-JSON ConfReader tree; ``from_conf`` adapts a flat conf dict.

Differences from the JAX module:

- No fallback hides a device or kernel error. The JAX ``_serve_batch``
  swallows any exception of the wave featurize (generic_searcher.py:362)
  and of ``search_from_feats_multi`` (:400) and reruns down another route.
  Here such an error is the error of the requests it hit, returned as
  their result (the ``MicroBatcher`` re-raises it in each caller). An
  image that does not decode still takes the per-image decode path, and
  if PIL cannot read it either, only its own request fails (in the JAX
  module the whole coalesced group does).
- The device stage runs under ``torch.inference_mode``: it runs in the
  coalescer's thread, and grad mode is per thread.
- Device features are detected as ``torch.Tensor`` (on the CPU too).
- ``device`` (default: the first card; raises without one) is where the
  featurizer the searcher builds runs; ``device="cpu"`` asks for the CPU.
- The served path opens the spans ``cis.decode`` (a request's
  ``prepare_wave``, on its handler's thread) and ``cis.featurize`` (the
  wave's reconstruction and forward, on the coalescer's thread); see
  ``common/profiling.py``.
"""

import numpy as np
import torch

from columbiaimagesearch_tpu_torch.common.profiling import span
from columbiaimagesearch_tpu_torch.device import resolve_device
from columbiaimagesearch_tpu_torch.searcher.output_mapping import DictOutput


class GenericSearcher:
    def __init__(self, detector_type="full", featurizer_type="sentibank",
                 input_type="image", sim_limit=100, quota=None,
                 near_dup=False, near_dup_th=0.8, top_feature=100,
                 reranking=False, rerank_nb=None, skip_get_sim_info=False,
                 file_input=False, dict_output_type="CamelCase",
                 detector=None, featurizer=None, indexer=None, storer=None,
                 verbose=0, coalesce_window_ms=None, coalesce_max_batch=32,
                 device=None):
        self.device = resolve_device(device)
        self.detector_type = detector_type
        self.featurizer_type = featurizer_type
        self.input_type = input_type
        self.sim_limit = sim_limit
        self.quota = quota if quota is not None else 10 * sim_limit
        self.near_dup = near_dup
        self.near_dup_th = near_dup_th
        self.top_feature = top_feature
        self.reranking = reranking
        # The reference's top_feature knob's only live effect is as the
        # rerank-depth default (reference: generic_searcher.py:35,154:
        # rerank_nb = get_param('rerank_nb', default=self.top_feature)).
        self.rerank_nb = (rerank_nb if rerank_nb is not None
                          else (top_feature or 10 * sim_limit))
        self.skip_get_sim_info = skip_get_sim_info
        self.file_input = file_input
        self.verbose = verbose
        self.pp = type(self).__name__

        # Components: accept instances or build from types.
        if detector is not None:
            self.detector = detector
        else:
            from columbiaimagesearch_tpu_torch.extraction.detector import get_detector

            self.detector = get_detector(detector_type, device=self.device)
        if featurizer is not None:
            self.featurizer = featurizer
        else:
            from columbiaimagesearch_tpu_torch.extraction.extractor import get_featurizer

            self.featurizer = get_featurizer(featurizer_type,
                                             device=self.device)
        self.indexer = indexer
        self.storer = storer

        self.img_column = "info:s3_url"
        self.needed_output_columns = [self.img_column]
        self.do = DictOutput(dict_output_type)
        self.do.url_field = self.img_column

        # Cross-request micro-batching (see api/microbatch.py): concurrent
        # requests arriving within the window are melded into one device
        # wave — one batched forward + one probed-query launch. The
        # reference scales by gunicorn worker replication instead
        # (api/gunicorn_api.py:21-75); one resident index + batched waves
        # is the single-accelerator equivalent.
        self.request_batcher = None
        if coalesce_window_ms is not None:
            from columbiaimagesearch_tpu_torch.api.microbatch import MicroBatcher

            self.request_batcher = MicroBatcher(
                self._serve_batch, max_batch=coalesce_max_batch,
                window_ms=coalesce_window_ms,
                name=f"{self.pp}-coalescer")

        self.init_searcher()

    @classmethod
    def from_conf(cls, conf: dict, **components):
        """Build from a flat conf dict (ConfReader-style keys)."""
        keys = ["detector_type", "featurizer_type", "input_type", "sim_limit",
                "quota", "near_dup", "near_dup_th", "top_feature",
                "reranking", "rerank_nb", "skip_get_sim_info", "file_input",
                "verbose", "coalesce_window_ms", "coalesce_max_batch",
                "device"]
        kwargs = {k: conf[k] for k in keys if k in conf}
        kwargs.update(components)
        return cls(**kwargs)

    def build_extr_str(self):
        from columbiaimagesearch_tpu_torch.extraction.extractor import build_extr_str

        return build_extr_str(self.featurizer_type, self.detector_type,
                              self.input_type)

    # ------------------------------------------------------ query frontends

    def search_imageURL_list(self, image_list, options_dict=None):
        from columbiaimagesearch_tpu_torch.imgio.imgio import get_buffer_from_URL

        load_fn = (get_buffer_from_URL if self.detector is None
                   else self.detector.detect_from_url)
        return self._search_from_any_list(image_list, load_fn,
                                          options_dict or {}, push_img=True)

    def search_image_path_list(self, image_list, options_dict=None):
        from columbiaimagesearch_tpu_torch.imgio.imgio import get_buffer_from_filepath

        load_fn = (get_buffer_from_filepath if self.detector is None
                   else self.detector.detect_from_filepath)
        return self._search_from_any_list(image_list, load_fn,
                                          options_dict or {}, push_img=True)

    def search_imageB64_list(self, imageB64_list, options_dict=None):
        from columbiaimagesearch_tpu_torch.imgio.imgio import get_buffer_from_B64

        load_fn = (get_buffer_from_B64 if self.detector is None
                   else self.detector.detect_from_b64)
        return self._search_from_any_list(imageB64_list, load_fn,
                                          options_dict or {}, push_img=False)

    def _search_from_any_list(self, image_list, load_fn, options_dict,
                              push_img=False):
        """Detect/featurize each query then search
        (reference: generic_searcher.py:343-414).

        Decode (and for the face path, detect+featurize) runs in the
        CALLER's thread — it parallelizes across server handler threads.
        The device work (featurize forward + probed query) runs in
        ``_serve_batch``, either directly or — when request coalescing is
        on — melded with concurrent requests into one device wave
        (``api/microbatch.MicroBatcher``; see ``coalesce_window_ms``).
        """
        request = self._prepare_request(image_list, load_fn, options_dict,
                                        push_img)
        if self.request_batcher is not None:
            return self.request_batcher.submit(request)
        out = self._serve_batch([request])[0]
        if isinstance(out, Exception):
            raise out
        return out

    def _prepare_request(self, image_list, load_fn, options_dict,
                         push_img=False):
        """Host-side request prep: decode buffers (non-detector) or the
        full detect+featurize (detector path). Returns a dict consumed by
        ``_serve_batch``."""
        if self.detector is not None:
            dets, feats = [], []
            for image in image_list:
                infos, img, bboxes = load_fn(image)
                sha1, img_type, width, height = infos
                dets.append((sha1, bboxes, image if push_img else None,
                             img_type, width, height))
                face_feats = []
                if not options_dict.get("detect_only"):
                    if bboxes:
                        face_feats = list(self.featurizer.featurize_batch(
                            img, bboxes))
                feats.append(face_feats)
            return {"dets": dets, "feats": feats, "options": options_dict}

        from columbiaimagesearch_tpu_torch.imgio.imgio import get_SHA1_from_buffer

        dets, bufs = [], []
        for image in image_list:
            buf = load_fn(image)
            sha1 = get_SHA1_from_buffer(buf)
            dets.append((sha1, image if push_img else None))
            buf.seek(0)
            bufs.append(buf.read())
        request = {"dets": dets, "bufs": bufs, "options": options_dict}
        # Decode in THIS (handler) thread when the featurizer supports the
        # split wave: the coalesced device wave then carries decoded
        # pixels or JPEG coefficients only (the featurizer's prep), so
        # request decode overlaps the previous wave's device time (and
        # parallelizes across handler threads on multi-core hosts) instead
        # of serializing inside the coalescer worker. Gated on the device
        # wave route actually serving this request — otherwise
        # _serve_batch's fallback (_featurize_bufs) would decode a second
        # time and the prep would be dead weight. The JAX handler decodes
        # pixels here whatever its featurizer's device_decode
        # (generic_searcher.py:184-192); the port carries the coefficient
        # route through, so a query image takes the route its stored
        # features took.
        if (bufs and hasattr(self.featurizer, "prepare_wave")
                and hasattr(self.featurizer, "featurize_preps")
                and self._use_device_feats(options_dict)):
            with span("cis.decode"):
                prep = self.featurizer.prepare_wave(bufs)
            if all(int(s) == 0 for s in prep[1]["status"]):
                request["prep"] = prep
        return request

    def _featurize_bufs(self, bufs, use_device):
        """One batched featurize for ``bufs``, then the per-image PIL path
        for the images the batched decode could not read. The batched
        decode is extraction's (native imgpipe), so query features match
        stored features. The JAX ladder has a middle rung, the buffers
        path after the device route (generic_searcher.py:218); here both
        routes share one decode, so it could only fail again.

        With ``use_device`` the features stay on the device for the
        backend's raw-feature search. An image PIL cannot read either gets
        its decode error in place of a feature (its request fails alone);
        an error of the forward propagates."""
        import io

        from columbiaimagesearch_tpu_torch.imgio.imgio import load_image_from_buffer

        batched = (self.featurizer.featurize_buffers_device if use_device
                   else getattr(self.featurizer, "featurize_buffers", None))
        feats = [None] * len(bufs)
        pending = list(range(len(bufs)))
        if batched is not None and bufs:
            fts, status = batched(bufs)
            pending = [i for i in pending if int(status[i]) != 0]
            for i in range(len(bufs)):
                if int(status[i]) == 0:
                    feats[i] = fts[i]
        for i in pending:
            try:
                img = load_image_from_buffer(io.BytesIO(bufs[i]))
            except Exception as inst:  # noqa: BLE001 — this image's error
                feats[i] = inst
                continue
            feats[i] = self.featurizer.featurize(img)
        return feats

    def _use_device_feats(self, options_dict):
        backend = getattr(self, "searcher", None)
        rerank_req = bool(options_dict.get("reranking", self.reranking))
        return (hasattr(self.featurizer, "featurize_buffers_device")
                and hasattr(backend, "search_device_feats")
                and (not rerank_req
                     or getattr(backend, "has_rerank_feats", False)))

    def prewarm_serving(self, max_wave=4, options_dict=None):
        """Drive the serving route once at every wave size up to
        ``max_wave`` before the server takes traffic, then every probe
        rung (``prewarm_ladder``) at the serving geometry.

        Nothing here compiles per shape (the JAX package's reason,
        generic_searcher.py:241-319), but the first launch of each shape
        loads the kernels, grows the caching allocator and picks the
        convolution algorithms. This drives ``_serve_batch`` with b
        synthetic one-image requests for each size b, the coalesced route
        live traffic takes. The reference warms per-process at gunicorn
        worker boot instead (api/gunicorn_api.py:21-75).

        :returns: the wave buckets driven
        """
        if self.detector is not None or getattr(self, "searcher", None) is None:
            return []
        import io

        from PIL import Image

        from columbiaimagesearch_tpu_torch.imgio.imgio import get_SHA1_from_buffer
        from columbiaimagesearch_tpu_torch.utils.chunking import wave_bucket

        rng = np.random.RandomState(0)
        img = rng.randint(0, 255, (64, 64, 3), dtype=np.uint8)
        b = io.BytesIO()
        Image.fromarray(img).save(b, format="JPEG", quality=85)
        raw = b.getvalue()
        sha1 = get_SHA1_from_buffer(io.BytesIO(raw))
        opts = dict(options_dict or {})
        sizes = list(range(1, max_wave + 1))
        # Two passes: pass 1 also warms the searcher's yield EMA and tier
        # hint, and the plan live traffic then takes can differ from the
        # cold plan.
        for _ in range(2):
            for n in sizes:
                reqs = [{"dets": [(sha1, None)], "bufs": [raw],
                         "options": opts} for _ in range(n)]
                outs = self._serve_batch(reqs)
                for out in outs:
                    if isinstance(out, Exception):
                        raise out
        # The synthetic request only visited the rungs of its own
        # escalation; run the whole ladder at the serving geometry.
        backend = getattr(self, "searcher", None)
        if (hasattr(backend, "prewarm_ladder")
                and hasattr(self, "_query_params")
                and self._use_device_feats(opts)):
            (quota, max_ret, reranking, rerank_nb,
             _nd, _ndt) = self._query_params(opts)
            device_rerank = bool(
                reranking and getattr(backend, "has_rerank_feats", False))
            limit = (max_ret if (not reranking or device_rerank)
                     else max(max_ret, rerank_nb))
            backend.prewarm_ladder(
                quota=quota, limit=limit,
                rerank_nb=rerank_nb if device_rerank else None,
                waves=sizes)
        return sorted({wave_bucket(n) for n in sizes})

    @torch.inference_mode()
    def _serve_batch(self, requests):
        """Device stage for 1+ prepared requests: one batched featurize
        across every request's buffers, then the query. Subclasses that
        implement ``search_from_feats_multi`` get the query waves
        coalesced too; others run per-request ``search_from_feats``.
        Per-request failures return as Exception results (the
        MicroBatcher re-raises them in the right caller); an error of a
        shared device stage is the result of every request it served."""
        groups = {}
        for ri, req in enumerate(requests):
            if "bufs" in req and req["bufs"]:
                groups.setdefault(
                    self._use_device_feats(req["options"]), []).append(ri)
        wave = None  # (device feats, n_valid); spans live per request
        for use_device, rids in groups.items():
            flat = [b for ri in rids for b in requests[ri]["bufs"]]
            try:
                if (use_device and self.detector is None
                        and hasattr(self.featurizer, "featurize_wave")):
                    # Wave route: keep the whole forward output on the
                    # device and record per-request row spans.
                    with span("cis.featurize"):
                        if (hasattr(self.featurizer, "featurize_preps")
                                and all("prep" in requests[ri]
                                        for ri in rids)):
                            # The handler threads decoded
                            # (_prepare_request): the wave is device-only.
                            w, n_w, status = self.featurizer.featurize_preps(
                                [requests[ri]["prep"] for ri in rids])
                        else:
                            w, n_w, status = self.featurizer.featurize_wave(
                                flat)
                    if all(int(s) == 0 for s in status):
                        at = 0
                        for ri in rids:
                            n = len(requests[ri]["bufs"])
                            requests[ri]["feats"] = [w[at + j]
                                                     for j in range(n)]
                            requests[ri]["span"] = (at, n)
                            at += n
                        wave = (w, n_w)
                        continue
                    # An image did not decode: the per-image decode
                    # ladder below.
                feats = self._featurize_bufs(flat, use_device)
            except Exception as inst:  # noqa: BLE001 — isolate to group
                for ri in rids:
                    requests[ri]["error"] = inst
                continue
            at = 0
            for ri in rids:
                n = len(requests[ri]["bufs"])
                requests[ri]["feats"] = feats[at:at + n]
                at += n
                bad = [f for f in requests[ri]["feats"]
                       if isinstance(f, Exception)]
                if bad:
                    requests[ri]["error"] = bad[0]
        for req in requests:
            req.setdefault("feats", [])

        multi = getattr(self, "search_from_feats_multi", None)
        ready = [i for i, r in enumerate(requests) if "error" not in r]
        outs = {}
        if multi is not None and (len(ready) > 1
                                  or (wave is not None and ready)):
            try:
                got = multi([(requests[i]["dets"], requests[i]["feats"],
                              requests[i]["options"]) for i in ready],
                            wave=wave,
                            spans=[requests[i].get("span") for i in ready])
                outs = dict(zip(ready, got))
            except Exception as inst:  # noqa: BLE001 — the wave's error
                outs = {i: inst for i in ready}
        else:
            for i in ready:
                r = requests[i]
                try:
                    outs[i] = self.search_from_feats(
                        r["dets"], r["feats"], r["options"])
                except Exception as inst:  # noqa: BLE001
                    outs[i] = inst
        return [requests[i].get("error") or outs[i]
                for i in range(len(requests))]

    # -------------------------------------------------- subclass interface

    def init_searcher(self):
        raise NotImplementedError("init_searcher")

    def train_index(self):
        raise NotImplementedError("train_index")

    def search_from_feats(self, dets, feats, options_dict=None):
        raise NotImplementedError("search_from_feats")
