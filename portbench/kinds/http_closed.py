"""``http_closed``: closed-loop clients posting one image a request to the
search API, as users of the release image search reach it: the facade
that ``common.factory.build_searcher`` builds from the production conf,
served by ``api.app.make_server`` in this process, ``byB64``. Each request
is decoded on its handler's thread (the JPEG coefficient read), coalesced
with concurrent ones, reconstructed, featurized to fc7 by DeepSentibank,
projected by the PCA and searched with exact rerank, and its reply
formatted as JSON. The clients run in child processes
(``portbench/http_clients.py``) and send the next request as soon as the
reply is in, so the served rate is what the path sustains.

The configuration (``configs/<name>.json``) gives the production conf,
the index's shapes and how its data is made; the traffic mix
(``traffic/<mix>.json``): ``clients`` threads over ``client_procs``
processes, a pool of ``images`` seeded ``height`` x ``width`` JPEGs at
``quality``, the request's ``options`` and what they ask for (``limit``
results of ``quota`` candidates, ``rerank_nb`` re-scored exactly),
``warmup_requests`` sent in set-up, ``sample`` requests of the window
checked once it has closed, and ``trace_seconds`` of traffic under the
profiler after the window in a traced run.

The data, from seeds, on the card. The net's weights are the program's
seeded draw (``init_params``, the factory's weights where no pretrained
file is found), held to the reference's own draw. The PCA is fitted on
the fc7 of ``fit_images`` seeded images (the configuration's
``index_seed``, as a deployment trains once) and the LOPQ tables are
drawn in its space as ``data.Inputs`` draws them, from a mixture around
the fit images' projections. The corpus is a mixture around the pool
images' projections and the fit images' (``row_noise`` times the fit
projections' spread a dimension), so that each query image has its
near-duplicates indexed; the pool and the corpus follow the run's seed.

What the window produced is kept by wrappers set up from outside: the
coalescer's batch function and the featurizer's ``featurize_pixel_wave``.
A reservoir drawn from the seed keeps ``sample`` of the window's requests
with their reconstructed 227 x 227 input pixels, their fc7 rows and their
replies, on the card until the window has closed. ``judge`` holds them to
the plain references: the pixels to ``reference/sentibank_plain.py``'s
PIL decode of the same bytes, the fc7 rows to its float64 forward of the
program's own pixels, and the replies to ``reference/lopq_search.py`` on
the program's fc7 (``check.judge``).
"""

import base64
import gc
import json
import os
import subprocess
import sys
import threading
import time
import urllib.parse

import numpy as np
import torch

from portbench import check, data, images, served, spec, trace
from portbench.reference import lopq_search, sentibank_plain
from portbench.util import log, sync

#: streams of the seeds, after ``data``'s
FIT, POOL, CLIENTS = 5, 6, 7
#: images a forward call while the data is made
CHUNK = 256
#: offset of the central 227 x 227 in the 256 x 256 staging pixels
OFF, CROP = sentibank_plain.OFF, sentibank_plain.CROP


def unit(x):
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


class Keeper:
    """A reservoir of the window's requests, drawn from the seed: the
    coalescer's batch function and the featurizer's
    ``featurize_pixel_wave``, wrapped on the instances. While ``on``, each
    served request may take a slot: its pool image, its 227 x 227 input
    pixels and its fc7 row (copied on the card) and its reply's ids and
    distances."""

    def __init__(self, facade, image_of, k, limit, seed, dev):
        self.facade, self.image_of, self.k = facade, image_of, k
        self.rng = np.random.default_rng(data.derive(seed, data.SAMPLE))
        self.on = False
        self.seen = self.filled = 0
        self.last = None
        self.pixels = torch.empty((k, CROP, CROP, 3), dtype=torch.uint8,
                                  device=dev)
        self.fc7 = torch.empty((k, 4096), dtype=torch.float32, device=dev)
        self.image = np.full(k, -1, np.int64)
        self.ids = np.zeros((k, limit), np.int64)
        self.dists = np.zeros((k, limit), np.float64)
        self.count = np.zeros(k, np.int64)
        m = facade.do.map
        self.keys = (m["all_similar_images"], m["similar_images"],
                     m["image_sha1s"], m["distances"])
        batcher, feat = facade.request_batcher, facade.featurizer
        self.batch_fn = batcher.batch_fn
        self.pixel_wave = feat.featurize_pixel_wave
        batcher.batch_fn = self.batch
        feat.featurize_pixel_wave = self.wave

    def wave(self, stack):
        out = self.pixel_wave(stack)
        if self.on:
            self.last = (stack, out[0])
        return out

    def batch(self, requests):
        self.last = None
        outs = self.batch_fn(requests)
        if self.on and self.last is not None:
            self.keep(requests, outs, *self.last)
        return outs

    def keep(self, requests, outs, stack, feats):
        if stack.shape[0] != len(requests):
            return
        taken = {}          # slot -> request; a later request replaces
        for i, out in enumerate(outs):
            if isinstance(out, Exception):
                continue
            s = self.seen
            self.seen += 1
            if self.filled < self.k:
                taken[self.filled] = i
                self.filled += 1
            else:
                slot = int(self.rng.integers(0, s + 1))
                if slot < self.k:
                    taken[slot] = i
        for slot, i in taken.items():
            block = outs[i][self.keys[0]][0][self.keys[1]]
            ids, dists = block[self.keys[2]], block[self.keys[3]]
            m = min(len(ids), self.ids.shape[1])
            self.image[slot] = self.image_of[requests[i]["dets"][0][0]]
            self.ids[slot, :m] = [int(x) for x in ids[:m]]
            self.dists[slot, :m] = dists[:m]
            self.count[slot] = m
        if taken:
            dev = self.pixels.device
            # one source a slot: index_copy_ leaves a repeated index's
            # winner unspecified on the card
            r = torch.tensor(list(taken.values()), device=dev)
            s = torch.tensor(list(taken), device=dev)
            self.pixels.index_copy_(0, s, stack.index_select(0, r)[
                :, OFF:OFF + CROP, OFF:OFF + CROP])
            self.fc7.index_copy_(0, s, feats.index_select(0, r))

    def remove(self):
        self.facade.request_batcher.batch_fn = self.batch_fn
        del self.facade.featurizer.featurize_pixel_wave


class Clients:
    """The client processes (``portbench/http_clients.py``)."""

    def __init__(self, mix, port, forms, sha1s, seed):
        per = mix["clients"] // mix["client_procs"]
        self.procs = []
        for p in range(mix["client_procs"]):
            proc = subprocess.Popen(
                [sys.executable, "-m", "portbench.http_clients"],
                cwd=spec.ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                text=True)
            first = p * per
            proc.stdin.write(json.dumps({
                "port": port, "path": "/cuimgsearch/byB64", "sha1s": sha1s,
                "limit": mix["limit"],
                "seeds": [data.derive(seed, CLIENTS) + first + t
                          for t in range(per)]}) + "\n")
            for f in forms:
                proc.stdin.write(f + "\n")
            proc.stdin.flush()
            self.procs.append(proc)
        for proc in self.procs:
            if not json.loads(proc.stdout.readline()).get("ready"):
                raise RuntimeError("an HTTP client process did not start")

    def run(self, cmd):
        """One command in every process; their answers."""
        for proc in self.procs:
            proc.stdin.write(json.dumps(cmd) + "\n")
            proc.stdin.flush()
        out = []
        for proc in self.procs:
            line = proc.stdout.readline()
            if not line:
                raise RuntimeError("an HTTP client process ended")
            out.append(json.loads(line))
        return out

    def close(self):
        for proc in self.procs:
            try:
                proc.stdin.write(json.dumps({"cmd": "quit"}) + "\n")
                proc.stdin.close()
            except OSError:
                pass
        for proc in self.procs:
            proc.wait(timeout=60)
        self.procs = []


def totals(answers):
    """(ok, failed, first errors) over the client processes' answers."""
    ok = sum(a["ok"] for a in answers)
    failed = sum(a["failed"] for a in answers)
    return ok, failed, [e for a in answers for e in a["errors"]][:3]


class Load:
    """One run of an ``http_closed`` cell (see the module docstring)."""

    def __init__(self, cfg, mix, seed, dev):
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, int(seed), dev
        self.server = self.clients = self.facade = self.keeper = None

    # ------------------------------------------------------------ set-up

    def _featurizer(self):
        """The featurizer the program's factory builds, checked to run the
        configuration's net on the coefficient route."""
        from columbiaimagesearch_tpu_torch.extraction.extractor import (
            get_featurizer,
        )

        f = get_featurizer(self.cfg["featurizer_type"], device=self.dev)
        self._check_featurizer(f)
        return f

    def _check_featurizer(self, f):
        want = sentibank_plain.init_weights(self.cfg["weights_seed"])
        if (f.pretrained or not f.device_decode
                or f.compute_dtype != self.cfg["compute_dtype"]
                or any(not torch.equal(f.params[k], v)
                       for k, v in want.items())):
            raise RuntimeError(
                "the program's featurizer is not the configuration's: "
                f"pretrained={f.pretrained} device_decode={f.device_decode} "
                f"compute_dtype={f.compute_dtype}")

    def _fc7(self, f, stack):
        """fc7 of device pixels [n, 256, 256, 3] through the program's
        forward, a chunk at a time."""
        return torch.cat([f.featurize_pixel_wave(stack[lo:lo + CHUNK])[0]
                          for lo in range(0, stack.shape[0], CHUNK)])

    def setup(self):
        """Make the data, build the facade through the factory, index the
        corpus, start the server and the clients and warm the route up.
        Returns the stages' seconds."""
        from columbiaimagesearch_tpu_torch.api.app import make_server
        from columbiaimagesearch_tpu_torch.common.factory import (
            build_searcher,
        )
        from columbiaimagesearch_tpu_torch.extraction.extractor import (
            build_extr_str,
        )
        from columbiaimagesearch_tpu_torch.imgio.imgio import (
            get_SHA1_from_data,
        )
        from columbiaimagesearch_tpu_torch.index.encode import (
            blocks_needed,
            lopq_encode_blocked,
        )
        from columbiaimagesearch_tpu_torch.index.model import LOPQModelPCA
        from columbiaimagesearch_tpu_torch.index.searcher import (
            LOPQSearcherTorch,
        )
        from columbiaimagesearch_tpu_torch.store.storer import MemoryStorer

        cfg, mix, dev = self.cfg, self.mix, self.dev
        stages = {}
        clock = [time.perf_counter()]

        def lap(name):
            sync(dev)
            now = time.perf_counter()
            stages[name] = now - clock[0]
            clock[0] = now

        f = self._featurizer()
        lap("featurizer")
        # the PCA, fitted on the fit set's fc7 (the configuration's index)
        g = data.generator(dev, cfg["index_seed"], FIT)
        fit = torch.cat([
            unit(self._fc7(f, images.pixels(min(CHUNK, cfg["fit_images"]
                                               - lo), 256, 256, g)))
            for lo in range(0, cfg["fit_images"], CHUNK)]).to(torch.float64)
        mu = fit.mean(0)
        _, vecs = torch.linalg.eigh((fit - mu).T @ (fit - mu))
        P = vecs[:, -cfg["dim"]:].flip(1).to(torch.float32).contiguous()
        self.pca = dict(P=P, mu=mu.to(torch.float32))
        fit_y = (fit.to(torch.float32) - self.pca["mu"]) @ P
        del fit, vecs
        lap("fit")
        # the pool the clients post (the run's seed)
        g = data.generator(dev, self.seed, POOL)
        self.pool = images.jpeg_pool(mix["images"], mix["height"],
                                     mix["width"], mix["quality"], g)
        pool_fc7 = torch.cat([
            f.featurize_wave(self.pool[lo:lo + CHUNK])[0]
            for lo in range(0, len(self.pool), CHUNK)])
        pool_y = (unit(pool_fc7) - self.pca["mu"]) @ P
        del f, pool_fc7
        lap("pool")
        # the model's tables, drawn in the PCA space from the fit images'
        # mixture, and the corpus around the pool's and the fit set's
        self.noise = cfg["row_noise"] * float(
            (fit_y - fit_y.mean(0)).square().mean().sqrt())
        g = data.generator(dev, cfg["index_seed"], data.MODEL)
        train = data.mixture(cfg["train_rows"], fit_y, g, self.noise)
        self.tables = data.make_tables(train, cfg["V"], cfg["M"],
                                       cfg["subq"], g)
        del train
        self.comps = torch.cat([pool_y, fit_y])
        lap("model")
        rows = self.rows()
        lap("rows")
        t = self.tables
        coarse, fine = lopq_encode_blocked(
            t["Cs"], t["Rs"], t["mus"], t["subs"], rows, cfg["V"],
            blocks_needed(rows.shape[0], cfg["V"]))
        coarse, fine = coarse.cpu().numpy(), fine.to(torch.uint8).cpu().numpy()
        lap("encode")
        # the model through the storer, as train_index leaves it, and the
        # facade through the factory on the production conf's keys
        with open(os.path.join(spec.ROOT, cfg["conf"])) as fh:
            conf = json.load(fh)
        conf.update(cfg["conf_overrides"])
        storer = MemoryStorer()
        key = (build_extr_str(conf["SEARCHLOPQ_featurizer_type"],
                              conf["SEARCHLOPQ_detector_type"],
                              conf["SEARCHLOPQ_input_type"])
               + f"_lopq_pca-pca{cfg['dim']}-subq{cfg['subq']}"
               f"-V{cfg['V']}-M{cfg['M']}")
        storer.save(key, LOPQModelPCA(t["Cs"], t["Rs"], t["mus"], t["subs"],
                                      P, self.pca["mu"], device=dev))
        self.facade = fc = build_searcher(conf, storer=storer, device=dev)
        if (fc.build_model_str() != key
                or not isinstance(fc.model, LOPQModelPCA)
                or not isinstance(fc.searcher, LOPQSearcherTorch)
                or fc.request_batcher is None):
            raise RuntimeError("the facade did not load the stored model "
                               "into the probed searcher with coalescing")
        self._check_featurizer(fc.featurizer)
        # replies carry ids and distances; no KV store holds image rows
        fc.skip_get_sim_info = True
        lap("facade")
        fc.searcher.add_codes((coarse, fine), feats=rows)
        del rows, coarse, fine
        nb = fc.get_nb_indexed()
        store = getattr(fc.searcher, "_buf_feats", None)
        if nb != cfg["rows"] or store is None or store.dtype != getattr(
                torch, cfg["rerank_dtype"]):
            raise RuntimeError(f"indexed {nb} rows of {cfg['rows']} with a "
                               f"store of {getattr(store, 'dtype', None)}")
        lap("index")
        sha1s = [get_SHA1_from_data(b) for b in self.pool]
        self.keeper = Keeper(fc, {s: i for i, s in enumerate(sha1s)},
                             mix["sample"], mix["limit"], self.seed, dev)
        self.server = make_server(fc, port=0, host="127.0.0.1")
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        fc.prewarm_serving(fc.request_batcher.max_batch,
                           options_dict=mix["options"])
        lap("prewarm")
        opts = json.dumps(mix["options"])
        forms = [urllib.parse.urlencode({"data": base64.b64encode(b)
                                         .decode(), "options": opts})
                 for b in self.pool]
        self.clients = Clients(mix, self.server.server_address[1], forms,
                               sha1s, self.seed)
        lap("clients")
        ok, failed, errors = totals(self.clients.run(
            {"cmd": "count", "n": -(-mix["warmup_requests"]
                                    // mix["client_procs"])}))
        if failed:
            raise RuntimeError(f"{failed} warm-up requests failed: {errors}")
        lap("warmup")
        gc.collect()
        lap("collect")
        return stages

    def rows(self):
        """The corpus, [rows, dim] float32: the same on every call."""
        g = data.generator(self.dev, self.seed, data.ROWS)
        return data.mixture(self.cfg["rows"], self.comps, g, self.noise)

    # ------------------------------------------------------------ window

    def _serve(self, seconds):
        """The clients' closed loops for ``seconds``; (their answers, the
        coalesced waves' sizes, the images each route took)."""
        fc = self.facade
        sizes, routes = fc.request_batcher.batch_sizes, fc.featurizer \
            .route_counts
        i0, r0 = len(sizes), dict(routes)
        t0 = time.monotonic() + 0.2
        answers = self.clients.run({"cmd": "window", "t0": t0,
                                    "t1": t0 + seconds})
        return answers, sizes[i0:], {k: routes[k] - r0[k] for k in r0}

    def window(self, seconds, traced):
        """The measured window, then, when ``traced``, ``trace_seconds``
        more under a profiler of every thread with the forward's spans set
        up (so the profiler's cost stays out of the window)."""
        m = self.mix
        self.keeper.on = True
        answers, sizes, routes = self._serve(seconds)
        self.keeper.on = False
        ok, failed, errors = totals(answers)
        lat = np.concatenate([a["lat_ms"] for a in answers]) if ok else \
            np.zeros(1)
        cpu = [a["cpu_s"] / a["wall_s"] for a in answers]
        log(f"window: {ok} replies, {failed} failed in {seconds:.3f} s by "
            f"{m['clients']} clients; reply ms p50 {np.median(lat):.2f} p95 "
            f"{np.percentile(lat, 95):.2f} p99 {np.percentile(lat, 99):.2f}; "
            f"{len(sizes)} waves of {np.mean(sizes) if sizes else 0:.2f} "
            f"requests; routes {routes}; client processes' CPU share "
            f"{[round(c, 3) for c in cpu]} of a core; errors {errors}")
        if routes["pixels"] or routes["coeffs"] < ok + failed:
            raise RuntimeError(f"images took another route than the "
                               f"coefficient route: {routes}")
        counters = dict(requests=ok, failed=failed, waves=len(sizes),
                        coeff_images=routes["coeffs"],
                        pixel_images=routes["pixels"],
                        kept=int(min(self.keeper.filled, m["sample"])),
                        client_cpu_share=cpu)
        out = dict(e2e={"queries_per_s": ok / seconds}, attempted=ok + failed,
                   failed=failed, counters=counters, window_s=seconds,
                   window_sizes=list(sizes), trace=None, served=None)
        if traced:
            spans = trace.Spans()
            spans.wrap(self.facade.featurizer, "_forward", "forward",
                       keep=lambda x: int(x.shape[0]))
            with served.profiler() as prof:
                spans.recording = True
                with torch.profiler.record_function(trace.PREFIX + "window"):
                    t_answers, t_sizes, _ = self._serve(m["trace_seconds"])
                spans.recording = False
            spans.remove()
            events = trace.events_of(prof)
            red = trace.Reduction(events, "window")
            out["trace"] = red
            out["served"] = dict(
                spans=served.program_spans(events, red.t0, red.t1),
                traced_sizes=list(t_sizes),
                forward_images=spans.calls["forward"])
            log(f"trace: {totals(t_answers)[0]} replies in "
                f"{red.window_s:.3f} s, {len(t_sizes)} waves")
        return out

    # ------------------------------------------------------------- check

    def sample(self):
        """The kept requests, copied off the card: a dict of their pool
        images, input pixels, fc7 rows and replies' ids and distances."""
        kp = self.keeper
        n = min(kp.filled, kp.k)
        log(f"check: {n} requests kept of {kp.seen} served in the window")
        return dict(image=kp.image[:n].copy(),
                    pixels=kp.pixels[:n].cpu(), fc7=kp.fc7[:n].cpu(),
                    got=[(kp.ids[j, :kp.count[j]].copy(),
                          kp.dists[j, :kp.count[j]].copy())
                         for j in range(n)])

    def free(self):
        """Stop the clients and the server; drop the program's state and
        the device memory it held."""
        if self.clients is not None:
            self.clients.close()
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
        if self.facade is not None:
            self.keeper.remove()
            self.facade.request_batcher.close()
        self.clients = self.server = self.facade = self.keeper = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, sample, control=False):
        """The check's numbers for the kept requests (and, with
        ``control``, for the controls in the program's place): the input
        pixels' mean and 99th-percentile absolute level against the plain
        decode, the fc7 rows' largest relative L2 error against the plain
        float64 forward of the same pixels, and ``check.judge``'s
        ``dist_gap`` and ``list_miss`` of the replies."""
        dev, m = self.dev, self.mix
        pixels = sample["pixels"].to(dev)
        which = sorted(set(sample["image"].tolist()))
        ref_pix = {i: torch.from_numpy(np.ascontiguousarray(
            sentibank_plain.decode(self.pool[i]))) for i in which}
        want = torch.stack([ref_pix[i] for i in sample["image"].tolist()]) \
            .to(dev)
        weights = sentibank_plain.init_weights(self.cfg["weights_seed"])
        ref_fc7 = sentibank_plain.fc7_in_chunks(
            sentibank_plain.Net(weights, dev), pixels)
        fc7 = sample["fc7"].to(dev)
        rows = self.rows()
        X = unit(fc7.to(torch.float64))
        kw = dict(quota=m["quota"], limit=m["limit"],
                  rerank_nb=m["rerank_nb"])
        ref = lopq_search.search(self.tables, self.pca, rows, X, **kw)
        out = {"program": dict(
            levels(pixels, want), fc7_rel_err=rel_err(fc7, ref_fc7),
            **check.judge(sample["got"], ref, self.pca, rows, X))}
        if control:
            plain = {i: torch.from_numpy(np.ascontiguousarray(
                sentibank_plain.decode_control(self.pool[i])))
                for i in which}
            ctl_pix = torch.stack([plain[i] for i in sample["image"]
                                   .tolist()]).to(dev)
            ctl_fc7 = sentibank_plain.fc7_in_chunks(
                sentibank_plain.Net(weights, dev, "tf32"), pixels)
            ctl = lopq_search.search(self.tables, self.pca, rows, X,
                                     precision="tf32", **kw)
            out["control"] = dict(
                levels(ctl_pix, want), fc7_rel_err=rel_err(ctl_fc7, ref_fc7),
                **check.judge([(i.cpu().numpy(), d.cpu().numpy())
                               for i, d in ctl], ref, self.pca, rows, X))
        return out


def levels(got, want):
    """``decode_mean`` and ``decode_p99``: the mean and the 99th
    percentile of the absolute differences of uint8 pixels, in levels."""
    d = (got.to(torch.int16) - want.to(torch.int16)).abs().flatten()
    hist = torch.bincount(d, minlength=256).cpu().numpy()
    cum = np.cumsum(hist)
    p99 = int(np.searchsorted(cum, 0.99 * cum[-1]))
    return {"decode_mean": float(d.to(torch.float64).mean()),
            "decode_p99": float(p99)}


def rel_err(got, want):
    """The largest relative L2 error of the rows of ``got`` against the
    float64 rows ``want``."""
    g = got.to(torch.float64)
    return float((torch.linalg.vector_norm(g - want, dim=1)
                  / torch.linalg.vector_norm(want, dim=1)).max())
