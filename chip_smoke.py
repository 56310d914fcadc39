#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for the H100).

Drives the port's paths (``columbiaimagesearch_tpu_torch``) once each:
LOPQ training of the release and the face configurations at their conf
sizes, then, on the trained models, the probed query path at the headline
size of the JAX package's query benchmark (10,485,760 rows, V=4096, M=8,
S=256, D=256, quota 10,000, limit 100), the release model's PCA front end,
and the exhaustive exact-ADC path at face-index scale (8,388,608 rows,
V=256, M=8, S=256, D=128). Phases:

0. device: requires CUDA; prints the card's name and power limit;
1. build: compiles ``csrc/lut_build.cu`` and ``csrc/adc_scan.cu`` with
   nvcc for sm_90a, one nvcc each, started together;
2. kernel vs plain: the LUT kernel against its plain PyTorch version at
   the headline shapes (NQ 1 and 100), a full serving wave's (NQ=32,
   B=64), the exhaustive path's all-V shape, every slot on one cluster,
   all slots distinct, and small odd shapes; the scan kernel against its
   plain version (bit-equal) at the documented profile configuration
   (scripts/profile_exhaustive.py: V=64, 1,048,576 random codes, NQ 8
   and 64) and small odd shapes with multi-block cells and count-0 blocks
   at NQ 1, 3, 12, 64. Each check prints the kernel's device time per
   call (for the LUT kernel, calls replayed from a CUDA graph, so that a
   call shorter than its launch is timed too), its plain version's, its
   bound (from this run's inputs: distinct
   probed matrices counted with ``torch.unique``) and share, and for the
   scan one ``embedding_bag`` on the same inputs (``library_ms``);
2a. train: the release configuration (conf/conf_search_production.json:
   ``lopq_pca`` 4096 -> 256, V=4096, M=8, S=256) through
   ``LOPQModelPCA.fit(n_init=1, random_state=0, pca_subsample=200000)``
   on its ``nb_train`` 2,000,000 raw rows, made on the card: the
   headline's 256-d gaussian mixture through a seeded orthonormal
   [256, 4096] basis plus isotropic noise. Checks: ``pca_P`` spans the
   basis (every principal cosine >= 0.999), every rotation is orthonormal,
   and the mean subquantizer distortion on 262,144 held-out rows is below
   a seeded random model's. Then the face configuration
   (conf/conf_search_face_local.json: ``lopq``, V=256, 128-d, 500,000
   rows of the face mixture) through ``LOPQModel.fit`` with the same
   checks. Each prints its stage seconds (PCA, coarse seeding, coarse
   Lloyd, accumulators, ``eigh``, allocation, projection, subquantizer
   k-means) and peak device memory;
2b. train card vs plain: Lloyd from one ``C_init`` at [262,144, 128],
   V=4096 on the card and the CPU (after one iteration >= 99.99% equal
   assignments and centroids within 1e-4; after 10 the inertia within
   1e-3 relative); the face rotations against a float64 numpy ``eigh``
   plus the copied allocation (``R cov R^T`` diagonal and equal to the
   reference's eigenvalues in its allocation order, 1e-4 relative; a
   cluster whose greedy allocation meets a near-tie follows the card's own
   eigenvalues, and at most 3% may); and ``torch.linalg.eigh`` alone on
   512 matrices of 128² and of 32² and on one 4096²;
2c. train_index: ``build_searcher`` over the release conf with ``lopq``
   at V=64 whose KVIndexer holds one update of 20,000 seeded 256-d
   features trains at init on the card and saves the model; a second
   ``build_searcher`` loads it and one query comes back first;
3. main path: the trained release model's index-space tables, the PCA
   image of raw rows drawn as in 2a (made a chunk at a time) encoded with
   ``lopq_encode`` and indexed by ``LOPQSearcherTorch`` with a float32
   rerank store on the card, request waves through ``search_batch`` with
   and without rerank, single ``search`` calls, and the headline query
   (``lopq_query`` at a pinned B=64) — with the LUT kernel's launch count
   read around that run, and result checks; then recall@{1, 10, 100}
   without rerank over 100 queries against the exact neighbours, for the
   trained and a seeded model on the same 1,048,576-row sub-index (the
   trained one may not fall more than 0.01 below at 100) and for the
   trained model on the full index;
4. numbers: p50 latencies and the probe plan's cost constants, and one
   32-query wave at a pinned B=256 (the sort-free wide square path) whose
   selected cells, totals, n_cells and grid_ok must equal a plain sorted
   walk of the same 256 x 256 region;
5. memory: each rung's peak device transients per query (rung 256
   included) against the searcher's wave model (``_bytes_per_query``);
6. profile: a torch.profiler trace of one steady-state ``search_batch``
   wave with and without rerank: device busy time, idle share and the top
   ops (chrome traces in ``build/profile/``);
7. pca: the trained ``LOPQModelPCA`` (``pca_P [4096, 256]``): 262,144 raw
   rows through
   ``add_data(store_feats=True)`` and a 100-query rerank wave, held equal
   to a plain-model searcher given the projected rows and queries;
7a. sharded (SHARDED), on the main path's rows, codes and tables (nothing
   encoded again): ``ShardedLOPQSearcher`` on one real shard
   (``make_mesh()``: every visible card) and on 4 logical shards of the
   card; waves of 100 with and without rerank on the natural ladder and
   one pinned to rung 64, where ``lut_build`` must launch and the ids
   equal a replay with the plain LUT (but rounding ties; 1e-4 absolute);
   100 index rows as queries, whose top-1 on the logical shards equals
   the one-shard index's wherever that returns the row itself, and every
   id both return at the same distance (rtol 1e-5); recall@{1, 10} and
   overlap@10 of both against the exact neighbours; the brute plan across
   the logical shards equal to the single store's ``brute_query_batch``
   (but rows at equal float32 distances); ``dp_encode`` of 1,048,576 rows
   on 1 and 4 shards equal to ``predict_batch``; one ``dp_lloyd_step`` at
   V=4096 on 2,000,000 x 128 rows equal to the single-device step (rtol
   1e-5); and a bfloat16 ``LOPQSearcherTorch`` (5.37 GB against 10.74;
   the ``auto`` plan picks float32 on the card; every exact distance equal
   to a float32 recompute from the rounded rows, rtol 1e-5; overlap@10
   with the float32 store). Traces of one rerank wave unsharded, on one
   shard and on 4 logical shards, and a host profile of the one-shard
   wave;
8. exhaustive: the face-search configuration (conf/conf_search_face_local
   .json, 128-d embeddings) with the trained face model, 8,388,608 rows
   of the face mixture through
   ``ExhaustiveADC`` (scan kernel vs plain at NQ=8 on that index, then
   ``search_batch`` at nq 8 and 64, k=100, with the LUT and scan kernels'
   launch counts read around it; the tiled tables of ``search_batch``
   equal to ``tile_luts(build_query_luts)``, and 4 queries of each nq
   held to a selection on the plain distances), a torch.profiler trace
   of one launch at each nq, and ``ExhaustiveADCSearcher`` on a
   20,000-row subset (the trained model spreads rows over the cells, so
   a larger subset pads past the layout's 8x guard).
   The headline state is freed first;
9. fc7: DeepSentibank on the card — the golden fc7 of
   ``tests/data/grace_hopper.jpg`` (deterministic Caffe blobs, the
   generator copied from tests/test_sentibank_weights.py), the card's fc7
   against the plain CPU forward on the same weights and pixels, and the
   forward's time per wave at n = 1, 8, 32 in float32 and bfloat16;
10. serving: the release configuration (conf/conf_search_production.json:
   ``lopq_pca`` 4096 -> 256, V=4096, M=8, rerank on with the device store,
   coalescing 4 ms / 32; the rerank depth raised to 4,096, see SERVING). The trained release model goes into the port's
   storer, the facade comes
   from ``common.factory.build_searcher``, 10,485,760 index-space rows go
   in through ``add_codes(..., feats=...)``; then the ingest pipeline
   (10a) fills the facade's store and ``load_codes`` indexes its rows
   (the refresh seconds are printed). ``make_server`` then answers
   ``byB64`` requests for pipeline images from 1 and from 32 concurrent
   clients and one ``byPATH`` request for the pipeline's copy of
   grace_hopper.jpg: every answer has no error and the query image
   first; one coalesced wave's ids equal ``search_batch`` on the same fc7
   normalized on the host; ``lut_build`` must launch. A torch.profiler
   trace of one 32-request wave gives device busy time and idle share;
   then conf/conf_search_sharded.json (``sharded``) through
   ``build_searcher`` on the same store: the trained release model under
   the conf's model string, the bulk rows through ``add_codes(...,
   feats=...)``, the pipeline's rows through ``load_codes`` (the conf
   keeps no device rerank store, so the rerank runs on the host), the
   serving phase's rerank depth; ``byB64`` from 1 and 32 clients, each
   query image first;
10a. pipeline (inside 10, once the facade holds the bulk rows): under
   ``build/pipeline/``, 2,000 JPEGs (grace_hopper.jpg and the seeded ones
   of ``serving_images``), a PNG, a GIF and a JPEG truncated after its
   header; conf/conf_extraction_local.json as shipped with only
   ``CHECK_input_dir`` and ``KVI_db_path`` (the facade's store)
   rewritten; ``python -m columbiaimagesearch_tpu_torch.pipeline.
   run_processing -c <conf> --once`` as a subprocess on the card (the
   facade's Sentibank weights through $SENTIBANK_WEIGHTS), failing on a
   timeout, a nonzero exit or a retried pass. Checks on the store: one
   update per 1,000 files in walk order, each processed and completed; an
   fc7 column for every decodable image; the failed column for the
   truncated JPEG (PIL's path: imgpipe does not build on the card's
   machine); a second ``--once`` run creates and processes nothing; 16
   sampled images' stored fc7 equal to the card featurizer's
   ``featurize_buffers`` on the same bytes (1e-4) and to the CPU forward
   of the same pixels (FC7_RTOL/ATOL). Prints img/s over the whole run,
   each update's fetch/extract/write seconds from the subprocess, and each
   update replayed stage by stage in this process (buffer fetch, decode
   and resize, device forward, column encode + sqlite write);
10b. code store: ``LOPQSearcherTorch(trained release model,
   codestore_path=build/codestore/...)`` takes 1,048,576 rows in 8
   ``add_codes``; a second searcher opened on the file answers a
   100-query wave exactly as a fresh searcher fed ``read_all()``'s rows
   in that order (ids and distances); 8,192 rows appended after the
   restart are held by a third open. Prints append MB/s, ``sync`` and
   reload seconds. Then one 8,192-row refresh of the sort path
   (``append_and_build_csr``) at 10,485,760 and 41,943,040 rows of
   capacity (codes only), the measurement that decides whether the JAX
   package's ``merge_append_csr`` is needed on this card;
11. face (after the exhaustive phase, over its model and 8,388,608 rows):
   ``lut_build`` against its plain version at the face probed shapes
   (V=256, Dh=64, B=64; NQ 1 and 32, the probe lists of a real wave);
   ``LOPQSearcherTorch`` waves of 32 on the default ladder (64, (128, 8),
   256) and at a pinned ``probe_width=256`` (the wide square path), 4
   queries' selection held to a plain sorted walk, the ms a wave at each
   rung and the memory model at rung 256; natural escalation on an
   8,192-row subset (below the quota, so the ladder must reach 256, and
   those answers must equal the pinned-256 ones); the detector (8
   ``face_synth`` scenes, the same boxes on the card and the CPU, ms an
   image split into host pyramid, device, host NMS) and FaceResNet (card
   vs CPU forward, ms at n = 1, 8, 32); and conf/conf_search_face_local
   .json served over HTTP (``build_searcher``, 18 scenes written as files
   and taken by ``build_checker`` and ``build_processor`` with the face
   keys, then ``load_codes``, then the index rows through
   ``add_codes``, ``byB64`` from 1 and 32 clients and one ``byPATH``,
   every query face found first as itself, one coalesced face wave equal
   to sequential ``search_from_feats``, ``lut_build`` launched);
12. tools (TOOLS), the operator tools' ``python -m`` modules on the card,
   under ``build/tools/``: ``build_index`` for conf/conf_search_face_local
   .json from an .fvecs of its 500,000 rows (the storer's model and the
   code store answer 32 queries exactly as a searcher fed
   ``predict_batch`` in memory) and for the release shapes (``lopq_pca``
   4096 -> 256, V=4096) from an .npy of 262,144 raw rows drawn as in 2a
   (``pca_P`` spans the basis, every stored code is the loaded model's
   encoding of its row), with each stage's seconds; ``eval_recall`` at its
   defaults (1,000,000 rows, dim 128, V=256, 100 queries, quota 10,000,
   probe widths adaptive and 64; the fused rerank's recall@k at least the
   probed one's at every k, and at width 64 its top-100 equal to a
   float64 re-sort of the probed top-1,000 but rounding ties), its
   exhaustive stage on a V=128 model of the same rows and 8 of its
   queries replayed through both kernels' plain versions;
   ``eval_recall_realfeat`` at 20,000 rows, V 256; ``train_face_template
   --synth 120`` (the template round-trips bit-equal, the detector loaded
   from it finds the trained one's boxes), ``eval_face_detector`` on 20
   scenes (AP beside the committed 0.6997, not gated); and
   ``drop_weights --dry-run``;
13. recall parity (RECALL_PARITY, RECALL_RUNS), on a model of its own:
   (a) ``eval_recall.run`` at the config of the JAX package's
   benchmarks/r05_recall_adversarial_10M_rerank.json (10,485,760 x 256
   rows drawn on the host as the JAX script draws them, V=4096, M=8,
   query noise 0.25, quotas 10,000 and 100,000, widths 64, 256 and
   adaptive, the fused rerank in bfloat16); (b) the stages on 104,857,600
   rows made on the card (``--stream-synth``) on (a)'s model, at the
   config of r05_recall_100M.json; (c) 100 queries at noise 0.1 on (b)'s
   index (r05_recall_100M_neardup.json). Each artifact row is matched by
   method and probe width and held to its rule (within 0.10; within 3
   sigma of the pooled recall; at least the JAX recall - 0.04), with the
   widths' and quotas' orderings; a wave pinned to width 64 in (a) and
   (b) equal to its replay with the plain LUT and a float64 re-scoring
   of the codes, and in (a) the bfloat16 fused rerank equal to a float64
   re-sort of the probed top-1,000; then 8,192 more rows into (b)'s
   index, the refresh timed on the host and its sort path
   (``append_and_build_csr``) on the card. Stage seconds, the seconds of
   ``add_codes``' steps at 104,857,600 rows and the peak card memory are
   printed; the artifacts go under build/recall_parity/.

Before the ``kernels`` line, a ``{"train": {...}}`` line carries the stage
seconds, the checks' numbers, the recalls, and the card's name and power
limit, an ``{"ingest": {...}}`` line the pipeline's, the refresh's
and the code store's numbers, and a ``{"sharded": {...}}`` line the
sharded phases' numbers, and one line each for the wide, model I/O,
decode, face training and tools phases and a ``{"recall_parity": {...}}``
line with each parity row. The last line is
``{"ok": true, "device": {...}}``; any failure raises and exits non-zero
before it. Run from the root of a checkout:

    python3 chip_smoke.py

Imports nothing of JAX.
"""

import base64
import itertools
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

HEADLINE = dict(rows=10_485_760, train=262_144, V=4096, M=8, S=256, D=256,
                quota=10_000, limit=100, rerank_nb=1000, wave=100, waves=3,
                B=64, strip_rung=(256, 16), seed=0)

#: the face-search configuration (conf/conf_search_face_local.json:2-5;
#: 128-d embeddings, columbiaimagesearch_tpu/models/face.py:25) at 128 V^2
#: rows, the regime columbiaimagesearch_tpu/index/pallas_adc.py:18-20 names
FACE = dict(rows=8_388_608, train=262_144, V=256, M=8, S=256, D=128, k=100,
            nqs=(8, 64), subset=20_000, seed=0)
#: the release model's PCA widths (conf/conf_search_production.json)
PCA = dict(rows=262_144, wave=100)
#: the serving phase: the trained release model over the headline's
#: 10,485,760 index rows (the PCA image of raw rows; they go in through
#: add_codes: 10.5M base64 4096-d features do not go through sqlite), plus
#: the ingest pipeline's images through its store and load_codes; the
#: first ``images`` + 1 of them are the queries. The rerank depth is
#: raised from the conf's 1,000 to 4,096: the trained release model
#: quantizes the 2,002 pipeline rows (unit-norm fc7 of a random net, near
#: the centre of its training cloud) into 31 cells and 47 distinct codes,
#: so ADC ties them, and only an exact rerank of all of them finds each
#: query image first (with 1,000, 2 of 41 query images missed on an H100
#: 80GB HBM3)
SERVING = dict(conf="conf/conf_search_production.json", rows=10_485_760,
               images=40, single=16, clients=32, rounds=3, seed=0,
               overrides={"SEARCHLOPQ_rerank_nb": 4096})
#: the ingest pipeline (conf/conf_extraction_local.json as shipped:
#: batch_update_size 1000, 8 fetch threads): ``images`` seeded JPEGs plus
#: grace_hopper.jpg, one PNG, one GIF and one JPEG truncated after its
#: header, through ``python -m ...pipeline.run_processing --once`` on the
#: card into the serving phase's store; ``sample`` images' stored fc7 held
#: to the card's direct ``featurize_batch`` (FC7_SAMPLE_ATOL) and to the
#: CPU forward (FC7_RTOL/ATOL); each run_processing call may take
#: ``timeout`` seconds
PIPELINE = dict(conf="conf/conf_extraction_local.json", images=1999,
                sample=16, seed=0, timeout=240)
FC7_SAMPLE_ATOL = 1e-4
#: the code store on the trained release model: ``rows`` in ``adds``
#: add_codes calls, a ``wave`` of queries after the restart, ``extra`` rows
#: appended after it; then one ``chunk``-row refresh of the sort path
#: (``append_and_build_csr``) at each ``caps`` rows of capacity
CODESTORE = dict(rows=1_048_576, adds=8, wave=100, quota=10_000, limit=100,
                 extra=8192, chunk=8192, caps=(10_485_760, 41_943_040),
                 seed=0)
#: DeepSentibank forward timing: wave sizes, and the golden fc7 tolerance
#: (tests/test_sentibank_weights.py:121); card vs CPU forward tolerance
#: (tests/test_sentibank.py:106)
FC7_WAVES = (1, 8, 32)
GOLDEN_RTOL, GOLDEN_ATOL = 2e-2, 2e-4
FC7_RTOL, FC7_ATOL = 2e-3, 2e-3
#: coalesced wave vs search_batch on host-normalized rows: distances
SERVING_DIST_ATOL = 1e-4
#: the sharded phase on the main path's 10,485,760 rows of the trained
#: release model: one real shard (every visible card: one on a one-card
#: machine) and ``shards`` logical shards on the first card; a wave pinned
#: to the LUT rung ``probe`` (the trained model's floor starts at rung 256,
#: which builds no tables); ``self_queries`` index rows as queries (their
#: nearest row is themselves); ``dp_encode`` of ``dp_rows`` rows and one
#: ``dp_lloyd_step`` at V=4096 on the first half of ``lloyd_rows`` rows
#: (drawn as the 2,000,000 training rows are); and
#: conf/conf_search_sharded.json served over HTTP inside the serving phase
#: (its pipeline store), ``single`` requests from one client and one round
#: of ``clients`` (8, cut from 32 to hold the run's time: each request's
#: host rerank reads 4,096 candidates through sqlite, and the round of 32
#: took ~30 s)
SHARDED = dict(shards=4, probe=64, self_queries=100, dp_rows=1_048_576,
               lloyd_rows=2_000_000, conf="conf/conf_search_sharded.json",
               single=4, clients=8, seed=0)
#: the pinned LUT wave against its replay with the plain LUT (absolute)
SHARDED_DIST_ATOL = 1e-4
#: the brute plan across shards against the single store's (absolute, a
#: few float32 ulps at the distances of the headline rows, ~6)
BRUTE_TIE_ATOL = 1e-6
#: distances the 1- and 4-shard indexes both return; dp Lloyd vs the
#: single-device step (relative, and absolute for components near 0)
SHARDED_RTOL, LLOYD_ATOL = 1e-5, 1e-6
#: the face phase, over the exhaustive phase's face index (FACE): probed
#: 32-query waves at quota 10,000 (the facade's quota at sim_limit 100),
#: ``check`` queries held to a plain selection, natural escalation on a
#: ``subset`` below the quota, the detector on ``det_scenes`` scenes, the
#: embedder at ``embed_waves``, and conf/conf_search_face_local.json
#: served over HTTP with ``scenes`` face_synth scenes indexed: ``single``
#: requests from one client and ``rounds`` of ``clients`` concurrent ones
#: (on the trained face model the host rerank takes ~3.4 s a request, so
#: one round of 32 is ~90 s of the run). 36 scenes hold 886 faces, fewer
#: than the conf's rerank_nb of 1,000: the random embedder puts every face
#: in one tight cluster (squared distances ~1e-3) that ADC cannot order,
#: so with more faces than rerank_nb a query face can miss the exact
#: rerank and another face come back first (40 scenes, 1,056 faces did).
#: The scenes, ``single`` and the ``parity`` wave are kept at 18, 2 and 4
#: so that the whole run stays under 450 s: a request's host rerank reads
#: the face columns of every indexed scene (~2 s a request at 36 scenes)
FACE_PHASE = dict(conf="conf/conf_search_face_local.json", wave=32,
                  waves=3, quota=10_000, limit=100, check=4, subset=8192,
                  det_scenes=8, embed_waves=(1, 8, 32), scenes=18, single=2,
                  clients=32, rounds=1, parity=4, seed=0)
#: FaceResNet card vs CPU forward (tests/test_torch_face.py); detector
#: scores card vs CPU
EMBED_RTOL, EMBED_ATOL = 1e-4, 1e-4
DET_SCORE_ATOL = 1e-4

KERNELS = ("lut_build", "adc_scan")

#: scan kernel checks: (label, rows, V, M, S, NQ, odd). The profile
#: configuration of scripts/profile_exhaustive.py:28-35 (uniform random
#: codes), and a small odd shape: ragged multi-block cells and count-0
#: blocks.
SCAN_CASES = [("profile NQ=8", 1 << 20, 64, 8, 256, 8, False),
              ("profile NQ=64", 1 << 20, 64, 8, 256, 64, False),
              ("small odd NQ=1", 3000, 37, 4, 32, 1, True),
              ("small odd NQ=3", 3000, 37, 4, 32, 3, True),
              ("small odd NQ=12", 3000, 37, 4, 32, 12, True),
              ("small odd NQ=64", 3000, 37, 4, 32, 64, True)]

#: kernel vs plain tolerance: fp32 both sides, sums in another order
LUT_RTOL, LUT_ATOL = 1e-5, 1e-4

#: the H100 SXM's published peaks at its full 700 W (NVIDIA's data sheet):
#: HBM3 bytes/s and fp32 FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def log(msg):
    print(msg, flush=True)


def card_line():
    """``name, power.limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters, warmup=1):
    """Per-call device times (ms) of ``fn`` from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return times


def kernel_ms(fn, iters, reps=3):
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls
    made back to back, the median of ``reps`` such runs. The host enqueues
    ahead of the device, so this is the device's time per call (the
    kernel's, for a wrapper); ``time_ms`` adds the host's launch cost."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / iters)
    return float(np.median(out))


def graph_ms(fn, iters, reps=3):
    """Device ms per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed between CUDA events, the median of ``reps`` replays.
    No host work sits between the calls, so a call shorter than its launch
    is timed too. ``fn`` must launch on the current stream and not sync."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / iters)
    del graph
    return float(np.median(out))


def host_ms(fn, iters, sync):
    """Per-call host-clock times (ms) of work that ends in a sync."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def bound_of(nbytes, flops):
    """(bound ms, which binds): the larger of the bytes over the card's
    memory rate and the operations over its fp32 rate."""
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def lut_work(isel, V, Dh, F, S, Dsub):
    """Bytes and FLOPs of one ``build_luts`` call on these ids: each
    distinct probed (split, cluster) matrix, Cs and mus row read once
    (counted with ``torch.unique`` on this ``isel``), the queries, the ids,
    ``subs`` and the output; per valid slot a residual, a rotation and
    F*S*Dsub (sub, square, add). Returns (bytes, flops, distinct)."""
    NQ, _, B = isel.shape
    s = torch.arange(2, device=isel.device).view(1, 2, 1)
    valid = (isel >= 0) & (isel < V)
    distinct = int(torch.unique((s * V + isel.long())[valid]).numel())
    slots = int(valid.sum())
    nbytes = (distinct * (Dh * Dh + 2 * Dh) * 4 + NQ * 2 * Dh * 4
              + isel.numel() * 4 + 2 * F * S * Dsub * 4
              + NQ * 2 * B * F * S * 4)
    flops = slots * (2 * Dh * Dh + 2 * Dh + 3 * F * S * Dsub)
    return nbytes, flops, distinct


def scan_work(block_count, M, V, S, NQ):
    """Bytes and FLOPs of one ``adc_scan_all``: the codes, the block
    arrays, both tables and the [NQ, Npad] output once each; M - 1 adds
    per valid row and query."""
    NB = block_count.shape[0]
    npad = NB * 128
    valid = int(block_count.clamp(min=0).sum())
    nbytes = (npad * M + 2 * NB * 4 + 2 * V * (M // 2) * S * NQ * 4
              + NQ * npad * 4)
    return nbytes, valid * NQ * (M - 1)


def bound_text(ms, nbytes, flops):
    b_ms, by = bound_of(nbytes, flops)
    return (f"bound_ms={b_ms:.4f} (bound by {by}: {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.3f} GFLOP) share={b_ms / ms:.3f}")


def scan_library_inputs(codes, block_cell, block_count, lut0, lut1, V):
    """The scan as one ``embedding_bag(mode="sum")``: the weight is both
    tables flattened to [2*V*F*S, NQ] plus one +inf row, and each padded
    row's bag holds its M table rows (padding rows: M times the +inf row).
    Built outside any timed region; the port never calls this."""
    from columbiaimagesearch_tpu_torch.index.exhaustive_adc import BLK

    M = codes.shape[1]
    F, S, NQ = lut0.shape[1], lut0.shape[2], lut0.shape[3]
    VFS = V * F * S
    cell = block_cell.long().repeat_interleave(BLK)
    valid = (torch.arange(BLK, device=codes.device)[None, :]
             < block_count[:, None]).reshape(-1)
    m = torch.arange(M, device=codes.device)
    h, f = m // F, m % F
    half = torch.where(h[None, :] == 0, (cell // V)[:, None],
                       (cell % V)[:, None])
    idx = h * VFS + half * (F * S) + f * S + codes.long()
    idx[~valid] = 2 * VFS
    weight = torch.cat([lut0.reshape(VFS, NQ), lut1.reshape(VFS, NQ),
                        torch.full((1, NQ), float("inf"),
                                   device=lut0.device)])
    return idx, weight


def scan_library(idx, weight):
    return torch.nn.functional.embedding_bag(idx, weight, mode="sum")


# ------------------------------------------------------------ synthetic data


def mixture(n, comp, g, chunk=1 << 20):
    """``n`` rows of the benchmark's gaussian mixture (bench.py:110-125):
    one of the unit-norm components plus 0.3 * N(0, I) noise."""
    D = comp.shape[1]
    out = torch.empty((n, D), dtype=torch.float32, device=comp.device)
    for lo in range(0, n, chunk):
        k = min(chunk, n - lo)
        which = torch.randint(0, comp.shape[0], (k,), generator=g,
                              device=comp.device)
        out[lo:lo + k] = torch.randn(k, D, generator=g,
                                     device=comp.device).mul_(0.3)
        out[lo:lo + k] += comp[which]
    return out


def make_model(train, V, M, S, g):
    """A well-formed random LOPQ model: coarse centroids and
    subquantizers sampled from the rows, orthogonal rotations from a
    seeded QR, residual means from one assignment pass."""
    from columbiaimagesearch_tpu_torch.index.model import LOPQModel

    dev = train.device
    n, D = train.shape
    Dh, F = D // 2, M // 2
    Dsub = Dh // F
    halves = train.reshape(n, 2, Dh)
    Cs = torch.stack([halves[torch.randperm(n, generator=g, device=dev)[:V],
                             s] for s in range(2)])
    Rs = torch.linalg.qr(torch.randn(2 * V, Dh, Dh, generator=g,
                                     device=dev))[0].reshape(2, V, Dh, Dh)
    mus = torch.zeros((2, V, Dh), device=dev)
    proj = torch.empty((2, n, Dh), device=dev)
    for s in range(2):
        x = halves[:, s]
        a = torch.argmin((Cs[s] * Cs[s]).sum(1)[None] - 2.0 * x @ Cs[s].T,
                         dim=1)
        res = x - Cs[s][a]
        cnt = torch.bincount(a, minlength=V).clamp(min=1)
        mus[s] = torch.zeros((V, Dh), device=dev).index_add_(0, a, res) \
            / cnt[:, None]
        for lo in range(0, n, 8192):
            aa = a[lo:lo + 8192]
            proj[s, lo:lo + 8192] = torch.bmm(
                Rs[s][aa], (res[lo:lo + 8192] - mus[s][aa])[:, :, None])[..., 0]
    subs = torch.stack([torch.stack([
        proj[s, torch.randperm(n, generator=g, device=dev)[:S],
             f * Dsub:(f + 1) * Dsub] for f in range(F)]) for s in range(2)])
    return LOPQModel(Cs, Rs, mus, subs, device=dev)


# ------------------------------------------------------------- training

#: the training phase: the release configuration (``conf``: lopq_pca
#: 4096 -> 256, V=4096, M=8, S=256, nb_train 2,000,000, nb_train_pca
#: 200,000) on raw rows that are the headline's 256-d gaussian mixture
#: mapped through a seeded orthonormal [256, raw_dim] basis plus isotropic
#: ``noise`` (so PCA has a known answer), and the face configuration
#: (``face_conf``: lopq, V=256, M=8, S=256, nb_train 500,000) on the face
#: mixture; ``heldout`` rows for the distortion checks, Lloyd card vs CPU
#: on ``lloyd_rows`` x Dh from one ``C_init``, recall over ``queries``
#: queries that are indexed rows plus ``query_noise`` N(0, I) (as
#: scripts/eval_recall.py makes them; 0.3 is the rows' own noise around
#: their component, where 0.1 left both models at recall 1.0 in a CPU
#: trial) on a ``sub_rows`` sub-index, and
#: ``train_index`` through the facade on ``index_rows`` seeded features at
#: V=``index_V``
TRAIN = dict(conf="conf/conf_search_production.json",
             face_conf="conf/conf_search_face_local.json", raw_dim=4096,
             noise=0.01, heldout=262_144, lloyd_rows=262_144, lloyd_iters=10,
             queries=100, query_noise=0.3, sub_rows=1 << 20,
             index_rows=20_000, index_V=64, seed=0, overrides={},
             face_overrides={})
#: card vs plain: Lloyd after one iteration (share of equal assignments,
#: centroid max abs), after all iterations (inertia, relative)
LLOYD_AGREE, LLOYD_C_ATOL, LLOYD_INERTIA_RTOL = 0.9999, 1e-4, 1e-3
#: rotations against a float64 eigh (relative to each cluster's largest
#: eigenvalue), with at most a ROT_MAX_TIES share of clusters whose greedy
#: allocation meets a near-tie; rotations orthonormal; PCA cosines
ROT_RTOL, ROT_MAX_TIES, ORTHO_ATOL, PCA_COS_MIN = 1e-4, 0.03, 1e-4, 0.999
RECALL_SLACK = 0.01


def raw_source(dev, latent_dim, raw_dim, noise, seed):
    """The raw rows' generator: the mixture's components, a seeded
    orthonormal [latent_dim, raw_dim] basis (rows), the noise level."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 11)
    comp = torch.randn(256, latent_dim, generator=g, device=dev)
    comp /= comp.norm(dim=1, keepdim=True)
    basis = torch.linalg.qr(torch.randn(raw_dim, latent_dim, generator=g,
                                        device=dev))[0].T.contiguous()
    return dict(comp=comp, basis=basis, noise=noise, g=g)


def raw_rows(n, src, chunk=1 << 18):
    """``n`` raw rows: a mixture row through the basis plus noise."""
    basis = src["basis"]
    out = torch.empty((n, basis.shape[1]), dtype=torch.float32,
                      device=basis.device)
    for lo in range(0, n, chunk):
        o = out[lo:lo + chunk]
        o.normal_(0.0, src["noise"], generator=src["g"])
        o.addmm_(mixture(o.shape[0], src["comp"], src["g"]), basis)
    return out


def index_rows(n, src, model, chunk=1 << 18):
    """The PCA image of ``n`` fresh raw rows under ``model``, made a
    chunk at a time (the raw rows never exist whole)."""
    out = torch.empty((n, model.pca_P.shape[1]), dtype=torch.float32,
                      device=model.device)
    for lo in range(0, n, chunk):
        out[lo:lo + chunk] = model.apply_PCA(
            raw_rows(min(chunk, n - lo), src))
    return out


class StageClock:
    """Seconds of each training stage, read by wrapping the training
    modules' functions while ``patched()`` is open; each wrapper
    synchronises the card before and after the stage it times."""

    def __init__(self, sync):
        self.sync = sync
        self.seconds = {}
        self.kind = "coarse"

    def _timed(self, name, fn):
        def run(*a, **k):
            self.sync()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.sync()
                key = name() if callable(name) else name
                self.seconds[key] = (self.seconds.get(key, 0.0)
                                     + time.perf_counter() - t0)
        return run

    def patched(self):
        import contextlib

        from columbiaimagesearch_tpu_torch.index import model as mm
        from columbiaimagesearch_tpu_torch.ops import kmeans as km
        from columbiaimagesearch_tpu_torch.ops import rotations as rm

        calls = itertools.count()
        real_auto = mm.fit_kmeans_auto

        def auto(*a, **k):           # the first two runs are the coarse ones
            self.kind = "coarse" if next(calls) < 2 else "subquantizer"
            return real_auto(*a, **k)

        def stage(coarse):
            return lambda: (coarse if self.kind == "coarse"
                            else "subquantizer k-means")

        stack = contextlib.ExitStack()
        for mod, name, fn in (
                (mm, "train_pca", self._timed("pca", mm.train_pca)),
                (mm, "_apply_pca", self._timed("pca apply", mm._apply_pca)),
                (mm, "fit_kmeans_auto", auto),
                (km, "kmeans_plusplus_init", self._timed(
                    stage("coarse seeding"), km.kmeans_plusplus_init)),
                (km, "_lloyd", self._timed(stage("coarse Lloyd"),
                                           km._lloyd)),
                (rm, "accumulate_covariance_estimators", self._timed(
                    "accumulators", rm.accumulate_covariance_estimators)),
                (rm, "_eigh", self._timed("eigh", rm._eigh)),
                (rm, "eigenvalue_allocation_batch", self._timed(
                    "allocation", rm.eigenvalue_allocation_batch)),
                (mm, "project_residuals_to_local", self._timed(
                    "projection", mm.project_residuals_to_local))):
            stack.enter_context(mock.patch.object(mod, name, fn))
        return stack


def _fit_timed(fit, sync, dev):
    """``fit()`` under a StageClock: (model, stage seconds with ``total``
    and ``other``, peak device GB)."""
    clock = StageClock(sync)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with clock.patched():
        model = fit()
        sync()
    total = time.perf_counter() - t0
    stages = {k: round(v, 3) for k, v in clock.seconds.items()}
    stages["other"] = round(total - sum(clock.seconds.values()), 3)
    stages["total"] = round(total, 3)
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)
    return model, stages, peak


def _check_trained(model, heldout, seeded, what):
    """Orthonormal rotations, and a mean subquantizer distortion on
    held-out rows below the seeded model's. Returns the two distortions."""
    from columbiaimagesearch_tpu_torch.index.eval import (
        get_subquantizer_distortion,
    )

    Dh = model.Rs.shape[-1]
    eye = torch.eye(Dh, device=model.device)
    ortho = max(float((torch.bmm(R, R.transpose(1, 2)) - eye).abs().max())
                for R in model.Rs)
    if not ortho <= ORTHO_ATOL:
        raise AssertionError(f"{what}: rotations not orthonormal "
                             f"(max |R R^T - I| = {ortho:.3e})")
    dist = float(np.mean(get_subquantizer_distortion(heldout, model)))
    dist_seeded = float(np.mean(get_subquantizer_distortion(heldout,
                                                            seeded)))
    if not dist < dist_seeded:
        raise AssertionError(f"{what}: trained distortion {dist:.5f} is not "
                             f"below the seeded model's {dist_seeded:.5f}")
    return dict(ortho_max=ortho, distortion=dist,
                distortion_seeded=dist_seeded)


def phase_train(dev, card, cfg=None):
    """Train the release configuration (LOPQModelPCA.fit, as train_index
    calls it) and the face configuration (LOPQModel.fit) on the card at
    their conf sizes; check the PCA subspace, the rotations and the
    distortion against a seeded model. Returns the trained models, their
    data sources and the numbers."""
    from columbiaimagesearch_tpu_torch.index.model import (
        LOPQModel,
        LOPQModelPCA,
    )

    cfg = dict(TRAIN, **(cfg or {}))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    with open(os.path.join(ROOT, cfg["conf"])) as f:
        conf = dict(json.load(f), **cfg["overrides"])
    V, M = int(conf["SEARCHLOPQ_lopq_V"]), int(conf["SEARCHLOPQ_lopq_M"])
    S = int(conf["SEARCHLOPQ_lopq_subq"])
    D = int(conf["SEARCHLOPQ_lopq_pcadims"])
    n, n_pca = int(conf["SEARCHLOPQ_nb_train"]), int(
        conf["SEARCHLOPQ_nb_train_pca"])
    src = raw_source(dev, D, cfg["raw_dim"], cfg["noise"], cfg["seed"])
    t0 = time.perf_counter()
    raw = raw_rows(n, src)
    sync()
    make_s = time.perf_counter() - t0
    model, stages, peak = _fit_timed(lambda: LOPQModelPCA.fit(
        raw, pca_dims=D, n_init=1, random_state=0, pca_subsample=n_pca,
        V=V, M=M, subquantizer_clusters=S, device=dev), sync, dev)
    del raw
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"train: release {cfg['conf']} (lopq_pca {cfg['raw_dim']} -> {D}, "
        f"V={V} M={M} S={S}): {n} raw rows made on the card in "
        f"{make_s:.2f}s; LOPQModelPCA.fit(n_init=1, random_state=0, "
        f"pca_subsample={n_pca}) stage seconds {stages}; peak device "
        f"memory {peak if peak is None else round(peak, 2)} GB; "
        f"linalg {torch.backends.cuda.preferred_linalg_library()} [{card}]")
    cos = torch.linalg.svdvals(src["basis"] @ model.pca_P)
    if not float(cos.min()) >= PCA_COS_MIN:
        raise AssertionError(f"train: pca_P does not span the basis "
                             f"(least principal cosine {float(cos.min())})")
    g = torch.Generator(device=dev)
    g.manual_seed(cfg["seed"] + 12)
    base = LOPQModel(model.Cs, model.Rs, model.mus, model.subs, device=dev)
    seeded = make_model(index_rows(HEADLINE["train"], src, model), V, M, S,
                        g)
    heldout = index_rows(cfg["heldout"], src, model)
    rel = _check_trained(base, heldout, seeded, "train: release")
    rel.update(stages=stages, peak_gb=peak, rows=n, pca_rows=n_pca,
               pca_cos_min=float(cos.min()))
    log(f"train: release checks passed: pca_P spans the basis (least "
        f"principal cosine {rel['pca_cos_min']:.6f}), rotations orthonormal "
        f"(max |R R^T - I| {rel['ortho_max']:.2e}), mean subquantizer "
        f"distortion on {cfg['heldout']} held-out rows {rel['distortion']:.5f}"
        f" < seeded {rel['distortion_seeded']:.5f}")

    # The face configuration (no PCA) on the face mixture.
    with open(os.path.join(ROOT, cfg["face_conf"])) as f:
        fconf = dict(json.load(f), **cfg["face_overrides"])
    fV, fM = int(fconf["SEARCHLOPQ_lopq_V"]), int(fconf["SEARCHLOPQ_lopq_M"])
    fS, fn = int(fconf["SEARCHLOPQ_lopq_subq"]), int(
        fconf["SEARCHLOPQ_nb_train"])
    fg = torch.Generator(device=dev)
    fg.manual_seed(FACE["seed"] + 7)
    fcomp = torch.randn(256, FACE["D"], generator=fg, device=dev)
    fcomp /= fcomp.norm(dim=1, keepdim=True)
    ftrain = mixture(fn, fcomp, fg)
    fmodel, fstages, fpeak = _fit_timed(lambda: LOPQModel.fit(
        ftrain, n_init=1, random_state=0, V=fV, M=fM,
        subquantizer_clusters=fS, device=dev), sync, dev)
    fseeded = make_model(mixture(FACE["train"], fcomp, fg), fV, fM, fS, fg)
    face = _check_trained(fmodel, mixture(cfg["heldout"], fcomp, fg),
                          fseeded, "train: face")
    face.update(stages=fstages, peak_gb=fpeak, rows=fn)
    log(f"train: face {cfg['face_conf']} (lopq, V={fV} M={fM} S={fS}, "
        f"D={FACE['D']}): LOPQModel.fit on {fn} rows, stage seconds "
        f"{fstages}; peak {fpeak if fpeak is None else round(fpeak, 2)} GB; "
        f"rotations orthonormal ({face['ortho_max']:.2e}), distortion "
        f"{face['distortion']:.5f} < seeded {face['distortion_seeded']:.5f}"
        f" [{card}]")
    return dict(release=model, src=src, seeded=seeded, heldout=heldout,
                face=dict(model=fmodel, comp=fcomp, g=fg, train=ftrain),
                numbers=dict(release=rel, face=face))


def phase_train_plain(dev, card, trained, cfg=None):
    """Card against plain: Lloyd from one C_init on the card and on the
    CPU, and the face rotations against a float64 eigh with the copied
    allocation. Also times ``torch.linalg.eigh`` alone on 512 matrices
    of 128² and of 32² and on one 4096²."""
    from columbiaimagesearch_tpu_torch.ops.eigen_alloc import (
        eigenvalue_allocation_batch,
    )
    from columbiaimagesearch_tpu_torch.ops.kmeans import lloyd_kmeans
    from columbiaimagesearch_tpu_torch.ops.rotations import (
        accumulate_covariance_estimators,
        compute_rotations_from_accumulators,
    )

    cfg = dict(TRAIN, **(cfg or {}))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    model = trained["release"]
    V, Dh = model.V, model.Cs.shape[2]
    X = trained["heldout"][:cfg["lloyd_rows"], :Dh].contiguous()
    g = torch.Generator(device=dev)
    g.manual_seed(cfg["seed"] + 13)
    C0 = X[torch.randperm(X.shape[0], generator=g, device=dev)[:V]]
    out = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        C1, a1, _ = lloyd_kmeans(X.to(d), C0.to(d), iters=1)
        Cn, _, inertia = lloyd_kmeans(X.to(d), C1, iters=cfg["lloyd_iters"]
                                      - 1)
        sync()
        out[name] = (C1.cpu(), a1.cpu(), inertia, time.perf_counter() - t0)
    agree = float((out["card"][1] == out["cpu"][1]).double().mean())
    c_err = float((out["card"][0] - out["cpu"][0]).abs().max())
    i_rel = abs(out["card"][2] - out["cpu"][2]) / out["cpu"][2]
    log(f"train plain: Lloyd [{X.shape[0]}, {Dh}] V={V} from one C_init: "
        f"after 1 iteration assignments equal on {agree:.6f} of rows, "
        f"centroid max abs {c_err:.2e}; after {cfg['lloyd_iters']} inertia "
        f"card {out['card'][2]:.6e} cpu {out['cpu'][2]:.6e} (rel "
        f"{i_rel:.2e}); card {out['card'][3]:.2f}s, cpu "
        f"{out['cpu'][3]:.2f}s (host clock) [{card}]")
    if not (agree >= LLOYD_AGREE and c_err <= LLOYD_C_ATOL
            and i_rel <= LLOYD_INERTIA_RTOL):
        raise AssertionError("train plain: Lloyd on the card differs from "
                             "the CPU's")

    face = trained["face"]
    fm = face["model"]
    fDh = fm.Cs.shape[2]
    A, mu, cnt, _, _ = accumulate_covariance_estimators(
        face["train"][:, :fDh], fm.Cs[0])
    R, _ = compute_rotations_from_accumulators(A, mu, cnt, fm.M // 2)
    # The card's own eigenvalues, from the same covariance (the formula of
    # compute_rotations_from_accumulators, on the card).
    m32 = mu / cnt.clamp_min(1.0)[:, None]
    cov32 = ((A + A.transpose(1, 2))
             / (2.0 * (cnt - 1.0)).clamp_min(1.0)[:, None, None]
             - m32[:, :, None] * m32[:, None, :])
    E32 = torch.linalg.eigh(cov32)[0].double().cpu().numpy()
    A64, mu64 = A.double().cpu().numpy(), mu.double().cpu().numpy()
    n64 = cnt.double().cpu().numpy()
    m = mu64 / np.maximum(n64, 1.0)[:, None]
    cov = ((A64 + A64.transpose(0, 2, 1))
           / np.maximum(2.0 * (n64 - 1.0), 1.0)[:, None, None]
           - m[:, :, None] * m[:, None, :])
    E, _ = np.linalg.eigh(cov)
    deg = n64 < fDh
    E[deg] = E32[deg] = 1.0
    perm = eigenvalue_allocation_batch(fm.M // 2, E)
    # The greedy allocation is discontinuous: where two buckets' log-sums
    # nearly tie, fp32 eigenvalues can pick another bucket than float64
    # ones. Those clusters are held to the allocation of the card's own
    # eigenvalues (the same copied code) and counted.
    perm_card = eigenvalue_allocation_batch(fm.M // 2, E32)
    ties = (perm != perm_card).any(axis=1) & ~deg
    R64 = R.double().cpu().numpy()
    worst_off = worst_diag = worst_eig = 0.0
    for v in np.nonzero(~deg)[0]:
        rot = R64[v] @ cov[v] @ R64[v].T
        scale = E[v].max()
        worst_off = max(worst_off,
                        np.abs(rot - np.diag(np.diag(rot))).max() / scale)
        worst_eig = max(worst_eig, np.abs(E32[v] - E[v]).max() / scale)
        want = E[v][perm_card[v] if ties[v] else perm[v]]
        worst_diag = max(worst_diag, np.abs(np.diag(rot) - want).max() / scale)
    n_ties = int(ties.sum())
    log(f"train plain: face rotations (V={fm.V}, Dh={fDh}, "
        f"{int((~deg).sum())} clusters with count >= Dh) vs a float64 eigh "
        f"+ the copied allocation: R cov R^T off-diagonal max "
        f"{worst_off:.2e}, eigenvalues max {worst_eig:.2e}, diagonal vs the "
        f"reference eigenvalues in allocation order max {worst_diag:.2e} "
        f"(relative to each cluster's largest); {n_ties} clusters' "
        f"allocation meets a near-tie and follows the card's eigenvalues")
    if not (worst_off <= ROT_RTOL and worst_eig <= ROT_RTOL
            and worst_diag <= ROT_RTOL and n_ties <= ROT_MAX_TIES * fm.V):
        raise AssertionError("train plain: face rotations differ from the "
                             "float64 reference")

    # torch.linalg.eigh alone: per-matrix cost at the rotations' width
    # (the fit's own eigh stage times the 4,096-matrix calls), at a width
    # cuSOLVER's batched Jacobi covers (n <= 32), and the PCA's one matrix.
    eigh_s = {}
    if dev.type == "cuda":
        for b, n in ((512, Dh), (512, 32), (1, model.pca_P.shape[0])):
            B = torch.randn(b, n, n // 2, generator=g, device=dev)
            cov = B @ B.transpose(1, 2)
            torch.linalg.eigh(cov[:1])
            sync()
            t0 = time.perf_counter()
            torch.linalg.eigh(cov)
            sync()
            eigh_s[f"{b}x{n}^2"] = round(time.perf_counter() - t0, 4)
            del B, cov
        log(f"train plain: torch.linalg.eigh alone (s): {eigh_s}; linalg "
            f"{torch.backends.cuda.preferred_linalg_library()} [{card}]")
    return dict(lloyd_agree=agree, lloyd_c_err=c_err, lloyd_inertia_rel=i_rel,
                rot_off=worst_off, rot_diag=worst_diag, eigh_alone_s=eigh_s)


def phase_train_index(dev, card, cfg=None):
    """``SearcherLOPQ.train_index`` through ``build_searcher``: the
    release conf with ``lopq`` at V=``index_V``, its KVIndexer holding one
    update of ``index_rows`` seeded 256-d features; the facade trains at
    init on the card and saves the model, a second facade loads it, and
    one query answers with itself first."""
    import shutil

    from columbiaimagesearch_tpu_torch.common.factory import (
        build_indexer,
        build_searcher,
    )
    from columbiaimagesearch_tpu_torch.extraction.extractor import (
        build_extr_str,
    )
    from columbiaimagesearch_tpu_torch.extraction.featsio import (
        normfeatB64encode,
    )
    from columbiaimagesearch_tpu_torch.index.model import LOPQModel

    cfg = dict(TRAIN, **(cfg or {}))
    work = os.path.join(ROOT, "build", "train_index")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        with open(os.path.join(ROOT, cfg["conf"])) as f:
            conf = json.load(f)
        n, D = cfg["index_rows"], int(conf["SEARCHLOPQ_lopq_pcadims"])
        conf.update({"SEARCHLOPQ_model_type": "lopq",
                     "SEARCHLOPQ_lopq_V": cfg["index_V"],
                     "SEARCHLOPQ_nb_train": n,
                     "SEARCHLOPQ_train_at_init": True,
                     "SEARCHLOPQ_coalesce_window_ms": None,
                     "KVI_db_path": os.path.join(work, "cuimgsearch.db"),
                     "ST_base_path": os.path.join(work, "storer")})
        g = torch.Generator(device=dev)
        g.manual_seed(cfg["seed"] + 14)
        comp = torch.randn(64, D, generator=g, device=dev)
        feats = mixture(n, comp, g)
        feats = (feats / feats.norm(dim=1, keepdim=True)).cpu().numpy()
        extr = build_extr_str("sentibank", "full", "image")
        sha1s = [f"{i:040X}" for i in range(n)]
        kv = build_indexer(conf)
        kv.push_dict_rows({s: {f"ext:{extr}": normfeatB64encode(x),
                               f"ext:{extr}_processed": "1",
                               kv.get_col_imgurl(): f"img/{s}"}
                           for s, x in zip(sha1s, feats)},
                          kv.table_sha1infos_name)
        uid, _ = kv.get_next_update_id(extr_type=extr)
        kv.push_dict_rows({uid: {kv.get_col_listsha1s(): ",".join(sha1s)}},
                          kv.table_updateinfos_name)
        t0 = time.perf_counter()
        facade = build_searcher(conf)
        train_s = time.perf_counter() - t0
        if not (isinstance(facade.model, LOPQModel)
                and facade.model.device == dev
                and facade.get_nb_indexed() == n):
            raise AssertionError("train_index: the facade did not train and "
                                 "index on the card")
        conf["SEARCHLOPQ_train_at_init"] = False
        t0 = time.perf_counter()
        again = build_searcher(conf)
        load_s = time.perf_counter() - t0
        if not torch.equal(again.model.Rs, facade.model.Rs) or \
                again.get_nb_indexed() != n:
            raise AssertionError("train_index: the saved model did not load")
        out = again.search_from_feats([(sha1s[7], None)], [feats[7]],
                                      {"max_returned": 5})
        first = out["AllSimilarImages"][0]["SimilarImages"]["ImageSha1s"][0]
        if first != sha1s[7]:
            raise AssertionError(f"train_index: query 7 came back as {first}")
        log(f"train_index: build_searcher(lopq, V={cfg['index_V']}, "
            f"nb_train={n}) trained at init, saved and indexed {n} rows in "
            f"{train_s:.2f}s; a second build_searcher loaded the model from "
            f"the storer in {load_s:.2f}s; the query came back first "
            f"[{card}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(train_s=train_s, load_s=load_s)


def recall_at(searcher, queries, nns, what):
    """recall@{1, 10, 100} without rerank, quota 100 (index/eval.py)."""
    from columbiaimagesearch_tpu_torch.index.eval import get_recall

    rec, q_s = get_recall(searcher, queries.cpu().numpy(), nns,
                          thresholds=(1, 10, 100))
    log(f"recall: {what}: recall@1 {rec[0]:.2f} @10 {rec[1]:.2f} @100 "
        f"{rec[2]:.2f} over {len(nns)} queries ({q_s * 1e3:.2f} ms a "
        f"search, host clock)")
    return [float(r) for r in rec]


# --------------------------------------------------------------- phases


def phase_build():
    """Build every kernel, one nvcc each, all started together."""
    from columbiaimagesearch_tpu_torch.kernels import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(build.load_library, KERNELS))
    seconds = time.perf_counter() - t0
    for name in KERNELS:
        nvcc_s, nvcc_log = build.BUILD_LOGS[name]
        log(f"build: {name} from {build.source_path(name)} "
            f"flags={' '.join(build.NVCC_FLAGS)} nvcc={nvcc_s:.2f}s")
        for line in nvcc_log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"build: {name} ptxas: {line.strip()}")
    log(f"build: all kernels in {seconds:.2f}s")
    return seconds


def lut_inputs(dev, g, NQ, V, Dh, F, S, B, pattern="random"):
    """Seeded LUT inputs; ``pattern`` picks the probed ids: uniform
    ``random``, every slot on ``one`` cluster, or all ``distinct``."""
    Dsub = Dh // F
    Cs = torch.randn(2, V, Dh, generator=g, device=dev)
    Rs = torch.randn(2, V, Dh, Dh, generator=g, device=dev) / Dh ** 0.5
    mus = 0.1 * torch.randn(2, V, Dh, generator=g, device=dev)
    subs = torch.randn(2, F, S, Dsub, generator=g, device=dev)
    x2 = torch.randn(NQ, 2, Dh, generator=g, device=dev)
    if pattern == "one":
        isel = torch.full((NQ, 2, B), 7, dtype=torch.int32, device=dev)
    elif pattern == "distinct":
        isel = torch.stack([torch.randperm(V, generator=g, device=dev)[
            :NQ * B].reshape(NQ, B) for _ in range(2)], 1).to(torch.int32)
    else:
        isel = torch.randint(0, V, (NQ, 2, B), generator=g, device=dev,
                             dtype=torch.int32)
    return x2, isel, Cs, Rs, mus, subs


#: LUT kernel checks: (label, NQ, V, Dh, F, S, B, isel pattern)
LUT_CASES = [("headline NQ=1", 1, 4096, 128, 4, 256, 64, "random"),
             ("headline NQ=100", 100, 4096, 128, 4, 256, 64, "random"),
             ("serving wave NQ=32", 32, 4096, 128, 4, 256, 64, "random"),
             ("exhaustive all-V NQ=64", 64, 256, 64, 4, 256, 256, "all-V"),
             ("one cluster NQ=8", 8, 4096, 128, 4, 256, 64, "one"),
             ("all distinct NQ=8", 8, 4096, 128, 4, 256, 64, "distinct"),
             ("small odd", 3, 37, 32, 4, 32, 8, "random"),
             ("ragged tile", 100, 37, 32, 4, 32, 12, "random")]


def phase_kernel_check(dev, card, seed):
    """LUT kernel vs plain version at the main path's shapes and the
    grouping's edge cases, with each call's bound. Returns (worst max abs
    error, {label: dict(ms, plain_ms, bound_ms, bound_by)})."""
    from columbiaimagesearch_tpu_torch.index.lut import (
        build_luts,
        build_luts_all_clusters,
    )

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    worst = 0.0
    out = {}
    for label, NQ, V, Dh, F, S, B, pattern in LUT_CASES:
        args = lut_inputs(dev, g, NQ, V, Dh, F, S, B, pattern)
        if pattern == "all-V":   # the exhaustive path's ids and entry point
            args = (args[0], torch.arange(V, dtype=torch.int32, device=dev)
                    .expand(NQ, 2, V).contiguous()) + args[2:]

            def fn(args=args):
                return build_luts_all_clusters(args[0], *args[2:])
        else:
            def fn(args=args):
                return build_luts(*args)
        out[label] = _lut_check(label, fn, args, card)
        worst = max(worst, out[label]["max_abs"])
    return worst, out


def _lut_check(label, fn, args, card):
    """``fn`` (a ``build_luts`` route on ``args``: x2, isel, Cs, Rs, mus,
    subs) against ``build_luts_plain`` within LUT_RTOL/LUT_ATOL; its
    device ms from a CUDA graph, the plain version's, the bound and the
    share. Returns the numbers; raises if they disagree."""
    from columbiaimagesearch_tpu_torch.index.lut import build_luts_plain

    NQ, _, B = args[1].shape
    V, Dh = args[2].shape[1], args[2].shape[2]
    F, S = args[5].shape[1], args[5].shape[2]
    got = fn()
    torch.cuda.synchronize()
    want = build_luts_plain(*args)
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp(min=1e-30)).max())
    ok = bool(torch.allclose(got, want, rtol=LUT_RTOL, atol=LUT_ATOL))
    k_ms = graph_ms(fn, 20)     # a call at NQ=1 is shorter than its launch
    p_ms = kernel_ms(lambda: build_luts_plain(*args), 3, reps=1)
    nbytes, flops, distinct = lut_work(args[1], V, Dh, F, S, Dh // F)
    b_ms, by = bound_of(nbytes, flops)
    log(f"kernel check: lut_build {label} (NQ={NQ} V={V} Dh={Dh} F={F} "
        f"S={S} B={B}, {distinct} distinct probed matrices): max_abs_err="
        f"{max_abs:.3e} max_rel_err={max_rel:.3e} (rtol {LUT_RTOL}, atol "
        f"{LUT_ATOL}) kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
        f"{bound_text(k_ms, nbytes, flops)} library_ms=none (no single "
        f"PyTorch call builds the tables: a residual, a batched "
        f"rotation and a distance table) [{card}]")
    if not ok:
        raise AssertionError(f"lut_build disagrees with plain ({label})")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                max_abs=max_abs, nbytes=nbytes, flops=flops)


def _check_results(res, limit, what):
    for results, _visited in res:
        ids = [r.id for r in results]
        d = np.array([r.dist for r in results])
        if len(ids) != limit or len(set(ids)) != limit:
            raise AssertionError(f"{what}: {len(ids)} results, "
                                 f"{len(set(ids))} distinct (want {limit})")
        if not (np.isfinite(d).all() and (np.diff(d) >= 0).all()):
            raise AssertionError(f"{what}: distances not finite ascending")


def phase_main_path(dev, cfg, card, trained):
    """Index the corpus and answer waves on the trained release model's
    index-space tables; returns (state, launches)."""
    from columbiaimagesearch_tpu_torch.index.encode import lopq_encode
    from columbiaimagesearch_tpu_torch.index.lut import build_luts
    from columbiaimagesearch_tpu_torch.index.model import LOPQModel
    from columbiaimagesearch_tpu_torch.index.query import lopq_query
    from columbiaimagesearch_tpu_torch.index.searcher import LOPQSearcherTorch

    release, src = trained["release"], trained["src"]
    g = src["g"]

    def draw(n):
        return index_rows(n, src, release)

    t0 = time.perf_counter()
    model = LOPQModel(release.Cs, release.Rs, release.mus, release.subs,
                      device=dev)
    rows = draw(cfg["rows"])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    log(f"main path: the trained release model's index-space tables; "
        f"{cfg['rows']} rows (the PCA image of raw rows, made a chunk at a "
        f"time) in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    coarse, fine = lopq_encode(model.Cs, model.Rs, model.mus, model.subs,
                               rows, chunk=ENCODE_CHUNK)
    sync()
    plain_s = time.perf_counter() - t0
    log(f"main path: lopq_encode {cfg['rows']} rows in {plain_s:.1f}s "
        f"[{card}]")
    blocked = blocked_encode_check(dev, cfg, card, model, rows, coarse, fine,
                                   plain_s)
    t0 = time.perf_counter()
    searcher = LOPQSearcherTorch(model, capacity_hint=cfg["rows"])
    searcher.add_codes((coarse.cpu().numpy(),
                        fine.to(torch.uint8).cpu().numpy()), feats=rows)
    nb = searcher.get_nb_indexed()
    sync()
    d = searcher._dev
    log(f"main path: indexed nb={nb} (CSR + {tuple(d['feats'].shape)} "
        f"float32 rerank store on {dev}) in "
        f"{time.perf_counter() - t0:.1f}s; occupied cells={d['n_occ']}")
    if nb != cfg["rows"]:
        raise AssertionError(f"indexed {nb} rows, want {cfg['rows']}")
    del coarse, fine

    waves = [draw(cfg["wave"]) for _ in range(cfg["waves"])]
    self_rows = torch.randint(0, cfg["rows"], (4,), generator=g, device=dev)
    rerank_waves = [w.clone() for w in waves]
    rerank_waves[0][:4] = rows[self_rows]
    q, lim, rnb = cfg["quota"], cfg["limit"], cfg["rerank_nb"]

    build_luts.launches = 0                     # counts the main path only
    t0 = time.perf_counter()
    plain_res = [searcher.search_batch(w, quota=q, limit=lim,
                                       with_dists=True, with_codes=False)
                 for w in waves]
    rerank_res = [searcher.search_batch(w, quota=q, limit=lim,
                                        with_dists=True, with_codes=False,
                                        rerank_nb=rnb)
                  for w in rerank_waves]
    single_res = [searcher.search(waves[1][i], quota=q, limit=lim,
                                  with_dists=True) for i in range(2)]
    single_res.append(searcher.search(rows[self_rows[0]], quota=q,
                                      limit=lim, with_dists=True,
                                      rerank_nb=rnb))
    sync()
    searcher_launches = build_luts.launches
    # The headline query path (the JAX bench's query mode, bench.py:1019):
    # lopq_query at a pinned B=64 over the searcher's CSR view.
    Q, K = _geometry(searcher, cfg)
    head_res = [lopq_query(w, d["Cs"], d["Rs"], d["mus"], d["subs"],
                           d["codes"], d["cell_start"], q, V=cfg["V"],
                           B=cfg["B"], Q=Q, K=K) for w in waves]
    sync()
    launches = build_luts.launches
    log(f"main path: {cfg['waves']} waves x {cfg['wave']} without rerank, "
        f"{cfg['waves']} with rerank_nb={rnb}, {len(single_res)} single "
        f"searches, {len(head_res)} headline lopq_query waves at "
        f"B={cfg['B']} in {time.perf_counter() - t0:.1f}s; lut_build "
        f"launches={launches} ({searcher_launches} from the searcher); "
        f"probe_stats waves={searcher.probe_stats['waves']} "
        f"brute_waves={searcher.probe_stats.get('brute_waves', 0)} "
        f"wave_log={searcher.probe_stats.get('wave_log')}")

    for i, res in enumerate(plain_res):
        _check_results(res, lim, f"wave {i}")
    for i, res in enumerate(rerank_res):
        _check_results(res, lim, f"rerank wave {i}")
    _check_results(single_res, lim, "single search")
    for i, (hr, hd, total, _, _) in enumerate(head_res):
        hr, hd = hr[:, :lim].cpu().numpy(), hd[:, :lim].cpu().numpy()
        if not ((hr >= 0).all() and np.isfinite(hd).all()
                and (np.diff(hd, axis=1) >= 0).all()
                and bool((total >= lim).all())):
            raise AssertionError(f"headline lopq_query wave {i}: invalid")
    for j, r in enumerate(self_rows.tolist()):
        first = rerank_res[0][j][0][0]
        if first.id != r or first.dist != 0.0:
            raise AssertionError(f"indexed row {r} came back as {first}")
    first = single_res[-1][0][0]
    if first.id != self_rows[0].item() or first.dist != 0.0:
        raise AssertionError(f"single search of an indexed row: {first}")
    log(f"main path: checks passed: {lim} valid ids per result, ascending "
        f"distances, {len(self_rows) + 1} indexed rows returned first at "
        f"exact distance 0 under rerank")
    return dict(searcher=searcher, waves=waves, draw=draw, g=g,
                blocked_encode=blocked), launches


#: rows a coarse-assignment step of both encoders on the main path: the
#: same product shapes, so their coarse codes must be equal on every row
ENCODE_CHUNK = 8192


def blocked_encode_check(dev, cfg, card, model, rows, coarse, fine, plain_s):
    """The main path's rows encoded again by ``lopq_encode_blocked`` (with
    ``blocks_needed`` blocks), held to ``lopq_encode``'s codes: coarse
    codes equal on every row, and each differing subcode a float64
    near-tie (``blocked_encode_ties``). Returns the ``blocked_encode``
    line's numbers: both encoders' seconds, the coarse step's alone, the
    rows that differ and the ties among them, the peak bytes above the
    resident set."""
    from columbiaimagesearch_tpu_torch.index.encode import (
        blocks_needed,
        coarse_assign,
        lopq_encode_blocked,
    )

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    N, V = rows.shape[0], cfg["V"]
    sync()
    if cuda:
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    bc, bf = lopq_encode_blocked(model.Cs, model.Rs, model.mus, model.subs,
                                 rows, V, blocks_needed(N, V),
                                 chunk=ENCODE_CHUNK)
    sync()
    blocked_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) - resident) if cuda else None
    if not torch.equal(bc, coarse):
        bad = int((bc != coarse).any(dim=1).sum())
        raise AssertionError(f"blocked encode: coarse codes differ from "
                             f"lopq_encode's on {bad} rows")
    differ = (bf != fine).any(dim=1).nonzero()[:, 0]
    ties = blocked_encode_ties(model, rows, coarse, fine, bf, differ)
    del bc, bf
    # where the time goes: the coarse step, which both encoders share, alone
    Dh = model.Cs.shape[2]
    c2 = (model.Cs * model.Cs).sum(dim=2)
    t0 = time.perf_counter()
    for s in range(2):
        coarse_assign(rows[:, s * Dh:(s + 1) * Dh], model.Cs[s], c2[s],
                      ENCODE_CHUNK)
    sync()
    coarse_s = time.perf_counter() - t0
    out = dict(rows=N, V=V, n_blocks=blocks_needed(N, V),
               lopq_encode_s=plain_s, blocked_s=blocked_s,
               coarse_step_s=coarse_s, rows_differ=int(differ.shape[0]),
               ties=ties, peak_above_resident_bytes=peak)
    log(f"main path: lopq_encode_blocked {N} rows in {blocked_s:.3f}s "
        f"(lopq_encode {plain_s:.3f}s; the coarse step alone "
        f"{coarse_s:.3f}s), peak {peak} bytes above the "
        f"resident set; coarse codes equal on every row, fine codes differ "
        f"on {out['rows_differ']} rows, {ties} of them float64 near-ties "
        f"[{card}]")
    return out


def blocked_encode_ties(model, rows, coarse, fine_a, fine_b, differ,
                        chunk=2048):
    """Rows ``differ`` re-scored on the host in float64: for each
    subvector whose codes differ, the distances of the projected residual
    ``R[a] (x - C[a] - mu[a])`` to the two subcodewords must agree within
    SELECT_TIE_RTOL (relative to max(1, d), as ``plain_selection_check``).
    Returns the rows that are near-ties (all of ``differ``); raises on any
    other."""
    F, Dsub = model.subs.shape[1], model.subs.shape[3]
    Dh = model.Cs.shape[2]
    subs = model.subs.double().cpu().numpy()
    for lo in range(0, differ.shape[0], chunk):
        ii = differ[lo:lo + chunk]
        x = rows[ii].double().cpu().numpy()
        for s in range(2):
            a = coarse[ii, s].long()
            R = model.Rs[s][a].double().cpu().numpy()
            r = (x[:, s * Dh:(s + 1) * Dh]
                 - model.Cs[s][a].double().cpu().numpy()
                 - model.mus[s][a].double().cpu().numpy())
            pr = np.einsum("nij,nj->ni", R, r).reshape(-1, F, Dsub)
            ga = fine_a[ii, s * F:(s + 1) * F].long().cpu().numpy()
            gb = fine_b[ii, s * F:(s + 1) * F].long().cpu().numpy()
            f = np.arange(F)[None, :]
            da = ((pr - subs[s][f, ga]) ** 2).sum(-1)
            db = ((pr - subs[s][f, gb]) ** 2).sum(-1)
            far = (ga != gb) & (np.abs(da - db) > SELECT_TIE_RTOL
                                * np.maximum(1.0, np.minimum(da, db)))
            if far.any():
                n, k = map(int, np.argwhere(far)[0])
                raise AssertionError(
                    f"blocked encode: row {int(ii[n])} half {s} subvector "
                    f"{k}: code {gb[n, k]} at {db[n, k]} where lopq_encode "
                    f"has {ga[n, k]} at {da[n, k]} (float64)")
    return int(differ.shape[0])


def phase_recall(dev, cfg, state, card, trained):
    """recall@{1, 10, 100} without rerank (quota 100, ``get_recall``) over
    ``queries`` near-duplicate queries of rows of the ``sub_rows``-row
    sub-index, against the exact neighbours (``compute_all_neighbors``):
    the trained and the seeded model on that sub-index, and the trained
    model on the full index. The trained model's recall@100 must not fall
    below the seeded model's by more than RECALL_SLACK."""
    from columbiaimagesearch_tpu_torch.index.encode import lopq_encode
    from columbiaimagesearch_tpu_torch.index.eval import compute_all_neighbors
    from columbiaimagesearch_tpu_torch.index.searcher import LOPQSearcherTorch

    s = state["searcher"]
    nb = s.get_nb_indexed()
    rows = s._dev["feats"][:nb]          # the index rows, insertion order
    sub = rows[:TRAIN["sub_rows"]]
    g = state["g"]
    picks = torch.randint(0, sub.shape[0], (TRAIN["queries"],), generator=g,
                          device=dev)
    queries = sub[picks] + TRAIN["query_noise"] * torch.randn(
        TRAIN["queries"], sub.shape[1], generator=g, device=dev)
    nns_sub = compute_all_neighbors(queries, sub)
    out = {}
    for name, model in (("trained", s.model), ("seeded", trained["seeded"])):
        coarse, fine = lopq_encode(model.Cs, model.Rs, model.mus, model.subs,
                                   sub, chunk=8192)
        ss = LOPQSearcherTorch(model, capacity_hint=sub.shape[0])
        ss.add_codes((coarse.cpu().numpy(),
                      fine.to(torch.uint8).cpu().numpy()))
        out[name] = recall_at(ss, queries, nns_sub,
                              f"{name} model, {sub.shape[0]}-row sub-index")
        del ss, coarse, fine
    out["trained_full"] = recall_at(
        s, queries, compute_all_neighbors(queries, rows),
        f"trained model, full {nb}-row index [{card}]")
    if not out["trained"][2] >= out["seeded"][2] - RECALL_SLACK:
        raise AssertionError(f"recall: the trained model's recall@100 "
                             f"{out['trained'][2]} is below the seeded "
                             f"model's {out['seeded'][2]}")
    return out


def _geometry(searcher, cfg):
    from columbiaimagesearch_tpu_torch.index.searcher import _query_geometry

    _K, Q, K_stage, _R, _ = _query_geometry(
        cfg["quota"], cfg["limit"], searcher.nb_indexed, None)
    return Q, K_stage


def phase_query_parity(dev, cfg, state):
    """One wave through lopq_query with the kernel and with the plain
    LUT: same rows except float-rounding ties, same totals."""
    from columbiaimagesearch_tpu_torch.index.lut import build_luts_plain
    from columbiaimagesearch_tpu_torch.index.query import lopq_query

    s = state["searcher"]
    d = s._dev
    Q, K = _geometry(s, cfg)
    tables = (d["Cs"], d["Rs"], d["mus"], d["subs"], d["codes"],
              d["cell_start"])
    kw = dict(V=cfg["V"], B=cfg["B"], Q=Q, K=K)
    X = state["waves"][0]
    a = lopq_query(X, *tables, cfg["quota"], **kw)
    with mock.patch("columbiaimagesearch_tpu_torch.index.query.build_luts",
                    build_luts_plain):
        b = lopq_query(X, *tables, cfg["quota"], **kw)
    for name, x, y in zip(("total", "n_cells", "grid_ok"), a[2:], b[2:]):
        if not torch.equal(x, y):
            raise AssertionError(f"lopq_query kernel vs plain: {name} differ")
    da, db = a[1].cpu().numpy(), b[1].cpu().numpy()
    ra, rb = a[0].cpu().numpy(), b[0].cpu().numpy()
    fin = np.isfinite(da)
    if not (fin == np.isfinite(db)).all():
        raise AssertionError("lopq_query kernel vs plain: validity differs")
    max_abs = float(np.abs(da[fin] - db[fin]).max())
    np.testing.assert_allclose(db[fin], da[fin], rtol=1e-5, atol=1e-4)
    diff = ra != rb
    if (np.abs(da - db)[diff & fin] > 1e-4 * np.maximum(1, da[diff & fin])).any():
        raise AssertionError("lopq_query kernel vs plain: rows differ "
                             "beyond rounding ties")
    log(f"query parity: lopq_query B={cfg['B']} kernel vs plain LUT on "
        f"{X.shape[0]} queries: totals/n_cells/grid_ok equal, "
        f"{int(diff.sum())} tie swaps, max_abs_dist_err={max_abs:.3e}")


def phase_memory(dev, cfg, state, card):
    """Device transients of one wave per rung against the searcher's wave
    model: the peak allocation above the resident index, per query, must
    not exceed ``_bytes_per_query`` (which sizes the wave cap). Rung 256
    is a pinned ``probe_width=256``: the sort-free wide square path."""
    out = {}
    for rung, rnb in ((cfg["B"], None), ((128, 8), None),
                      ((128, 8), cfg["rerank_nb"]), (256, None)):
        out[f"rung={rung} rerank_nb={rnb}"] = wave_memory(
            dev, state["searcher"], state["waves"][0], rung, rnb,
            cfg["quota"], cfg["limit"], f"V={cfg['V']}", card)
    return out


def wave_memory(dev, s, X, rung, rnb, quota, limit, what, card):
    """Peak device bytes per query of one wave of ``X`` through searcher
    ``s``'s tables at ``rung`` (rerank depth ``rnb``) above what is
    resident, against ``s._bytes_per_query``; fails if the model is
    below it. Returns (measured, model)."""
    from columbiaimagesearch_tpu_torch.index.probe import rung_parts
    from columbiaimagesearch_tpu_torch.index.query import (
        lopq_query_orig,
        lopq_query_rerank,
        pack_query_out,
    )
    from columbiaimagesearch_tpu_torch.index.searcher import _query_geometry

    d = s._dev
    V = s.model.V
    tables = (d["Cs"], d["Rs"], d["mus"], d["subs"], d["codes"],
              d["cell_start"], d["order"])
    nq = X.shape[0]
    _K, Q, K_stage, R, K_emit = _query_geometry(quota, limit, s.nb_indexed,
                                                rnb)
    B, SB = rung_parts(rung)

    def wave():
        if R:
            o = lopq_query_rerank(X, d["feats"], *tables, quota, V=V, B=B,
                                  Q=Q, K=K_stage, R=R, K_out=K_emit, SB=SB)
        else:
            o = lopq_query_orig(X, *tables, quota, V=V, B=B, Q=Q, K=K_stage,
                                SB=SB)
        return pack_query_out(*o).cpu()

    wave()                                      # library workspaces
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    wave()
    torch.cuda.synchronize()
    measured = (torch.cuda.max_memory_allocated(dev) - base) / nq
    model = s._bytes_per_query(Q, rung, R)
    label = f"{what} rung={rung} rerank_nb={rnb}"
    log(f"memory: {label}: peak transient {measured:.0f} B/query "
        f"(wave of {nq}, Q={Q}), model {model} B/query, "
        f"model/measured={model / measured:.2f} [{card}]")
    if measured > model:
        raise AssertionError(f"memory model below measured at {label}")
    return measured, model


PROFILE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "profile")


def trace(fn, name):
    """torch.profiler trace of one call of ``fn``, ended by a sync; the
    chrome trace goes to ``PROFILE_DIR/<name>.json``.

    :returns: (wall ms (profiled), device busy ms (union of kernel and
        copy intervals), device ops, log lines of the top 10 ops by
        device time)
    """
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(PROFILE_DIR, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(PROFILE_DIR, f"{name}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    avgs = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(avgs[0], "self_device_time_total")
           else "self_cuda_time_total")
    top = [f"profile:   {a.key[:48]:48s} self device "
           f"{getattr(a, key) / 1e3:.3f} ms x{a.count}"
           for a in sorted(avgs, key=lambda a: -getattr(a, key))[:10]]
    return wall_ms, busy_us / 1e3, len(spans), top


def host_profile(fn, sync, top=8):
    """cProfile of one call of ``fn`` (ended by ``sync``): the wall time
    and the ``top`` functions by own time, as log lines."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    sync()
    prof.disable()
    wall = (time.perf_counter() - t0) * 1e3
    st = pstats.Stats(prof).stats
    rows = sorted(st.items(), key=lambda kv: -kv[1][2])[:top]
    lines = [f"cProfile wall {wall:.2f} ms; by own time:"]
    for (path, line, name), (_cc, nc, tt, ct, _) in rows:
        lines.append(f"  {tt * 1e3:8.2f} ms own {ct * 1e3:8.2f} ms cum "
                     f"x{nc} {os.path.basename(path)}:{line}({name})")
    return lines


def phase_profile(dev, cfg, state, card):
    """torch.profiler trace of one steady-state search_batch wave, with
    and without rerank: wall time, device busy time, device idle share,
    and the top ops by device time."""
    s = state["searcher"]
    for rnb in (None, cfg["rerank_nb"]):
        X = state["draw"](cfg["wave"])
        kw = dict(quota=cfg["quota"], limit=cfg["limit"], with_codes=False,
                  rerank_nb=rnb)
        s.search_batch(X, **kw)                # settle the tier hint
        torch.cuda.synchronize()
        wall_ms, busy_ms, n_ops, top = trace(
            lambda: s.search_batch(X, **kw), f"wave_rerank{rnb or 0}")
        log(f"profile: search_batch wave rerank_nb={rnb}: wall "
            f"{wall_ms:.2f} ms (profiled), device busy {busy_ms:.2f} ms, "
            f"idle share {1 - busy_ms / wall_ms:.3f}, {n_ops} device ops, "
            f"tier hint {s.probe_stats['wave_log'][-1]} [{card}]")
        for line in top:
            log(line)


def phase_numbers(dev, cfg, state, card):
    from columbiaimagesearch_tpu_torch.index.probe import rung_cells
    from columbiaimagesearch_tpu_torch.index.query import (
        brute_query_batch,
        lopq_query,
    )

    s = state["searcher"]
    d = s._dev
    Q, K = _geometry(s, cfg)
    tables = (d["Cs"], d["Rs"], d["mus"], d["subs"], d["codes"],
              d["cell_start"])
    batches = [state["draw"](cfg["wave"]) for _ in range(6)]
    nq = cfg["wave"]
    V = cfg["V"]
    out = {}

    def rung_ms(B, SB):
        it = iter(batches * 2)
        ts = time_ms(lambda: lopq_query(next(it), *tables, cfg["quota"], V=V,
                                        B=B, Q=Q, K=K, SB=SB), 5)
        return float(np.median(ts)) / nq

    t64 = rung_ms(cfg["B"], 0)
    out[f"lopq_query_p50_ms_per_query_B{cfg['B']}"] = t64
    Bs, SBs = cfg["strip_rung"]
    tstrip = rung_ms(Bs, SBs)
    out[f"lopq_query_p50_ms_per_query_B{Bs}_SB{SBs}"] = tstrip
    g1, g2 = rung_cells(cfg["B"], V), rung_cells(cfg["strip_rung"], V)
    per_cell_ns = (tstrip - t64) * 1e6 / (g2 - g1)
    out["GRID_NS_PER_CELL"] = per_cell_ns
    out["GRID_NS_FIXED"] = t64 * 1e6 - per_cell_ns * g1

    sync = torch.cuda.synchronize
    it = iter(batches * 3)
    out["search_batch_p50_ms_per_wave"] = float(np.median(host_ms(
        lambda: s.search_batch(next(it), quota=cfg["quota"],
                               limit=cfg["limit"], with_codes=False), 5,
        sync)))
    out["search_batch_rerank_p50_ms_per_wave"] = float(np.median(host_ms(
        lambda: s.search_batch(next(it), quota=cfg["quota"],
                               limit=cfg["limit"], with_codes=False,
                               rerank_nb=cfg["rerank_nb"]), 5, sync)))

    nb = s.nb_indexed
    Kb = _geometry(s, cfg)[1]

    def brute_ms(n):
        X = batches[0][:n]
        return float(np.median(time_ms(lambda: brute_query_batch(
            X, d["feats"], d["feats_sq"], nb, d["n_occ"],
            K_pre=cfg["rerank_nb"], K_out=Kb), 3)))

    # probe.prefer_brute's model: a wave of n costs FIXED + n * nb * PER_ROW
    t_all, t_1 = brute_ms(nq), brute_ms(1)
    per_row = (t_all - t_1) * 1e6 / ((nq - 1) * nb)
    out["brute_p50_ms_per_wave"] = t_all
    out["brute_p50_ms_single_query"] = t_1
    out["BRUTE_NS_PER_ROW"] = per_row
    out["BRUTE_NS_FIXED"] = t_1 * 1e6 - nb * per_row
    # A pinned probe_width=256 (B*B = 65,536 > 16,384, B < V): the
    # sort-free wide square path, held to a plain selection.
    Xw = batches[1][:32]
    Qw, Kw = _geometry(s, cfg)
    out["lopq_query_p50_ms_per_wave32_B256"] = float(np.median(time_ms(
        lambda: lopq_query(Xw, *tables, cfg["quota"], V=V, B=256, Q=Qw,
                           K=Kw), 5)))
    wide_selection_check(s, Xw, cfg["quota"], 256, f"headline V={V}")
    for k, v in out.items():
        log(f"numbers: {k}={v!r} [{card}]")
    return out


def plain_selection(s, X, quota, B):
    """Per query of ``X``, the cells a plain walk over the B x B region of
    searcher ``s``'s index selects: sort the region's cells by grid
    distance, take cells until the quota (capped at the region's rows) is
    covered, and include every cell tied with the crossing one (theta).
    Coarse distances come from the query path's own ``_coarse_dists`` on
    the same batch, so the grid values are bit-equal. Returns a list of
    dicts: the occupied selected cells, total, n_cells (empty cells
    included), grid_ok."""
    from columbiaimagesearch_tpu_torch.index.query import _coarse_dists

    d = s._dev
    V = s.model.V
    csl = d["cell_start"].long()
    x2 = X.to(torch.float32).reshape(X.shape[0], 2, -1)
    dists = [_coarse_dists(x2[:, h], d["Cs"][h]) for h in range(2)]
    out = []
    for i in range(X.shape[0]):
        t0, i0 = torch.sort(dists[0][i], stable=True)
        t1, i1 = torch.sort(dists[1][i], stable=True)
        grid = (t0[:B, None] + t1[None, :B]).reshape(-1)
        cells = (i0[:B, None] * V + i1[None, :B]).reshape(-1)
        cnt = csl[cells + 1] - csl[cells]
        order = torch.sort(grid, stable=True).indices
        csum = cnt[order].cumsum(0)
        quota_eff = min(int(quota), int(csum[-1]))
        theta = grid[order[int((csum < quota_eff).sum())]]
        sel = grid <= theta
        out_min = (min(float(t0[B] + t1[0]), float(t0[0] + t1[B])) if B < V
                   else float("inf"))
        out.append(dict(cells=set(cells[sel & (cnt > 0)].tolist()),
                        total=int(cnt[sel].sum()), n_cells=int(sel.sum()),
                        grid_ok=float(theta) <= out_min))
    return out


def wide_selection_check(s, X, quota, B, what):
    """``lopq_query`` at the square rung B (the sort-free wide path when
    B*B > 16,384) against :func:`plain_selection` on ``X``: the same
    occupied cells (those of the rows it returns, with Q and K large
    enough that no candidate is clipped), total, n_cells and grid_ok."""
    from columbiaimagesearch_tpu_torch.index.query import lopq_query
    from columbiaimagesearch_tpu_torch.utils.chunking import round_up

    d = s._dev
    plain = plain_selection(s, X, quota, B)
    Q = round_up(max(p["total"] for p in plain) + 1, 1024)
    rows, _, total, n_cells, grid_ok = lopq_query(
        X, d["Cs"], d["Rs"], d["mus"], d["subs"], d["codes"],
        d["cell_start"], quota, V=s.model.V, B=B, Q=Q, K=Q)
    csl = d["cell_start"].long()
    for i, p in enumerate(plain):
        r = rows[i][rows[i] >= 0]
        cells = set((torch.searchsorted(csl, r, right=True) - 1).tolist())
        got = (cells, int(total[i]), int(n_cells[i]), bool(grid_ok[i]))
        if got != (p["cells"], p["total"], p["n_cells"], p["grid_ok"]):
            raise AssertionError(
                f"wide selection {what} B={B} query {i}: port total/n_cells/"
                f"grid_ok {got[1:]} and {len(cells)} cells, plain "
                f"{p['total']}/{p['n_cells']}/{p['grid_ok']} and "
                f"{len(p['cells'])} cells")
    log(f"wide selection: {what} B={B}, {len(plain)} queries: selected "
        f"cells, total, n_cells and grid_ok equal to the plain sorted walk "
        f"(totals {min(p['total'] for p in plain)}-"
        f"{max(p['total'] for p in plain)}, n_cells "
        f"{min(p['n_cells'] for p in plain)}-"
        f"{max(p['n_cells'] for p in plain)}, grid_ok "
        f"{sum(p['grid_ok'] for p in plain)}/{len(plain)})")


def _scan_check(label, args, V, card, plain_iters=3):
    """Scan kernel vs plain on ``args`` (codes, block_cell, block_count,
    lut0, lut1): bit-equal with identical +inf positions (both add the M
    entries in m order); the kernel's time (tiling of the tables
    included), the plain version's, the bound, and one
    ``embedding_bag`` on the same inputs (held equal to the plain output
    within LUT_RTOL/LUT_ATOL). Returns a dict of the numbers."""
    from columbiaimagesearch_tpu_torch.index.exhaustive_adc import (
        adc_scan_all,
        adc_scan_all_plain,
        scan_items,
    )

    items = scan_items(args[1])
    got = adc_scan_all(*args, V=V, items=items)
    torch.cuda.synchronize()
    want = adc_scan_all_plain(*args, V=V)
    inf = torch.isinf(want)
    if not torch.equal(torch.isinf(got), inf):
        raise AssertionError(f"adc_scan {label}: +inf positions differ")
    max_abs = (float((got[~inf] - want[~inf]).abs().max())
               if (~inf).any() else 0.0)
    if not torch.equal(got, want):
        raise AssertionError(f"adc_scan {label}: not bit-equal to plain "
                             f"(max_abs_err={max_abs:.3e})")
    del got
    idx, weight = scan_library_inputs(*args, V)
    lib = scan_library(idx, weight).T
    lib_inf = torch.isinf(lib)
    lib_err = (float((lib[~lib_inf] - want[~lib_inf]).abs().max())
               if (~lib_inf).any() else 0.0)
    if not (torch.equal(lib_inf, inf) and torch.allclose(
            lib[~inf], want[~inf], rtol=LUT_RTOL, atol=LUT_ATOL)):
        raise AssertionError(f"embedding_bag disagrees with the plain scan "
                             f"({label})")
    del lib, want
    k_ms = kernel_ms(lambda: adc_scan_all(*args, V=V, items=items), 10)
    p_ms = kernel_ms(lambda: adc_scan_all_plain(*args, V=V), plain_iters,
                     reps=1)
    l_ms = kernel_ms(lambda: scan_library(idx, weight), 10)
    del idx, weight
    M, S, NQ = args[0].shape[1], args[3].shape[2], args[3].shape[3]
    nbytes, flops = scan_work(args[2], M, V, S, NQ)
    b_ms, by = bound_of(nbytes, flops)
    log(f"kernel check: adc_scan {label}: {int(inf.sum())} +inf of "
        f"{inf.numel()}, bit-equal to plain (max_abs_err={max_abs:.3e}) "
        f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
        f"{bound_text(k_ms, nbytes, flops)} library_ms={l_ms:.4f} "
        f"(embedding_bag sum, max_abs_err vs plain {lib_err:.3e}) [{card}]")
    return dict(max_abs=max_abs, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=by, library_ms=l_ms)


def scan_case_args(dev, rng, g, n, V, M, S, NQ, odd):
    """A scan check's inputs: uniform random cells, or (``odd``) half the
    rows in 5 cells (multi-block runs) with count-0 blocks inserted at the
    front, the middle and the end."""
    from columbiaimagesearch_tpu_torch.index.exhaustive_adc import (
        BLK,
        build_padded_layout,
    )

    if odd:
        cells = np.concatenate([rng.randint(0, 5, n // 2),
                                rng.randint(0, V * V, n - n // 2)])
    else:
        cells = rng.randint(0, V, n) * V + rng.randint(0, V, n)
    fine = rng.randint(0, S, (n, M)).astype(np.uint8)
    codes, bc, bn, _ = build_padded_layout(cells, fine)
    if odd:
        at = [0, len(bc) // 2, len(bc)]
        codes = np.insert(codes.reshape(-1, BLK, M), at, 1,
                          axis=0).reshape(-1, M)
        bc = np.insert(bc, at, [0, 5, V * V - 1]).astype(np.int32)
        bn = np.insert(bn, at, 0).astype(np.int32)
    return [torch.from_numpy(a).to(dev) for a in (codes, bc, bn)] + [
        10 * torch.rand(V, M // 2, S, NQ, generator=g, device=dev)
        for _ in range(2)]


def phase_scan_check(dev, card, seed):
    """Scan kernel vs plain version at each of SCAN_CASES."""
    rng = np.random.RandomState(seed + 2)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 2)
    worst = 0.0
    out = {}
    for label, n, V, M, S, NQ, odd in SCAN_CASES:
        args = scan_case_args(dev, rng, g, n, V, M, S, NQ, odd)
        r = _scan_check(f"{label} (V={V} M={M} S={S} rows={n} padded="
                        f"{args[0].shape[0]})", args, V, card)
        worst = max(worst, r["max_abs"])
        out[label] = r
        del args
    return worst, out


#: a rank where a card path's ids differ from a plain selection must hold
#: two rows at distances this close (relative to max(1, d)): a rounding tie
SELECT_TIE_RTOL = 1e-4


def plain_selection_check(ids, dists, want_ids, want_dists, what):
    """One query's ids from a card path (best first, at ``dists``) held to
    a stable selection on plain distances (``want_ids`` at
    ``want_dists``): the same id at every rank but rounding ties, where
    the two distances agree within SELECT_TIE_RTOL. Returns the swaps."""
    ids, dists = np.asarray(ids), np.asarray(dists, np.float64)
    want_dists = np.asarray(want_dists, np.float64)
    diff = ids != np.asarray(want_ids)
    far = np.abs(dists - want_dists) > SELECT_TIE_RTOL * np.maximum(
        1.0, want_dists)
    bad = np.nonzero(diff & far)[0]
    if len(bad):
        r = int(bad[0])
        raise AssertionError(f"{what}: rank {r}: id {ids[r]} at {dists[r]} "
                             f"where the plain selection has {want_ids[r]} "
                             f"at {want_dists[r]}")
    return int(diff.sum())


def _same_ids_but_ties(got, want, atol, what):
    """Two waves of (results, visited): the same ids in order except swaps
    between distances within ``atol`` (float rounding ties), and every
    distance within ``atol``. Returns (worst |dist diff|, tie swaps)."""
    worst, swaps = 0.0, 0
    for (rg, _), (rw, _) in zip(got, want):
        dg = np.array([r.dist for r in rg])
        dw = np.array([r.dist for r in rw])
        if len(dg) != len(dw):
            raise AssertionError(f"{what}: {len(dg)} results vs {len(dw)}")
        if len(dg):
            worst = max(worst, float(np.abs(dg - dw).max()))
        at = {r.id: y for r, y in zip(rw, dw)}
        for a, b, x in zip(rg, rw, dg):
            if a.id != b.id:
                swaps += 1
                # A tie: the id sits at a distance within atol in the
                # other list, or fell off its end at the cut-off distance.
                y = at.get(a.id, dw[-1])
                if abs(x - y) > 2 * atol:
                    raise AssertionError(f"{what}: id {a.id} at {x} is not "
                                         f"a rounding tie of {b.id}")
    if worst > atol:
        raise AssertionError(f"{what}: distances differ by {worst}")
    return worst, swaps


def _recall_vs(res, true_rows, k=10):
    """(recall@1, recall@10, overlap@10) of a wave against exact
    neighbours ``true_rows`` [nq, >= k] (insertion rows)."""
    r1 = r10 = ov = 0.0
    for (rr, _), t in zip(res, true_rows):
        ids = [r.id for r in rr[:k]]
        r1 += bool(ids) and ids[0] == t[0]
        r10 += t[0] in ids
        ov += len(set(ids) & set(t[:k].tolist())) / k
    n = len(true_rows)
    return r1 / n, r10 / n, ov / n


def phase_sharded(dev, cfg, state, card):
    """The mesh layer on the main path's state (its codes, PCA-space rows
    and trained tables, nothing encoded again): ``ShardedLOPQSearcher`` on
    one real shard and on SHARDED["shards"] logical shards of the card,
    the LUT rung held to the plain LUT, the brute plan across shards,
    ``dp_encode`` and ``dp_lloyd_step`` against their single-device
    counterparts, and the bfloat16 rerank store. Returns (numbers,
    ``lut_build`` launches on the sharded path)."""
    from columbiaimagesearch_tpu_torch.index import query as qmod
    from columbiaimagesearch_tpu_torch.index.lut import (
        build_luts,
        build_luts_plain,
    )
    from columbiaimagesearch_tpu_torch.index.query import (
        brute_query_batch,
        unpack_query_out,
    )
    from columbiaimagesearch_tpu_torch.index.searcher import (
        LOPQSearcherTorch,
        ResultDist as Result,
        _query_geometry,
    )
    from columbiaimagesearch_tpu_torch.ops.kmeans import (
        _lloyd_sums,
        _pick_chunk,
        _update,
    )
    from columbiaimagesearch_tpu_torch.parallel import (
        SHARD_AXIS,
        ShardedLOPQSearcher,
        dp_encode,
        dp_lloyd_step,
        make_mesh,
        shard_rows,
    )

    c = SHARDED
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    s = state["searcher"]
    model = s.model
    nb = s.get_nb_indexed()
    d = s._dev
    V = model.V
    cells = s._cells[:nb]
    coarse = np.stack([cells // V, cells % V], axis=1).astype(np.int32)
    fine = s._fine[:nb]
    feats = d["feats"][:nb]
    waves = state["waves"]
    q, lim, rnb = cfg["quota"], cfg["limit"], cfg["rerank_nb"]
    kw = dict(quota=q, limit=lim, with_dists=True)
    g = torch.Generator(device=dev)
    g.manual_seed(c["seed"] + 31)
    t_phase = time.perf_counter()
    out = {}

    def build(mesh, what, rerank_dtype="float32"):
        t0 = time.perf_counter()
        sh = ShardedLOPQSearcher(model, mesh=mesh, rerank_dtype=rerank_dtype,
                                 capacity_hint=nb)
        sh.add_codes((coarse, fine), feats=feats)
        n = sh.get_nb_indexed()
        sync()
        build_s = time.perf_counter() - t0
        if n != nb or not sh.has_rerank_feats:
            raise AssertionError(f"sharded: {what} indexed {n} of {nb} rows")
        log(f"sharded: {what}: {len(mesh)} shard(s) on {list(mesh)}, {nb} "
            f"rows dealt round-robin (codes + float32 store) in "
            f"{build_s:.2f}s; cap_per={sh.index._cap_per}")
        return sh, build_s

    def run_waves(sh, what):
        res, ms = {}, {}
        for rr in (None, rnb):
            res[rr] = []
            times = []
            for w in waves:
                t0 = time.perf_counter()
                res[rr].append(sh.search_batch(w, rerank_nb=rr, **kw))
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
            ms[rr or 0] = times
            for i, r in enumerate(res[rr]):
                _check_results(r, lim, f"sharded {what} rerank_nb={rr} "
                               f"wave {i}")
        log(f"sharded: {what}: {len(waves)} waves of {waves[0].shape[0]} "
            f"(natural ladder) ms without rerank "
            f"{[round(t, 2) for t in ms[0]]}, with rerank_nb={rnb} "
            f"{[round(t, 2) for t in ms[rnb]]}; wave_log "
            f"{sh.probe_stats.get('wave_log', [])[-3:]} [{card}]")
        return res, ms

    # --- one real shard: every visible card.
    build_luts.launches = 0                   # counts the sharded path only
    mesh1 = make_mesh(axis=SHARD_AXIS)
    sh1, b1 = build(mesh1, "one real shard")
    res1, ms1 = run_waves(sh1, "one real shard")
    X = waves[0]
    sh1.index.probe_width = c["probe"]        # pin a LUT rung
    before = build_luts.launches
    t0 = time.perf_counter()
    pinned = sh1.search_batch(X, **kw)
    sync()
    pinned_ms = (time.perf_counter() - t0) * 1e3
    pin_launches = build_luts.launches - before
    with mock.patch.object(qmod, "build_luts", build_luts_plain):
        plain = sh1.search_batch(X, **kw)
    sh1.index.probe_width = None
    worst, swaps = _same_ids_but_ties(pinned, plain, SHARDED_DIST_ATOL,
                                      "sharded pinned LUT wave vs plain")
    if pin_launches <= 0:
        raise AssertionError("sharded: the pinned wave launched no lut_build")
    log(f"sharded: one shard, a wave of {X.shape[0]} pinned to rung "
        f"{c['probe']} (LUT route) {pinned_ms:.2f} ms, {pin_launches} "
        f"lut_build launch(es); replayed with the plain LUT: ids equal but "
        f"{swaps} rounding-tie swaps, max_abs_dist_err={worst:.3e} (atol "
        f"{SHARDED_DIST_ATOL}) [{card}]")
    Xr = waves[1]
    sh1.search_batch(Xr, rerank_nb=rnb, **kw)
    s.search_batch(Xr, rerank_nb=rnb, with_codes=False, **kw)
    sync()
    trace_ms = {}
    if dev.type == "cuda":
        for name, fn in (
                ("unsharded", lambda: s.search_batch(
                    Xr, rerank_nb=rnb, with_codes=False, **kw)),
                ("one_shard", lambda: sh1.search_batch(
                    Xr, rerank_nb=rnb, **kw))):
            wall, busy, n_ops, _top = trace(fn, f"sharded_{name}")
            trace_ms[name] = dict(wall=wall, busy=busy, ops=n_ops)
        log(f"profile: a 100-query rerank wave, unsharded "
            f"LOPQSearcherTorch vs one-shard ShardedLOPQSearcher: device "
            f"busy {trace_ms['unsharded']['busy']:.2f} / "
            f"{trace_ms['one_shard']['busy']:.2f} ms, wall (profiled) "
            f"{trace_ms['unsharded']['wall']:.2f} / "
            f"{trace_ms['one_shard']['wall']:.2f} ms [{card}]")
        for line in host_profile(
                lambda: sh1.search_batch(Xr, rerank_nb=rnb, **kw), sync):
            log(f"sharded: one-shard rerank wave, host {line}")

    # --- logical shards on the first card, at the same rows.
    n4 = c["shards"]
    mesh4 = make_mesh(axis=SHARD_AXIS, devices=[dev] * n4)
    sh4, b4 = build(mesh4, f"{n4} logical shards")
    res4, ms4 = run_waves(sh4, f"{n4} logical shards")
    if dev.type == "cuda":
        wall, busy, n_ops, _top = trace(
            lambda: sh4.search_batch(Xr, rerank_nb=rnb, **kw),
            f"sharded_{n4}")
        trace_ms[f"{n4}_shards"] = dict(wall=wall, busy=busy, ops=n_ops)
        log(f"profile: the same wave on {n4} logical shards: device busy "
            f"{busy:.2f} ms, wall (profiled) {wall:.2f} ms [{card}]")
    sel = torch.randint(0, nb, (c["self_queries"],), generator=g, device=dev)
    Xs = feats[sel]
    self1 = sh1.search_batch(Xs, rerank_nb=rnb, **kw)
    self4 = sh4.search_batch(Xs, rerank_nb=rnb, **kw)
    # An index row's nearest row is itself (distance 0). Each shard walks
    # at least as far as the one-shard walk, so wherever the one-shard
    # index returns the row first, the logical shards must too.
    distinct = found4 = 0
    for i, (row, (r1, _), (r4, _)) in enumerate(
            zip(sel.tolist(), self1, self4)):
        found4 += r4[0].id == row
        if r1[0].id == row and (len(r1) < 2 or r1[1].dist > 0.0):
            distinct += 1
            if r4[0].id != row:
                raise AssertionError(f"sharded: query {i}: top-1 "
                                     f"{r4[0].id} on {n4} shards, "
                                     f"{row} on one")
    if distinct < c["self_queries"] // 2:
        raise AssertionError(f"sharded: only {distinct} queries came back "
                             f"first as themselves on one shard")
    common = 0
    for a, b in ([(self1, self4)] + list(zip(res1[None], res4[None]))
                 + list(zip(res1[rnb], res4[rnb]))):
        for (ra, _), (rb, _) in zip(a, b):
            da = {r.id: r.dist for r in ra}
            for r in rb:
                if r.id in da:
                    common += 1
                    if not np.isclose(r.dist, da[r.id], rtol=SHARDED_RTOL,
                                      atol=0.0):
                        raise AssertionError(
                            f"sharded: id {r.id}: {r.dist} on {n4} shards, "
                            f"{da[r.id]} on one")
    log(f"sharded: {n4} logical shards vs one, {c['self_queries']} index "
        f"rows as queries (rerank_nb={rnb}): first as themselves on one "
        f"shard {distinct}, on {n4} shards {found4} (the same top-1 "
        f"wherever one shard has it); {common} ids returned by both at "
        f"equal distances (rtol {SHARDED_RTOL})")
    # Exact neighbours of a wave of fresh queries: the single store's
    # brute plan.
    _K, _Q, _Ks, R, K_emit = _query_geometry(q, lim, nb, rnb)
    packed = brute_query_batch(X, d["feats"], d["feats_sq"], nb, d["n_occ"],
                               K_pre=R, K_out=K_emit).cpu().numpy()
    true_rows, true_d, _t, true_cells, _ok = unpack_query_out(packed, K_emit)
    quality = {}
    for name, res in (("one", res1), (f"{n4}", res4)):
        for rr in (None, rnb):
            quality[f"{name} rerank_nb={rr}"] = _recall_vs(res[rr][0],
                                                           true_rows)
    log(f"sharded: recall@1, recall@10, overlap@10 against the exact "
        f"neighbours of {X.shape[0]} queries: {quality}")
    with mock.patch.object(sh4.index, "_use_brute",
                           lambda *a, **k: True):
        t0 = time.perf_counter()
        brute4 = sh4.search_batch(X, rerank_nb=rnb, **kw)
        sync()
        brute_ms = (time.perf_counter() - t0) * 1e3
    # Equal ids, but for rows at equal float32 distances (within
    # BRUTE_TIE_ATOL, a few ulps): the single store orders them by
    # preselect rank, the merge by shard.
    single = [([Result(int(r), None, float(x))
                for r, x in zip(true_rows[i][:lim], true_d[i][:lim])],
               int(true_cells[i])) for i in range(len(brute4))]
    _, brute_ties = _same_ids_but_ties(brute4, single, BRUTE_TIE_ATOL,
                                       "sharded brute plan vs single store")
    if any(a[1] != b[1] for a, b in zip(brute4, single)):
        raise AssertionError("sharded: the brute plan's occupied cells "
                             "differ from the single store's")
    log(f"sharded: the brute plan across {n4} logical shards {brute_ms:.2f} "
        f"ms a wave of {X.shape[0]}; ids and occupied cells "
        f"({int(true_cells[0])}) equal to the single store's "
        f"brute_query_batch but {brute_ties} swaps of rows at equal float32 "
        f"distances [{card}]")
    launches = build_luts.launches
    out.update(one=dict(build_s=b1, wave_ms=ms1, pinned_ms=pinned_ms,
                        pinned_launches=pin_launches, pinned_swaps=swaps,
                        pinned_max_abs=worst),
               logical=dict(shards=n4, build_s=b4, wave_ms=ms4,
                            brute_ms=brute_ms, brute_ties=brute_ties,
                            self_first_one=distinct,
                            self_first_logical=found4, common_ids=common),
               quality=quality, trace=trace_ms, launches=launches)
    del sh1, sh4, res1, res4, self1, self4, brute4
    torch.cuda.empty_cache()

    # --- data parallel.
    X1 = feats[:c["dp_rows"]]
    t0 = time.perf_counter()
    want_c, want_f = model.predict_batch(X1)
    sync()
    dp = dict(predict_batch_s=time.perf_counter() - t0)
    for name, mesh in (("one", mesh1), (f"{n4}", mesh4)):
        t0 = time.perf_counter()
        got_c, got_f = dp_encode(mesh, model.Cs, model.Rs, model.mus,
                                 model.subs, X1, chunk=4096)
        dp[f"encode_{name}_s"] = time.perf_counter() - t0
        if not (np.array_equal(got_c, want_c.astype(np.int32))
                and np.array_equal(got_f, want_f.astype(np.int32))):
            raise AssertionError(f"sharded: dp_encode on {name} shard(s) "
                                 f"differs from predict_batch")
    Dh = int(model.Cs.shape[2])
    XL = feats[:c["lloyd_rows"], :Dh].contiguous()
    C0 = model.Cs[0]
    t0 = time.perf_counter()
    sums, counts, total = _lloyd_sums([XL], C0, _pick_chunk(XL.shape[0], V))
    C1 = _update(C0, sums, counts)
    sync()
    dp["lloyd_single_s"] = time.perf_counter() - t0
    for name, mesh in (("one", mesh1), (f"{n4}", mesh4)):
        Xsh, n = shard_rows(mesh, XL)
        wsh, _ = shard_rows(mesh, torch.ones(n, device=dev))
        t0 = time.perf_counter()
        Cd, inertia = dp_lloyd_step(Xsh, wsh, C0, V)
        sync()
        dp[f"lloyd_{name}_s"] = time.perf_counter() - t0
        err = float(((Cd - C1).abs() - SHARDED_RTOL * C1.abs()).max())
        if err > LLOYD_ATOL or not np.isclose(float(inertia), float(total),
                                              rtol=SHARDED_RTOL, atol=0.0):
            raise AssertionError(f"sharded: dp_lloyd_step on {name} "
                                 f"shard(s) vs single device: excess "
                                 f"{err}, inertia {float(inertia)} vs "
                                 f"{float(total)}")
    del XL, sums, counts
    log(f"sharded: dp_encode of {X1.shape[0]} rows on one shard and on "
        f"{n4} logical shards equals predict_batch; dp_lloyd_step at V={V} "
        f"on {c['lloyd_rows']} rows (first half) equals the single-device "
        f"Lloyd step (rtol {SHARDED_RTOL}, atol {LLOYD_ATOL}); seconds "
        f"{ {k: round(v, 3) for k, v in dp.items()} } [{card}]")
    out["dp"] = dp

    # --- the bfloat16 rerank store.
    plan = LOPQSearcherTorch._plan_rerank_dtype("auto", s._cap,
                                                int(feats.shape[1]),
                                                device=dev)
    if plan != torch.float32:
        raise AssertionError(f"sharded: the auto plan picked {plan} for "
                             f"{s._cap} rows of capacity")
    t0 = time.perf_counter()
    sb = LOPQSearcherTorch(model, rerank_dtype="bfloat16", capacity_hint=nb)
    sb.add_codes((coarse, fine), feats=feats)
    sb.get_nb_indexed()
    sync()
    bf_build_s = time.perf_counter() - t0
    store = sb._dev["feats"]
    if store.dtype != torch.bfloat16:
        raise AssertionError(f"sharded: the bfloat16 store is {store.dtype}")
    gb_bf = nb * feats.shape[1] * 2 / 1e9
    gb_f32 = nb * feats.shape[1] * 4 / 1e9
    bf_ms, worst_rel, ov = [], 0.0, 0.0
    for w in waves:
        t0 = time.perf_counter()
        rb = sb.search_batch(w, rerank_nb=rnb, with_codes=False, **kw)
        sync()
        bf_ms.append((time.perf_counter() - t0) * 1e3)
        rf = s.search_batch(w, rerank_nb=rnb, with_codes=False, **kw)
        for i, ((rrb, _), (rrf, _)) in enumerate(zip(rb, rf)):
            rows = torch.as_tensor([r.id for r in rrb], device=dev)
            exact = torch.linalg.vector_norm(
                feats[rows].to(torch.bfloat16).float() - w[i], dim=1)
            dist = torch.as_tensor([r.dist for r in rrb], device=dev)
            worst_rel = max(worst_rel, float(
                ((dist - exact).abs() / exact.clamp_min(1e-30)).max()))
            ov += len({r.id for r in rrb[:10]}
                      & {r.id for r in rrf[:10]}) / 10
    ov /= len(waves) * waves[0].shape[0]
    if worst_rel > SHARDED_RTOL:
        raise AssertionError(f"sharded: bfloat16 store distances differ "
                             f"from float32 recomputes by {worst_rel}")
    log(f"sharded: bfloat16 store {tuple(store.shape)} "
        f"({gb_bf:.2f} GB for {nb} rows, float32 {gb_f32:.2f} GB), built in "
        f"{bf_build_s:.2f}s; auto plan at capacity {s._cap} on this card: "
        f"float32; rerank waves ms {[round(t, 2) for t in bf_ms]} "
        f"(brute_waves {sb.probe_stats.get('brute_waves', 0)}); every "
        f"exact distance equals a float32 recompute from the rounded rows "
        f"(max rel err {worst_rel:.2e}); overlap@10 with the float32 store "
        f"{ov:.4f} [{card}]")
    out["bf16"] = dict(gb=gb_bf, gb_f32=gb_f32, build_s=bf_build_s,
                       wave_ms=bf_ms, max_rel=worst_rel, overlap10=ov)
    del sb, store
    torch.cuda.empty_cache()
    log(f"sharded: checks passed; phase "
        f"{time.perf_counter() - t_phase:.1f}s")
    return out, launches


def phase_pca(dev, cfg, state, card, trained):
    """The release model's PCA front end: the trained LOPQModelPCA
    (``pca_P [4096, 256]`` over the main path's tables). Raw rows go
    through ``add_data(store_feats=True)`` and raw queries through one
    rerank wave; the results must equal a plain-model searcher's given
    ``apply_PCA`` of the same rows and queries."""
    from columbiaimagesearch_tpu_torch.index.searcher import LOPQSearcherTorch

    base = state["searcher"].model
    pm = trained["release"]
    P = pm.pca_P
    n = PCA["rows"]
    raw = raw_rows(n, trained["src"])
    wave = raw_rows(PCA["wave"], trained["src"])
    wave[:4] = raw[:4]
    t0 = time.perf_counter()
    ps = LOPQSearcherTorch(pm, capacity_hint=n)
    ps.add_data(raw, store_feats=True)
    nb = ps.get_nb_indexed()
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    plain = LOPQSearcherTorch(base, capacity_hint=n)
    plain.add_data(pm.apply_PCA(raw), store_feats=True)
    kw = dict(quota=cfg["quota"], limit=cfg["limit"], with_dists=True,
              with_codes=False, rerank_nb=cfg["rerank_nb"])
    t0 = time.perf_counter()
    got = ps.search_batch(wave, **kw)
    torch.cuda.synchronize()
    wave_ms = (time.perf_counter() - t0) * 1e3
    want = plain.search_batch(pm.apply_PCA(wave), **kw)
    log(f"pca: LOPQModelPCA pca_P {tuple(P.shape)}: add_data of {n} raw "
        f"rows (store_feats) in {add_s:.2f}s, nb={nb}, "
        f"has_rerank_feats={ps.has_rerank_feats}; one {PCA['wave']}-query "
        f"wave with rerank_nb={cfg['rerank_nb']} in {wave_ms:.1f} ms "
        f"(first wave, host clock) [{card}]")
    if nb != n or not ps.has_rerank_feats:
        raise AssertionError(f"pca: indexed {nb} rows of {n}, "
                             f"has_rerank_feats={ps.has_rerank_feats}")
    _check_results(got, cfg["limit"], "pca wave")
    if got != want:
        raise AssertionError("pca: LOPQModelPCA searcher differs from the "
                             "plain-model searcher on projected inputs")
    for j in range(4):
        if got[j][0][0].id != j:
            raise AssertionError(f"pca: indexed raw row {j} came back as "
                                 f"{got[j][0][0]}")
    log(f"pca: checks passed: results equal the plain-model searcher's on "
        f"apply_PCA inputs ({PCA['wave']} queries x {cfg['limit']}), 4 "
        f"indexed raw rows returned first")


def face_index(dev, face):
    """The face configuration's trained model and index rows (FACE): the
    face mixture encoded by the model ``phase_train`` trained on it.
    Returns (model, coarse [n, 2] and fine [n, M] uint8 as numpy, the
    mixture's components, the generator, to draw queries from the same
    mixture)."""
    from columbiaimagesearch_tpu_torch.index.encode import lopq_encode

    model, comp, g = face["model"], face["comp"], face["g"]
    rows = mixture(FACE["rows"], comp, g)
    coarse, fine = lopq_encode(model.Cs, model.Rs, model.mus, model.subs,
                               rows, chunk=8192)
    del rows
    return (model, coarse.cpu().numpy(), fine.to(torch.uint8).cpu().numpy(),
            comp, g)


def phase_exhaustive(dev, card, face):
    """The exhaustive exact-ADC path at face-index scale (FACE) on the
    trained face model."""
    from columbiaimagesearch_tpu_torch.index.exhaustive_adc import (
        BLK,
        ExhaustiveADC,
        ExhaustiveADCSearcher,
        _scan_tiling,
        adc_scan_all,
        adc_scan_all_plain,
        build_query_luts,
        build_query_luts_tiled,
        tile_luts,
    )
    from columbiaimagesearch_tpu_torch.index.lut import build_luts

    cfg = FACE
    V, k, n = cfg["V"], cfg["k"], cfg["rows"]
    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    model, coarse, fine, comp, g = face_index(dev, face)
    log(f"exhaustive: model (V={V} M={cfg['M']} S={cfg['S']} "
        f"D={cfg['D']}) + {n} rows made and encoded in "
        f"{time.perf_counter() - t0:.1f}s [{card}]")
    ex = ExhaustiveADC(model)
    t0 = time.perf_counter()
    ex.build(coarse, fine)
    build_s = time.perf_counter() - t0
    npad = ex.n_blocks * BLK
    log(f"exhaustive: ExhaustiveADC.build: {n} rows -> {npad} padded rows "
        f"({ex.n_blocks} blocks), ratio {npad / n:.4f}, host "
        f"{build_s:.2f}s")
    d = ex._dev
    Q = mixture(max(cfg["nqs"]), comp, g)

    # The scan kernel vs plain on this index at NQ 64 and 8 (launches not
    # counted); the NQ=8 tables stay for the selection check below.
    face = {}
    for nq in sorted(cfg["nqs"], reverse=True):
        lut0, lut1 = build_query_luts(Q[:nq], d["Cs"], d["Rs"], d["mus"],
                                      d["subs"])
        args = (d["codes"], d["block_cell"], d["block_count"], lut0, lut1)
        face[nq] = _scan_check(f"face NQ={nq} (V={V} M={cfg['M']} "
                               f"S={cfg['S']} rows={n} padded={npad})",
                               args, V, card)
        # search_batch's route to the same tables: the scan's tiled layout
        # made in one copy from the all-clusters LUT call
        QT, Sp, _ = _scan_tiling(nq, cfg["M"], cfg["S"])
        for half, t in zip((lut0, lut1), build_query_luts_tiled(
                Q[:nq], d["Cs"], d["Rs"], d["mus"], d["subs"])):
            if not torch.equal(t, tile_luts(half, QT, Sp)):
                raise AssertionError(f"exhaustive NQ={nq}: "
                                     "build_query_luts_tiled differs from "
                                     "tile_luts(build_query_luts)")
    max_abs = max(r["max_abs"] for r in face.values())

    adc_scan_all.launches = 0                  # counts this path only
    build_luts.launches = 0
    results, per_query = {}, {}
    for nq in cfg["nqs"]:
        ex.NQ = nq
        X = Q[:nq]
        results[nq] = ex.search_batch(X, k=k)
        per_query[nq] = float(np.median(host_ms(
            lambda: ex.search_batch(X, k=k), 5, sync))) / nq
    es = ExhaustiveADCSearcher(model)
    sub = cfg["subset"]
    es.add_codes_from_dict({i: (tuple(coarse[i]), tuple(fine[i]))
                            for i in range(sub)})
    nb_sub = es.get_nb_indexed()
    es_res = [es.search(Q[i], quota=k, with_dists=True) for i in range(2)]
    sync()
    adc_launches, lut_launches = adc_scan_all.launches, build_luts.launches
    for nq in cfg["nqs"]:
        log(f"exhaustive: search_batch nq={nq} k={k}: p50 "
            f"{per_query[nq]:.4f} ms/query (host clock, p50 of 5 "
            f"launches) [{card}]")
    log(f"exhaustive: adc_scan launches={adc_launches}, lut_build "
        f"launches={lut_launches}; ExhaustiveADCSearcher indexed {nb_sub}")
    if adc_launches <= 0 or lut_launches <= 0:
        raise AssertionError("the exhaustive path did not launch both "
                             "adc_scan and lut_build")

    for nq, res in results.items():
        for i, (ids, dists) in enumerate(res):
            if len(ids) != k or len(set(ids)) != k:
                raise AssertionError(f"exhaustive nq={nq} query {i}: "
                                     f"{len(set(ids))} distinct of {k}")
            if not (np.isfinite(dists).all() and (np.diff(dists) >= 0).all()):
                raise AssertionError(f"exhaustive nq={nq} query {i}: "
                                     "distances not finite ascending")
    # A selection made on the plain version's distances (a stable sort:
    # lower padded position first on ties).
    plain = adc_scan_all_plain(*args, V=V)[:4]
    pv, pi = torch.sort(plain, dim=1, stable=True)
    pv, pi = pv[:, :k].cpu().numpy(), pi[:, :k].cpu().numpy()
    swaps = 0
    for nq, q in itertools.product(cfg["nqs"], range(4)):
        ids, dists = results[nq][q]
        np.testing.assert_allclose(dists, pv[q], rtol=LUT_RTOL,
                                   atol=LUT_ATOL)
        swaps += plain_selection_check(ids, dists, ex._ids[pi[q]], pv[q],
                                       f"exhaustive nq={nq} query {q}")
    del plain, pv, pi, lut0, lut1, args
    for nq in cfg["nqs"]:
        ex.NQ = nq
        wall_ms, busy_ms, n_ops, top = trace(
            lambda: ex.search_batch(Q[:nq], k=k), f"exhaustive_nq{nq}")
        log(f"profile: exhaustive search_batch nq={nq} k={k}: wall "
            f"{wall_ms:.2f} ms (profiled), device busy {busy_ms:.2f} ms, "
            f"idle share {1 - busy_ms / wall_ms:.3f}, {n_ops} device ops "
            f"[{card}]")
        for line in top:
            log(line)
    ref = ExhaustiveADC(model)
    ref.build(coarse[:sub], fine[:sub], ids=list(range(sub)))
    for i, (res, visited) in enumerate(es_res):
        rids, rd = ref.search(Q[i], k=k)
        if ([r.id for r in res] != rids or [r.dist for r in res]
                != [float(x) for x in rd] or visited != V * V
                or nb_sub != sub):
            raise AssertionError("ExhaustiveADCSearcher differs from "
                                 "ExhaustiveADC on the same rows")
    log(f"exhaustive: checks passed: {k} distinct ids with finite ascending "
        f"distances per query; 4 queries of each nq equal a stable "
        f"selection on the plain distances ({swaps} rounding-tie swaps); "
        f"the tiled tables equal tile_luts(build_query_luts); "
        f"ExhaustiveADCSearcher equals ExhaustiveADC on {sub} rows")
    return dict(adc_launches=adc_launches, lut_launches=lut_launches,
                max_abs=max_abs, face=face,
                index=dict(model=model, coarse=coarse, fine=fine, comp=comp,
                           g=g))


ROOT = os.path.dirname(os.path.abspath(__file__))
HOPPER = os.path.join(ROOT, "tests", "data", "grace_hopper.jpg")


def deterministic_caffe_blobs(seed=0):
    """Caffe-layout blobs with trained-net-like scales; a copy of
    tests/test_sentibank_weights.py:54-75 (the golden fc7's weights)."""
    r = np.random.RandomState(seed)

    def conv(out_c, in_c, k):
        return (0.01 * r.randn(out_c, in_c, k, k).astype(np.float32),
                0.1 * np.ones(out_c, np.float32))

    def fc(out_c, in_c):
        return (0.005 * r.randn(out_c, in_c).astype(np.float32),
                0.1 * np.ones(out_c, np.float32))

    return {
        "conv1": conv(96, 3, 11), "conv2": conv(256, 48, 5),
        "conv3": conv(384, 256, 3), "conv4": conv(384, 192, 3),
        "conv5": conv(256, 192, 3),
        "fc6": fc(4096, 9216), "fc7": fc(4096, 4096),
        "fc8-t": fc(2089, 4096),
    }


def serving_images(seed, n):
    """grace_hopper.jpg and ``n`` seeded JPEGs (block patterns plus noise,
    sizes 160-480), as encoded bytes."""
    import io

    from PIL import Image

    rng = np.random.RandomState(seed)
    with open(HOPPER, "rb") as f:
        out = [f.read()]
    for _ in range(n):
        h, w = rng.randint(160, 481, 2)
        img = rng.randint(0, 40, (h, w, 3)).astype(np.int32)
        for _ in range(4):
            y, x = rng.randint(0, h - 32), rng.randint(0, w - 32)
            img[y:y + rng.randint(16, h - y), x:x + rng.randint(16, w - x),
                rng.randint(3)] += rng.randint(60, 200)
        b = io.BytesIO()
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            b, format="JPEG", quality=90)
        out.append(b.getvalue())
    return out


def phase_fc7(dev, card):
    """DeepSentibank on the card: the golden fc7, card vs CPU forward, and
    the forward's ms per wave (CUDA events) at FC7_WAVES in float32 and
    bfloat16."""
    from PIL import Image

    from columbiaimagesearch_tpu_torch.models.preprocess import (
        default_mean_image,
        preprocess_batch,
    )
    from columbiaimagesearch_tpu_torch.models.sentibank import (
        DeepSentibank,
        SentibankFeaturizer,
        init_params,
        load_caffe_weights,
    )

    img = np.asarray(Image.open(HOPPER).convert("RGB"))
    x = preprocess_batch([img, img[:, ::-1]], default_mean_image(),
                         device=dev)
    net = DeepSentibank.from_state_dict(
        load_caffe_weights(deterministic_caffe_blobs()), dev)
    with torch.inference_mode():
        got = net.features(x).cpu().numpy()
    with np.load(os.path.join(ROOT, "tests", "data", "golden_fc7.npz")) as z:
        want = z["fc7"]
    golden_err = float(np.abs(got - want).max())
    log(f"fc7: golden grace_hopper.jpg fc7 on {dev}: max_abs_err="
        f"{golden_err:.3e} (rtol {GOLDEN_RTOL}, atol {GOLDEN_ATOL}) [{card}]")
    np.testing.assert_allclose(got, want, rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL)
    del net

    sd = init_params(seed=0)
    card_f = SentibankFeaturizer(params=sd, device=dev)
    cpu_f = SentibankFeaturizer(params=sd, device="cpu")
    pix, status = card_f.decode_wave(serving_images(1, 7))
    assert not any(status)
    got = card_f.featurize_pixel_wave(pix)[0].cpu().numpy()
    want = cpu_f.featurize_pixel_wave(pix)[0].numpy()
    err = float(np.abs(got - want).max())
    log(f"fc7: {len(pix)} images, the card's fc7 vs the CPU forward on the "
        f"same weights: max_abs_err={err:.3e} max |fc7|={np.abs(want).max():.3e}"
        f" (rtol {FC7_RTOL}, atol {FC7_ATOL}); TF32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32}")
    np.testing.assert_allclose(got, want, rtol=FC7_RTOL, atol=FC7_ATOL)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on")
    del cpu_f
    out = {}
    rng = np.random.RandomState(2)
    for dtype in ("float32", "bfloat16"):
        f = (card_f if dtype == "float32" else SentibankFeaturizer(
            params=sd, device=dev, compute_dtype="bfloat16"))
        for n in FC7_WAVES:
            stack = rng.randint(0, 255, (n, 256, 256, 3), dtype=np.uint8)
            ms = float(np.median(time_ms(
                lambda: f.featurize_pixel_wave(stack), 10, warmup=2)))
            out[(dtype, n)] = ms
            log(f"fc7: forward {dtype} wave n={n} (uint8 upload, "
                f"preprocess, conv stack, fc6, fc7): {ms:.4f} ms/wave, "
                f"{ms / n:.4f} ms/image (CUDA events, p50 of 10) [{card}]")
    return out


def _form(data):
    """A request's form body, encoded once before any timing starts (the
    urlencoding of a base64 image is slow Python that would otherwise run
    in the clients' timed region and contend with the server for the
    GIL)."""
    import urllib.parse

    return urllib.parse.urlencode({"data": data}).encode()


def _post(port, mode, body):
    """One POST of a :func:`_form` body to the search API; returns
    (latency ms, json reply)."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/cuimgsearch/{mode}",
        data=body, method="POST",
        headers={"Content-Type": "application/x-www-form-urlencoded"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        reply = json.loads(r.read())
    return (time.perf_counter() - t0) * 1e3, reply


def _check_reply(reply, sha1, what):
    if "error" in reply or "Errors" in reply:
        raise AssertionError(f"{what}: error in the response: {reply}")
    entry = reply["AllSimilarImages"][0]
    ids = entry["SimilarImages"]["ImageSha1s"]
    if entry["QuerySha1"] != sha1 or not ids or ids[0] != sha1:
        raise AssertionError(f"{what}: query {sha1} came back first as "
                             f"{ids[:1]}")


def pipeline_files(seed, n):
    """(name, bytes) of the pipeline's input files in the order the
    directory walk takes them: ``serving_images(seed, n)`` (grace_hopper.jpg
    first) as JPEGs, then one PNG, one GIF and one JPEG cut at the end of
    its SOS header (its size reads, its pixels do not)."""
    import io

    from PIL import Image

    files = [(f"img_{i:05d}.jpg", b)
             for i, b in enumerate(serving_images(seed, n))]
    rng = np.random.RandomState(seed + 5)
    for fmt in ("png", "gif"):
        b = io.BytesIO()
        Image.fromarray(rng.randint(0, 255, (180, 240, 3)).astype(
            np.uint8)).save(b, format=fmt.upper())
        files.append((f"img_{len(files):05d}.{fmt}", b.getvalue()))
    jpeg = serving_images(seed + 6, 1)[1]
    sos = jpeg.index(b"\xff\xda")
    cut = sos + 2 + ((jpeg[sos + 2] << 8) | jpeg[sos + 3])
    files.append((f"img_{len(files):05d}_truncated.jpg", jpeg[:cut]))
    return files


def _run_processing(conf_path, env, timeout):
    """``python -m columbiaimagesearch_tpu_torch.pipeline.run_processing -c
    <conf> --once`` on the card: (seconds, stdout lines, the per-update
    dicts it printed). The copied loop retries a failed pass forever, even
    with ``--once``: a timeout, a nonzero exit or a retry fails."""
    cmd = [sys.executable, "-m",
           "columbiaimagesearch_tpu_torch.pipeline.run_processing", "-c",
           conf_path, "--once"]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=timeout)
    except subprocess.TimeoutExpired as err:
        raise AssertionError(f"pipeline: run_processing did not end within "
                             f"{timeout}s: {str(err.stderr)[-3000:]}")
    seconds = time.perf_counter() - t0
    if proc.returncode != 0 or "[run_processing] error" in proc.stderr:
        raise AssertionError(f"pipeline: run_processing exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    updates = [json.loads(line.split(" update ", 1)[1]) for line in lines
               if line.startswith("[run_processing] update ")]
    return seconds, lines, updates


def phase_pipeline(dev, card, db, weights, sd, cfg=None):
    """The ingest path on the card into the store ``db`` (see the module
    docstring, phase 10a). ``weights`` is the Sentibank npz the serving
    facade loaded (``sd`` its state dict): the subprocess loads it through
    $SENTIBANK_WEIGHTS. Returns the pipeline's images and numbers."""
    import shutil

    from columbiaimagesearch_tpu_torch.common.factory import build_indexer
    from columbiaimagesearch_tpu_torch.common.profiling import StageTimer
    from columbiaimagesearch_tpu_torch.extraction.extractor import (
        GenericExtractor,
        build_extr_str,
    )
    from columbiaimagesearch_tpu_torch.extraction.featsio import (
        featB64decode,
        normfeatB64encode,
    )
    from columbiaimagesearch_tpu_torch.imgio.imgio import get_SHA1_from_data
    from columbiaimagesearch_tpu_torch.models.sentibank import (
        WEIGHTS_ENV,
        SentibankFeaturizer,
    )
    from columbiaimagesearch_tpu_torch.native.imgpipe import (
        imgpipe_available,
        read_coeffs_batch,
    )
    from columbiaimagesearch_tpu_torch.pipeline.processor import (
        ExtractionProcessor,
    )
    from columbiaimagesearch_tpu_torch.store.kvindexer import KVIndexer

    cfg = dict(PIPELINE, **(cfg or {}))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    work = os.path.join(ROOT, "build", "pipeline")
    shutil.rmtree(work, ignore_errors=True)
    images = os.path.join(work, "images")
    os.makedirs(images)
    t0 = time.perf_counter()
    files = pipeline_files(cfg["seed"] + 3, cfg["images"])
    for name, data in files:
        with open(os.path.join(images, name), "wb") as f:
            f.write(data)
    sha1s = [get_SHA1_from_data(data) for _, data in files]
    n_good = len(files) - 1
    log(f"pipeline: {len(files)} files ({n_good - 2} JPEGs, a PNG, a GIF "
        f"and {files[-1][0]}) under build/pipeline/images in "
        f"{time.perf_counter() - t0:.2f}s")
    with open(os.path.join(ROOT, cfg["conf"])) as f:
        conf = json.load(f)
    conf["CHECK_input_dir"] = images
    conf["KVI_db_path"] = db
    conf_path = os.path.join(work, "conf_extraction.json")
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    env = dict(os.environ, **{WEIGHTS_ENV: weights})
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])

    seconds, lines, per_update = _run_processing(conf_path, env,
                                                 cfg["timeout"])
    for line in lines:
        if not line.startswith("[run_processing] update "):
            log(f"pipeline: run_processing: {line}")
    log(f"pipeline: python -m columbiaimagesearch_tpu_torch.pipeline."
        f"run_processing -c build/pipeline/conf_extraction.json --once: "
        f"{seconds:.2f}s for {len(files)} images, {n_good / seconds:.1f} "
        f"img/s over the whole run (process start, weights, checker, "
        f"processor) [{card}]")
    for u in per_update:
        n = u["images"]
        log(f"pipeline: update {u['update_id'].rsplit('-', 2)[0]}: {n} "
            f"images ({u['ok']} extracted): fetch {u.get('fetch_s', 0):.3f}s"
            f", extract {u.get('extract_s', 0):.3f}s, write "
            f"{u.get('write_s', 0):.3f}s; "
            f"{n / sum(v for k, v in u.items() if k.endswith('_s')):.1f} "
            f"img/s (host clock, in the subprocess) [{card}]")

    kv = build_indexer(conf)
    extr = build_extr_str("sentibank", "full", "image")
    updates = [(r, c) for b in kv.get_updates_from_date(
        "1970-01-01", extr_type=extr) for r, c in b]
    lists = [c[kv.get_col_listsha1s()].decode().split(",")
             for _, c in updates]
    size = int(conf["CHECK_batch_update_size"])
    sizes = [min(size, len(files) - lo) for lo in range(0, len(files), size)]
    if (len(updates) != len(sizes) or len(per_update) != len(sizes)
            or [len(x) for x in lists] != sizes
            or sum(lists, []) != sha1s
            or any(c.get(kv.get_col_upproc()) is None
                   or c.get(kv.get_col_upcomp()) != b"1"
                   for _, c in updates)):
        raise AssertionError(f"pipeline: expected updates of {sizes} "
                             f"images in walk order, each processed and "
                             f"completed, got "
                             f"{[(r, sorted(c)) for r, c in updates]}")
    rows = dict(kv.get_rows_by_batch(sha1s, kv.table_sha1infos_name))
    col, col_ok = f"ext:{extr}", f"ext:{extr}_processed"
    missing = [s for s in sha1s[:n_good]
               if col not in rows[s] or rows[s].get(col_ok) != b"1"]
    if missing:
        raise AssertionError(f"pipeline: {len(missing)} decodable images "
                             f"have no fc7 column")
    # The last update holds a PNG, a GIF and the truncated JPEG, so the
    # JPEG is its wave's dominant size and takes the coefficient route
    # (the processor's featurizer decodes on the device by default), whose
    # reader fills the missing scan with gray as libjpeg does: it is
    # extracted. On the pixel route PIL would refuse it (imgpipe does not
    # build on the card's machine).
    bad = rows[sha1s[-1]]
    bad_status = int(read_coeffs_batch([files[-1][1]], 8, 64, 64)[4][0])
    want_failed = not (bad_status == 0 or imgpipe_available())
    if want_failed != (bad.get(f"ext:{extr}_failed") == b"1"
                       and col not in bad):
        raise AssertionError(f"pipeline: the truncated JPEG's columns "
                             f"{sorted(bad)} (failed expected: "
                             f"{want_failed})")
    log(f"pipeline: store checks passed: {len(sizes)} updates of {sizes} "
        f"images, each processed and completed; fc7 for all {n_good} "
        f"decodable images; the truncated JPEG "
        f"{'failed' if want_failed else 'extracted (coefficient route)'}")

    seconds2, lines2, per_update2 = _run_processing(conf_path, env,
                                                    cfg["timeout"])
    n_updates2 = sum(len(b) for b in kv.get_updates_from_date(
        "1970-01-01", extr_type=extr))
    if per_update2 or any("updates created" in x for x in lines2) or \
            n_updates2 != len(sizes):
        raise AssertionError(f"pipeline: the second --once run created or "
                             f"processed something: {lines2[-5:]}")
    log(f"pipeline: a second --once run created and processed nothing in "
        f"{seconds2:.2f}s")

    # Where an update's time goes: the processor's stages replayed one
    # after another in this process (the subprocess overlaps decode and
    # forward), in its waves of PIPELINE_CHUNK images and on its routes
    # (the card featurizer decodes on the device, as the processor's),
    # the writes into a scratch store.
    card_f = SentibankFeaturizer(params=sd, device=dev, device_decode=True)
    proc = ExtractionProcessor(
        KVIndexer(path=os.path.join(work, "split.db")),
        GenericExtractor("full", "sentibank", "image", featurizer=card_f),
        nb_threads=int(conf["PROC_nb_threads"]))
    pick = np.linspace(0, n_good - 3, cfg["sample"]).astype(int)
    picked = {sha1s[i] for i in pick}
    replay, replay_pix = {}, {}
    splits, routes = [], []
    for (uid, _), sha1_list in zip(updates, lists):
        timer = StageTimer()
        with timer.stage("fetch"):
            got = kv.get_rows_by_batch(sha1_list, kv.table_sha1infos_name)
            buffers = proc.fetch_buffers(got)
        raws = [buffers[r].getvalue() for r, _ in got]
        keys = [r for r, _ in got]
        feats, status = [], []
        before = dict(card_f.route_counts)
        for lo in range(0, len(raws), card_f.PIPELINE_CHUNK):
            with timer.stage("decode"):
                prep = card_f.prepare_wave(
                    raws[lo:lo + card_f.PIPELINE_CHUNK])
            with timer.stage("forward"):
                pix, st = card_f.wave_pixels(prep)
                out, _ = card_f.featurize_pixel_wave(pix)
                feats.append(out.cpu().numpy())
                sync()
            for j, k in enumerate(keys[lo:lo + card_f.PIPELINE_CHUNK]):
                if k in picked:
                    replay_pix[k] = (pix[j].cpu().numpy()
                                     if isinstance(pix, torch.Tensor)
                                     else pix[j])
            status.extend(st)
        feats = np.concatenate(feats)
        for k, x, st in zip(keys, feats, status):
            if k in picked and st == 0:
                replay[k] = x
        route = {k: card_f.route_counts[k] - before[k] for k in before}
        routes.append(route)
        with timer.stage("encode"):
            cols = {r: {col: normfeatB64encode(x)}
                    for (r, _), x, st in zip(got, feats, status) if st == 0}
        with timer.stage("write"):
            proc.indexer.push_dict_rows(cols, kv.table_sha1infos_name)
        t = {k: v for k, v in timer.totals.items()}
        splits.append(dict(t, images=len(raws), routes=route))
        log(f"pipeline: update {uid.rsplit('-', 2)[0]} replayed stage by "
            f"stage ({len(raws)} images; routes {route}: a wave's "
            f"dominant-size 4:2:0 JPEGs take the coefficient route, and "
            f"these random sizes are mostly unique): buffer fetch "
            f"{t['fetch']:.3f}s, host decode (coefficient read, PIL decode "
            f"and resize on the pixel route) {t['decode']:.3f}s, device "
            f"(upload, reconstruction, preprocess, fc7, download) "
            f"{t['forward']:.3f}s, column encode {t['encode']:.3f}s + "
            f"sqlite write {t['write']:.3f}s; ms an image: "
            f"{1e3 * t['fetch'] / len(raws):.3f} / "
            f"{1e3 * t['decode'] / len(raws):.3f} / "
            f"{1e3 * t['forward'] / len(raws):.3f} / "
            f"{1e3 * (t['encode'] + t['write']) / len(raws):.3f} [{card}]")

    # fc7 of sampled images: the stored column against the card
    # featurizer on the same bytes in the processor's waves (the replay
    # above: the same routes), and against the CPU forward of the same
    # pixels.
    stored = np.stack([featB64decode(rows[sha1s[i]][col], "sentibank")
                       for i in pick])

    def unit(x):
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    on_card = np.stack([replay[sha1s[i]] for i in pick])
    cpu_f = SentibankFeaturizer(params=sd, device="cpu")
    on_cpu = unit(cpu_f.featurize_pixel_wave(np.stack(
        [replay_pix[sha1s[i]] for i in pick]))[0].numpy())
    del cpu_f
    card_err = float(np.abs(stored - unit(on_card)).max())
    cpu_err = float(np.abs(stored - on_cpu).max())
    log(f"pipeline: {len(pick)} sampled images' stored fc7 (unit norm) vs "
        f"the card's featurizer on the same bytes in the processor's waves: "
        f"max_abs_err={card_err:.3e} (atol {FC7_SAMPLE_ATOL}); vs the CPU "
        f"forward of the same pixels: max_abs_err={cpu_err:.3e} (rtol "
        f"{FC7_RTOL}, atol {FC7_ATOL})")
    if card_err > FC7_SAMPLE_ATOL:
        raise AssertionError("pipeline: stored fc7 differs from the card's "
                             "featurizer")
    np.testing.assert_allclose(stored, on_cpu, rtol=FC7_RTOL, atol=FC7_ATOL)
    proc.indexer._shared.close()
    return dict(work=work, files=files, sha1s=sha1s,
                n_rows=n_good + (not want_failed),
                seconds=seconds, img_s=n_good / seconds,
                per_update=per_update, splits=splits, routes=routes,
                card_err=card_err, cpu_err=cpu_err)


def phase_serving(dev, card, trained, cfg=None):
    """The release configuration served over HTTP on the trained release
    model (see the module docstring, phase 10). Returns the launch counts
    and numbers."""
    import shutil
    import threading

    from columbiaimagesearch_tpu_torch.api.app import make_server
    from columbiaimagesearch_tpu_torch.common.factory import (
        build_searcher,
        build_storer,
    )
    from columbiaimagesearch_tpu_torch.extraction.extractor import (
        build_extr_str,
    )
    from columbiaimagesearch_tpu_torch.imgio.imgio import get_buffer_from_B64
    from columbiaimagesearch_tpu_torch.index.encode import lopq_encode
    from columbiaimagesearch_tpu_torch.index.exhaustive_adc import (
        adc_scan_all,
    )
    from columbiaimagesearch_tpu_torch.index.lut import build_luts
    from columbiaimagesearch_tpu_torch.index.model import LOPQModelPCA
    from columbiaimagesearch_tpu_torch.index.searcher import LOPQSearcherTorch
    from columbiaimagesearch_tpu_torch.models.sentibank import (
        WEIGHTS_ENV,
        init_params,
        save_weights_npz,
    )

    cfg = dict(SERVING, **(cfg or {}))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    work = os.path.join(ROOT, "build", "serving")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    with open(os.path.join(ROOT, cfg["conf"])) as f:
        conf = json.load(f)
    conf.update(cfg["overrides"])
    conf["KVI_db_path"] = os.path.join(work, "cuimgsearch.db")
    conf["ST_base_path"] = os.path.join(work, "storer")
    V = int(conf["SEARCHLOPQ_lopq_V"])
    M = int(conf["SEARCHLOPQ_lopq_M"])
    S = int(conf["SEARCHLOPQ_lopq_subq"])
    D = int(conf["SEARCHLOPQ_lopq_pcadims"])
    rerank_nb = int(conf["SEARCHLOPQ_rerank_nb"])
    t_phase = time.perf_counter()

    # Weights through the conventional path, as a deployment drops them.
    weights = os.path.join(work, "sentibank.npz")
    sd = init_params(seed=cfg["seed"])
    save_weights_npz(sd, weights)
    old_env = os.environ.get(WEIGHTS_ENV)
    os.environ[WEIGHTS_ENV] = weights

    # The model: the trained release model, as train_index saves it.
    model = trained["release"]
    extr = build_extr_str("sentibank", "full", "image")
    key = f"{extr}_lopq_pca-pca{D}-subq{S}-V{V}-M{M}"
    t0 = time.perf_counter()
    build_storer(conf).save(key, model)
    save_s = time.perf_counter() - t0
    del model

    t0 = time.perf_counter()
    facade = build_searcher(conf)
    sync()
    log(f"serving: {cfg['conf']} -> build_searcher: model {key} from the "
        f"storer (saved in {save_s:.2f}s), facade in "
        f"{time.perf_counter() - t0:.2f}s, coalescing "
        f"{conf['SEARCHLOPQ_coalesce_window_ms']} ms / "
        f"{conf['SEARCHLOPQ_coalesce_max_batch']}")
    if (facade.build_model_str() != key
            or not isinstance(facade.model, LOPQModelPCA)
            or not isinstance(facade.searcher, LOPQSearcherTorch)
            or facade.request_batcher is None
            or facade.model.device != dev):
        raise AssertionError("serving: the facade did not load the stored "
                             "model onto the card")
    s = facade.searcher
    try:
        t0 = time.perf_counter()
        rows = index_rows(cfg["rows"], trained["src"], facade.model)
        coarse, fine = lopq_encode(facade.model.Cs, facade.model.Rs,
                                   facade.model.mus, facade.model.subs, rows,
                                   chunk=8192)
        s.add_codes((coarse.cpu().numpy(), fine.to(torch.uint8).cpu().numpy()),
                    feats=rows)
        nb = s.get_nb_indexed()
        sync()
        del rows, coarse, fine
        log(f"serving: {nb} index-space rows (codes + float32 rerank store) "
            f"through add_codes in {time.perf_counter() - t0:.1f}s")

        # The refresh route: the ingest pipeline fills the facade's store
        # (the two confs share KVI_db_path), then load_codes.
        pipe = phase_pipeline(dev, card, conf["KVI_db_path"], weights, sd)
        bufs = [data for _, data in pipe["files"][:cfg["images"] + 1]]
        sha1s = pipe["sha1s"][:len(bufs)]
        t0 = time.perf_counter()
        added = facade.load_codes()
        sync()
        refresh_s = time.perf_counter() - t0
        nb2 = facade.get_nb_indexed()
        log(f"serving: load_codes indexed the pipeline's "
            f"{len(pipe['per_update'])} updates into the {nb}-row index: "
            f"added {added} rows in {refresh_s:.2f}s (fc7 from sqlite, PCA "
            f"and encode on the card, one refresh); nb_indexed={nb2}, "
            f"has_rerank_feats={s.has_rerank_feats} [{card}]")
        if (added != pipe["n_rows"] or nb2 != nb + added
                or not s.has_rerank_feats):
            raise AssertionError("serving: the refresh did not index the "
                                 "pipeline's images with their rerank "
                                 "features")
        b64 = [base64.b64encode(b).decode() for b in bufs]
        forms = [_form(x) for x in b64]

        # Record the waves the coalescer hands the raw-feature path.
        waves = []
        live = s.search_device_feats

        def recording(X, **kw):
            out = live(X, **kw)
            waves.append((X[:kw.get("n_valid") or X.shape[0]].cpu().numpy(),
                          kw, out))
            return out
        s.search_device_feats = recording
        # And each wave's routes: the handlers' preps (one a request) are
        # decoded JPEG coefficients or pixels.
        wave_routes = []
        live_preps = facade.featurizer.featurize_preps

        def counting_preps(preps):
            coef = pix = 0
            for kind, payload in preps:
                if kind == "pixels":
                    pix += len(payload["status"])
                else:
                    coef += len(payload["ok_idx"])
                    pix += len(payload["pix_idx"])
            wave_routes.append((coef, pix))
            return live_preps(preps)
        facade.featurizer.featurize_preps = counting_preps

        server = make_server(facade, port=0, host="127.0.0.1")
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        build_luts.launches = 0                     # counts this path only
        adc_scan_all.launches = 0
        try:
            first_ms, reply = _post(port, "byB64", forms[1])
            _check_reply(reply, sha1s[1], "first request")
            t0 = time.perf_counter()
            warmed = facade.prewarm_serving(
                int(conf["SEARCHLOPQ_coalesce_max_batch"]))
            sync()
            prewarm_s = time.perf_counter() - t0
            del waves[:]           # the parity check takes a live wave
            single = []
            for i in range(cfg["single"]):
                j = i % len(bufs)
                ms, reply = _post(port, "byB64", forms[j])
                _check_reply(reply, sha1s[j], f"1-client request {i}")
                single.append(ms)
            rounds, server_ms = [], []
            n_c = cfg["clients"]
            for r in range(cfg["rounds"]):
                res, srv, errs = [None] * n_c, [None] * n_c, []
                gate = threading.Event()

                def client(i, r=r):
                    gate.wait()
                    j = (r * n_c + i) % len(bufs)
                    try:
                        ms, reply = _post(port, "byB64", forms[j])
                        _check_reply(reply, sha1s[j], f"client {i}")
                        res[i], srv[i] = ms, reply["Timing"] * 1e3
                    except Exception as inst:  # noqa: BLE001 — reported
                        errs.append(inst)
                ts = [threading.Thread(target=client, args=(i,))
                      for i in range(n_c)]
                for t in ts:
                    t.start()
                gate.set()
                for t in ts:
                    t.join(timeout=300)
                if errs or any(t.is_alive() for t in ts):
                    raise AssertionError(f"serving: {n_c}-client round {r}: "
                                         f"{errs[:3]}")
                rounds.append(res)
                server_ms.extend(srv)
            path_ms, reply = _post(port, "byPATH", _form(os.path.join(
                pipe["work"], "images", pipe["files"][0][0])))
            _check_reply(reply, sha1s[0], "byPATH grace_hopper.jpg")
            sync()
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
            s.search_device_feats = live
        launches = dict(lut=build_luts.launches, adc=adc_scan_all.launches)
        sizes = list(facade.request_batcher.batch_sizes)
        conc = [ms for rr in rounds for ms in rr]
        log(f"serving: first request (no prewarm, 1 client) {first_ms:.2f} "
            f"ms; prewarm_serving({conf['SEARCHLOPQ_coalesce_max_batch']}) "
            f"buckets {warmed} in {prewarm_s:.2f}s; after it the first "
            f"1-client request {single[0]:.2f} ms and the first {n_c}-client "
            f"round max {max(rounds[0]):.2f} ms [{card}]")
        log(f"serving: HTTP byB64 latency, 1 client: p50 "
            f"{np.percentile(single, 50):.2f} ms p99 "
            f"{np.percentile(single, 99):.2f} ms ({len(single)} requests); "
            f"{n_c} clients: p50 {np.percentile(conc, 50):.2f} ms p99 "
            f"{np.percentile(conc, 99):.2f} ms ({len(conc)} requests in "
            f"{cfg['rounds']} rounds), of which the server's own Timing "
            f"(handler decode, coalescer wait, wave, assembly) p50 "
            f"{np.percentile(server_ms, 50):.2f} ms; byPATH {path_ms:.2f} ms "
            f"[{card}]")
        log(f"serving: coalesced wave sizes {sizes}; probe_stats waves="
            f"{s.probe_stats['waves']} escalated="
            f"{s.probe_stats['escalated_queries']} brute_waves="
            f"{s.probe_stats.get('brute_waves', 0)} wave_log="
            f"{s.probe_stats.get('wave_log', [])[-6:]}")
        log(f"serving: each wave's routes (coefficient, pixel): "
            f"{wave_routes}; in all {sum(c for c, _ in wave_routes)} "
            f"coefficient, {sum(p for _, p in wave_routes)} pixel")
        if not any(c for c, _ in wave_routes):
            raise AssertionError("serving: no request took the coefficient "
                                 "route")
        log(f"serving: launches during the phase: lut_build "
            f"{launches['lut']}, adc_scan {launches['adc']}")
        if launches["lut"] <= 0:
            raise AssertionError("serving: lut_build never launched")
        if max(sizes) <= 1:
            raise AssertionError("serving: no wave coalesced two requests")

        # Parity: the largest coalesced wave against search_batch on the
        # same fc7 rows normalized on the host.
        X, kw, got = max(waves, key=lambda w: len(w[0]))
        Xn = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-30)
        want = s.search_batch(Xn, quota=kw["quota"], limit=kw["limit"],
                              with_dists=True, with_codes=False,
                              rerank_nb=kw["rerank_nb"])
        worst = 0.0
        for (rg, _), (rw, _) in zip(got, want):
            if [r.id for r in rg] != [r.id for r in rw]:
                raise AssertionError("serving: coalesced wave ids differ "
                                     "from search_batch")
            worst = max(worst, float(np.abs(
                np.array([r.dist for r in rg])
                - np.array([r.dist for r in rw])).max()))
        if worst > SERVING_DIST_ATOL:
            raise AssertionError(f"serving: distances differ by {worst}")
        log(f"serving: a coalesced wave of {len(X)} equals search_batch on "
            f"the host-normalized fc7 rows ({kw['limit']} ids each, "
            f"rerank_nb={kw['rerank_nb']}): max_abs_dist_err={worst:.3e} "
            f"(atol {SERVING_DIST_ATOL})")

        def wave_reqs():
            return [facade._prepare_request(
                [b64[j % len(bufs)]], get_buffer_from_B64, {}, False)
                for j in range(n_c)]

        t0 = time.perf_counter()
        reqs = wave_reqs()                        # decoded, as handlers do
        prep_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        replies = facade._serve_batch(reqs)
        sync()
        wave_ms = (time.perf_counter() - t0) * 1e3
        log(f"serving: {n_c} requests prepared one after another in one "
            f"thread (base64, sha1, the JPEG coefficient read): "
            f"{prep_ms:.2f} "
            f"ms; their _serve_batch wave {wave_ms:.2f} ms [{card}]")
        for j, reply in enumerate(replies):
            _check_reply(reply, sha1s[j % len(bufs)], f"wave request {j}")
        if dev.type == "cuda":
            reqs = wave_reqs()
            wall_ms, busy_ms, n_ops, top = trace(
                lambda: facade._serve_batch(reqs), "serving_wave32")
            log(f"profile: serving wave of {n_c} requests (_serve_batch: "
                f"fc7 forward + fast path + result assembly, rerank_nb="
                f"{rerank_nb}): device busy {busy_ms:.2f} ms, {n_ops} device "
                f"ops; wall {wave_ms:.2f} ms unprofiled (idle share "
                f"{1 - busy_ms / wave_ms:.3f}), {wall_ms:.2f} ms profiled "
                f"[{card}]")
            for line in top:
                log(line)
        reqs = wave_reqs()
        for line in host_profile(lambda: facade._serve_batch(reqs), sync):
            log(f"serving: wave of {n_c}, host {line}")
        log(f"serving: checks passed: {len(single) + len(conc) + 2} HTTP "
            f"answers without errors, each with its query image first; "
            f"phase {time.perf_counter() - t_phase:.1f}s")
        sharded_http = phase_sharded_http(
            dev, card, facade, nb, conf["KVI_db_path"], work, forms, sha1s,
            cfg["overrides"])
        return dict(launches=launches, first_ms=first_ms, single=single,
                    conc=conc, sizes=sizes, refresh_s=refresh_s,
                    sharded_http=sharded_http,
                    wave_routes=wave_routes,
                    pipeline={k: pipe[k] for k in (
                        "seconds", "img_s", "per_update", "splits",
                        "routes", "card_err", "cpu_err")})
    finally:
        facade.request_batcher.close()
        shutil.rmtree(work, ignore_errors=True)     # the 262 MB weights file
        shutil.rmtree(os.path.join(ROOT, "build", "pipeline"),
                      ignore_errors=True)
        if old_env is None:
            os.environ.pop(WEIGHTS_ENV, None)
        else:
            os.environ[WEIGHTS_ENV] = old_env


def phase_sharded_http(dev, card, facade, nb, db, work, forms, sha1s,
                       overrides):
    """conf/conf_search_sharded.json served over HTTP (SHARDED): the
    release serving facade's ``nb`` bulk rows (its codes and PCA-space
    features, not encoded again) and the pipeline's store ``db``. Only the
    db and storer paths are rewritten, plus the serving phase's rerank
    depth (``overrides``; see SERVING). The storer holds the trained
    release ``LOPQModelPCA`` under the conf's model string (a ``lopq``
    model of this V on the raw 4096-d fc7 would need 2 x 4096 rotations of
    2048^2 floats, 137 GB). The conf sets no ``store_rerank_feats``, so the
    ingested rows' codes go in without features, which drops the device
    store (JAX semantics) and the rerank runs on the host through sqlite.
    Returns (numbers, ``lut_build`` launches)."""
    import threading

    from columbiaimagesearch_tpu_torch.api.app import make_server
    from columbiaimagesearch_tpu_torch.common.factory import (
        build_searcher,
        build_storer,
    )
    from columbiaimagesearch_tpu_torch.extraction.extractor import (
        build_extr_str,
    )
    from columbiaimagesearch_tpu_torch.index.lut import build_luts
    from columbiaimagesearch_tpu_torch.parallel.sharded import (
        ShardedLOPQSearcher,
    )

    c = SHARDED
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t_phase = time.perf_counter()
    with open(os.path.join(ROOT, c["conf"])) as f:
        conf = json.load(f)
    conf.update(overrides)
    conf["KVI_db_path"] = db
    conf["ST_base_path"] = os.path.join(work, "sharded_storer")
    V, M = int(conf["SEARCHLOPQ_lopq_V"]), int(conf["SEARCHLOPQ_lopq_M"])
    S = int(conf["SEARCHLOPQ_lopq_subq"])
    key = (f"{build_extr_str('sentibank', 'full', 'image')}_lopq-subq{S}"
           f"-V{V}-M{M}")
    build_storer(conf).save(key, facade.model)
    t0 = time.perf_counter()
    fac = build_searcher(conf)            # load_codes of the store at init
    sh = fac.searcher
    if (fac.build_model_str() != key
            or not isinstance(sh, ShardedLOPQSearcher)
            or len(sh.index.devices) != torch.cuda.device_count()
            or sh.index.devices[0] != dev):
        raise AssertionError("sharded http: the facade is not sharded over "
                             "every visible card")
    s = facade.searcher
    cells = s._cells[:nb]
    sh.add_codes((np.stack([cells // V, cells % V], axis=1).astype(np.int32),
                  s._fine[:nb]), feats=s._dev["feats"][:nb])
    total = fac.get_nb_indexed()
    sync()
    build_s = time.perf_counter() - t0
    log(f"sharded http: {c['conf']} (rerank_nb "
        f"{conf['SEARCHLOPQ_rerank_nb']}) -> build_searcher over "
        f"{len(sh.index.devices)} card(s): {len(fac.indexed_updates)} "
        f"pipeline updates through load_codes, {nb} bulk rows through "
        f"add_codes(feats=...); nb_indexed={total}, has_rerank_feats="
        f"{sh.has_rerank_feats} in {build_s:.2f}s [{card}]")
    if total <= nb or sh.has_rerank_feats:
        raise AssertionError("sharded http: the index does not hold the "
                             "pipeline's rows, or kept a device store")
    server = make_server(fac, port=0, host="127.0.0.1")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    before = build_luts.launches
    try:
        single, timing = [], []
        for i in range(c["single"]):
            j = (i + 1) % len(forms)
            ms, reply = _post(port, "byB64", forms[j])
            _check_reply(reply, sha1s[j], f"sharded 1-client request {i}")
            single.append(ms)
        n_c = c["clients"]
        res, srv, errs = [None] * n_c, [None] * n_c, []
        gate = threading.Event()

        def client(i):
            gate.wait()
            j = i % len(forms)
            try:
                ms, reply = _post(port, "byB64", forms[j])
                _check_reply(reply, sha1s[j], f"sharded client {i}")
                res[i], srv[i] = ms, reply["Timing"] * 1e3
            except Exception as inst:  # noqa: BLE001 — reported
                errs.append(inst)
        ts = [threading.Thread(target=client, args=(i,)) for i in range(n_c)]
        for t in ts:
            t.start()
        gate.set()
        for t in ts:
            t.join(timeout=300)
        if errs or any(t.is_alive() for t in ts):
            raise AssertionError(f"sharded http: {n_c}-client round: "
                                 f"{errs[:3]}")
        timing = srv
        sync()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    launches = build_luts.launches - before
    out = dict(build_s=build_s, single_p50=float(np.percentile(single, 50)),
               single_p99=float(np.percentile(single, 99)),
               conc_p50=float(np.percentile(res, 50)),
               conc_p99=float(np.percentile(res, 99)),
               timing_p50=float(np.percentile(timing, 50)),
               launches=launches, waves=sh.probe_stats["waves"],
               wave_log=sh.probe_stats.get("wave_log", [])[-3:])
    log(f"sharded http: byB64 1 client p50 {out['single_p50']:.2f} ms p99 "
        f"{out['single_p99']:.2f} ms ({len(single)} requests); {n_c} "
        f"clients p50 {out['conc_p50']:.2f} ms p99 {out['conc_p99']:.2f} ms,"
        f" Timing p50 {out['timing_p50']:.2f} ms; every query image first "
        f"(host rerank at depth {conf['SEARCHLOPQ_rerank_nb']}); lut_build "
        f"launches {launches}; wave_log {out['wave_log']}; phase "
        f"{time.perf_counter() - t_phase:.1f}s [{card}]")
    del fac, sh
    torch.cuda.empty_cache()
    return out, launches


def phase_codestore(dev, card, trained, cfg=None):
    """The native code store under ``LOPQSearcherTorch`` on the trained
    release model (see the module docstring, phase 10b). Returns its
    numbers."""
    import shutil

    from columbiaimagesearch_tpu_torch.common.profiling import StageTimer
    from columbiaimagesearch_tpu_torch.index.encode import lopq_encode
    from columbiaimagesearch_tpu_torch.index.searcher import LOPQSearcherTorch
    from columbiaimagesearch_tpu_torch.native.codestore import ID_LEN

    cfg = dict(CODESTORE, **(cfg or {}))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    work = os.path.join(ROOT, "build", "codestore")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path = os.path.join(work, "codes.cs")
    model = trained["release"]
    n, extra = cfg["rows"], cfg["extra"]
    try:
        rows = index_rows(n + extra, trained["src"], model)
        coarse, fine = lopq_encode(model.Cs, model.Rs, model.mus, model.subs,
                                   rows, chunk=8192)
        coarse = coarse.cpu().numpy()
        fine = fine.to(torch.uint8).cpu().numpy()
        del rows
        ids = np.array([f"r{i}" for i in range(n + extra)], dtype=object)
        queries = raw_rows(cfg["wave"], trained["src"])

        timer = StageTimer()
        first = LOPQSearcherTorch(model, codestore_path=path)
        store = first._codestore
        for name in ("append", "sync"):
            def timed(*a, _fn=getattr(store, name), _name=name):
                with timer.stage(_name):
                    return _fn(*a)
            setattr(store, name, timed)
        t0 = time.perf_counter()
        bounds = np.linspace(0, n, cfg["adds"] + 1).astype(int)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            first.add_codes((coarse[lo:hi], fine[lo:hi]), ids[lo:hi])
        add_s = time.perf_counter() - t0
        if first.get_nb_indexed() != n or len(store) != n:
            raise AssertionError("codestore: the first searcher lost rows")
        store.close()
        del first
        mb = n * (4 + model.M + ID_LEN) / 1e6
        append_s, sync_s = timer.totals["append"], timer.totals["sync"]
        log(f"codestore: {n} rows in {cfg['adds']} add_codes calls "
            f"({add_s:.2f}s): append {append_s:.3f}s ({mb / append_s:.1f} "
            f"MB/s of {mb:.1f} MB records), sync {sync_s:.3f}s in all, "
            f"{sync_s / cfg['adds']:.3f}s a call (cell sort + msync) "
            f"[{card}]")

        t0 = time.perf_counter()
        again = LOPQSearcherTorch(model, codestore_path=path)
        open_s = time.perf_counter() - t0
        nb = again.get_nb_indexed()
        sync()
        reload_s = time.perf_counter() - t0
        if nb != n:
            raise AssertionError(f"codestore: the restart indexed {nb} rows")
        cells, fcodes, rids = again._codestore.read_all()
        fresh = LOPQSearcherTorch(model)
        fresh.add_codes((np.stack([cells // model.V, cells % model.V], 1),
                         fcodes), rids)
        kw = dict(quota=cfg["quota"], limit=cfg["limit"], with_dists=True,
                  with_codes=False)
        got = again.search_batch(queries, **kw)
        want = fresh.search_batch(queries, **kw)
        worst = 0.0
        for (rg, _), (rw, _) in zip(got, want):
            if [r.id for r in rg] != [r.id for r in rw] or not rg:
                raise AssertionError("codestore: the restarted searcher's "
                                     "ids differ from a fresh searcher fed "
                                     "read_all()'s rows")
            worst = max(worst, float(np.abs(np.array([r.dist for r in rg])
                                            - np.array([r.dist for r in rw])
                                            ).max()))
        if worst > 0:
            raise AssertionError(f"codestore: distances differ by {worst}")
        del fresh
        log(f"codestore: restart: open + read_all {open_s:.2f}s, reload "
            f"to the card (first refresh) {reload_s:.2f}s for {nb} rows; "
            f"its {len(queries)}-query wave (quota {cfg['quota']}, limit "
            f"{cfg['limit']}) equals a fresh searcher fed read_all()'s rows "
            f"in its order: ids equal, distances equal [{card}]")
        t0 = time.perf_counter()
        again.add_codes((coarse[n:], fine[n:]), ids[n:])
        extra_s = time.perf_counter() - t0
        again._codestore.close()
        del again
        third = LOPQSearcherTorch(model, codestore_path=path)
        nb3 = third.get_nb_indexed()
        held = len(third._codestore)
        third._codestore.close()
        del third
        if nb3 != n + extra or held != n + extra:
            raise AssertionError(f"codestore: the third open holds {nb3} "
                                 f"rows ({held} records)")
        log(f"codestore: {extra} rows appended after the restart in "
            f"{extra_s:.3f}s; a third open holds {nb3}")
        return dict(rows=n, append_mb_s=mb / append_s, sync_s=sync_s,
                    open_s=open_s, reload_s=reload_s, extra_s=extra_s)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_refresh_sort(dev, card, cfg=None):
    """One ``chunk``-row refresh of the port's sort path
    (``append_and_build_csr``: write the chunk, stable radix sort of the
    cells, gather the codes, the offsets table) at each capacity of
    CODESTORE["caps"], codes only, V and M of the headline: the JAX
    searcher switches to ``merge_append_csr`` above 32M rows of capacity
    because XLA's sort was slow on its chip (JAX searcher.py:638-641)."""
    from columbiaimagesearch_tpu_torch.index.csr import append_and_build_csr

    cfg = dict(CODESTORE, **(cfg or {}))
    V, M, k = HEADLINE["V"], HEADLINE["M"], cfg["chunk"]
    g = torch.Generator(device=dev)
    g.manual_seed(cfg["seed"] + 21)
    out = {}
    for cap in cfg["caps"]:
        cells = torch.randint(0, V * V, (cap,), generator=g, device=dev,
                              dtype=torch.int32)
        cells[cap - k:] = V * V                   # the free tail: sentinel
        fine = torch.randint(0, 256, (cap, M), generator=g, device=dev,
                             dtype=torch.uint8)
        new_c = torch.randint(0, V * V, (k,), generator=g, device=dev,
                              dtype=torch.int32)
        new_f = torch.randint(0, 256, (k, M), generator=g, device=dev,
                              dtype=torch.uint8)
        ms = float(np.median(time_ms(lambda: append_and_build_csr(
            cells, fine, new_c, new_f, cap - k, V), 5)))
        out[cap] = ms
        log(f"refresh sort: one {k}-row append_and_build_csr at "
            f"{cap} rows of capacity (V={V}, M={M}, "
            f"{cap * (4 + M) / 1e9:.2f} GB of codes): {ms:.3f} ms (p50 of "
            f"5, CUDA events around each call) [{card}]")
        del cells, fine, new_c, new_f
    return out


def face_scene_png(seed):
    """A ``face_synth`` scene (480x640, 1-3 identities of 3) as PNG."""
    import io

    from PIL import Image

    from columbiaimagesearch_tpu_torch.models.face_synth import make_scene

    gray, _ = make_scene(seed, range(3 * seed, 3 * seed + 3))
    b = io.BytesIO()
    Image.fromarray(np.stack([gray.astype(np.uint8)] * 3, -1)).save(
        b, format="PNG")
    return b.getvalue()


def _assert_same_rows(got, want, what):
    """Per query, the same ids except swaps between rounding ties, and
    distances within LUT_RTOL/LUT_ATOL."""
    for q, ((rg, _), (rw, _)) in enumerate(zip(got, want)):
        dg = np.array([r.dist for r in rg])
        dw = np.array([r.dist for r in rw])
        np.testing.assert_allclose(dg, dw, rtol=LUT_RTOL, atol=LUT_ATOL)
        diff = np.array([r.id for r in rg]) != np.array([r.id for r in rw])
        if (np.abs(dg - dw)[diff] > 1e-4 * np.maximum(1, dw[diff])).any():
            raise AssertionError(f"{what} query {q}: ids differ beyond "
                                 "rounding ties")


def phase_face_probe(dev, card, index, cfg=None):
    """Probed search over the face index (the exhaustive phase's seeded
    model and rows, V=256): ``lut_build`` at the face shapes, waves on the
    default ladder (64, (128, 8), 256) and at a pinned probe_width=256 (the
    sort-free wide square path), its selection held to a plain sorted
    walk, the ms a wave at each rung, the wave memory model at rung 256,
    and natural escalation into rung 256 on a subset below the quota.
    Returns the numbers and the main path's ``lut_build`` launches."""
    from columbiaimagesearch_tpu_torch.index.lut import build_luts
    from columbiaimagesearch_tpu_torch.index.probe import (
        rung_cells,
        rung_parts,
    )
    from columbiaimagesearch_tpu_torch.index.query import (
        _ascending,
        _coarse_dists,
        lopq_query_orig,
    )
    from columbiaimagesearch_tpu_torch.index.searcher import (
        LOPQSearcherTorch,
        _query_geometry,
    )

    cfg = dict(FACE_PHASE, **(cfg or {}))
    model, coarse, fine = index["model"], index["coarse"], index["fine"]
    V, nq, q, lim = model.V, cfg["wave"], cfg["quota"], cfg["limit"]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    waves = [mixture(nq, index["comp"], index["g"])
             for _ in range(cfg["waves"])]
    out = {}

    # lut_build at the face probed shapes: the face model's tables and the
    # probe lists (B=64) of a real wave
    Dh = int(model.Cs.shape[2])
    x2 = waves[0].reshape(nq, 2, Dh)
    isel = torch.stack([_ascending(_coarse_dists(x2[:, h], model.Cs[h]),
                                   64)[1] for h in range(2)], 1)
    isel = isel.to(torch.int32)
    for n in (1, nq):
        args = (x2[:n].contiguous(), isel[:n].contiguous(), model.Cs,
                model.Rs, model.mus, model.subs)
        out[f"lut NQ={n}"] = _lut_check(
            f"face probed NQ={n}", lambda a=args: build_luts(*a), args, card)

    t0 = time.perf_counter()
    s = LOPQSearcherTorch(model, capacity_hint=len(coarse))
    s.add_codes((coarse, fine))
    nb = s.get_nb_indexed()
    sync()
    log(f"face probe: LOPQSearcherTorch over {nb} face rows (V={V}, no "
        f"feature store) in {time.perf_counter() - t0:.1f}s; ladder "
        f"{s._probe_ladder()}")
    build_luts.launches = 0                     # counts this path only
    t0 = time.perf_counter()
    ladder_res = [s.search_batch(w, quota=q, limit=lim, with_dists=True,
                                 with_codes=False) for w in waves]
    ladder_log = list(s.probe_stats.get("wave_log", []))
    s.probe_width = 256
    pinned_res = [s.search_batch(w, quota=q, limit=lim, with_dists=True,
                                 with_codes=False) for w in waves]
    s.probe_width = None
    sync()
    launches = build_luts.launches
    log(f"face probe: {cfg['waves']} waves x {nq} on the default ladder "
        f"(wave_log {ladder_log}) and {cfg['waves']} at probe_width=256 in "
        f"{time.perf_counter() - t0:.2f}s; lut_build launches={launches}")
    for i, res in enumerate(ladder_res + pinned_res):
        _check_results(res, lim, f"face wave {i}")
    wide_selection_check(s, waves[0][:cfg["check"]], q, 256, f"face V={V}")

    d = s._dev
    tables = (d["Cs"], d["Rs"], d["mus"], d["subs"], d["codes"],
              d["cell_start"], d["order"])
    _K, Q, K_stage, _R, _ = _query_geometry(q, lim, nb, None)
    for rung in s._probe_ladder():
        B, SB = rung_parts(rung)
        it = iter(waves * 3)
        ms = float(np.median(time_ms(lambda: lopq_query_orig(
            next(it), *tables, q, V=V, B=B, Q=Q, K=K_stage, SB=SB), 5)))
        out[f"rung {rung} ms/wave"] = ms
        log(f"face probe: rung {rung} (G={rung_cells(rung, V)} cells): "
            f"p50 {ms:.3f} ms a {nq}-query wave, {ms / nq:.4f} ms/query "
            f"(CUDA events, Q={Q}) [{card}]")
    out["memory"] = wave_memory(dev, s, waves[0], 256, None, q, lim,
                                f"face V={V}", card)
    del s

    # Natural escalation: below the quota, a query stays on (128, 8) only
    # if every row lies in its region, so the ladder must climb to 256.
    sub = cfg["subset"]
    ss = LOPQSearcherTorch(model)
    ss.add_codes((coarse[:sub], fine[:sub]))
    calls = []
    chunk = ss._chunk_waves

    def recording(run_tier, cap):
        inner = chunk(run_tier, cap)

        def run(idx, rung):
            calls.append((rung, np.asarray(idx).copy()))
            return inner(idx, rung)
        return run
    ss._chunk_waves = recording
    Xe = waves[1]
    natural = ss.search_batch(Xe, quota=q, limit=lim, with_dists=True,
                              with_codes=False)
    reached = {rung: idx for rung, idx in calls}
    shares = {str(r): round(len(reached.get(r, ())) / nq, 3)
              for r in ss._probe_ladder()}
    log(f"face escalation: {sub} rows (quota {q}), one {nq}-query wave on "
        f"the default ladder: share of queries reaching each rung {shares}; "
        f"probe_stats {ss.probe_stats}")
    top = reached.get(256)
    if top is None or not len(top):
        raise AssertionError("face escalation: no query reached rung 256")
    ss.probe_width = 256
    pinned = ss.search_batch(Xe, quota=q, limit=lim, with_dists=True,
                             with_codes=False)
    _assert_same_rows([natural[i] for i in top], [pinned[i] for i in top],
                      "face escalation vs pinned 256")
    out["escalation shares"] = shares
    log(f"face escalation: the {len(top)} queries that reached rung 256 "
        f"answer as the pinned-256 wave does ({lim} ids each)")
    return out, launches


def phase_face_models(dev, card, cfg=None):
    """The detector and the embedder on the card against the CPU: the same
    boxes (scores within DET_SCORE_ATOL) on ``det_scenes`` face_synth
    scenes, with each image's time split into the host pyramid, the
    device work (upload, HOG, score convolution, download) and the host
    collection (threshold, NMS); FaceResNet's card forward against the CPU
    forward on the same weights and chips (EMBED_RTOL/EMBED_ATOL), and
    its ms at ``embed_waves``."""
    import io

    from PIL import Image

    from columbiaimagesearch_tpu_torch.models.face import (
        FaceEmbedder,
        extract_chip,
        init_params,
    )
    from columbiaimagesearch_tpu_torch.models.face_detector import (
        ConvHOGFaceDetector,
    )

    cfg = dict(FACE_PHASE, **(cfg or {}))
    imgs = [np.asarray(Image.open(io.BytesIO(face_scene_png(1000 + i)))
                       .convert("RGB")) for i in range(cfg["det_scenes"])]
    det = ConvHOGFaceDetector(device=dev)
    cpu = ConvHOGFaceDetector(device="cpu")
    det.run(imgs[0])                            # library workspaces
    t_pyr, t_dev, t_col, boxes_all, worst = [], [], [], [], 0.0
    for img in imgs:
        t0 = time.perf_counter()
        levels = det.pyramid(img)
        t1 = time.perf_counter()
        smaps = det.score_maps(levels)
        t2 = time.perf_counter()
        boxes, scores = det.collect(levels, smaps)
        t3 = time.perf_counter()
        t_pyr.append((t1 - t0) * 1e3)
        t_dev.append((t2 - t1) * 1e3)
        t_col.append((t3 - t2) * 1e3)
        wb, ws = cpu.run(img)
        if not np.array_equal(np.asarray(boxes), np.asarray(wb)):
            raise AssertionError("face detector: card and CPU boxes differ")
        if len(scores):
            worst = max(worst, float(np.abs(scores - ws).max()))
        boxes_all.append(det.detect_from_img(img))
    if worst > DET_SCORE_ATOL:
        raise AssertionError(f"face detector: scores differ by {worst}")
    n_boxes = sum(len(b) for b in boxes_all)
    log(f"face detector: {len(imgs)} scenes 480x640 (upsampled x2, "
        f"{len(levels)} pyramid levels): {n_boxes} boxes, equal on the card "
        f"and the CPU, max score err {worst:.3e} (atol {DET_SCORE_ATOL}); "
        f"ms an image p50: host pyramid {np.median(t_pyr):.2f}, device "
        f"(upload, HOG, score conv, download) {np.median(t_dev):.2f}, host "
        f"threshold+NMS {np.median(t_col):.2f} (host clock) [{card}]")
    if not n_boxes:
        raise AssertionError("face detector: no face found")

    sd = init_params(seed=cfg["seed"])
    emb = FaceEmbedder(params=sd, device=dev)
    chips = np.stack([extract_chip(img, b) for img, bs in zip(imgs, boxes_all)
                      for b in bs])
    n_max = max(cfg["embed_waves"])
    chips = np.resize(chips, (n_max,) + chips.shape[1:])
    got = emb.featurize_chips(chips)
    want = FaceEmbedder(params=sd, device="cpu").featurize_chips(chips)
    err = float(np.abs(got - want).max())
    log(f"face embedder: FaceResNet on {len(chips)} detected chips, card vs "
        f"CPU forward on the same weights: max_abs_err={err:.3e} max |emb|="
        f"{np.abs(want).max():.3e} (rtol {EMBED_RTOL}, atol {EMBED_ATOL})")
    np.testing.assert_allclose(got, want, rtol=EMBED_RTOL, atol=EMBED_ATOL)
    out = dict(detector=dict(pyramid=float(np.median(t_pyr)),
                             device=float(np.median(t_dev)),
                             collect=float(np.median(t_col))))
    x = torch.from_numpy(chips.astype(np.float32)).to(dev)
    for n in cfg["embed_waves"]:
        ms = float(np.median(time_ms(lambda: emb.embed(x[:n]), 10,
                                     warmup=2)))
        out[f"embed n={n}"] = ms
        log(f"face embedder: forward fp32 n={n} (normalize, 29 convs, fc): "
            f"{ms:.4f} ms/wave, {ms / n:.4f} ms/chip (CUDA events, p50 of "
            f"10) [{card}]")
    return out


def _check_face_reply(reply, sha1, what):
    """No error; every detected face of the query image finds itself (the
    same sha1 and box) first. Returns the number of faces."""
    if "error" in reply or "Errors" in reply:
        raise AssertionError(f"{what}: error in the response: {reply}")
    for entry in reply["AllSimilarFaces"]:
        block = entry["SimilarFaces"]
        box = {k: entry["QueryFace"][k]
               for k in ("left", "top", "right", "bottom")}
        if (entry["QuerySha1"] != sha1 or not block["ImageSha1s"]
                or block["ImageSha1s"][0] != sha1
                or block["Faces"][0] != box):
            raise AssertionError(f"{what}: face {box} of {sha1} came back "
                                 f"first as {block['ImageSha1s'][:1]} "
                                 f"{block['Faces'][:1]}")
    return len(reply["AllSimilarFaces"])


def phase_face_serving(dev, card, index, cfg=None):
    """The face configuration (conf/conf_search_face_local.json as shipped)
    served over HTTP: the face model in the storer, the facade from
    ``common.factory.build_searcher``, ``scenes`` face_synth scenes
    written as files and taken by the conf's checker and processor
    (``build_checker``, ``build_processor`` with the face keys, on the
    card), then ``load_codes``, then the face index's rows through ``add_codes`` (no sqlite rows: they
    keep their ADC distance in the host rerank); then
    ``byB64`` from 1 and from ``clients`` concurrent clients and one
    ``byPATH``. Returns the launch count and numbers."""
    import shutil
    import threading

    from columbiaimagesearch_tpu_torch.api.app import make_server
    from columbiaimagesearch_tpu_torch.common.factory import (
        build_checker,
        build_indexer,
        build_processor,
        build_searcher,
        build_storer,
    )
    from columbiaimagesearch_tpu_torch.extraction.detector import (
        FaceDetector,
    )
    from columbiaimagesearch_tpu_torch.extraction.extractor import (
        build_extr_str,
    )
    from columbiaimagesearch_tpu_torch.imgio.imgio import get_SHA1_from_data
    from columbiaimagesearch_tpu_torch.index.lut import build_luts
    from columbiaimagesearch_tpu_torch.models.face import FaceEmbedder

    cfg = dict(FACE_PHASE, **(cfg or {}))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    work = os.path.join(ROOT, "build", "face_serving")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t_phase = time.perf_counter()
    try:
        with open(os.path.join(ROOT, cfg["conf"])) as f:
            conf = json.load(f)
        conf["KVI_db_path"] = os.path.join(work, "cufacesearch.db")
        conf["ST_base_path"] = os.path.join(work, "storer")
        model = index["model"]
        V, M, S = model.V, model.M, model.subquantizer_clusters
        extr = build_extr_str("face", "face", "face")
        key = f"{extr}_lopq-subq{S}-V{V}-M{M}"
        build_storer(conf).save(key, model)
        t0 = time.perf_counter()
        facade = build_searcher(conf)
        sync()
        log(f"face serving: {cfg['conf']} -> build_searcher: model {key} "
            f"from the storer, facade in {time.perf_counter() - t0:.2f}s")
        if (facade.build_model_str() != key
                or not isinstance(facade.detector, FaceDetector)
                or not isinstance(facade.featurizer, FaceEmbedder)
                or facade.model.device != dev
                or facade.featurizer.device != dev
                or facade.detector.model.device != dev):
            raise AssertionError("face serving: the facade did not load the "
                                 "face stack onto the card")
        s = facade.searcher
        # The faces go in first. A cell's rows keep insertion order, and
        # a quota-crossing cell is clipped at Q candidate slots (the JAX
        # slot semantics): this index's cells hold up to 32,768 rows, and
        # bulk rows added first would fill the Q slots of the face cells.
        # The scenes go in as files through the ingest pipeline (the
        # checker and the processor built from the conf with the face
        # keys, extracting on the card), then load_codes.
        bufs = [face_scene_png(2000 + i) for i in range(cfg["scenes"])]
        sha1s = [get_SHA1_from_data(b) for b in bufs]
        scenes = os.path.join(work, "scenes")
        os.makedirs(scenes)
        for i, b in enumerate(bufs):
            with open(os.path.join(scenes, f"scene_{i:03d}.png"), "wb") as f:
                f.write(b)
        conf.update({f"{p}_{k}": "face" for p in ("EXTR", "CHECK")
                     for k in ("featurizer_type", "detector_type",
                               "input_type")})
        conf["CHECK_input_dir"] = scenes
        t0 = time.perf_counter()
        kv = build_indexer(conf)
        created = build_checker(conf, indexer=kv).run_once()
        processor = build_processor(conf, indexer=kv, device=dev)
        processed = processor.run_once()
        extract_s = time.perf_counter() - t0
        rows = dict(kv.get_rows_by_batch(sha1s, kv.table_sha1infos_name))
        prefix = f"ext:{extr}_"
        n_faces = sum(k.startswith(prefix) and not k.endswith(
            ("_processed", "_updateid", "_failed"))
            for c in rows.values() for k in c)
        if (len(created) != 1 or processed != created
                or processor.extractor.featurizer.device != dev
                or any(c.get(f"ext:{extr}_processed") != b"1"
                       for c in rows.values()) or len(rows) != len(bufs)):
            raise AssertionError("face serving: the checker and processor "
                                 "did not extract every scene on the card")
        added = facade.load_codes()
        log(f"face serving: build_checker + build_processor over "
            f"{len(bufs)} scene files ({n_faces} faces, update "
            f"{created[0].rsplit('-', 2)[0]}) in {extract_s:.2f}s -> "
            f"load_codes added {added}")
        t0 = time.perf_counter()
        s.add_codes((index["coarse"], index["fine"]))
        nb2 = s.get_nb_indexed()
        sync()
        log(f"face serving: {len(index['coarse'])} index rows through "
            f"add_codes in {time.perf_counter() - t0:.1f}s; nb_indexed={nb2}")
        if added != n_faces or nb2 != len(index["coarse"]) + n_faces:
            raise AssertionError("face serving: the refresh did not index "
                                 "the detected faces")
        forms = [_form(base64.b64encode(b).decode()) for b in bufs]
        scene0 = os.path.join(scenes, "scene_000.png")

        server = make_server(facade, port=0, host="127.0.0.1")
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        build_luts.launches = 0                 # counts this path only
        faces_checked = 0
        try:
            first_ms, reply = _post(port, "byB64", forms[0])
            faces_checked += _check_face_reply(reply, sha1s[0], "first")
            single, server_ms = [], []
            for i in range(cfg["single"]):
                j = (i + 1) % len(bufs)
                ms, reply = _post(port, "byB64", forms[j])
                faces_checked += _check_face_reply(reply, sha1s[j],
                                                   f"1-client request {i}")
                single.append(ms)
                server_ms.append(reply["Timing"] * 1e3)
            conc, n_c = [], cfg["clients"]
            for r in range(cfg["rounds"]):
                res, srv, errs = [None] * n_c, [None] * n_c, []
                gate = threading.Event()

                def client(i, r=r):
                    gate.wait()
                    j = (r * n_c + i) % len(bufs)
                    try:
                        ms, reply = _post(port, "byB64", forms[j])
                        n = _check_face_reply(reply, sha1s[j], f"client {i}")
                        res[i], srv[i] = (ms, n), reply["Timing"] * 1e3
                    except Exception as inst:  # noqa: BLE001 — reported
                        errs.append(inst)
                ts = [threading.Thread(target=client, args=(i,))
                      for i in range(n_c)]
                for t in ts:
                    t.start()
                gate.set()
                for t in ts:
                    t.join(timeout=600)
                if errs or any(t.is_alive() for t in ts):
                    raise AssertionError(f"face serving: {n_c}-client round "
                                         f"{r}: {errs[:3]}")
                conc.extend(ms for ms, _ in res)
                faces_checked += sum(n for _, n in res)
                server_ms.extend(srv)
            path_ms, reply = _post(port, "byPATH", _form(scene0))
            faces_checked += _check_face_reply(reply, sha1s[0], "byPATH")
            sync()
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        launches = build_luts.launches
        log(f"face serving: HTTP byB64 latency, 1 client: first "
            f"{first_ms:.2f} ms, p50 {np.percentile(single, 50):.2f} ms p99 "
            f"{np.percentile(single, 99):.2f} ms ({len(single)} requests); "
            f"{n_c} clients: p50 {np.percentile(conc, 50):.2f} ms p99 "
            f"{np.percentile(conc, 99):.2f} ms ({len(conc)} requests in "
            f"{cfg['rounds']} rounds); reply Timing p50 "
            f"{np.percentile(server_ms, 50):.2f} ms; byPATH {path_ms:.2f} ms; "
            f"{faces_checked} query faces each found themselves first "
            f"[{card}]")
        log(f"face serving: probe_stats waves={s.probe_stats['waves']} "
            f"escalated={s.probe_stats['escalated_queries']} wave_log="
            f"{s.probe_stats.get('wave_log', [])[-6:]}; lut_build launches "
            f"{launches}")
        if launches <= 0:
            raise AssertionError("face serving: lut_build never launched")
        if not faces_checked:
            raise AssertionError("face serving: no query face was checked")

        # One coalesced face wave (every face of every request) against
        # sequential search_from_feats; then where a request's time goes.
        reqs, prep_ms = [], []
        for j in range(cfg["parity"]):
            t0 = time.perf_counter()
            reqs.append(facade._prepare_request(
                [base64.b64encode(bufs[j]).decode()],
                facade.detector.detect_from_b64, {}, False))
            prep_ms.append((time.perf_counter() - t0) * 1e3)
        items = [(r["dets"], r["feats"], r["options"]) for r in reqs]
        t0 = time.perf_counter()
        multi = facade.search_from_feats_multi(items)
        multi_ms = (time.perf_counter() - t0) * 1e3
        seq_ms = []
        for (dets, feats, opts), got in zip(items, multi):
            t0 = time.perf_counter()
            want = facade.search_from_feats(dets, feats, dict(opts))
            seq_ms.append((time.perf_counter() - t0) * 1e3)
            for g_, w_ in zip(got["AllSimilarFaces"], want["AllSimilarFaces"]):
                gb, wb = g_["SimilarFaces"], w_["SimilarFaces"]
                if (gb["ImageSha1s"] != wb["ImageSha1s"]
                        or gb["Faces"] != wb["Faces"]):
                    raise AssertionError("face serving: the coalesced wave "
                                         "differs from search_from_feats")
                np.testing.assert_allclose(gb["Distances"], wb["Distances"],
                                           rtol=LUT_RTOL, atol=LUT_ATOL)
        n_q = sum(len(r["feats"][0]) for r in reqs)
        log(f"face serving: a coalesced wave of {len(reqs)} requests ({n_q} "
            f"faces) equals sequential search_from_feats; per request p50: "
            f"prepare (decode, detect, embed) {np.median(prep_ms):.2f} ms, "
            f"search_from_feats (waves, host rerank, assembly) "
            f"{np.median(seq_ms):.2f} ms; the coalesced wave {multi_ms:.2f} "
            f"ms (host clock) [{card}]")
        dets, feats, opts = items[0]
        for line in host_profile(lambda: facade.search_from_feats(
                dets, feats, dict(opts)), sync):
            log(f"face serving: one request's search_from_feats, host {line}")
        log(f"face serving: checks passed; phase "
            f"{time.perf_counter() - t_phase:.1f}s")
        return dict(launches=launches, single=single, conc=conc,
                    server_ms=server_ms, prep_ms=prep_ms, seq_ms=seq_ms)
    finally:
        shutil.rmtree(work, ignore_errors=True)


#: wide-V mode at the headline's rows: a V=8192 model derived from the
#: trained release model (each coarse centroid split into itself and one
#: seeded index row of its cluster, refined by ``lloyd_steps``
#: ``dp_lloyd_step``s over ``lloyd_rows`` index rows; children keep their
#: parent's rotation and mean), waves of ``wave`` on the ladder and one
#: pinned to rung ``probe`` (the LUT route), then the dense [V^2+1] table
#: built once from the same sorted rows, against which the sorted square
#: ``probe``, the strip rung ``strip`` and the sort-free wide square
#: ``wide_rung`` must return equal rows and distances
WIDE = dict(V=8192, lloyd_rows=2_000_000, lloyd_steps=3, probe=64,
            strip=(256, 16), wide_rung=256, seed=0)
#: model I/O: the release model and the face model through .mat (and the
#: face model through proto where protobuf imports); a ``rows``-row face
#: searcher and one wave of ``wave`` queries on each side
MODEL_IO = dict(rows=262_144, wave=100, seed=0)
#: the device JPEG decode: ``photos`` synthimg renders at h x w, encoded by
#: PIL with 4:2:0 subsampling at the qualities in turn; ``baseline``,
#: ``progressive`` and ``restart`` of them; plus minority-size JPEGs, a
#: 4:4:4 and a grayscale JPEG, a PNG and two truncated JPEGs (mid-scan,
#: after SOS), spread over the waves; reconstruction timed at ``wave``
DECODE = dict(photos=512, h=480, w=640, baseline=256, progressive=128,
              restart=128, qualities=(75, 90), minority=4, wave=256, seed=0)
#: the reconstruction's bounds against PIL's full decode and the host
#: Lanczos resize (tests/test_jpeg_device.py:100-117) and the fc7 cosine
#: of the two routes (:145-180)
DECODE_MEAN, DECODE_P99, DECODE_COS = 3.0, 12.0, 0.995
#: face training: the detector template from the crops of
#: ``train_face_template.synth_training_set`` (``identities`` x 7
#: jittered ``face_synth`` head crops, hard negatives and 12 crops of each
#: face-free scene, from ``RandomState(seed)``), ``steps`` steps on the card
#: and on the CPU (templates within rtol 1e-3, atol 1e-5), checked on
#: ``heldout_scenes`` scenes of held-out identities; the 68-point landmark
#: net ``lm_steps`` Adam steps on ``lm_ids`` identities x 3 crops, held to
#: tests/test_face_align68.py:81-91 (loss < 5e-3, held-out error < 0.06)
FACE_TRAIN = dict(identities=57, steps=300, heldout_scenes=8, lm_ids=40,
                  lm_steps=400, seed=0)
FACE_TRAIN_RTOL, FACE_TRAIN_ATOL = 1e-3, 1e-5
LANDMARK_LOSS, LANDMARK_ERR = 5e-3, 0.06


def _derive_wide_model(dev, s, nb, cfg):
    """The V=8192 model of WIDE from the trained V=4096 tables of the
    searcher ``s`` and its index rows. Returns (model, seconds, inertias)."""
    from columbiaimagesearch_tpu_torch.index.model import LOPQModel
    from columbiaimagesearch_tpu_torch.parallel import dp_lloyd_step

    m = s.model
    V = m.V
    feats = s._dev["feats"][:nb]
    cells = torch.from_numpy(s._cells[:nb]).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(cfg["seed"] + 41)
    perm = torch.randperm(nb, generator=g, device=dev)
    Dh = int(m.Cs.shape[2])
    n_l = min(cfg["lloyd_rows"], nb)
    t0 = time.perf_counter()
    Cs, inertias = [], []
    for h in range(2):
        own = (cells // V) if h == 0 else (cells % V)
        # The first row of each cluster in a seeded order: a seeded index
        # row of the cluster (an empty cluster keeps a copy of its parent).
        first = torch.full((V,), nb, dtype=torch.int64, device=dev)
        first.scatter_reduce_(0, own[perm], torch.arange(nb, device=dev),
                              reduce="amin")
        child = m.Cs[h].clone()
        has = first < nb
        child[has] = feats[perm[first[has]], h * Dh:(h + 1) * Dh]
        C = torch.cat([m.Cs[h], child])
        X = feats[perm[:n_l], h * Dh:(h + 1) * Dh]
        w = torch.ones(n_l, device=dev)
        for _ in range(cfg["lloyd_steps"]):
            C, inertia = dp_lloyd_step(X, w, C, 2 * V)
            inertias.append(float(inertia) / n_l)
        Cs.append(C)
        del X, w
    parent = torch.cat([torch.arange(V, device=dev)] * 2)
    model = LOPQModel(torch.stack(Cs), m.Rs[:, parent], m.mus[:, parent],
                      m.subs, device=dev)
    torch.cuda.synchronize() if dev.type == "cuda" else None
    return model, time.perf_counter() - t0, inertias


def phase_wide(dev, cfg, state, card):
    """Wide-V mode (V >= 8192: no dense offsets table) on the headline's
    rows (see WIDE). Returns (numbers, ``lut_build`` launches on the wide
    path)."""
    from columbiaimagesearch_tpu_torch.index import query as qmod
    from columbiaimagesearch_tpu_torch.index.csr import _offsets
    from columbiaimagesearch_tpu_torch.index.encode import lopq_encode
    from columbiaimagesearch_tpu_torch.index.lut import (
        build_luts,
        build_luts_plain,
    )
    from columbiaimagesearch_tpu_torch.index.probe import rung_parts
    from columbiaimagesearch_tpu_torch.index.query import lopq_query_orig
    from columbiaimagesearch_tpu_torch.index.searcher import LOPQSearcherTorch

    c = WIDE
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    s = state["searcher"]
    nb = s.get_nb_indexed()
    feats = s._dev["feats"][:nb]
    model, derive_s, inertias = _derive_wide_model(dev, s, nb, c)
    V = model.V
    if V != c["V"] or V < LOPQSearcherTorch.WIDE_V_THRESHOLD:
        raise AssertionError(f"wide: derived V={V}")
    log(f"wide: V={V} model from the trained V={s.model.V} tables (each "
        f"centroid split into itself and a seeded row of its cluster, "
        f"{c['lloyd_steps']} dp_lloyd_step(s) a half on "
        f"{min(c['lloyd_rows'], nb)} index rows: mean inertia "
        f"{[round(x, 5) for x in inertias]}) in {derive_s:.2f}s [{card}]")
    t0 = time.perf_counter()
    coarse, fine = lopq_encode(model.Cs, model.Rs, model.mus, model.subs,
                               feats, chunk=8192)
    sync()
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ws = LOPQSearcherTorch(model, capacity_hint=nb)
    ws.add_codes((coarse.cpu().numpy(), fine.to(torch.uint8).cpu().numpy()),
                 feats=feats)
    del coarse, fine
    n = ws.get_nb_indexed()
    sync()
    build_s = time.perf_counter() - t0
    d = ws._dev
    if n != nb or d["cell_start"] is not None:
        raise AssertionError(f"wide: indexed {n} of {nb} rows, cell_start "
                             f"{type(d['cell_start'])} (want None)")
    log(f"wide: lopq_encode {nb} rows at V={V} in {encode_s:.2f}s; "
        f"LOPQSearcherTorch (wide-V mode, no dense table) indexed them in "
        f"{build_s:.2f}s; occupied cells={d['n_occ']} [{card}]")

    waves = state["waves"]
    q, lim = cfg["quota"], cfg["limit"]
    kw = dict(quota=q, limit=lim, with_dists=True, with_codes=False)
    build_luts.launches = 0                    # counts the wide path only
    ladder_ms = []
    for w in waves:
        t0 = time.perf_counter()
        res = ws.search_batch(w, **kw)
        sync()
        ladder_ms.append((time.perf_counter() - t0) * 1e3)
        _check_results(res, lim, "wide ladder wave")
    ws.probe_width = c["probe"]                 # pin the LUT rung
    before = build_luts.launches
    t0 = time.perf_counter()
    pinned = ws.search_batch(waves[0], **kw)
    sync()
    pinned_ms = (time.perf_counter() - t0) * 1e3
    pin_launches = build_luts.launches - before
    with mock.patch.object(qmod, "build_luts", build_luts_plain):
        plain = ws.search_batch(waves[0], **kw)
    ws.probe_width = None
    lut_err, swaps = _same_ids_but_ties(pinned, plain, SHARDED_DIST_ATOL,
                                        "wide pinned LUT wave vs plain")
    launches = build_luts.launches
    if pin_launches <= 0:
        raise AssertionError("wide: the pinned wave launched no lut_build")
    log(f"wide: {len(waves)} waves of {waves[0].shape[0]} on the ladder "
        f"{[round(x, 2) for x in ladder_ms]} ms (wave_log "
        f"{ws.probe_stats.get('wave_log', [])[-3:]}); a wave pinned to rung "
        f"{c['probe']} {pinned_ms:.2f} ms, {pin_launches} lut_build "
        f"launch(es), equal to its plain LUT replay but {swaps} rounding-tie "
        f"swaps (max_abs_dist_err={lut_err:.3e}) [{card}]")

    # The dense table from the same sorted rows: equal results at each
    # rung kind, since only the bucket bounds' source differs.
    t0 = time.perf_counter()
    dense = _offsets(d["cells_sorted"], V)
    sync()
    dense_s = time.perf_counter() - t0
    n_occ = int((dense[1:] > dense[:-1]).sum())
    if n_occ != d["n_occ"]:
        raise AssertionError(f"wide: n_occ {d['n_occ']} vs dense {n_occ}")
    Q, K = _geometry(ws, cfg)
    tabs = (d["Cs"], d["Rs"], d["mus"], d["subs"], d["codes"])
    X = waves[1]
    rung_ms = {}
    for rung in (c["probe"], c["strip"], c["wide_rung"]):
        B, SB = rung_parts(rung)
        args = dict(V=V, B=B, Q=Q, K=K, SB=SB)

        def run_dense():
            return lopq_query_orig(X, *tabs, dense, d["order"], q, **args)

        def run_wide():
            return lopq_query_orig(X, *tabs, None, d["order"], q,
                                   cells_sorted=d["cells_sorted"], **args)

        a, b = run_dense(), run_wide()
        for name, x, y in zip(("rows", "dists", "total", "n_cells",
                               "grid_ok"), a, b):
            if not torch.equal(x, y):
                raise AssertionError(f"wide: rung {rung}: {name} differ "
                                     f"from the dense table's")
        if dev.type == "cuda":
            rung_ms[str(rung)] = dict(
                wide=float(np.median(time_ms(run_wide, 3))),
                dense=float(np.median(time_ms(run_dense, 3))))
        log(f"wide: rung {rung} (Q={Q}, K={K}): rows, distances, totals, "
            f"cells and grid_ok equal to the dense [V^2+1] table's; ms a "
            f"wave of {X.shape[0]} {rung_ms.get(str(rung))} [{card}]")
    nbytes = lambda t: t.numel() * t.element_size()
    common = nbytes(d["codes"]) + nbytes(d["order"])
    resident = dict(wide=common + nbytes(d["cells_sorted"]),
                    dense=common + nbytes(dense))
    log(f"wide: resident index bytes (codes + order + bucket bounds) wide "
        f"{resident['wide']} vs dense {resident['dense']} (the [V^2+1] "
        f"table alone {nbytes(dense)}, built in {dense_s * 1e3:.2f} ms); "
        f"n_occ {n_occ} equal")
    out = dict(V=V, rows=nb, derive_s=derive_s, encode_s=encode_s,
               build_s=build_s, ladder_ms=ladder_ms, pinned_ms=pinned_ms,
               rung_ms=rung_ms, resident_bytes=resident, n_occ=n_occ,
               lut_launches=launches, lut_max_abs=lut_err, tie_swaps=swaps)
    del ws, dense, model
    return out, launches


def phase_model_io(dev, card, trained, state, cfg=None):
    """The release model and the face model through ``export_mat`` /
    ``load_mat`` (and the face model through proto where protobuf
    imports): tables bit-equal, one wave of identical ids and distances
    on each side (see MODEL_IO)."""
    import shutil

    from columbiaimagesearch_tpu_torch.index.model import LOPQModel
    from columbiaimagesearch_tpu_torch.index.query import lopq_query_orig
    from columbiaimagesearch_tpu_torch.index.searcher import LOPQSearcherTorch

    cfg = dict(MODEL_IO, **(cfg or {}))
    work = os.path.join(ROOT, "build", "model_io")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = {}

    def same_tables(a, b, what):
        for t in ("Cs", "Rs", "mus", "subs"):
            if not torch.equal(getattr(a, t), getattr(b, t).to(
                    getattr(a, t).device)):
                raise AssertionError(f"model_io: {what}: {t} differs")

    def mat_round_trip(model, name):
        path = os.path.join(work, f"{name}.mat")
        t0 = time.perf_counter()
        model.export_mat(path)
        t1 = time.perf_counter()
        back = LOPQModel.load_mat(path, device=dev)
        t2 = time.perf_counter()
        same_tables(model, back, f"{name} .mat")
        out[name] = dict(mat_bytes=os.path.getsize(path),
                         export_s=t1 - t0, load_s=t2 - t1)
        return back

    # The release model (a PCA model writes its LOPQ tables only) against
    # the main path's index: one wave through each table set.
    rel = mat_round_trip(trained["release"], "release")
    s = state["searcher"]
    d = s._dev
    Q, K = _geometry(s, HEADLINE)
    X = state["waves"][0]
    geo = dict(V=rel.V, B=HEADLINE["B"], Q=Q, K=K)
    a = lopq_query_orig(X, d["Cs"], d["Rs"], d["mus"], d["subs"], d["codes"],
                        d["cell_start"], d["order"], HEADLINE["quota"], **geo)
    b = lopq_query_orig(X, rel.Cs, rel.Rs, rel.mus, rel.subs, d["codes"],
                        d["cell_start"], d["order"], HEADLINE["quota"], **geo)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("model_io: the reloaded release model's wave "
                             "differs")
    del rel

    # The face model: .mat, proto, and a searcher on each.
    face = trained["face"]["model"]
    fmat = mat_round_trip(face, "face")
    try:
        ppath = os.path.join(work, "face.pb")
        t0 = time.perf_counter()
        face.export_proto(ppath)
        fproto = LOPQModel.load_proto(ppath, device=dev)
        same_tables(face, fproto, "face proto")
        again = os.path.join(work, "face2.pb")
        fproto.export_proto(again)
        with open(ppath, "rb") as f1, open(again, "rb") as f2:
            if f1.read() != f2.read():
                raise AssertionError("model_io: proto not byte-stable")
        out["face"]["proto"] = dict(bytes=os.path.getsize(ppath),
                                    s=time.perf_counter() - t0)
        proto_case = "protobuf imports: the face model round-trips"
    except ImportError as e:
        if "protobuf" not in str(e):
            raise
        fproto = None
        out["face"]["proto"] = "raises ImportError naming protobuf"
        proto_case = f"protobuf is not installed: export_proto raises ({e})"
    g = torch.Generator(device=dev)
    g.manual_seed(cfg["seed"] + 43)
    rows = mixture(cfg["rows"], trained["face"]["comp"], g)
    queries = mixture(cfg["wave"], trained["face"]["comp"], g)
    kw = dict(quota=1000, limit=10, with_dists=True, with_codes=False)
    want = None
    for what, m in (("trained", face), ("from .mat", fmat),
                    ("from proto", fproto)):
        if m is None:
            continue
        fs = LOPQSearcherTorch(m)
        fs.add_data(rows)
        got = [[(r.id, r.dist) for r in res]
               for res, _ in fs.search_batch(queries, **kw)]
        if want is None:
            want = got
        elif got != want:
            raise AssertionError(f"model_io: the face model {what} answers "
                                 f"differently")
    log(f"model_io: release .mat {out['release']['mat_bytes']} B (export "
        f"{out['release']['export_s']:.2f}s, load {out['release']['load_s']:.2f}"
        f"s), tables bit-equal, a {X.shape[0]}-query wave at B="
        f"{HEADLINE['B']} identical; face .mat {out['face']['mat_bytes']} B, "
        f"tables bit-equal, a {cfg['wave']}-query wave on {cfg['rows']} rows "
        f"identical; proto: {proto_case} [{card}]")
    shutil.rmtree(work, ignore_errors=True)
    return out


def decode_corpus(dev, cfg):
    """The decode phase's files (see DECODE): (files [(name, bytes)] with
    the other files spread among the photos, the photos [n, h, w, 3]
    uint8, a note on the restart markers)."""
    import io

    from PIL import Image

    from columbiaimagesearch_tpu_torch.utils.synthimg import (
        make_render_batch,
    )

    g = torch.Generator(device=dev)
    g.manual_seed(cfg["seed"] + 47)
    h, w = cfg["h"], cfg["w"]
    render = make_render_batch(64, height=h, width=w, device=dev)
    photos = np.concatenate([render(g).cpu().numpy()
                             for _ in range(-(-cfg["photos"] // 64))])
    restart_note = "restart_marker_rows/_blocks"

    def enc(a, **kw):
        b = io.BytesIO()
        Image.fromarray(a).save(b, "JPEG", **kw)
        return b.getvalue()

    files = []
    qs = cfg["qualities"]
    for i in range(cfg["photos"]):
        kw = dict(quality=qs[i % len(qs)], subsampling=2)
        if i < cfg["baseline"]:
            kind = "baseline"
        elif i < cfg["baseline"] + cfg["progressive"]:
            kind, kw["progressive"] = "progressive", True
        else:
            kind = "restart"
            if i % 2:
                kw["restart_marker_rows"] = 1
            else:
                kw["restart_marker_blocks"] = 8
        try:
            data = enc(photos[i], **kw)
        except TypeError:            # a Pillow without restart markers
            kw.pop("restart_marker_rows", None)
            kw.pop("restart_marker_blocks", None)
            restart_note = "none: this Pillow writes no restart markers"
            data = enc(photos[i], **kw)
        files.append((f"{kind}_{i}", data))
    extra = [(f"minority_{k}", enc(photos[k][:h * 3 // 4, :w * 3 // 4],
                                   quality=90))
             for k in range(cfg["minority"])]
    extra.append(("444", enc(photos[0], quality=90, subsampling=0)))
    extra.append(("gray", enc(photos[1][..., 0].copy(), quality=90)))
    b = io.BytesIO()
    Image.fromarray(photos[2]).save(b, "PNG")
    extra.append(("png", b.getvalue()))
    base = enc(photos[3], quality=90, subsampling=2)
    sos = base.index(b"\xff\xda")
    extra.append(("truncated_mid_scan", base[:(sos + len(base)) // 2]))
    extra.append(("truncated_after_sos",
                  base[:sos + 2 + ((base[sos + 2] << 8) | base[sos + 3])]))
    step = max(1, len(files) // (len(extra) + 1))
    for k, item in enumerate(extra):
        files.insert((k + 1) * step + k, item)
    return files, photos, restart_note


def phase_decode(dev, card, cfg=None):
    """The device JPEG decode (see DECODE): the reader against a header
    parse, the reconstruction against PIL's full decode and the host
    Lanczos resize, the featurizer's two routes against each other, and
    the route every dominant-size 4:2:0 JPEG takes."""
    import io

    from PIL import Image

    from columbiaimagesearch_tpu_torch.models.jpeg_device import (
        CoeffDecoder,
        pick_msub,
    )
    from columbiaimagesearch_tpu_torch.models.preprocess import resize_host
    from columbiaimagesearch_tpu_torch.models.sentibank import (
        SentibankFeaturizer,
        init_params,
    )
    from columbiaimagesearch_tpu_torch.native.imgpipe import (
        coeffs_available,
        coeffs_build_error,
        jpeg_dims,
        read_coeffs_batch,
    )

    cfg = dict(DECODE, **(cfg or {}))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if not coeffs_available():
        raise AssertionError(f"decode: the coefficient reader did not "
                             f"build: {coeffs_build_error()}")
    t0 = time.perf_counter()
    files, photos, restart_note = decode_corpus(dev, cfg)
    names = [n for n, _ in files]
    bufs = [b for _, b in files]
    h, w = cfg["h"], cfg["w"]
    photo_idx = [i for i, n in enumerate(names)
                 if n.split("_")[0] in ("baseline", "progressive",
                                        "restart")]
    others = [n for i, n in enumerate(names) if i not in set(photo_idx)]
    log(f"decode: {len(files)} files ({cfg['photos']} synthimg photos at "
        f"{h}x{w}, 4:2:0, quality {cfg['qualities']}: {cfg['baseline']} "
        f"baseline, {cfg['progressive']} progressive, {cfg['restart']} with "
        f"restart markers ({restart_note}); {len(others)} others {others})"
        f" made in {time.perf_counter() - t0:.2f}s")

    # The reader: status and dims against a header parse.
    msub = pick_msub(h, w)
    bh, bw = -(-h // 8), -(-w // 8)
    bh, bw = bh + (bh & 1), bw + (bw & 1)
    yc, cc, qt, dims, st = read_coeffs_batch(bufs, msub, bh, bw)
    for name, b, s_, d in zip(names, bufs, st, dims):
        hw = jpeg_dims(b)
        want = -3 if (hw is None or name in ("444", "gray")) else 0
        if s_ != want:
            raise AssertionError(f"decode: reader status {s_} for {name}, "
                                 f"want {want}")
        if want == 0 and list(d) != [hw[0], hw[1], -(-hw[0] // 8),
                                     -(-hw[1] // 8), -(-hw[0] // 16),
                                     -(-hw[1] // 16)]:
            raise AssertionError(f"decode: reader dims {list(d)} for {name}"
                                 f" against the header's {hw}")
    pb = [bufs[i] for i in photo_idx]
    reader_ms = {}
    for threads in (1, 0):
        t0 = time.perf_counter()
        read_coeffs_batch(pb, msub, bh, bw, n_threads=threads)
        reader_ms[threads or os.cpu_count()] = (
            (time.perf_counter() - t0) * 1e3 / len(pb))
    log(f"decode: the reader's statuses and dims equal a header parse on "
        f"all {len(files)} files; ms an image over the {len(pb)} photos "
        f"(msub={msub}) by host threads: "
        f"{ {k: round(v, 3) for k, v in reader_ms.items()} } [{card}]")

    # The reconstruction against PIL's full decode + the host Lanczos.
    dec = CoeffDecoder(dev)
    ok = photo_idx
    diffs, pil_s = [], 0.0
    worst_mean = 0.0
    for lo in range(0, len(ok), cfg["wave"]):
        idx = ok[lo:lo + cfg["wave"]]
        out = dec.decode(yc[idx], cc[idx], qt[idx], msub=msub, h=h,
                         w=w).cpu().numpy()
        for j, i in enumerate(idx):
            t0 = time.perf_counter()
            full = np.asarray(Image.open(io.BytesIO(bufs[i])).convert("RGB"))
            pil_s += time.perf_counter() - t0
            diff = np.abs(out[j] - resize_host(full).astype(np.float32))
            worst_mean = max(worst_mean, float(diff.mean()))
            diffs.append(diff.ravel()[::7])
    diffs = np.concatenate(diffs)
    mean, p99 = float(diffs.mean()), float(np.percentile(diffs, 99))
    if not (mean < DECODE_MEAN and p99 < DECODE_P99):
        raise AssertionError(f"decode: reconstruction vs PIL mean {mean}, "
                             f"p99 {p99}")
    wave = ok[:cfg["wave"]]
    dyc = torch.from_numpy(yc[wave]).to(dev)
    dcc = torch.from_numpy(cc[wave]).to(dev)
    dqt = torch.from_numpy(qt[wave].astype(np.int32)).to(dev)
    recon_ms = (float(np.median(time_ms(
        lambda: dec.decode(dyc, dcc, dqt, msub=msub, h=h, w=w), 5)))
        if dev.type == "cuda" else None)
    del dyc, dcc, dqt
    log(f"decode: device reconstruction vs PIL full decode + host Lanczos "
        f"over {len(ok)} photos: mean {mean:.4f} levels (< {DECODE_MEAN}; "
        f"worst image {worst_mean:.4f}), p99 {p99:.4f} (< {DECODE_P99}); "
        f"PIL decode {1e3 * pil_s / len(ok):.3f} ms an image; "
        f"reconstruction {recon_ms} ms a wave of {len(wave)} [{card}]")

    # The featurizer's two routes on the same weights.
    sd = init_params(seed=cfg["seed"])
    f_dev = SentibankFeaturizer(params=sd, device=dev, device_decode=True)
    f_pix = SentibankFeaturizer(params=sd, device=dev, device_decode=False)
    f_dev.featurize_buffers(bufs[:8])                 # warm both routes
    f_pix.featurize_buffers(bufs[:8])
    sync()
    before = dict(f_dev.route_counts)
    t0 = time.perf_counter()
    fd, st_d = f_dev.featurize_buffers(bufs)
    sync()
    dev_s = time.perf_counter() - t0
    routes = {k: f_dev.route_counts[k] - before[k] for k in before}
    t0 = time.perf_counter()
    fp, st_p = f_pix.featurize_buffers(bufs)
    sync()
    pix_s = time.perf_counter() - t0
    truncated = [i for i, n in enumerate(names) if n.startswith("trunc")]
    for i, (a, b) in enumerate(zip(st_d, st_p)):
        if i in truncated:
            # libjpeg fills a truncated scan with gray, and so does the
            # reader; PIL (the pixel route on a machine without libjpeg
            # headers) refuses the file.
            if int(a) != 0:
                raise AssertionError(f"decode: {names[i]} status {a}")
        elif int(a) != int(b):
            raise AssertionError(f"decode: {names[i]}: status {a} on the "
                                 f"coefficient route, {b} on the pixel")
    both = [i for i in range(len(bufs))
            if int(st_d[i]) == 0 and int(st_p[i]) == 0]
    a, b = fd[both], fp[both]
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                            * np.linalg.norm(b, axis=1))
    dominant = len(photo_idx) + len(truncated)
    if cos.min() <= DECODE_COS or routes["coeffs"] != dominant \
            or routes["coeffs"] <= 0:
        raise AssertionError(f"decode: fc7 cosine min {cos.min()}, routes "
                             f"{routes} (want {dominant} coefficient)")
    numbers = dict(
        files=len(files), photos=len(pb), msub=msub, restart=restart_note,
        reader_ms_per_image=reader_ms, recon_ms_per_wave=recon_ms,
        recon_wave=len(wave), pil_decode_ms=1e3 * pil_s / len(ok),
        recon_mean=mean, recon_p99=p99, cos_min=float(cos.min()),
        routes=routes, img_s=dict(coefficient=len(bufs) / dev_s,
                                  pixel=len(bufs) / pix_s),
        truncated_pixel_status=[int(st_p[i]) for i in truncated])
    log(f"decode: featurize_buffers on {len(bufs)} files: coefficient route "
        f"{numbers['img_s']['coefficient']:.1f} img/s, pixel route (PIL) "
        f"{numbers['img_s']['pixel']:.1f} img/s; routes {routes} (every "
        f"dominant-size 4:2:0 JPEG on the coefficient route); statuses "
        f"equal but the truncated JPEGs (0 here, pixel route "
        f"{numbers['truncated_pixel_status']}); fc7 cosine min "
        f"{numbers['cos_min']:.6f} (> {DECODE_COS}) [{card}]")
    return numbers


def phase_face_train(dev, card, cfg=None):
    """Face training on the card (see FACE_TRAIN): the detector template
    against the same training on the CPU and on held-out scenes, and the
    68-point landmark net against JAX's held-out bound."""
    from columbiaimagesearch_tpu_torch.models.face_align import (
        _params_to,
        init_landmark_params,
        make_landmark_training_set,
        predict_landmarks,
        train_landmark_net,
    )
    from columbiaimagesearch_tpu_torch.models.face_detector import (
        ConvHOGFaceDetector,
    )
    from columbiaimagesearch_tpu_torch.models.eval_face_detector import iou
    from columbiaimagesearch_tpu_torch.models.face_synth import make_scene
    from columbiaimagesearch_tpu_torch.models.train_face_template import (
        synth_training_set,
    )

    cfg = dict(FACE_TRAIN, **(cfg or {}))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    pos, neg = synth_training_set(cfg["identities"],
                                  np.random.RandomState(cfg["seed"]))
    set_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    det = ConvHOGFaceDetector(device=dev, threshold=0.0).train(
        pos, neg, steps=cfg["steps"])
    sync()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = ConvHOGFaceDetector(device="cpu", threshold=0.0).train(
        pos, neg, steps=cfg["steps"])
    cpu_s = time.perf_counter() - t0
    got = det.template.cpu().numpy()
    want = cpu.template.numpy()
    np.testing.assert_allclose(got, want, rtol=FACE_TRAIN_RTOL,
                               atol=FACE_TRAIN_ATOL)
    t_err = float(np.abs(got - want).max())

    found = total = 0
    for k in range(cfg["heldout_scenes"]):
        img, gt = make_scene(700 + k, range(300, 340))
        boxes = [(d["left"], d["top"], d["right"], d["bottom"])
                 for d in det.detect_from_img(img)]
        total += len(gt)
        found += sum(any(iou(g, b) >= 0.4 for b in boxes) for g in gt)
    if found != total:
        raise AssertionError(f"face_train: the card's template found "
                             f"{found} of {total} held-out faces")
    log(f"face_train: detector template from {len(pos)} positive and "
        f"{len(neg)} negative face_synth crops (made in {set_s:.2f}s), "
        f"{cfg['steps']} steps: card {card_s:.2f}s, CPU {cpu_s:.2f}s, "
        f"templates within {t_err:.2e} (rtol {FACE_TRAIN_RTOL}, atol "
        f"{FACE_TRAIN_ATOL}), bias {det.bias:.5f} vs {cpu.bias:.5f}; "
        f"{found} of {total} faces of {cfg['heldout_scenes']} held-out "
        f"scenes found (IoU >= 0.4) [{card}]")

    crops, targets = make_landmark_training_set(range(cfg["lm_ids"]),
                                                n_per_identity=3, seed=0)
    t0 = time.perf_counter()
    params, loss = train_landmark_net(init_landmark_params(0, n_points=68),
                                      crops, targets, steps=cfg["lm_steps"],
                                      device=dev)
    sync()
    lm_s = time.perf_counter() - t0
    ho_crops, ho_targets = make_landmark_training_set(
        range(200, 212), n_per_identity=2, seed=1)
    pred = predict_landmarks(_params_to(params, dev),
                             torch.from_numpy(ho_crops).to(dev),
                             n_points=68).cpu().numpy()
    err = float(np.abs(pred - ho_targets).mean())
    if not (loss < LANDMARK_LOSS and err < LANDMARK_ERR):
        raise AssertionError(f"face_train: landmark loss {loss}, held-out "
                             f"error {err}")
    log(f"face_train: 68-point landmark net, {cfg['lm_steps']} Adam steps "
        f"on {len(crops)} crops in {lm_s:.2f}s: loss {loss:.5f} (< "
        f"{LANDMARK_LOSS}), held-out error {err:.4f} (< {LANDMARK_ERR}) "
        f"[{card}]")
    return dict(detector=dict(pos=len(pos), neg=len(neg), card_s=card_s,
                              cpu_s=cpu_s, template_max_abs=t_err,
                              found=found, faces=total),
                landmarks=dict(crops=len(crops), steps=cfg["lm_steps"],
                               s=lm_s, loss=loss, heldout_err=err))


# ------------------------------------------------------- operator tools

#: the operator tools, each through its ``python -m`` module's
#: ``main``/``run`` on the card: ``build_index`` for ``face_conf`` from an
#: .fvecs of its nb_train rows of the face mixture, then ``face_queries``
#: queries answered from the storer's model and the code store equal to a
#: searcher fed ``predict_batch`` in memory; ``build_index --model-type
#: lopq_pca`` at the release shapes (TRAIN's ``conf``) from an .npy of
#: ``release_rows`` raw rows drawn as the training phase draws them (cut
#: from nb_train 2,000,000: 33 GB of .npy on the host, and the run's time),
#: its stage seconds printed and every stored code equal to the loaded
#: model's ``predict_batch`` of its row; ``eval_recall`` at its defaults
#: with --probe-widths 0,64 and --skip-exact, its fused rerank held to a
#: plain re-sort (exact float64 distances from the rows) of the probed
#: top-1000 at the pinned width ``rerank_width``, its exhaustive stage on a
#: V=``exact_V`` model of the same rows (at V=256 the 1,000,000 rows fill
#: all 65,536 cells and pad to 8,388,608 rows, past ExhaustiveADC's 8x
#: guard, in both packages) and ``replay`` of its queries through both
#: kernels' plain versions; ``eval_recall_realfeat`` at 20,000 rows and
#: V 256 (cut from 200,000 and 1,024: fc7 runs at ~1,300 img/s);
#: ``train_face_template --synth synth``, ``eval_face_detector`` on
#: ``scenes`` scenes (AP printed beside the committed ``ref_ap`` of
#: benchmarks/r04_face_detector_eval.json, not gated) and
#: ``drop_weights --dry-run``
TOOLS = dict(face_conf="conf/conf_search_face_local.json", face_queries=32,
             release_rows=262_144,
             recall_args=("--probe-widths", "0,64", "--skip-exact"),
             rerank_width=64, exact_V=128, replay=8,
             realfeat_args=("--n", "20000", "--V", "256"),
             synth=120, scenes=20, ref_ap=0.6997, seed=0,
             face_overrides={})


def build_and_load(dev, work, name, X, argv):
    """``X`` written under ``work`` (``name``'s suffix picks .npy or
    .fvecs), ``python -m ...index.build_index`` on it with ``argv``, and
    the model loaded back from its storer onto ``dev``. Returns (the
    build's result, the model, the file's write seconds)."""
    from columbiaimagesearch_tpu_torch.index import build_index
    from columbiaimagesearch_tpu_torch.store.storer import LocalStorer
    from columbiaimagesearch_tpu_torch.utils.xvecs import save_xvecs

    path = os.path.join(work, name)
    t0 = time.perf_counter()
    if name.endswith(".npy"):
        np.save(path, X)
    else:
        save_xvecs(X, path)
    write_s = time.perf_counter() - t0
    out = os.path.join(work, os.path.splitext(name)[0])
    res = build_index.main(["--features", path, "--out", out] + argv
                           + (["--cpu"] if dev.type == "cpu" else []))
    model = LocalStorer(os.path.join(out, "storer")).load(
        res["model_str"]).to(dev)
    return res, model, write_s


def tools_face_build(dev, card, work, cfg):
    """``build_index`` for the face conf from an .fvecs file; the offline
    index answers like one built in memory."""
    from columbiaimagesearch_tpu_torch.index.searcher import (
        LOPQSearcherTorch,
    )

    with open(os.path.join(ROOT, cfg["face_conf"])) as f:
        conf = dict(json.load(f), **cfg["face_overrides"])
    V, M = int(conf["SEARCHLOPQ_lopq_V"]), int(conf["SEARCHLOPQ_lopq_M"])
    S, n = int(conf["SEARCHLOPQ_lopq_subq"]), int(conf["SEARCHLOPQ_nb_train"])
    g = torch.Generator(device=dev)
    g.manual_seed(cfg["seed"] + 21)
    comp = torch.randn(256, FACE["D"], generator=g, device=dev)
    comp /= comp.norm(dim=1, keepdim=True)
    X = mixture(n, comp, g).cpu().numpy()
    Q = mixture(cfg["face_queries"], comp, g)
    res, model, write_s = build_and_load(dev, work, "face.fvecs", X, [
        "--model-type", "lopq", "--V", str(V), "--M", str(M), "--subq",
        str(S), "--nb-train", str(n), "--seed", str(cfg["seed"])])
    t0 = time.perf_counter()
    offline = LOPQSearcherTorch(model, codestore_path=res["codes"])
    nb = offline.get_nb_indexed()
    load_s = time.perf_counter() - t0
    mem = LOPQSearcherTorch(model)
    mem.add_codes(model.predict_batch(X), [str(i) for i in range(n)])
    kw = dict(quota=FACE_PHASE["quota"], limit=FACE_PHASE["limit"],
              with_dists=True, with_codes=False)
    got = offline.search_batch(Q, **kw)
    want = mem.search_batch(Q, **kw)
    offline._codestore.close()
    if nb != n:
        raise AssertionError(f"tools: the face build's code store holds {nb}"
                             f" rows, not {n}")
    for i, ((a, _), (b, _)) in enumerate(zip(got, want)):
        if ([(r.id, r.dist) for r in a] != [(r.id, r.dist) for r in b]
                or len(a) != FACE_PHASE["limit"]):
            raise AssertionError(f"tools: offline face index query {i} "
                                 "differs from the in-memory searcher's")
    stages = {k: round(v, 3) for k, v in res["stages"].items()}
    log(f"tools: build_index {cfg['face_conf']} (lopq V={V} M={M} S={S}) "
        f"from {n} rows of .fvecs (written in {write_s:.2f}s): stage "
        f"seconds {stages}; LOPQSearcherTorch from the storer + code store "
        f"in {load_s:.2f}s; {len(Q)} queries equal to the in-memory "
        f"searcher's (ids and distances) [{card}]")
    return dict(rows=n, stages=stages, fvecs_write_s=write_s,
                load_s=load_s)


def tools_release_build(dev, card, work, cfg):
    """``build_index --model-type lopq_pca`` at the release shapes from an
    .npy of raw rows drawn as the training phase draws them; the PCA
    spans the rows' basis and every stored code is the loaded model's
    encoding of its row."""
    from columbiaimagesearch_tpu_torch.index.build_index import encode_rows
    from columbiaimagesearch_tpu_torch.native.codestore import CodeStore

    tc = TRAIN
    with open(os.path.join(ROOT, tc["conf"])) as f:
        conf = dict(json.load(f), **tc["overrides"])
    V, M = int(conf["SEARCHLOPQ_lopq_V"]), int(conf["SEARCHLOPQ_lopq_M"])
    S = int(conf["SEARCHLOPQ_lopq_subq"])
    D = int(conf["SEARCHLOPQ_lopq_pcadims"])
    n = cfg["release_rows"]
    src = raw_source(dev, D, tc["raw_dim"], tc["noise"], tc["seed"])
    X = raw_rows(n, src).cpu().numpy()
    res, model, write_s = build_and_load(dev, work, "release.npy", X, [
        "--model-type", "lopq_pca", "--V", str(V), "--M", str(M), "--subq",
        str(S), "--pca-dims", str(D), "--nb-train", str(n), "--seed",
        str(cfg["seed"])])
    cos = float(torch.linalg.svdvals(src["basis"] @ model.pca_P).min())
    if not cos >= PCA_COS_MIN:
        raise AssertionError(f"tools: the release build's pca_P does not "
                             f"span the basis (least principal cosine {cos})")
    cs = CodeStore(res["codes"], m=M)
    try:
        cells, codes, ids = cs.read_all()
    finally:
        cs.close()
    want_cells, want_codes = encode_rows(model, X)
    rows = np.asarray(ids, dtype=np.int64)
    if not (len(rows) == n and np.array_equal(np.sort(rows), np.arange(n))
            and np.array_equal(cells, want_cells[rows])
            and np.array_equal(codes, want_codes[rows])):
        raise AssertionError("tools: the release build's code store does not "
                             "hold the loaded model's codes of its rows")
    stages = {k: round(v, 3) for k, v in res["stages"].items()}
    log(f"tools: build_index --model-type lopq_pca {tc['conf']} ({tc['raw_dim']}"
        f" -> {D}, V={V} M={M} S={S}) from an .npy of {n} raw rows (written "
        f"in {write_s:.2f}s): stage seconds {stages}; pca_P spans the "
        f"basis (least principal cosine {cos:.6f}); the {n} stored codes "
        f"equal the loaded model's predict_batch [{card}]")
    return dict(rows=n, stages=stages, npy_write_s=write_s,
                pca_cos_min=cos)


def exhaustive_replay(model, coarse, fine, queries, exact_ids):
    """The exhaustive stage's first queries through the plain versions of
    both kernels (the LUT of every cluster, the scan) held to a stable
    selection on the plain distances (plain_selection_check). Returns
    the tie swaps."""
    from columbiaimagesearch_tpu_torch.index.exhaustive_adc import (
        adc_scan_all_plain,
        build_padded_layout,
    )
    from columbiaimagesearch_tpu_torch.index.lut import build_luts_plain

    dev, V = model.device, model.V
    cells = coarse[:, 0].astype(np.int64) * V + coarse[:, 1].astype(np.int64)
    codes_padded, block_cell, block_count, row_of = build_padded_layout(
        cells, fine)
    by_row = np.full(len(codes_padded), -1, np.int64)
    by_row[row_of] = np.arange(len(cells))
    nq, Dh = len(queries), model.Cs.shape[2]
    x2 = torch.as_tensor(queries, device=dev).reshape(nq, 2, Dh)
    isel = torch.arange(V, device=dev).expand(nq, 2, V)
    t = build_luts_plain(x2, isel, model.Cs, model.Rs, model.mus, model.subs)
    luts = [t[:, s].permute(1, 2, 3, 0).contiguous() for s in range(2)]
    plain = adc_scan_all_plain(
        torch.from_numpy(codes_padded).to(dev),
        torch.from_numpy(block_cell).to(dev),
        torch.from_numpy(block_count).to(dev), *luts, V=V).cpu().numpy()
    swaps = 0
    for q, got in enumerate(exact_ids):
        order = np.argsort(plain[q], kind="stable")[:len(got)]
        swaps += plain_selection_check(
            got, plain[q, row_of[np.asarray(got)]], by_row[order],
            plain[q, order], f"tools: exhaustive replay query {q}")
    return swaps


def rerank_replay(s, X, queries, quota, width, what):
    """The fused device rerank (``eval_recall.RERANK_NB``) of searcher
    ``s`` (its store holds the rows ``X``) at the pinned probe width
    ``width`` held to a plain re-sort of the same searcher's probed
    top-RERANK_NB by exact float64 L2 distances from the rows as the store
    holds them (``X`` rounded to its dtype): each query's distances
    within SELECT_TIE_RTOL and its ids by plain_selection_check. Returns
    the tie swaps."""
    from columbiaimagesearch_tpu_torch.index import eval_recall

    s.probe_width = width
    kw = dict(quota=quota, with_codes=False)
    fused = s.search_batch(queries, limit=eval_recall.LIMIT, with_dists=True,
                           rerank_nb=eval_recall.RERANK_NB, **kw)
    probed = s.search_batch(queries, limit=eval_recall.RERANK_NB, **kw)
    s.probe_width = None
    store_dtype = s._dev["feats"].dtype         # packed by the searches
    swaps = 0
    for q, ((got, _), (cand, _)) in enumerate(zip(fused, probed)):
        rows = np.array([r.id for r in cand], np.int64)
        held = torch.from_numpy(X[rows]).to(store_dtype).double().numpy()
        d = np.sqrt(((held - queries[q].astype(np.float64)) ** 2).sum(axis=1))
        order = np.argsort(d, kind="stable")[:len(got)]
        dists = np.array([r.dist for r in got])
        if len(got) != min(eval_recall.LIMIT, len(rows)):
            raise AssertionError(f"{what}: fused rerank query {q}: "
                                 f"{len(got)} results")
        np.testing.assert_allclose(dists, d[order], rtol=SELECT_TIE_RTOL,
                                   err_msg=f"{what}: fused rerank query {q}")
        swaps += plain_selection_check([r.id for r in got], dists,
                                       rows[order], d[order],
                                       f"{what}: fused rerank query {q}")
    return swaps


def tools_recall(dev, card, work, cfg):
    """``eval_recall`` at its defaults (probed sweep and fused rerank),
    its exhaustive stage on a V=exact_V model of the same rows, and the
    replay of that stage through both kernels' plain versions."""
    from columbiaimagesearch_tpu_torch.index import eval_recall
    from columbiaimagesearch_tpu_torch.index.searcher import (
        LOPQSearcherTorch,
    )

    t0 = time.perf_counter()
    args = eval_recall.parse_args(list(cfg["recall_args"]))
    artifact, state = eval_recall.run(args)
    run_s = time.perf_counter() - t0
    by = {(r["method"], r.get("probe_width"), r.get("rerank")): r
          for r in artifact["runs"]}
    probed = by[(f"probed_quota{args.quota}", "adaptive", None)]
    rerank = by[(f"probed_quota{args.quota}_rerank{eval_recall.RERANK_NB}",
                 "adaptive", "fused_device")]
    for k in eval_recall.KS:
        if rerank[f"recall@{k}"] < probed[f"recall@{k}"]:
            raise AssertionError(f"tools: eval_recall rerank recall@{k} "
                                 f"{rerank[f'recall@{k}']} < probed "
                                 f"{probed[f'recall@{k}']}")
    data, nns = state["data"], state["nns"]
    t0 = time.perf_counter()
    s = LOPQSearcherTorch(state["model"], rerank_dtype="float32")
    s.add_codes((state["coarse"], state["fine"]), feats=data.X)
    rerank_swaps = rerank_replay(s, data.X, data.queries, args.quota,
                                 cfg["rerank_width"], "tools")
    del s
    rerank_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = eval_recall.train_model(data.train, cfg["exact_V"], args.M, dev)
    coarse, fine = eval_recall.encode(model, data)
    row, exact_ids = eval_recall.exhaustive_exact(model, coarse, fine,
                                                  data.queries, nns)
    exact_s = time.perf_counter() - t0
    row["V"] = cfg["exact_V"]
    artifact["runs"].append(row)
    with open(os.path.join(work, "eval_recall.json"), "w") as f:
        json.dump(artifact, f, indent=1)
    r = cfg["replay"]
    swaps = exhaustive_replay(model, coarse, fine, data.queries[:r],
                              exact_ids[:r])
    for run in artifact["runs"]:
        log(f"tools: eval_recall {run['method']} (probe "
            f"{run.get('probe_width', '-')}"
            f"{', V=' + str(run['V']) if 'V' in run else ''}): recall@1 "
            f"{run['recall@1']} @10 {run['recall@10']} @100 "
            f"{run['recall@100']}, {run['ms_per_query_e2e_host']} ms/query "
            f"(host clock) [{card}]")
    log(f"tools: eval_recall (n={args.n} dim={args.dim} V={args.V} "
        f"queries={args.queries} quota={args.quota}) in {run_s:.1f}s; "
        f"rerank recall@k >= probed at k = 1, 10, 100; at probe width "
        f"{cfg['rerank_width']} the fused rerank's top-{eval_recall.LIMIT} "
        f"of {args.queries} queries equals a float64 re-sort of the probed "
        f"top-{eval_recall.RERANK_NB} ({rerank_swaps} rounding-tie swaps, "
        f"{rerank_s:.1f}s); the exhaustive stage (V={cfg['exact_V']}) in "
        f"{exact_s:.1f}s, {r} of its queries equal to the plain kernels' "
        f"replay ({swaps} rounding-tie swaps)")
    return dict(runs=artifact["runs"], run_s=run_s, exact_s=exact_s,
                replay_swaps=swaps, rerank_swaps=rerank_swaps)


def tools_realfeat(dev, card, work, cfg):
    """``eval_recall_realfeat`` with ``realfeat_args``: the raw rerank
    reorders the probed top-1000 exactly, so its recall@k is at least the
    probed one's."""
    from columbiaimagesearch_tpu_torch.index import eval_recall_realfeat

    t0 = time.perf_counter()
    artifact = eval_recall_realfeat.main(list(cfg["realfeat_args"]) + [
        "--out", os.path.join(work, "realfeat.json")])
    run_s = time.perf_counter() - t0
    runs = artifact["runs"]
    probed, raw = runs[0], runs[2]
    for k in (1, 10, 100):
        if raw[f"recall@{k}"] < probed[f"recall@{k}"]:
            raise AssertionError(f"tools: realfeat raw rerank recall@{k} "
                                 "below the probed search's")
    for run in runs:
        log(f"tools: eval_recall_realfeat {run['method']}: recall@1 "
            f"{run['recall@1']} @10 {run['recall@10']} @100 "
            f"{run['recall@100']} [{card}]")
    log(f"tools: eval_recall_realfeat n={artifact['config']['n']} "
        f"V={artifact['config']['V']} in {run_s:.1f}s [{card}]")
    return dict(runs=runs, run_s=run_s)


def tools_face(dev, card, work, cfg):
    """``train_face_template --synth`` to a template in ``work``; the file
    round-trips bit-equal and the detector loaded from it finds the
    trained one's boxes; then ``eval_face_detector`` on it."""
    from columbiaimagesearch_tpu_torch.models import (
        eval_face_detector,
        train_face_template,
    )
    from columbiaimagesearch_tpu_torch.models.face_synth import make_scene

    path = os.path.join(work, "face_template.npz")
    t0 = time.perf_counter()
    det, out = train_face_template.main(["--synth", str(cfg["synth"]),
                                         "--out", path])
    train_s = time.perf_counter() - t0
    loaded = eval_face_detector.load_detector(out, dev)
    with np.load(out) as z:
        same = (np.array_equal(z["template"], det.template.cpu().numpy())
                and z["template"].dtype == np.float32
                and float(z["bias"]) == float(np.float32(det.bias)))
    if not same or not torch.equal(loaded.template, det.template):
        raise AssertionError("tools: the saved template does not round-trip "
                             "bit-equal")
    loaded.threshold = det.threshold = 0.5
    for k in range(4):
        img, _ = make_scene(1000 + k, range(cfg["synth"], cfg["synth"] + 40))
        a, b = det.run(img), loaded.run(img)
        if not (np.array_equal(np.asarray(a[0]), np.asarray(b[0]))
                and np.array_equal(np.asarray(a[1]), np.asarray(b[1]))):
            raise AssertionError(f"tools: scene {k}: the loaded template "
                                 "finds other boxes than the trained one")
    t0 = time.perf_counter()
    res = eval_face_detector.main([
        "--template", out, "--train-n", str(cfg["synth"]), "--scenes",
        str(cfg["scenes"]), "--out", os.path.join(work, "face_eval.json")])
    eval_s = time.perf_counter() - t0
    log(f"tools: train_face_template --synth {cfg['synth']} in "
        f"{train_s:.1f}s (bias {det.bias:+.4f}); the template round-trips "
        f"bit-equal and its loaded detector finds the same boxes on 4 "
        f"scenes; eval_face_detector on {cfg['scenes']} scenes in "
        f"{eval_s:.1f}s: AP {res['value']} (the committed artifact: "
        f"{cfg['ref_ap']}, a reference, not a gate), real-photo IoU "
        f"{res['extra']['real_photo_best_iou']} [{card}]")
    return dict(train_s=train_s, eval_s=eval_s, ap=res["value"],
                real_photo_iou=res["extra"]["real_photo_best_iou"])


def phase_tools(dev, card, cfg=None):
    """The operator tools on the card (see TOOLS), under build/tools/
    (deleted at the end). Returns the numbers and each kernel's launches
    in the phase."""
    import shutil

    from columbiaimagesearch_tpu_torch.index.exhaustive_adc import (
        adc_scan_all,
    )
    from columbiaimagesearch_tpu_torch.index.lut import build_luts
    from columbiaimagesearch_tpu_torch.models import drop_weights

    cfg = dict(TOOLS, **(cfg or {}))
    work = os.path.join(ROOT, "build", "tools")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    adc_scan_all.launches = 0                  # counts this phase only
    build_luts.launches = 0
    numbers = {}
    try:
        for name, step in (("face_build", tools_face_build),
                           ("release_build", tools_release_build),
                           ("recall", tools_recall),
                           ("realfeat", tools_realfeat),
                           ("face", tools_face)):
            t0 = time.perf_counter()
            numbers[name] = step(dev, card, work, cfg)
            numbers[name]["s"] = round(time.perf_counter() - t0, 2)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        t0 = time.perf_counter()
        drop_weights.main(["--dry-run"] + (["--cpu"] if dev.type == "cpu"
                                           else []))
        numbers["drop_weights_s"] = round(time.perf_counter() - t0, 2)
        log(f"tools: drop_weights --dry-run passed every gate in "
            f"{numbers['drop_weights_s']:.1f}s [{card}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = dict(lut=build_luts.launches, adc=adc_scan_all.launches)
    log(f"tools: lut_build launches={launches['lut']}, adc_scan launches="
        f"{launches['adc']}")
    if dev.type == "cuda" and (launches["lut"] <= 0 or launches["adc"] <= 0):
        raise AssertionError("the tools phase did not launch both kernels")
    return numbers, launches


#: phase_recall_parity holds the port to the JAX package's committed
#: recall artifacts, each row matched by method and probe width at
#: k = 1, 10, 100 under the rule of its run: "abs" |port - JAX| <= bound
#: (the same rows, queries and ground truth, another model); "sigma"
#: |port - JAX| <= bound * sigma, sigma = sqrt(2 p (1 - p) / queries) at
#: the pooled recall p (another draw of the same distribution); "floor"
#: port >= JAX - bound. ``ordered``: within a quota width 256 is at least
#: width 64 - ORDER_SLACK, and at a width the larger quota at least the
#: smaller - ORDER_SLACK (the JAX artifacts show both orderings)
RECALL_PARITY = {
    "adversarial_10M": dict(
        ref="benchmarks/r05_recall_adversarial_10M_rerank.json", rule="abs",
        bound=0.10, ordered=True),
    "stream_100M": dict(ref="benchmarks/r05_recall_100M.json",
                        rule="sigma", bound=3.0, ordered=True),
    "neardup_100M": dict(ref="benchmarks/r05_recall_100M_neardup.json",
                         rule="floor", bound=0.04, ordered=False),
}
ORDER_SLACK = 0.03

#: phase_recall_parity's runs: ``host_args`` is the adversarial artifact's
#: config through ``eval_recall.run`` (10,485,760 rows drawn on the host,
#: the fused rerank in bfloat16 as the artifact's); the stream runs take
#: ``stream_n`` rows made on the card (``--stream-synth``), over ``quotas``
#: x ``widths`` and, at the near-duplicate artifact's query noise, over
#: ``neardup_quotas`` x ``widths`` on the same index; ``replay_width`` is
#: the pinned width of the kernel-vs-plain replays; ``refresh_rows`` more
#: rows go into the stream index after its sweeps
RECALL_RUNS = dict(
    host_args=("--n", "10485760", "--dim", "256", "--V", "4096", "--M", "8",
               "--query-noise", "0.25", "--queries", "100", "--quota",
               "10000", "--quotas", "10000,100000", "--probe-widths",
               "64,256,0", "--rerank-dtype", "bfloat16", "--skip-exact"),
    stream_n=104_857_600, quotas=(10_000, 100_000), widths=(64, 256, 0),
    neardup_quotas=(10_000,), replay_width=64,
    refresh_rows=8192, seed=0)


def ordering_misses(runs, slack=ORDER_SLACK):
    """The orderings that the probed rows of ``runs`` break at k = 1, 10,
    100: within a quota, width 256 below width 64 by more than ``slack``;
    at a width, a larger quota below a smaller one by more than
    ``slack``."""
    probed = {}
    for r in runs:
        if r["method"].startswith("probed_quota") and "rerank" not in r:
            probed[(int(r["method"][len("probed_quota"):]),
                    r["probe_width"])] = r
    quotas = sorted({q for q, _ in probed})
    widths = sorted({w for _, w in probed})
    misses = []
    for k in (1, 10, 100):
        key = f"recall@{k}"
        pairs = [((q, "64"), (q, "256")) for q in quotas]
        pairs += [((q0, w), (q1, w)) for w in widths
                  for q0, q1 in zip(quotas, quotas[1:])]
        for lo, hi in pairs:
            if lo in probed and hi in probed and round(
                    probed[lo][key] - probed[hi][key], 9) > slack:
                misses.append(f"{key} at quota {hi[0]} width {hi[1]} "
                              f"({probed[hi][key]}) below quota {lo[0]} "
                              f"width {lo[1]} ({probed[lo][key]}) by more "
                              f"than {slack}")
    return misses


def parity_table(port_runs, ref_runs, rule, bound, queries, ordered):
    """Each row of a JAX artifact's ``ref_runs`` beside the port's row of
    the same method and probe width at k = 1, 10, 100 under ``rule`` (see
    RECALL_PARITY): both recalls, the difference, the bound (and sigma)
    and whether it holds; a JAX row the port lacks fails. Returns
    ``rows``, the ordering misses of the port's rows and ``ok``."""
    by = {(r["method"], r.get("probe_width")): r for r in port_runs}
    rows = []
    for ref in ref_runs:
        got = by.get((ref["method"], ref.get("probe_width")))
        for k in (1, 10, 100):
            row = dict(method=ref["method"], probe_width=ref.get(
                "probe_width"), k=k, jax=ref[f"recall@{k}"], port=None,
                delta=None, bound=None, ok=False)
            rows.append(row)
            if got is None:
                continue
            row["port"] = p = got[f"recall@{k}"]
            row["delta"] = d = round(p - row["jax"], 9)
            if rule == "abs":
                row["bound"] = bound
                row["ok"] = abs(d) <= bound
            elif rule == "sigma":
                pooled = (p + row["jax"]) / 2
                row["sigma"] = float(np.sqrt(2 * pooled * (1 - pooled)
                                             / queries))
                row["bound"] = round(bound * row["sigma"], 9)
                row["ok"] = abs(d) <= row["bound"]
            elif rule == "floor":
                row["bound"] = -bound
                row["ok"] = d >= -bound
            else:
                raise ValueError(f"unknown parity rule {rule!r}")
    misses = ordering_misses(port_runs) if ordered else []
    return dict(rows=rows, order_misses=misses,
                ok=all(r["ok"] for r in rows) and not misses)


def check_recall_parity(name, port_runs, ref, queries, card):
    """parity_table of the port's rows against the JAX artifact ``ref``
    under RECALL_PARITY[name]'s rule, each row logged; raises on a miss.
    Returns the table."""
    spec = RECALL_PARITY[name]
    table = parity_table(port_runs, ref["runs"], spec["rule"], spec["bound"],
                         queries, spec["ordered"])
    for r in table["rows"]:
        sigma = f", sigma {r['sigma']:.4f}" if "sigma" in r else ""
        log(f"recall parity {name}: {r['method']} width {r['probe_width']} "
            f"recall@{r['k']}: port {r['port']} JAX {r['jax']} delta "
            f"{r['delta']} ({spec['rule']} bound {r['bound']}{sigma}): "
            f"{'pass' if r['ok'] else 'FAIL'} [{card}]")
    for m in table["order_misses"]:
        log(f"recall parity {name}: ordering FAIL: {m}")
    if not table["ok"]:
        bad = [f"{r['method']} width {r['probe_width']} recall@{r['k']} "
               f"port {r['port']} JAX {r['jax']}"
               for r in table["rows"] if not r["ok"]]
        raise AssertionError(f"recall parity {name} ({spec['ref']}): "
                             f"{bad + table['order_misses']}")
    return table


def adc_float64(tables, x, cells, fine, V):
    """Exact float64 ADC distances of the rows with cell ids ``cells`` and
    fine codes ``fine`` [n, M] from the query ``x``, from the model's
    tables (``Cs``, ``Rs``, ``mus``, ``subs``, float64 on one device)."""
    Cs, Rs, mus, subs = tables
    F, Dsub = subs.shape[1], subs.shape[3]
    dev = Cs.device
    x2 = torch.as_tensor(x, device=dev).double().reshape(2, -1)
    cells = torch.as_tensor(cells, device=dev).long()
    fine = torch.as_tensor(fine, device=dev).long()
    d = torch.zeros(len(cells), dtype=torch.float64, device=dev)
    for s, c in enumerate((cells // V, cells % V)):
        r = x2[s][None] - Cs[s][c] - mus[s][c]
        pr = torch.einsum("nij,nj->ni", Rs[s][c], r)
        for f in range(F):
            diff = pr[:, f * Dsub:(f + 1) * Dsub] - subs[s, f][fine[:, s * F
                                                                   + f]]
            d += (diff * diff).sum(dim=1)
    return d.cpu().numpy()


def pinned_lut_replay(s, queries, quota, width, what):
    """A wave of searcher ``s`` pinned to probe width ``width`` (the LUT
    route: ``lut_build`` launches) held to its replay with the plain LUT
    (``build_luts_plain``) and a float64 re-scoring of the codes: the
    kernel wave's distances equal the float64 ADC distances of its rows
    (SELECT_TIE_RTOL), and its ids a stable selection of the plain wave's
    rows by those distances but rounding ties (plain_selection_check).
    The searcher's ids are its rows. Returns (launches, tie swaps)."""
    from columbiaimagesearch_tpu_torch.index import eval_recall
    from columbiaimagesearch_tpu_torch.index import query as qmod
    from columbiaimagesearch_tpu_torch.index.lut import (
        build_luts,
        build_luts_plain,
    )

    kw = dict(quota=quota, limit=eval_recall.LIMIT, with_dists=True,
              with_codes=False)
    s.probe_width = width
    before = build_luts.launches
    got = s.search_batch(queries, **kw)
    launches = build_luts.launches - before
    with mock.patch.object(qmod, "build_luts", build_luts_plain):
        plain = s.search_batch(queries, **kw)
    s.probe_width = None
    m = s.model
    tables = tuple(t.double() for t in (m.Cs, m.Rs, m.mus, m.subs))
    swaps = 0
    for q, ((a, _), (b, _)) in enumerate(zip(got, plain)):
        ids = np.array([r.id for r in a], np.int64)
        want = np.array([r.id for r in b], np.int64)
        if len(ids) != len(want) or not len(ids):
            raise AssertionError(f"{what}: query {q}: {len(ids)} results on "
                                 f"the kernel, {len(want)} plain")
        dists = np.array([r.dist for r in a], np.float64)
        exact = adc_float64(tables, queries[q], s._cells[ids], s._fine[ids],
                            m.V)
        far = np.abs(dists - exact) > SELECT_TIE_RTOL * np.maximum(1.0,
                                                                   exact)
        if far.any():
            r = int(np.nonzero(far)[0][0])
            raise AssertionError(f"{what}: query {q} rank {r}: distance "
                                 f"{dists[r]} against {exact[r]} in float64")
        d64 = adc_float64(tables, queries[q], s._cells[want], s._fine[want],
                          m.V)
        order = np.argsort(d64, kind="stable")
        swaps += plain_selection_check(ids, dists, want[order], d64[order],
                                       f"{what}: query {q}")
    del tables
    return launches, swaps


def _stage_timer(stages, name, fn, sync):
    """``fn`` wrapped to add its host seconds (to a sync) to
    ``stages[name]``."""
    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        sync()
        stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
        return out
    return timed


def _kept_searchers(made, sync):
    """A ``LOPQSearcherTorch`` subclass that appends each instance to
    ``made`` and packs in ``add_codes`` (the refresh a first search would
    run), recording its seconds as ``add_s`` (the results are the
    same)."""
    from columbiaimagesearch_tpu_torch.index.searcher import (
        LOPQSearcherTorch,
    )

    class Kept(LOPQSearcherTorch):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

        def add_codes(self, *a, **kw):
            t0 = time.perf_counter()
            super().add_codes(*a, **kw)
            self._pack()
            sync()
            self.add_s = getattr(self, "add_s", 0.0) + (
                time.perf_counter() - t0)
    return Kept


def _add_codes_split(split, sync):
    """Patches (an ExitStack) that add the host seconds of
    ``LOPQSearcherTorch.add_codes``' steps to ``split``: the codes'
    arrays, the dedup's id interning and whole ``filter_new``, the merge
    into the host mirror (``_take_pending``) and the device sort path."""
    import contextlib

    from columbiaimagesearch_tpu_torch.index import searcher as smod
    from columbiaimagesearch_tpu_torch.utils.codes import IncrementalDedup

    stack = contextlib.ExitStack()
    for owner, name, key in (
            (smod, "_codes_to_arrays", "codes_to_arrays"),
            (IncrementalDedup, "intern", "intern"),
            (IncrementalDedup, "filter_new", "filter_new"),
            (smod.LOPQSearcherTorch, "_take_pending", "take_pending"),
            (smod, "append_and_build_csr", "csr_build")):
        stack.enter_context(mock.patch.object(owner, name, _stage_timer(
            split, key, getattr(owner, name), sync)))
    return stack


def _wave_log(s, n):
    """The last ``n`` waves' [start rung, share short, settle rung, floor,
    yield EMA] of searcher ``s``'s ladder."""
    return s.probe_stats.get("wave_log", [])[-n:]


def _peak(dev):
    return (int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
            else None)


def recall_host_run(dev, card, work, cfg, ref):
    """Run (a): ``eval_recall.run`` at the adversarial artifact's config
    (``host_args``), its artifact under ``work``, held to the artifact by
    check_recall_parity; the sweep's index replayed at ``replay_width``
    (pinned_lut_replay) and the bfloat16 fused rerank's
    (rerank_replay). Returns (numbers, the trained model)."""
    from columbiaimagesearch_tpu_torch.index import eval_recall as er
    from columbiaimagesearch_tpu_torch.index import searcher as smod
    from columbiaimagesearch_tpu_torch.index.lut import build_luts

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out_path = os.path.join(work, "r05_recall_adversarial_10M_rerank.json")
    args = er.parse_args(list(cfg["host_args"]) + [
        "--out", out_path] + (["--cpu"] if dev.type == "cpu" else []))
    stages, made = {}, []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = build_luts.launches
    t0 = time.perf_counter()
    with mock.patch.object(smod, "LOPQSearcherTorch",
                           _kept_searchers(made, sync)), \
            mock.patch.multiple(
                er, SynthData=_stage_timer(stages, "draw", er.SynthData,
                                           sync),
                train_model=_stage_timer(stages, "train", er.train_model,
                                         sync),
                ground_truth=_stage_timer(stages, "ground_truth",
                                          er.ground_truth, sync),
                encode=_stage_timer(stages, "encode", er.encode, sync),
                probed_sweep=_stage_timer(stages, "sweep", er.probed_sweep,
                                          sync),
                probed_rerank=_stage_timer(stages, "rerank",
                                           er.probed_rerank, sync)):
        artifact, state = er.run(args)
    run_s = time.perf_counter() - t0
    sweep_s, rerank_s = made
    stages["add_codes"] = sweep_s.add_s
    stages["sweep"] -= sweep_s.add_s
    stages["rerank_add_codes"] = rerank_s.add_s
    stages["rerank"] -= rerank_s.add_s
    n_sweep = len(artifact["runs"]) - 1
    logs = _wave_log(sweep_s, 2 * n_sweep)[1::2]
    for r, w in zip(artifact["runs"], logs):
        r["wave_log"] = w
    with open(out_path, "w") as f:
        json.dump(artifact, f, indent=1)
    data, queries = state["data"], state["data"].queries
    table = check_recall_parity("adversarial_10M", artifact["runs"], ref,
                                args.queries, card)
    t0 = time.perf_counter()
    lut_launches, lut_swaps = pinned_lut_replay(
        sweep_s, queries, args.quota, cfg["replay_width"],
        "recall parity (a): pinned LUT replay")
    rerank_swaps = rerank_replay(rerank_s, data.X, queries, args.quota,
                                 cfg["replay_width"], "recall parity (a)")
    replay_s = time.perf_counter() - t0
    launches = build_luts.launches - launches0
    if dev.type == "cuda" and (launches <= 0 or lut_launches <= 0):
        raise AssertionError("recall parity (a): lut_build did not launch")
    stages = {k: round(v, 2) for k, v in stages.items()}
    nums = dict(n=args.n, dim=args.dim, V=args.V, rows=table["rows"],
                stages_s=stages, run_s=round(run_s, 2),
                replay_s=round(replay_s, 2), peak_bytes=_peak(dev),
                lut_launches=launches, lut_replay_swaps=lut_swaps,
                rerank_replay_swaps=rerank_swaps,
                wave_log=dict(zip([f"{r['method']}@{r['probe_width']}"
                                   for r in artifact["runs"]], logs)))
    log(f"recall parity (a): eval_recall.run at {args.n} x {args.dim} "
        f"(host draw, V={args.V}) in {run_s:.1f}s: stage seconds {stages}; "
        f"peak card memory {nums['peak_bytes']} bytes; every row within "
        f"{RECALL_PARITY['adversarial_10M']['bound']} of the JAX artifact; "
        f"a wave pinned to width {cfg['replay_width']} equal to its plain "
        f"LUT and float64 replay ({lut_swaps} rounding-tie swaps) and the "
        f"bfloat16 fused rerank to a float64 re-sort ({rerank_swaps}); "
        f"lut_build launches {launches} [{card}]")
    model = state["model"]
    del state, data, made, sweep_s, rerank_s
    return nums, model


def _sweep_rows(s, queries, nns, widths, quotas):
    """The probed rows of searcher ``s`` over quotas x widths, as
    ``eval_recall.probed_sweep`` makes them, on an index already built."""
    from columbiaimagesearch_tpu_torch.index import eval_recall

    rows = []
    for quota in quotas:
        for w in widths:
            s.probe_width = w or None
            answers, dt = eval_recall._timed_wave(s, queries, quota=quota)
            rows.append(eval_recall.recall_row(
                f"probed_quota{quota}", answers, nns, dt, batched=True,
                probe_width="adaptive" if not w else str(w)))
    s.probe_width = None
    return rows


def recall_stream_runs(dev, card, work, cfg, model, refs):
    """Runs (b) and (c) on one index of ``stream_n`` rows made on the
    card: (b) ``eval_recall``'s stages on ``model`` (run (a)'s: its
    training rows, seed 1, are (b)'s), held to the 100M artifact, its
    index replayed at ``replay_width``; (c) new queries on the same index
    and a new ground truth, held to the near-duplicate artifact; then
    refresh_at_scale. The query counts and noises are the artifacts'.
    Returns (numbers of (b), of (c), the refresh's)."""
    from columbiaimagesearch_tpu_torch.index import eval_recall as er
    from columbiaimagesearch_tpu_torch.index import searcher as smod
    from columbiaimagesearch_tpu_torch.index.lut import build_luts

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    n, dim = cfg["stream_n"], 2 * model.Cs.shape[2]
    ref_b, ref_c = refs["stream_100M"]["config"], refs["neardup_100M"]["config"]
    nq, noise, near_noise = (ref_b["queries"], ref_b["query_noise"],
                             ref_c["query_noise"])
    stages, made = {}, []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = build_luts.launches
    t0 = time.perf_counter()
    # train_n 0: (a)'s model is reused, so the training rows are not drawn
    data = _stage_timer(stages, "draw", er.SynthData, sync)(
        n, dim, 0, nq, noise, True, dev)
    nns = _stage_timer(stages, "ground_truth", er.ground_truth, sync)(data)
    coarse, fine = _stage_timer(stages, "encode", er.encode, sync)(model,
                                                                   data)
    split = {}
    with _add_codes_split(split, sync), mock.patch.object(
            smod, "LOPQSearcherTorch", _kept_searchers(made, sync)):
        runs = _stage_timer(stages, "sweep", er.probed_sweep, sync)(
            model, coarse, fine, data.queries, nns, list(cfg["widths"]),
            list(cfg["quotas"]))
    del coarse, fine
    s, = made
    stages["add_codes"] = s.add_s
    stages["sweep"] -= s.add_s
    split = dict(codes_to_arrays=split["codes_to_arrays"],
                 intern=split["intern"],
                 dedup_keys=split["filter_new"] - split["intern"],
                 mirror=split["take_pending"] - split["filter_new"],
                 csr_build=split["csr_build"],
                 rest=s.add_s - split["codes_to_arrays"]
                 - split["take_pending"] - split["csr_build"])
    split = {k: round(v, 2) for k, v in split.items()}
    log(f"recall parity (b): add_codes of {n} rows, seconds a step: {split} "
        f"(intern: np.unique of the ids; dedup_keys: the (cell, id) key "
        f"sorts; mirror: the host arrays; csr_build: append_and_build_csr; "
        f"rest: the device buffers' upload) [{card}]")
    b_s = time.perf_counter() - t0
    logs = _wave_log(s, 2 * len(runs))[1::2]
    for r, w in zip(runs, logs):
        r["wave_log"] = w
    config = dict(n=n, dim=dim, V=model.V, M=model.M, query_noise=noise,
                  queries=nq, quota=cfg["quotas"][0], stream_synth=True,
                  device=torch.cuda.get_device_name(dev)
                  if dev.type == "cuda" else "cpu", model="run (a)'s")
    with open(os.path.join(work, "r05_recall_100M.json"), "w") as f:
        json.dump(dict(config=config, runs=runs), f, indent=1)
    table_b = check_recall_parity("stream_100M", runs, refs["stream_100M"],
                                  nq, card)
    t0 = time.perf_counter()
    lut_launches, lut_swaps = pinned_lut_replay(
        s, data.queries, cfg["quotas"][0], cfg["replay_width"],
        "recall parity (b): pinned LUT replay")
    replay_s = time.perf_counter() - t0
    launches_b = build_luts.launches - launches0
    peak_b = _peak(dev)
    stages = {k: round(v, 2) for k, v in stages.items()}
    log(f"recall parity (b): {n} x {dim} streamed rows on run (a)'s model "
        f"in {b_s:.1f}s: stage seconds {stages}; peak card memory {peak_b} "
        f"bytes; every row within {RECALL_PARITY['stream_100M']['bound']} "
        f"sigma of the JAX artifact; a wave pinned to width "
        f"{cfg['replay_width']} equal to its plain LUT and float64 replay "
        f"({lut_swaps} rounding-tie swaps, {replay_s:.1f}s); lut_build "
        f"launches {launches_b} [{card}]")
    if dev.type == "cuda" and (launches_b <= 0 or lut_launches <= 0):
        raise AssertionError("recall parity (b): lut_build did not launch")
    nums_b = dict(n=n, rows=table_b["rows"], stages_s=stages,
                  add_codes_split_s=split,
                  run_s=round(b_s, 2), replay_s=round(replay_s, 2),
                  peak_bytes=peak_b, lut_launches=launches_b,
                  lut_replay_swaps=lut_swaps,
                  wave_log=dict(zip([f"{r['method']}@{r['probe_width']}"
                                     for r in runs], logs)))

    # (c): near-duplicate queries on the same index, drawn as the JAX
    # script draws them (RandomState(3)) at the artifact's noise.
    stages = {}
    launches0 = build_luts.launches
    t0 = time.perf_counter()
    near = _stage_timer(stages, "draw", er.SynthData, sync)(
        n, dim, 0, ref_c["queries"], near_noise, True, dev)
    nns_c = _stage_timer(stages, "ground_truth", er.ground_truth, sync)(near)
    runs_c = _stage_timer(stages, "sweep", _sweep_rows, sync)(
        s, near.queries, nns_c, cfg["widths"], cfg["neardup_quotas"])
    c_s = time.perf_counter() - t0
    logs = _wave_log(s, 2 * len(runs_c))[1::2]
    for r, w in zip(runs_c, logs):
        r["wave_log"] = w
    with open(os.path.join(work, "r05_recall_100M_neardup.json"), "w") as f:
        json.dump(dict(config=dict(config, query_noise=near_noise),
                       runs=runs_c), f, indent=1)
    table_c = check_recall_parity("neardup_100M", runs_c,
                                  refs["neardup_100M"], nq, card)
    launches_c = build_luts.launches - launches0
    if dev.type == "cuda" and launches_c <= 0:
        raise AssertionError("recall parity (c): lut_build did not launch")
    stages = {k: round(v, 2) for k, v in stages.items()}
    log(f"recall parity (c): {ref_c['queries']} queries at noise {near_noise} "
        f"on (b)'s index in {c_s:.1f}s: stage seconds {stages}; every row "
        f"at least the JAX artifact's - "
        f"{RECALL_PARITY['neardup_100M']['bound']}; lut_build launches "
        f"{launches_c} [{card}]")
    nums_c = dict(rows=table_c["rows"], stages_s=stages, run_s=round(c_s, 2),
                  lut_launches=launches_c,
                  wave_log=dict(zip([f"{r['method']}@{r['probe_width']}"
                                     for r in runs_c], logs)))

    refresh = refresh_at_scale(s, data.comp, cfg, card)
    del s, made, data, near
    return nums_b, nums_c, refresh


def refresh_at_scale(s, comp, cfg, card):
    """``refresh_rows`` more rows of the mixture ``comp`` into searcher
    ``s``'s index, with ids that go on from its own: the refresh through
    ``add_codes`` and the pack a search would run, timed on the host
    (the dedup's id table first turned into a dict, once after a bulk add,
    timed apart), then its sort path (``append_and_build_csr``) alone on
    the card, as phase_refresh_sort times it. Returns the numbers."""
    from columbiaimagesearch_tpu_torch.index.csr import append_and_build_csr

    dev, model = s.device, s.model
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    dim = comp.shape[1]
    k = cfg["refresh_rows"]
    rng = np.random.RandomState(cfg["seed"] + 31)
    extra = (comp[rng.randint(0, len(comp), k)]
             + 0.25 * rng.randn(k, dim)).astype(np.float32)
    co, fi = model.predict_batch(extra)
    n0 = s.get_nb_indexed()
    t0 = time.perf_counter()
    s._dedup._materialize()
    intern_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s.add_codes((co, fi), ids=np.arange(n0, n0 + k))
    nb = s.get_nb_indexed()
    sync()
    pack_s = time.perf_counter() - t0
    if nb != n0 + k:
        raise AssertionError(f"recall parity: the refresh indexed {nb} rows, "
                             f"not {n0 + k}")
    V = model.V
    chunk_c = torch.from_numpy(s._cells[n0:nb].astype(np.int32)).to(dev)
    chunk_f = torch.from_numpy(s._fine[n0:nb].copy()).to(dev)

    def refresh():
        return append_and_build_csr(s._buf_cells, s._buf_fine, chunk_c,
                                    chunk_f, n0, V)

    again = refresh()
    if not torch.equal(again[0], s._dev["cells_sorted"]):
        raise AssertionError("recall parity: the timed refresh's sorted "
                             "cells differ from the searcher's")
    del again
    ms = (float(np.median(time_ms(refresh, 5))) if dev.type == "cuda"
          else None)
    cap = int(s._buf_cells.shape[0])
    refresh_nums = dict(rows=k, index_rows=n0, capacity=cap,
                        intern_s=round(intern_s, 2),
                        add_and_pack_s=round(pack_s, 2), sort_path_ms=ms)
    log(f"refresh sort: one {k}-row append_and_build_csr into the "
        f"{n0}-row index ({cap} rows of capacity, V={V}, M={model.M}): "
        f"{ms} ms (p50 of 5, CUDA events around each call); the whole "
        f"refresh through add_codes on the host: the id table made a dict "
        f"{intern_s:.2f}s (once after the bulk add), add_codes + pack "
        f"{pack_s:.2f}s [{card}]")
    return refresh_nums


def phase_recall_parity(dev, card, cfg=None):
    """The port's recall held to the JAX package's committed artifacts
    (RECALL_PARITY) in three runs (RECALL_RUNS): (a) at 10,485,760 rows
    drawn on the host, (b) at 104,857,600 rows made on the card, (c)
    near-duplicate queries on (b)'s index; the artifacts go under
    build/recall_parity/. Returns (numbers, ``lut_build`` launches)."""
    cfg = dict(RECALL_RUNS, **(cfg or {}))
    work = os.path.join(ROOT, "build", "recall_parity")
    os.makedirs(work, exist_ok=True)
    refs = {}
    for name, spec in RECALL_PARITY.items():
        with open(os.path.join(ROOT, spec["ref"])) as f:
            refs[name] = json.load(f)
    a, model = recall_host_run(dev, card, work, cfg,
                               refs["adversarial_10M"])
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    b, c, refresh = recall_stream_runs(dev, card, work, cfg, model, refs)
    launches = a["lut_launches"] + b["lut_launches"] + c["lut_launches"]
    return dict(adversarial_10M=a, stream_100M=b, neardup_100M=c,
                refresh=refresh), launches


class PhaseClock:
    """Host seconds of each phase of ``main``, logged as each ends."""

    def __init__(self):
        self.seconds = {}
        self._t = time.perf_counter()

    def lap(self, name):
        now = time.perf_counter()
        self.seconds[name] = round(now - self._t, 2)
        self._t = now
        log(f"phase {name}: {self.seconds[name]:.2f}s")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import columbiaimagesearch_tpu_torch  # noqa: F401  (TF32 off)

    cfg = dict(HEADLINE)
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} count="
        f"{torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    log(card)
    clock = PhaseClock()
    phase_build()
    clock.lap("build")
    worst, luts = phase_kernel_check(dev, card, cfg["seed"])
    clock.lap("kernel_check")
    scan_worst, _ = phase_scan_check(dev, card, cfg["seed"])
    clock.lap("scan_check")
    trained = phase_train(dev, card)
    clock.lap("train")
    plain = phase_train_plain(dev, card, trained)
    clock.lap("train_plain")
    del trained["face"]["train"], trained["heldout"]
    train_index = phase_train_index(dev, card)
    clock.lap("train_index")
    torch.cuda.empty_cache()
    state, launches = phase_main_path(dev, cfg, card, trained)
    clock.lap("main_path")
    blocked = state.pop("blocked_encode")
    if launches <= 0:
        raise AssertionError("the main path never launched lut_build")
    wide, wide_launches = phase_wide(dev, cfg, state, card)
    clock.lap("wide")
    torch.cuda.empty_cache()
    model_io = phase_model_io(dev, card, trained, state)
    clock.lap("model_io")
    recall = phase_recall(dev, cfg, state, card, trained)
    clock.lap("recall")
    phase_query_parity(dev, cfg, state)
    clock.lap("query_parity")
    phase_numbers(dev, cfg, state, card)
    clock.lap("numbers")
    phase_memory(dev, cfg, state, card)
    clock.lap("memory")
    phase_profile(dev, cfg, state, card)
    clock.lap("profile")
    phase_pca(dev, cfg, state, card, trained)
    clock.lap("pca")
    sharded, sharded_launches = phase_sharded(dev, cfg, state, card)
    clock.lap("sharded")
    del state
    torch.cuda.empty_cache()
    phase_fc7(dev, card)
    clock.lap("fc7")
    decode = phase_decode(dev, card)
    clock.lap("decode")
    torch.cuda.empty_cache()
    serving = phase_serving(dev, card, trained)
    clock.lap("serving")
    torch.cuda.empty_cache()
    codestore = phase_codestore(dev, card, trained)
    clock.lap("codestore")
    codestore["refresh_sort_ms"] = phase_refresh_sort(dev, card)
    clock.lap("refresh_sort")
    torch.cuda.empty_cache()
    ex = phase_exhaustive(dev, card, trained["face"])
    clock.lap("exhaustive")
    index = ex.pop("index")
    torch.cuda.empty_cache()
    face_probe, face_launches = phase_face_probe(dev, card, index)
    clock.lap("face_probe")
    phase_face_models(dev, card)
    clock.lap("face_models")
    face_serving = phase_face_serving(dev, card, index)
    clock.lap("face_serving")
    del index
    face_train = phase_face_train(dev, card)
    clock.lap("face_train")
    torch.cuda.empty_cache()
    tools, tools_launches = phase_tools(dev, card)
    clock.lap("tools")
    torch.cuda.empty_cache()
    parity, parity_launches = phase_recall_parity(dev, card)
    clock.lap("recall_parity")
    codestore["refresh_sort_ms"][parity["refresh"]["capacity"]] = (
        parity["refresh"]["sort_path_ms"])
    http, http_launches = serving["sharded_http"]
    sharded["http"] = http
    sharded_launches += http_launches
    log(f"launches: lut_build {launches} on the probed path + "
        f"{wide_launches} on the wide-V path + "
        f"{sharded_launches} on the sharded path + "
        f"{serving['launches']['lut']} on the serving path + "
        f"{ex['lut_launches']} on the exhaustive path + {face_launches} on "
        f"the face probed path + {face_serving['launches']} on the face "
        f"serving path + {tools_launches['lut']} on the tools path + "
        f"{parity_launches} on the recall parity path; "
        f"adc_scan {ex['adc_launches']} on the exhaustive path + "
        f"{tools_launches['adc']} on the tools path")
    worst = max([worst] + [r["max_abs"] for k, r in face_probe.items()
                           if k.startswith("lut")])
    head, face = luts["headline NQ=100"], ex["face"][8]
    name, power = card.rsplit(",", 1)
    log(json.dumps({"train": dict(
        trained["numbers"], plain=plain, train_index=train_index,
        recall=recall, card=name.strip(), power_limit=power.strip())}))
    log(json.dumps({"ingest": dict(
        serving["pipeline"], refresh_s=serving["refresh_s"],
        codestore=codestore, card=name.strip(),
        power_limit=power.strip())}))
    log(json.dumps({"sharded": dict(sharded, card=name.strip(),
                                    power_limit=power.strip())}))
    log(json.dumps({"phase_s": clock.seconds}))
    for key, numbers in (("wide", wide), ("model_io", model_io),
                         ("decode", decode), ("face_train", face_train),
                         ("tools", tools)):
        log(json.dumps({key: dict(numbers, card=name.strip(),
                                  power_limit=power.strip())}))
    log(json.dumps({"blocked_encode": dict(blocked, card=name.strip(),
                                           power_limit=power.strip())}))
    log(json.dumps({"recall_parity": dict(parity, card=name.strip(),
                                          power_limit=power.strip())}))
    log(json.dumps({"kernels": [{
        "name": "lut_build", "route": "cuda",
        "source": "columbiaimagesearch_tpu_torch/csrc/lut_build.cu",
        "replaces": "columbiaimagesearch_tpu/index/tpu_query.py:71",
        "launches": launches + wide_launches + sharded_launches
        + serving["launches"]["lut"] + ex["lut_launches"] + face_launches
        + face_serving["launches"] + tools_launches["lut"]
        + parity_launches,
        "max_abs_err": worst,
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None}, {
        "name": "adc_scan", "route": "cuda",
        "source": "columbiaimagesearch_tpu_torch/csrc/adc_scan.cu",
        "replaces": "columbiaimagesearch_tpu/index/pallas_adc.py:35",
        "launches": ex["adc_launches"] + tools_launches["adc"],
        "max_abs_err": max(scan_worst, ex["max_abs"]), "ms": face["ms"],
        "plain_ms": face["plain_ms"], "bound_ms": face["bound_ms"],
        "bound_by": face["bound_by"], "library_ms": face["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
