"""columbiaimagesearch_tpu_torch — the PyTorch/CUDA port of columbiaimagesearch_tpu.

This package runs the LOPQ query path (encode, CSR multi-index, probed ADC
query with exact rerank, the probe ladder and the wave-driving searcher)
and the exhaustive exact-ADC search in PyTorch, with both of the JAX
package's TPU kernels hand-written in CUDA C++ for Hopper: the ADC
lookup tables (``csrc/lut_build.cu``) and the exhaustive ADC scan
(``csrc/adc_scan.cu``). It also serves: image -> DeepSentibank fc7, the
fused raw-feature query, the ``SearcherLOPQ`` facade and the HTTP API,
and face search (conv-HOG detection -> 150x150 chips -> 128-d FaceResNet
embeddings -> the probed query), trains LOPQ models on the card
(k-means, PCA, local rotations), and ingests: image directories or bus
messages -> updates -> features extracted on the card -> the KV store
(``pipeline/``), with the codes persisted in the native code store.
JPEGs are decoded on the card: the host only entropy-decodes them to DCT
coefficients with the port's own reader (``native/csrc/jpegcoef.cpp``,
no libjpeg), and the device reconstructs and resizes them
(``models/jpeg_device.py``).
It serves on several cards too: the row-sharded index over a device mesh
(``parallel/``), one process launching every shard's query on its own
card. It imports ``torch`` and numpy only (PIL and ``requests`` lazily), never
``jax`` or ``columbiaimagesearch_tpu``: the JAX package is the reference the
port is tested against, not a dependency.

Layout (JAX counterpart in brackets):

- ``device.py``: fp32 precision settings (TF32 off) and device memory.
- ``utils/chunking.py``, ``utils/codes.py``, ``utils/xvecs.py``
  [utils/chunking.py, utils/codes.py, utils/xvecs.py]
- ``ops/kmeans.py``, ``ops/pca.py``, ``ops/rotations.py``,
  ``ops/eigen_alloc.py`` [the same names]: training.
- ``index/model.py`` [index/model.py]: ``train``, ``LOPQModel`` and
  ``LOPQModelPCA`` (parameter containers, ``fit`` classmethods, npz, .mat
  and proto I/O); ``index/proto.py``, ``index/protos/`` [the same names].
- ``index/eval.py`` [index/eval.py]: recall, distortion, cell balance.
- ``index/encode.py`` [index/tpu_encode.py]: ``lopq_encode``.
- ``index/csr.py`` [index/csr.py]: CSR build and in-place appends (the
  dense offsets table, or in wide-V mode the sorted cell ids only).
- ``index/lut.py`` [index/tpu_query.py ``build_luts_pallas``]: the LUT
  kernel's wrapper and its plain PyTorch version.
- ``index/query.py`` [index/tpu_query.py]: ``lopq_query`` and friends.
- ``index/probe.py`` [index/tpu_query.py]: the probe-ladder policy.
- ``index/multisequence.py`` [index/multisequence.py]: the cell walk.
- ``index/searcher.py`` [index/searcher.py]: ``LOPQSearcherTorch``, and
  the host reference ``LOPQSearcherBase``/``LOPQSearcher``.
- ``parallel/mesh.py``, ``parallel/sharded.py`` [the same names]: device
  meshes, data-parallel encode and Lloyd, ``ShardedLOPQIndex`` and
  ``ShardedLOPQSearcher``.
- ``index/exhaustive_adc.py`` [index/pallas_adc.py]: the scan kernel's
  wrapper and plain version, ``ExhaustiveADC``, ``ExhaustiveADCSearcher``.
- ``kernels/build.py`` [native/build.py]: nvcc build + ctypes loading.
- ``models/`` [models/layers.py, preprocess.py, sentibank.py,
  jpeg_device.py]: the fc7 featurizer and the device JPEG decode;
  [models/face.py, face_detector.py, face_dlib.py, face_align.py,
  face_synth.py]: the face embedders, detector, aligner (the detector
  template and the landmark net train on the card) and scene renderer;
  ``utils/synthimg.py`` [the same name]: procedural images;
  ``native/`` [native/build.py, imgpipe.py, codestore.py]: the host
  image decoder, the JPEG coefficient reader (``native/csrc/``) and the
  code store;
  ``imgio/``, ``extraction/``, ``store/``, ``common/``, ``searcher/``,
  ``api/`` [the same names]: the serving stack; ``pipeline/`` [pipeline/,
  and scripts/run_processing.py, run_images_pusher.py, bus_printer.py as
  ``python -m`` entry points]: ingest.
- The operator tools, ``python -m`` entry points beside their layers
  (each runs on the first card unless given ``--cpu``):
  ``common/generate_conf.py`` [scripts/generate_conf.py],
  ``index/build_index.py`` [scripts/build_index.py],
  ``index/eval_recall.py`` [scripts/eval_recall.py],
  ``index/eval_recall_realfeat.py`` [scripts/eval_recall_realfeat.py],
  ``models/train_face_template.py`` [scripts/train_face_template.py],
  ``models/eval_face_detector.py`` [scripts/eval_face_detector.py],
  ``models/eval_face_real_composite.py``
  [scripts/eval_face_real_composite.py],
  ``models/drop_weights.py`` [scripts/drop_weights.py].
"""

from columbiaimagesearch_tpu_torch import device  # noqa: F401  (TF32 off)
from columbiaimagesearch_tpu_torch.index.exhaustive_adc import (
    ExhaustiveADC,
    ExhaustiveADCSearcher,
)
from columbiaimagesearch_tpu_torch.index.model import (
    LOPQCode,
    LOPQModel,
    LOPQModelPCA,
)
from columbiaimagesearch_tpu_torch.index.searcher import (
    LOPQSearcher,
    LOPQSearcherTorch,
)

__all__ = ["ExhaustiveADC", "ExhaustiveADCSearcher", "LOPQCode", "LOPQModel",
           "LOPQModelPCA", "LOPQSearcher", "LOPQSearcherTorch"]
