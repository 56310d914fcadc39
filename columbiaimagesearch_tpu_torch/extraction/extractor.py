"""Extraction: image buffer(s) -> encoded feature columns (port of
columbiaimagesearch_tpu/extraction/extractor.py:1-219).

Same column conventions as the reference
(reference: cufacesearch/extractor/generic_extractor.py:17-24,165-255):
extraction string ``<featurizer>_feat_<detector>_<input>``, per-bbox feature
columns ``<col>:<extr>_<left>_<top>_<right>_<bottom>_<score>`` and the
``_processed`` / ``_failed`` markers; ``process_batch`` decodes on the
host (or, on the default device-decode route, entropy-decodes JPEGs on
the host and reconstructs them on the device) and runs one batched device
forward for all images, or with a face detector one detection per image
and one embedder forward for all chips.
"""

from columbiaimagesearch_tpu_torch.extraction.detector import (
    get_bbox_str,
    get_detector,
)
from columbiaimagesearch_tpu_torch.extraction.featsio import (
    get_feat_dtype,
    normfeatB64encode,
)
from columbiaimagesearch_tpu_torch.imgio.imgio import load_image_from_buffer

EXTR_STR_PROCESSED = "processed"
EXTR_STR_FAILED = "failed"


def build_extr_str(featurizer_type, detector_type, input_type):
    return "_".join([featurizer_type, "feat", detector_type, input_type])


def build_extr_str_processed(featurizer_type, detector_type, input_type):
    return build_extr_str(featurizer_type, detector_type, input_type) \
        + "_" + EXTR_STR_PROCESSED


def build_extr_str_failed(featurizer_type, detector_type, input_type):
    return build_extr_str(featurizer_type, detector_type, input_type) \
        + "_" + EXTR_STR_FAILED


def get_featurizer(featurizer_type, params=None, device_decode=True,
                   device=None):
    """Factory (reference: featurizer/generic_featurizer.py:5-41).

    ``device_decode=True`` (default, as in the JAX package,
    extractor.py:41-48): the production route — the host only
    entropy-decodes the JPEGs and the device reconstructs them
    (models/jpeg_device.py); other images take the host pixel route. It
    raises when the coefficient reader does not build. ``device``: where
    the featurizer runs (default: the first card; raises without one)."""
    if featurizer_type in ("sbpycaffe", "sentibank"):
        from columbiaimagesearch_tpu_torch.models.sentibank import (
            SentibankFeaturizer,
        )

        return SentibankFeaturizer(params=params,
                                   device_decode=device_decode,
                                   device=device)
    elif featurizer_type in ("dlib", "face"):
        from columbiaimagesearch_tpu_torch.models.face import FaceEmbedder

        return FaceEmbedder(params=params, device=device)
    raise ValueError(f"[get_featurizer: error] unknown featurizer {featurizer_type}")


def get_feat_size(featurizer_type):
    """Feature dimensionality (reference: generic_featurizer.py:43-56)."""
    if featurizer_type in ("sbpycaffe", "sbcmdline", "sentibank"):
        return 4096
    elif featurizer_type in ("dlib", "face"):
        return 128
    raise ValueError(f"[get_feat_size: error] unknown featurizer {featurizer_type}")


class GenericExtractor:
    """Detector + featurizer -> output column dict per image."""

    def __init__(self, detector_type, featurizer_type, input_type="image",
                 extr_column="ext", detector=None, featurizer=None,
                 device=None):
        self.detector_type = detector_type
        self.featurizer_type = featurizer_type
        self.input_type = input_type
        self.extr_column = extr_column
        self.detector = (detector if detector is not None
                         else get_detector(detector_type, device=device))
        self.featurizer = (featurizer if featurizer is not None
                           else get_featurizer(featurizer_type,
                                               device=device))
        base = build_extr_str(featurizer_type, detector_type, input_type)
        self.extr_str = f"{extr_column}:{base}"
        self.extr_str_processed = \
            f"{extr_column}:{build_extr_str_processed(featurizer_type, detector_type, input_type)}"
        self.extr_str_failed = \
            f"{extr_column}:{build_extr_str_failed(featurizer_type, detector_type, input_type)}"

    def init_out_dict(self):
        return {self.extr_str_processed: str(0)}

    def failed_out_dict(self):
        return {self.extr_str_failed: str(1)}

    def process_buffer(self, img_buffer):
        """One image buffer -> column dict
        (reference: generic_extractor.py:211-255)."""
        return self.process_batch([img_buffer])[0]

    def process_batch(self, img_buffers):
        """Batch of buffers -> list of column dicts, one device pass.

        Inputs may also be pre-decoded pixel arrays (HWC uint8 numpy);
        they skip straight to the batched featurizer through the same
        column path (extractor.py:112-219)."""
        import numpy as _np

        dtype = get_feat_dtype(self.featurizer_type)
        outs = [self.init_out_dict() for _ in img_buffers]
        any_pixels = any(isinstance(b, _np.ndarray) for b in img_buffers)

        if (self.detector is None and any_pixels
                and not all(isinstance(b, _np.ndarray)
                            for b in img_buffers)
                and hasattr(self.featurizer, "featurize_buffers")):
            # Mixed batch: split by input kind, process each sub-batch on
            # its own fast path, merge back in order.
            pix = [i for i, b in enumerate(img_buffers)
                   if isinstance(b, _np.ndarray)]
            enc = [i for i, b in enumerate(img_buffers)
                   if not isinstance(b, _np.ndarray)]
            enc_out = self.process_batch([img_buffers[i] for i in enc])
            pix_out = self.process_batch([img_buffers[i] for i in pix])
            for j, i in enumerate(enc):
                outs[i] = enc_out[j]
            for j, i in enumerate(pix):
                outs[i] = pix_out[j]
            return outs

        # Fast path: encoded buffers go straight through the batched
        # decode pipeline.
        if (self.detector is None and not any_pixels
                and hasattr(self.featurizer, "featurize_buffers")):
            raws = []
            for buf in img_buffers:
                if hasattr(buf, "seek"):
                    buf.seek(0)
                    raws.append(buf.read())
                else:
                    raws.append(bytes(buf))
            feats, status = self.featurizer.featurize_buffers(raws)
            retry = []
            for i, st in enumerate(status):
                if st != 0:
                    retry.append(i)
                else:
                    outs[i][self.extr_str] = \
                        normfeatB64encode(feats[i].astype(dtype))
                    outs[i][self.extr_str_processed] = str(1)
            # Formats the native decoder doesn't cover (e.g. GIF) retry via
            # the PIL path before being marked failed.
            if retry:
                import io

                good, good_imgs = [], []
                for i in retry:
                    try:
                        good_imgs.append(
                            load_image_from_buffer(io.BytesIO(raws[i])))
                        good.append(i)
                    except Exception:  # noqa: BLE001 — undecodable input
                        outs[i] = self.failed_out_dict()
                if good:
                    rfeats = self.featurizer.featurize_batch(good_imgs)
                    for j, i in enumerate(good):
                        outs[i][self.extr_str] = \
                            normfeatB64encode(rfeats[j].astype(dtype))
                        outs[i][self.extr_str_processed] = str(1)
            return outs

        imgs = []
        ok = []
        for i, buf in enumerate(img_buffers):
            if isinstance(buf, _np.ndarray):
                imgs.append(buf)
                ok.append(i)
                continue
            try:
                imgs.append(load_image_from_buffer(buf))
                ok.append(i)
            except Exception:  # noqa: BLE001 — undecodable input
                outs[i] = self.failed_out_dict()

        if not ok:
            return outs

        if self.detector is not None:
            # Detect per image (host pyramid and NMS), then embed ALL
            # chips in one forward.
            from columbiaimagesearch_tpu_torch.models.face import (
                extract_chip,
            )

            all_chips, owners, all_dets = [], [], []
            for j, i in enumerate(ok):
                for det in self.detector.detect_from_img(imgs[j]):
                    all_chips.append(extract_chip(imgs[j], det))
                    owners.append(i)
                    all_dets.append(det)
            if all_chips:
                feats = self.featurizer.featurize_chips(all_chips)
                for feat, i, det in zip(feats, owners, all_dets):
                    outs[i][self.extr_str_processed] = str(1)
                    outs[i][f"{self.extr_str}_{get_bbox_str(det)}"] = \
                        normfeatB64encode(feat.astype(dtype))
            return outs

        feats = self.featurizer.featurize_batch(imgs)
        for j, i in enumerate(ok):
            outs[i][self.extr_str] = \
                normfeatB64encode(feats[j].astype(dtype))
            outs[i][self.extr_str_processed] = str(1)
        return outs
