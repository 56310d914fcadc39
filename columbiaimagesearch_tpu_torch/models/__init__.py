"""Featurizers of the port: Caffe-semantics layers, preprocessing, the
device JPEG decode (jpeg_device.py) and DeepSentibank; the face detector,
embedders and aligner (face_*.py) (port of
columbiaimagesearch_tpu/models/)."""

from columbiaimagesearch_tpu_torch.models.sentibank import (
    DeepSentibank,
    SentibankFeaturizer,
)
