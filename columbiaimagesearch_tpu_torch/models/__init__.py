"""Image featurizer of the port: Caffe-semantics layers, preprocessing and
DeepSentibank (port of columbiaimagesearch_tpu/models/)."""

from columbiaimagesearch_tpu_torch.models.sentibank import (
    DeepSentibank,
    SentibankFeaturizer,
)
