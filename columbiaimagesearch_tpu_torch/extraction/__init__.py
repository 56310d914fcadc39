from columbiaimagesearch_tpu_torch.extraction.detector import (
    FaceDetector,
    GenericDetector,
    get_bbox_str,
    get_detector,
)
from columbiaimagesearch_tpu_torch.extraction.extractor import (
    GenericExtractor,
    build_extr_str,
    build_extr_str_failed,
    build_extr_str_processed,
    get_feat_size,
    get_featurizer,
)
from columbiaimagesearch_tpu_torch.extraction.featsio import (
    featB64decode,
    featB64encode,
    get_feat_dtype,
    normfeatB64encode,
)
