"""Detector facades (port of columbiaimagesearch_tpu/extraction/detector.py:
``GenericDetector`` :25-68, ``FaceDetector`` :65-73, ``get_detector`` :76,
``get_bbox_str`` :87).

``get_detector("full")`` is None: whole-image featurization, the release
configuration. ``get_detector("face")`` (or its alias ``"dlib"``) is the
conv-HOG detector of models/face_detector.py behind the buffer/URL/B64/file
plumbing, on ``device`` (default: the first card; raises without one).
"""

from columbiaimagesearch_tpu_torch.imgio.imgio import (
    get_buffer_from_B64,
    get_buffer_from_filepath,
    get_buffer_from_URL,
    get_SHA1_img_info_from_buffer,
    load_image_from_buffer,
)

DEFAULT_IMAGE_DL_TIMEOUT = 1
DEFAULT_UPSAMPLING = 1


class GenericDetector:
    """Base class: buffer/URL/B64/file entry points around
    ``detect_from_img``."""

    def detect_from_filepath(self, img_file_path, up_sample=DEFAULT_UPSAMPLING,
                             with_infos=True):
        buf = get_buffer_from_filepath(img_file_path)
        if with_infos:
            return self.detect_from_buffer(buf, up_sample=up_sample)
        return self.detect_from_buffer_noinfos(buf, up_sample=up_sample)

    def detect_from_url(self, img_url, up_sample=DEFAULT_UPSAMPLING,
                        image_dl_timeout=DEFAULT_IMAGE_DL_TIMEOUT,
                        with_infos=True):
        buf = get_buffer_from_URL(img_url, image_dl_timeout=image_dl_timeout)
        if with_infos:
            return self.detect_from_buffer(buf, up_sample=up_sample)
        return self.detect_from_buffer_noinfos(buf, up_sample=up_sample)

    def detect_from_b64(self, img_base64str, up_sample=DEFAULT_UPSAMPLING,
                        with_infos=True):
        buf = get_buffer_from_B64(img_base64str)
        if with_infos:
            return self.detect_from_buffer(buf, up_sample=up_sample)
        return self.detect_from_buffer_noinfos(buf, up_sample=up_sample)

    def detect_from_buffer(self, img_buffer, up_sample=DEFAULT_UPSAMPLING):
        """:returns: (sha1, img_type, width, height), img, detections"""
        sha1, img_type, width, height = get_SHA1_img_info_from_buffer(img_buffer)
        img, detections = self.detect_from_buffer_noinfos(
            img_buffer, up_sample=up_sample)
        return (sha1, img_type, width, height), img, detections

    def detect_from_buffer_noinfos(self, img_buffer, up_sample=DEFAULT_UPSAMPLING):
        """:returns: img, detections"""
        img = load_image_from_buffer(img_buffer)
        return img, self.detect_from_img(img, up_sample=up_sample)

    def detect_from_img(self, img, up_sample=DEFAULT_UPSAMPLING):
        raise NotImplementedError()


class FaceDetector(GenericDetector):
    """The conv-HOG face detector behind the GenericDetector plumbing; it
    fills the role of the reference's DLibFaceDetector."""

    def __init__(self, model=None, device=None):
        from columbiaimagesearch_tpu_torch.models.face_detector import (
            ConvHOGFaceDetector,
        )

        self.model = (model if model is not None
                      else ConvHOGFaceDetector(device=device))

    def detect_from_img(self, img, up_sample=DEFAULT_UPSAMPLING):
        return self.model.detect_from_img(img, up_sample=up_sample)


def get_detector(detector_type, device=None):
    """Factory (reference: detector/utils.py:100-112): 'full' means no
    detector (whole-image featurization). 'dlib' is accepted as an alias of
    'face' for conf compatibility. ``device``: where the face detector
    runs (default: the first card; raises without one)."""
    if detector_type in ("face", "dlib"):
        return FaceDetector(device=device)
    elif detector_type == "full":
        return None
    raise ValueError(f"[get_detector: error] unknown 'detector' {detector_type}.")


def get_bbox_str(bbox):
    """left_top_right_bottom_score string
    (reference: detector/utils.py:114-124)."""
    return "_".join(str(v) for v in
                    [bbox["left"], bbox["top"], bbox["right"], bbox["bottom"],
                     bbox["score"]])
