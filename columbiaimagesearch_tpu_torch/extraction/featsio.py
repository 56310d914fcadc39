"""Copy of columbiaimagesearch_tpu/extraction/featsio.py:1-43.

Feature wire encoding: L2-normalize + base64, dtype conventions.

Same surface and conventions as the reference
(reference: cufacesearch/cufacesearch/featurizer/featsio.py:4-54):
sbpycaffe image features are float32, dlib-style face features float64.
"""

import base64

import numpy as np

_FEAT_DTYPES = {
    "sbpycaffe": np.float32,
    "sbcmdline": np.float32,
    "sentibank": np.float32,
    "float32": np.float32,
    "dlib": np.float64,
    "face": np.float64,
    "float64": np.float64,
}


def get_feat_dtype(feat_type: str):
    try:
        return _FEAT_DTYPES[feat_type]
    except KeyError:
        raise ValueError(
            f"[featsio.get_feat_dtype: error] Unknown feature type: {feat_type}")


def featB64encode(feat) -> bytes:
    return base64.b64encode(np.ascontiguousarray(feat).tobytes())


def normfeatB64encode(feat) -> bytes:
    feat = np.asarray(feat)
    norm = np.linalg.norm(feat)
    return featB64encode(feat / norm)


def featB64decode(feat_b64, feat_type=None):
    return np.frombuffer(base64.b64decode(feat_b64),
                         dtype=get_feat_dtype(feat_type))
