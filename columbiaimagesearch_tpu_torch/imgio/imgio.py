"""Copy of columbiaimagesearch_tpu/imgio/imgio.py:1-121 (PIL and requests
imported lazily).

Image I/O: buffers from URL/B64/file, SHA1 hashing, robust decode.

Python-3 re-design of the reference's imgio module
(reference: cufacesearch/cufacesearch/imgio/imgio.py:114-259): same surface
(buffer getters, sha1+info extraction, GIF/alpha-safe loading) with
``io.BytesIO`` instead of cStringIO and PIL header parsing instead of the
hand-rolled format sniffing.
"""

import base64
import hashlib
import io

import numpy as np

DEFAULT_RETRIES = 3
DEFAULT_BACKOFF = 0.3
DEFAULT_STATUS_FORCELIST = (500, 502, 503, 504)


class UnknownImageFormat(Exception):
    pass


def get_SHA1_from_data(data: bytes) -> str:
    """Uppercase SHA1 hex digest of raw bytes (the reference's image id
    convention)."""
    return hashlib.sha1(data).hexdigest().upper()


def get_SHA1_from_buffer(img_buffer) -> str:
    img_buffer.seek(0)
    return get_SHA1_from_data(img_buffer.read())


def get_image_size_and_format(img_buffer):
    """(width, height, format) from the image header.

    PIL lazily parses only the header, replacing the reference's manual
    GIF/PNG/JPEG sniffing (imgio.py:33-111).
    """
    from PIL import Image

    img_buffer.seek(0)
    head = img_buffer.read(64)
    img_buffer.seek(0)
    if head.startswith(b"<?xml") or head.lstrip()[:4] == b"<svg":
        raise UnknownImageFormat("SVG dimensions are not defined in pixels")
    try:
        with Image.open(img_buffer) as im:
            return im.width, im.height, im.format
    except Exception as err:
        raise UnknownImageFormat(
            f"{err.__class__.__name__}: could not parse image header") from err


def get_SHA1_img_info_from_buffer(img_buffer):
    """(sha1, img_type, width, height) of a buffer."""
    width, height, img_type = get_image_size_and_format(img_buffer)
    img_buffer.seek(0)
    sha1 = get_SHA1_from_data(img_buffer.read())
    return sha1, img_type, width, height


def get_SHA1_img_type_from_B64(base64str):
    img_buffer = get_buffer_from_B64(base64str)
    sha1, img_type, _, _ = get_SHA1_img_info_from_buffer(img_buffer)
    return sha1, img_type


def buffer_to_B64(img_buffer) -> bytes:
    img_buffer.seek(0)
    return base64.b64encode(img_buffer.read())


def get_buffer_from_B64(base64str):
    return io.BytesIO(base64.b64decode(base64str))


def get_buffer_from_filepath(filepath):
    with open(filepath, "rb") as f_in:
        return io.BytesIO(f_in.read())


def get_buffer_from_URL(img_url, verbose=0, image_dl_timeout=4,
                        retries=DEFAULT_RETRIES):
    """Fetch an image over HTTP with retry/backoff
    (reference: imgio.py:13-20,197-237)."""
    import requests
    from requests.adapters import HTTPAdapter
    from urllib3.util import Retry

    if verbose > 0:
        print(f"Downloading image from {img_url}")
    session = requests.Session()
    if retries:
        retry = Retry(total=retries, backoff_factor=DEFAULT_BACKOFF,
                      status_forcelist=DEFAULT_STATUS_FORCELIST)
        session.mount("http://", HTTPAdapter(max_retries=retry))
        session.mount("https://", HTTPAdapter(max_retries=retry))
    req = session.get(img_url, timeout=image_dl_timeout)
    if req.status_code != 200:
        raise ValueError(f"Incorrect status code: {req.status_code}")
    if int(req.headers.get("content-length", -1)) == 0:
        raise ValueError("Empty image.")
    return io.BytesIO(req.content)


def load_image_from_buffer(img_buffer):
    """Decode to an RGB uint8 ndarray; GIF- and alpha-safe
    (reference: imgio.py:241-259 — animated GIFs use frame 1, PNG alpha is
    dropped)."""
    from PIL import Image

    img_buffer.seek(0)
    im = Image.open(img_buffer)
    if getattr(im, "is_animated", False) and im.n_frames > 1:
        im.seek(1)  # reference takes the *second* frame of animated GIFs
    if im.mode != "RGB":
        im = im.convert("RGB")
    return np.asarray(im)
