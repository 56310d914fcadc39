"""DeepSentibank in PyTorch — the 4096-d image featurizer (port of
columbiaimagesearch_tpu/models/sentibank.py:35-487).

Architecture from the reference prototxt
(reference: cufacesearch/featurizer/data/pycaffe_sentibank.prototxt): an
AlexNet variant with grouped convolutions (``groups=2``), across-channel
LRN and ceil-mode pools, 2089 ANP classes; the feature is the post-ReLU
fc7 activation (sbpycaffe_img_featurizer.py:41,152-154). The net runs in
NCHW, so Caffe's NCHW flatten before fc6 needs no transpose; the convs
and fully connected layers are ``torch.nn`` Conv2d/Linear, i.e. the
``torch.nn.functional`` conv/linear (the JAX package runs them through
XLA, outside any Pallas kernel).

Weights: the port's parameters are a state dict keyed ``<layer>.weight`` /
``<layer>.bias`` in PyTorch layouts (OIHW convs, [out, in] linears), which
are Caffe's layouts. :func:`from_flax_params` carries the JAX package's
parameters across (HWIO -> OIHW, [in, out] -> [out, in]), and
:func:`save_weights_npz` / :func:`load_weights_npz` read and write the JAX
npz key layout (``<layer>/kernel|bias`` in flax layouts), so one file
serves both packages.
"""

import os
import threading

import numpy as np
import torch

from columbiaimagesearch_tpu_torch.device import resolve_device
from columbiaimagesearch_tpu_torch.models.layers import caffe_max_pool, lrn
from columbiaimagesearch_tpu_torch.models.preprocess import (
    TARGET,
    default_mean_image,
    preprocess_batch,
    preprocess_device,
)

FEATURE_DIM = 4096
NUM_ANP_CLASSES = 2089
INPUT_SIZE = 227

#: (name, out channels, in channels per group, kernel, stride, padding,
#: groups) of each conv (prototxt conv1..conv5)
_CONVS = (("conv1", 96, 3, 11, 4, 0, 1),
          ("conv2", 256, 48, 5, 1, 2, 2),
          ("conv3", 384, 256, 3, 1, 1, 1),
          ("conv4", 384, 192, 3, 1, 1, 2),
          ("conv5", 256, 192, 3, 1, 1, 2))
#: (name, out features, in features) of each fully connected layer
_FCS = (("fc6", 4096, 256 * 6 * 6),
        ("fc7", 4096, 4096),
        ("fc8_t", NUM_ANP_CLASSES, 4096))
LAYERS = tuple(c[0] for c in _CONVS) + tuple(f[0] for f in _FCS)


class DeepSentibank(torch.nn.Module):
    """Sentibank CaffeNet. Input: [N, 3, 227, 227] float, BGR,
    mean-subtracted, 0..255 scale. ``forward`` returns the ANP logits,
    :meth:`features` the 4096-d fc7."""

    def __init__(self, device="cpu", dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        for name, out_c, in_c, k, stride, pad, groups in _CONVS:
            setattr(self, name, torch.nn.Conv2d(
                in_c * groups, out_c, k, stride=stride, padding=pad,
                groups=groups, **kw))
        for name, out_f, in_f in _FCS:
            setattr(self, name, torch.nn.Linear(in_f, out_f, **kw))
        self.requires_grad_(False)

    @classmethod
    def from_state_dict(cls, state_dict, device="cpu", dtype=torch.float32):
        """The net on ``device`` in ``dtype``, with the weights of a state
        dict (see the module docstring). No random init runs."""
        net = cls(device="meta", dtype=dtype)
        net.load_state_dict({k: torch.as_tensor(v).to(device=device,
                                                       dtype=dtype)
                             for k, v in state_dict.items()}, assign=True)
        return net.requires_grad_(False)

    def features(self, x):
        """[N, 3, 227, 227] -> post-ReLU fc7 [N, 4096]."""
        relu = torch.relu
        x = lrn(caffe_max_pool(relu(self.conv1(x)), 3, 2), 5, 1e-4, 0.75)
        x = lrn(caffe_max_pool(relu(self.conv2(x)), 3, 2), 5, 1e-4, 0.75)
        x = relu(self.conv3(x))
        x = relu(self.conv4(x))
        x = caffe_max_pool(relu(self.conv5(x)), 3, 2)      # [N, 256, 6, 6]
        x = relu(self.fc6(x.flatten(1)))                   # Caffe's order
        return relu(self.fc7(x))

    def forward(self, x):
        return self.fc8_t(self.features(x))


# ------------------------------------------------------------------ weights


def init_params(seed: int = 0):
    """Random weights from an explicit ``torch.Generator``: LeCun normal
    kernels (std 1/sqrt(fan_in), flax's default) and zero biases. The
    values differ from the JAX package's ``init_params`` (another RNG)."""
    g = torch.Generator()
    g.manual_seed(int(seed))
    sd = {}
    for name, out_c, in_c, k, *_ in _CONVS:
        sd[f"{name}.weight"] = torch.randn(out_c, in_c, k, k, generator=g) \
            / float(in_c * k * k) ** 0.5
        sd[f"{name}.bias"] = torch.zeros(out_c)
    for name, out_f, in_f in _FCS:
        sd[f"{name}.weight"] = torch.randn(out_f, in_f, generator=g) \
            / float(in_f) ** 0.5
        sd[f"{name}.bias"] = torch.zeros(out_f)
    return sd


def _is_conv(layer):
    return layer.startswith("conv")


def from_flax_params(params):
    """The JAX package's params (``{layer: {"kernel", "bias"}}``, any array
    type numpy can read) -> the port's state dict: HWIO conv kernels ->
    OIHW, [in, out] dense kernels -> [out, in]."""
    sd = {}
    for layer in LAYERS:
        kernel = np.asarray(params[layer]["kernel"], dtype=np.float32)
        kernel = (np.transpose(kernel, (3, 2, 0, 1)) if _is_conv(layer)
                  else kernel.T)
        sd[f"{layer}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel))
        sd[f"{layer}.bias"] = torch.from_numpy(
            np.asarray(params[layer]["bias"], dtype=np.float32).copy())
    return sd


_CAFFE_LAYER_MAP = {"conv1": "conv1", "conv2": "conv2", "conv3": "conv3",
                    "conv4": "conv4", "conv5": "conv5", "fc6": "fc6",
                    "fc7": "fc7", "fc8-t": "fc8_t"}


def load_caffe_weights(blobs: dict):
    """Caffe blobs (layer -> (weights, bias); conv [out, in/g, kh, kw], fc
    [out, in], as pycaffe's ``net.params[name][i].data``) -> state dict.
    Caffe's layouts are PyTorch's, so nothing is transposed
    (sentibank.py:129-152)."""
    sd = {}
    for caffe_name, name in _CAFFE_LAYER_MAP.items():
        if caffe_name not in blobs:
            raise KeyError(f"missing caffe layer {caffe_name}")
        w, b = blobs[caffe_name]
        sd[f"{name}.weight"] = torch.from_numpy(
            np.array(w, dtype=np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(np.array(b, dtype=np.float32))
    return sd


def load_torch_weights(state_dict):
    """A torch state dict of Conv2d/Linear modules named conv1..conv5,
    fc6, fc7, fc8 -> the port's state dict (sentibank.py:206-223)."""
    def get(name):
        return (state_dict[f"{name}.weight"].detach().cpu().numpy(),
                state_dict[f"{name}.bias"].detach().cpu().numpy())

    blobs = {n: get(n) for n in
             ["conv1", "conv2", "conv3", "conv4", "conv5", "fc6", "fc7"]}
    blobs["fc8-t"] = get("fc8")
    return load_caffe_weights(blobs)


WEIGHTS_ENV = "SENTIBANK_WEIGHTS"


def default_weights_path():
    """Pretrained-weights location: $SENTIBANK_WEIGHTS (the variable the
    JAX package reads too) or ``<package>/models/weights/sentibank.npz``
    (sentibank.py:158-171)."""
    env = os.environ.get(WEIGHTS_ENV)
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "weights", "sentibank.npz")


def save_weights_npz(params, path):
    """Persist a state dict as the JAX package's flat npz (keys
    ``<layer>/kernel|bias``, flax layouts: HWIO convs, [in, out] dense)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = {}
    for layer in LAYERS:
        w = torch.as_tensor(params[f"{layer}.weight"]).detach().cpu().numpy()
        flat[f"{layer}/kernel"] = (np.transpose(w, (2, 3, 1, 0))
                                   if _is_conv(layer) else w.T)
        flat[f"{layer}/bias"] = torch.as_tensor(
            params[f"{layer}.bias"]).detach().cpu().numpy()
    np.savez(path, **flat)


def load_weights_npz(path):
    """Load an npz in the JAX key layout (either package's
    ``save_weights_npz``) as the port's state dict."""
    with np.load(path) as z:
        params = {}
        for key in z.files:
            layer, k = key.split("/")
            params.setdefault(layer, {})[k] = z[key]
    return from_flax_params(params)


def load_default_weights():
    """Pretrained weights from the conventional path, or None."""
    path = default_weights_path()
    if path and os.path.exists(path):
        return load_weights_npz(path)
    return None


# --------------------------------------------------------------- featurizer


class SentibankFeaturizer:
    """Image in, 4096-d float32 fc7 out (reference:
    featurizer/sbpycaffe_img_featurizer.py ``featurize``), batched, with
    the JAX featurizer's method set (sentibank.py:226-487).

    The forward runs under ``torch.inference_mode`` on every route: grad
    mode is per thread, and serving calls the featurizer from the
    coalescer's and the HTTP handlers' threads.
    """

    feat_size = FEATURE_DIM
    feat_type = "sbpycaffe"

    #: Chunk size for the pipelined buffers path (sentibank.py:282-285).
    PIPELINE_CHUNK = 256

    def __init__(self, params=None, mean_image=None, seed: int = 0,
                 compute_dtype="float32", dct_scale: bool = True,
                 device_decode: bool = False, device=None):
        """:param params: state dict (see module docstring); None loads
            :func:`load_default_weights`, else seeded random weights
        :param compute_dtype: "float32" or "bfloat16" (features are
            returned as float32 either way)
        :param dct_scale: DCT-scaled JPEG decode in the native pipeline
        :param device_decode: the coefficient route: the host only
            entropy-decodes the wave's dominant-size 4:2:0 JPEGs and the
            device reconstructs them (``models/jpeg_device.py``); other
            images take the pixel route
        :param device: torch device; default: the first card (raises
            when there is none: pass ``device="cpu"`` for the CPU)
        :raises RuntimeError: ``device_decode`` and the coefficient reader
            did not build (the JAX featurizer quietly takes the pixel
            route instead)
        """
        if device_decode:
            from columbiaimagesearch_tpu_torch.native.imgpipe import (
                coeffs_available,
                coeffs_build_error,
            )

            if not coeffs_available():
                raise RuntimeError(
                    "device_decode needs the JPEG coefficient reader "
                    "(native/csrc/jpegcoef.cpp), which did not build: "
                    f"{coeffs_build_error()}")
        dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
        if compute_dtype not in dtypes:
            raise ValueError(f"compute_dtype {compute_dtype!r}: float32 or "
                             "bfloat16")
        self.dct_scale = dct_scale
        self.device_decode = bool(device_decode)
        self.device = resolve_device(device)
        self._coeff_decoder = None
        #: images per route ("coeffs", "pixels") since construction
        self.route_counts = {"coeffs": 0, "pixels": 0}
        self._route_lock = threading.Lock()
        if params is None:
            params = load_default_weights()
        self.pretrained = params is not None
        self.params = params if params is not None else init_params(seed)
        self.compute_dtype = compute_dtype
        self._dtype = dtypes[compute_dtype]
        self.net = DeepSentibank.from_state_dict(self.params, self.device,
                                                 self._dtype)
        self.mean = (np.asarray(mean_image, dtype=np.float32)
                     if mean_image is not None else default_mean_image())
        self._mean_dev = torch.as_tensor(self.mean).to(self.device)

    @torch.inference_mode()
    def _forward(self, x):
        """Preprocessed [N, 3, 227, 227] -> fc7 [N, 4096] float32."""
        return self.net.features(x.to(self._dtype)).to(torch.float32)

    def featurize(self, img, bbox=None):
        """Single image -> 4096-d feature (bbox ignored, like the
        reference)."""
        del bbox
        return self.featurize_batch([img])[0]

    def featurize_batch(self, imgs):
        """HxWx3 uint8 RGB images (any sizes) -> [N, 4096] numpy."""
        x = preprocess_batch(imgs, self.mean, self.device)
        return self._forward(x).cpu().numpy()

    def featurize_buffers(self, buffers):
        """Encoded JPEG/PNG buffers -> ([N, 4096] numpy feats, status[N]).

        Batches larger than PIPELINE_CHUNK run double-buffered: a
        decode-ahead thread decodes chunk i+1 while chunk i runs on the
        device (sentibank.py:287-321)."""
        n = len(buffers)
        chunk = self.PIPELINE_CHUNK
        if n <= chunk:
            feats, status = self.featurize_buffers_device(buffers)
            return feats.cpu().numpy(), status
        from concurrent.futures import ThreadPoolExecutor

        waves, status_all = [], []
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(self.prepare_wave, buffers[:chunk])
            i = 0
            while i < n:
                prep = fut.result()
                nxt = i + chunk
                if nxt < n:
                    fut = pool.submit(self.prepare_wave,
                                      buffers[nxt:nxt + chunk])
                feats_d, nv, status = self.run_wave(prep)
                waves.append((feats_d, nv))
                status_all.extend(status)
                i = nxt
        feats = np.concatenate([f[:nv].cpu().numpy() for f, nv in waves])
        return feats, status_all

    def featurize_buffers_device(self, buffers):
        """Like :meth:`featurize_buffers`, but the features stay on the
        device (a tensor) for ``search_device_feats``."""
        feats, n, status = self.featurize_wave(buffers)
        return feats[:n], status

    def featurize_wave(self, buffers):
        """Serving-wave featurize: buffers -> (feats [n, 4096] on the
        device, n, status [n]). Host decode and resize (or the coefficient
        read and the device reconstruction), then one device pass
        (preprocess + forward). The JAX featurizer pads the wave to a
        bucket size for its compiled programs; nothing here compiles per
        shape, so the wave is not padded."""
        return self.run_wave(self.prepare_wave(buffers))

    def prepare_wave(self, buffers):
        """Host half of a wave (the decode-ahead thread or a server
        handler thread): pixel decode, or with ``device_decode`` the
        coefficient read. Returns a prep for :meth:`run_wave`: (kind, a
        payload dict whose "status" [n] is every image's decode status)
        (sentibank.py:342-353)."""
        if not self.device_decode:
            return self._pixel_prep(buffers)
        return self._prepare_coeff_wave(buffers)

    def run_wave(self, prep):
        """Device half: prep -> (feats [n, 4096] on the device, n,
        status [n])."""
        return self.featurize_preps([prep])

    def featurize_preps(self, preps):
        """Several preps (one a request, from the serving handlers) -> one
        forward: (feats [n, 4096] on the device, n, status [n]) in the
        order of the preps. Each prep's pixels are made first (the
        coefficient route reconstructs them on the device)."""
        stacks, status = [], []
        for prep in preps:
            stack, st = self.wave_pixels(prep)
            stacks.append(stack)
            status.extend(st)
        if len(stacks) == 1:
            stack = stacks[0]
        elif all(isinstance(x, np.ndarray) for x in stacks):
            stack = np.concatenate(stacks)
        else:
            stack = torch.cat([torch.as_tensor(x).to(self.device)
                               for x in stacks])
        feats, n = self.featurize_pixel_wave(stack)
        return feats, n, status

    def wave_pixels(self, prep):
        """A prep's staging pixels: ([n, 256, 256, 3] uint8 — a host array
        on the pixel route, a device tensor on the coefficient route, which
        reconstructs them — and status [n])."""
        kind, payload = prep
        if kind == "pixels":
            return payload["stack"], payload["status"]
        return self._coeff_pixels(payload)

    def _count(self, coeffs, pixels):
        with self._route_lock:
            self.route_counts["coeffs"] += coeffs
            self.route_counts["pixels"] += pixels

    def _pixel_prep(self, buffers):
        stack, status = self.decode_wave(buffers)
        self._count(0, len(buffers))
        return ("pixels", {"stack": stack, "status": list(status)})

    def _prepare_coeff_wave(self, buffers):
        """Coefficient route (sentibank.py:372-416): entropy-decode the
        wave's dominant-size 4:2:0 JPEGs, which the device reconstructs;
        everything else (non-JPEG, other subsampling, minority sizes, a
        failed read) takes the host pixel route. One block grid a wave,
        made even so that the 4:2:0 chroma grid (bh/2) fits."""
        from collections import Counter

        from columbiaimagesearch_tpu_torch.models.jpeg_device import (
            pick_msub,
        )
        from columbiaimagesearch_tpu_torch.native.imgpipe import (
            jpeg_dims,
            read_coeffs_batch,
        )

        n = len(buffers)
        dims = [jpeg_dims(b) for b in buffers]
        sizes = Counter(d for d in dims if d is not None)
        if not sizes:
            return self._pixel_prep(buffers)
        (h, w), _ = sizes.most_common(1)[0]
        cand = [i for i in range(n) if dims[i] == (h, w)]
        msub = pick_msub(h, w, TARGET)
        bh = -(-h // 8)
        bw = -(-w // 8)
        bh += bh & 1
        bw += bw & 1
        yc, cc, qt, _, st = read_coeffs_batch(
            [buffers[i] for i in cand], msub, bh, bw)
        ok = st == 0
        ok_idx = [i for i, o in zip(cand, ok) if o]
        ok_set = set(ok_idx)
        pix_idx = [i for i in range(n) if i not in ok_set]
        pix_stack, pix_status = (self.decode_wave(
            [buffers[i] for i in pix_idx]) if pix_idx else (None, []))
        status = [0] * n
        for i, s in zip(pix_idx, pix_status):
            status[i] = int(s)
        self._count(len(ok_idx), len(pix_idx))
        payload = {
            "ycoef": yc[ok], "ccoef": cc[ok], "qtab": qt[ok],
            "msub": msub, "h": h, "w": w, "ok_idx": ok_idx,
            "pix_idx": pix_idx, "pix_stack": pix_stack,
            "status": status, "n": n,
        }
        return ("coeffs", payload)

    def _coeff_pixels(self, payload):
        """Device half of the coefficient route (sentibank.py:418-446):
        reconstruct, round half to even to the uint8 staging domain (as
        ``jnp.round``) and put the pixel-route images back in input order.
        Returns ([n, 256, 256, 3] uint8 on the device, status [n])."""
        from columbiaimagesearch_tpu_torch.models.jpeg_device import (
            CoeffDecoder,
        )

        if self._coeff_decoder is None:
            self._coeff_decoder = CoeffDecoder(self.device, target=TARGET)
        n = payload["n"]
        parts, order = [], []
        if payload["ok_idx"]:
            dec = self._coeff_decoder.decode(
                payload["ycoef"], payload["ccoef"], payload["qtab"],
                msub=payload["msub"], h=payload["h"], w=payload["w"])
            parts.append(torch.round(dec).to(torch.uint8))
            order.extend(payload["ok_idx"])
        if payload["pix_idx"]:
            parts.append(torch.from_numpy(np.ascontiguousarray(
                payload["pix_stack"])).to(self.device))
            order.extend(payload["pix_idx"])
        stack = parts[0] if len(parts) == 1 else torch.cat(parts)
        if order != list(range(n)):
            inv = np.empty(n, dtype=np.int64)
            inv[np.asarray(order, dtype=np.int64)] = np.arange(n)
            stack = stack[torch.from_numpy(inv).to(self.device)]
        return stack, payload["status"]

    def decode_wave(self, buffers):
        """Decode + resize only: ([n, 256, 256, 3] uint8 host pixels,
        status). Serving runs this in the handler thread, so request decode
        overlaps the previous wave's device time."""
        from columbiaimagesearch_tpu_torch.native.imgpipe import (
            decode_resize_batch,
        )

        return decode_resize_batch(buffers, TARGET, dct_scale=self.dct_scale)

    def featurize_pixel_wave(self, stack):
        """Device half of :meth:`featurize_wave`: decoded pixels (host
        array or device tensor, [n, 256, 256, 3] uint8) -> (feats
        [n, 4096] on the device, n)."""
        x = stack if isinstance(stack, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(stack))
        x = x.to(self.device)
        return self._forward(preprocess_device(x, self._mean_dev)), len(stack)

