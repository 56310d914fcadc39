"""The port's weights-drop gate (``models/drop_weights.py``) against
scripts/drop_weights.py on the CPU: each drop format, written from seeded
blobs, converts to the JAX conversion carried across
(``sentibank.from_flax_params``; the dlib params as arrays), and
``--dry-run --cpu`` passes every gate."""

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch.models import drop_weights, sentibank


@pytest.fixture(scope="module")
def blobs(tmp_path_factory):
    return drop_weights.write_dry_run_blobs(str(tmp_path_factory.mktemp("b")))


def _assert_state_dicts_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(torch.as_tensor(got[k]).numpy(),
                                      torch.as_tensor(want[k]).numpy())


def _flat(params, prefix=""):
    if isinstance(params, dict):
        out = {}
        for k, v in params.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(params, (list, tuple)):
        out = {}
        for i, v in enumerate(params):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): np.asarray(params)}


def test_sentibank_formats_equal_the_jax_conversion(blobs, tmp_path):
    from scripts.drop_weights import load_sentibank_any as jax_load

    sb_path, _ = blobs
    want = sentibank.from_flax_params(jax_load(sb_path))
    got = drop_weights.load_sentibank_any(sb_path)
    _assert_state_dicts_equal(got, want)
    with np.load(sb_path) as z:      # the blob export is caffe's layout
        np.testing.assert_array_equal(got["conv1.weight"].numpy(),
                                      z["conv1.w"].astype(np.float32))
    flat = str(tmp_path / "flat.npz")
    sentibank.save_weights_npz(got, flat)
    _assert_state_dicts_equal(drop_weights.load_sentibank_any(flat), want)
    pt = str(tmp_path / "sd.pt")
    torch.save({("fc8" if k.startswith("fc8_t") else k.split(".")[0])
                + "." + k.split(".")[1]: v for k, v in got.items()}, pt)
    _assert_state_dicts_equal(drop_weights.load_sentibank_any(pt), want)
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, nope=np.zeros(2))
    with pytest.raises(SystemExit, match="unrecognized sentibank"):
        drop_weights.load_sentibank_any(bad)


def test_dlib_formats_equal_the_jax_conversion(blobs, tmp_path):
    from columbiaimagesearch_tpu_torch.models.face_dlib import save_params_npz

    from scripts.drop_weights import load_dlib_any as jax_load

    _, dl_path = blobs
    want = _flat(jax_load(dl_path))
    got = drop_weights.load_dlib_any(dl_path)
    flat = _flat(got)
    assert set(flat) == set(want) and len(flat) == 1 + 3 + 6 * 14
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k])
    conv = str(tmp_path / "dl.npz")
    save_params_npz(got, conv)
    for k, v in _flat(drop_weights.load_dlib_any(conv)).items():
        np.testing.assert_array_equal(v, want[k])
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, nope=np.zeros(2))
    with pytest.raises(SystemExit, match="unrecognized dlib"):
        drop_weights.load_dlib_any(bad)


def test_dry_run_passes_on_the_cpu(monkeypatch, tmp_path):
    """Every gate passes on self-recorded features, and the auto-load
    paths the dry run points into its directory are restored."""
    monkeypatch.setenv(sentibank.WEIGHTS_ENV, str(tmp_path / "keep.npz"))
    monkeypatch.delenv("DLIB_FACE_WEIGHTS", raising=False)
    drop_weights.main(["--dry-run", "--cpu"])
    import os

    assert os.environ[sentibank.WEIGHTS_ENV] == str(tmp_path / "keep.npz")
    assert "DLIB_FACE_WEIGHTS" not in os.environ
    with pytest.raises(SystemExit, match="nothing to do"):
        drop_weights.main(["--cpu"])
