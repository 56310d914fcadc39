"""The port's procedural renderer (utils/synthimg.py) against the JAX
package's: the parameters ``jax.random`` draws for an image
(synthimg.py:34-51, the same key splits) rendered by the port give the JAX
image within one level (float32 math in another order; the uint8 cast
truncates), and the port's own draw has the JAX distributions' ranges."""

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch.utils import synthimg


def _jax_params(key):
    """synthimg.py:34-51 with the draws returned instead of rendered."""
    import jax
    import jax.numpy as jnp

    ks = jax.random.split(key, 8)
    p = {"base": jax.random.uniform(ks[0], (1, 1, 3)) * 255.0,
         "grad_dir": jax.random.normal(ks[1], (2, 3)),
         "ang": jax.random.uniform(ks[2], (3,)) * jnp.pi,
         "freq": jax.random.uniform(ks[3], (3,), minval=2.0, maxval=40.0),
         "phase": jax.random.uniform(ks[4], (3,)) * 2 * jnp.pi,
         "amp": jax.random.uniform(ks[5], (3, 3)) * 50.0,
         "c": jax.random.uniform(ks[6], (2, 2)),
         "s": jax.random.uniform(ks[7], (2,), minval=0.01, maxval=0.08)}
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("side", [64, 256])
def test_render_matches_jax_on_jax_params(side):
    import jax

    from columbiaimagesearch_tpu.utils.synthimg import make_render_batch

    key = jax.random.PRNGKey(7)
    want = np.asarray(make_render_batch(4, side)(key))
    keys = jax.random.split(key, 4)
    draws = [_jax_params(k) for k in keys]
    params = {k: torch.from_numpy(np.stack([d[k] for d in draws]))
              for k in synthimg.PARAM_SHAPES}
    got = synthimg.render_from_params(params, side).numpy()
    assert got.shape == want.shape == (4, side, side, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 1e-3


def test_own_draw_ranges_and_rectangles():
    g = torch.Generator().manual_seed(3)
    p = synthimg.draw_params(256, g)
    for k, shape in synthimg.PARAM_SHAPES.items():
        assert tuple(p[k].shape) == (256,) + shape
    assert 0 <= p["base"].min() and p["base"].max() < 255
    assert 2 <= p["freq"].min() and p["freq"].max() < 40
    assert 0.01 <= p["s"].min() and p["s"].max() < 0.08
    imgs = synthimg.make_render_batch(3, height=48, width=64, device="cpu")(
        torch.Generator().manual_seed(4))
    assert imgs.shape == (3, 48, 64, 3) and imgs.dtype == torch.uint8
    again = synthimg.make_render_batch(3, height=48, width=64,
                                       device="cpu")(
        torch.Generator().manual_seed(4))
    assert torch.equal(imgs, again)                   # seeded
    one = synthimg.make_render_one(32, device="cpu")(
        torch.Generator().manual_seed(4))
    assert one.shape == (32, 32, 3)
    assert imgs.float().std() > 10                     # structured, not flat
