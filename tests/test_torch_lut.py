"""The LUT kernel's wrapper and plain version (port: index/lut.py) against
the JAX package's Pallas kernel ``build_luts_pallas``, run in interpret
mode on the CPU exactly as the JAX tests run it.

Tolerance: rtol 1e-4, atol 1e-5 (fp32; the Pallas kernel uses the
||a||^2 - 2ab + ||b||^2 expansion, the port the difference form, so the
two round differently). The kernel itself needs the card: its test is
marked ``cuda`` and skips elsewhere.
"""

import numpy as np
import pytest
import torch

from columbiaimagesearch_tpu_torch.index.lut import (
    build_luts,
    build_luts_all_clusters,
    build_luts_plain,
)

V, M, S, D = 16, 8, 32, 64     # Dh=32, F=4, Dsub=8
B = 8


@pytest.fixture(scope="module")
def tables():
    """Seeded tables with orthogonal rotations (made here, not from
    tests/oracle_lopq.py, so the card-only test runs without the repo's
    test helpers on the path)."""
    rng = np.random.RandomState(5)
    Dh, F = D // 2, M // 2
    Cs = rng.randn(2, V, Dh).astype(np.float32)
    Rs = np.stack([np.stack([np.linalg.qr(rng.randn(Dh, Dh))[0]
                             for _ in range(V)])
                   for _ in range(2)]).astype(np.float32)
    mus = 0.1 * rng.randn(2, V, Dh).astype(np.float32)
    subs = rng.randn(2, F, S, Dh // F).astype(np.float32)
    NQ = 3
    x2 = rng.randn(NQ, 2, D // 2).astype(np.float32)
    isel = np.stack([np.stack([rng.choice(V, B, replace=False)
                               for _ in range(2)]) for _ in range(NQ)])
    return Cs, Rs, mus, subs, x2, isel.astype(np.int32)


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def test_plain_matches_pallas_interpret(tables):
    import jax.numpy as jnp

    from columbiaimagesearch_tpu.index.tpu_query import build_luts_pallas

    Cs, Rs, mus, subs, x2, isel = tables
    got = build_luts_plain(*_t(x2, isel, Cs, Rs, mus, subs)).numpy()
    for q in range(x2.shape[0]):
        lut0, lut1 = build_luts_pallas(
            jnp.asarray(x2[q]), jnp.asarray(isel[q]), jnp.asarray(Cs),
            jnp.asarray(Rs), jnp.asarray(mus), jnp.asarray(subs),
            interpret=True)
        want = np.stack([np.asarray(lut0), np.asarray(lut1)])
        np.testing.assert_allclose(got[q], want, rtol=1e-4, atol=1e-5)


def test_batched_call_equals_single_calls(tables):
    """Equal up to the CPU einsum's batch-size-dependent blocking (a few
    fp32 ulps)."""
    Cs, Rs, mus, subs, x2, isel = tables
    args = _t(Cs, Rs, mus, subs)
    batched = build_luts(*_t(x2, isel), *args)
    for q in range(x2.shape[0]):
        one = build_luts(*_t(x2[q:q + 1], isel[q:q + 1]), *args)
        np.testing.assert_allclose(batched[q:q + 1].numpy(), one.numpy(),
                                   rtol=1e-6, atol=1e-5)


def test_cpu_tensors_take_plain_version(tables):
    Cs, Rs, mus, subs, x2, isel = tables
    before = build_luts.launches
    out = build_luts(*_t(x2, isel, Cs, Rs, mus, subs))
    assert out.shape == (x2.shape[0], 2, B, M // 2, S)
    assert build_luts.launches == before


def test_other_devices_raise(tables):
    Cs, Rs, mus, subs, x2, isel = tables
    with pytest.raises(ValueError, match="unsupported device"):
        build_luts(*_t(x2, isel, Cs, Rs, mus, subs, device="meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("NQ,Bq", [(3, 8), (200, 12)])
def test_kernel_matches_plain_on_card(tables, cuda_device, NQ, Bq):
    """Kernel vs plain version on the card (fp32 sums in another order:
    rtol 1e-5, atol 1e-4). 200 queries at B=12 take 8-slot tiles with a
    ragged last tile."""
    Cs, Rs, mus, subs, _, _ = tables
    rng = np.random.RandomState(NQ)
    x2 = rng.randn(NQ, 2, D // 2).astype(np.float32)
    isel = rng.randint(0, V, (NQ, 2, Bq)).astype(np.int32)
    args = _t(x2, isel, Cs, Rs, mus, subs, device=cuda_device)
    before = build_luts.launches
    got = build_luts(*args)
    torch.cuda.synchronize()
    assert build_luts.launches == before + 1
    want = build_luts_plain(*args)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    # A block holds slots of one (query, split), and a slot's arithmetic
    # does not depend on the tile size: a query's tables do not depend on
    # the rest of the batch.
    one = build_luts(args[0][1:2].contiguous(), args[1][1:2].contiguous(),
                     *args[2:])
    torch.testing.assert_close(one, got[1:2], rtol=0, atol=0)
    # An out-of-range cluster id poisons only its own table.
    bad = args[1].clone()
    bad[0, 1, 2] = V
    poisoned = build_luts(args[0], bad, *args[2:])
    assert torch.isnan(poisoned[0, 1, 2]).all()
    poisoned[0, 1, 2] = got[0, 1, 2]
    torch.testing.assert_close(poisoned, got, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("NQ", [1, 32])
def test_kernel_at_face_probed_shapes_on_card(cuda_device, NQ):
    """The face configuration's probed rung 64 (V=256, Dh=64, F=4, S=256,
    B=64): kernel vs plain on the card, rtol 1e-5, atol 1e-4."""
    rng = np.random.RandomState(NQ)
    Vf, Dh, F, S, Bf = 256, 64, 4, 256, 64
    Rs = np.stack([np.stack([np.linalg.qr(rng.randn(Dh, Dh))[0]
                             for _ in range(Vf)]) for _ in range(2)])
    args = _t(rng.randn(NQ, 2, Dh).astype(np.float32),
              np.stack([np.stack([rng.choice(Vf, Bf, replace=False)
                                  for _ in range(2)]) for _ in range(NQ)]
                       ).astype(np.int32),
              rng.randn(2, Vf, Dh).astype(np.float32), Rs.astype(np.float32),
              0.1 * rng.randn(2, Vf, Dh).astype(np.float32),
              rng.randn(2, F, S, Dh // F).astype(np.float32),
              device=cuda_device)
    before = build_luts.launches
    got = build_luts(*args)
    torch.cuda.synchronize()
    assert build_luts.launches == before + 1
    assert got.shape == (NQ, 2, Bf, F, S)
    torch.testing.assert_close(got, build_luts_plain(*args), rtol=1e-5,
                               atol=1e-4)


def _grouping_case(pattern, NQ, Bq=8, Dh=32, F=4, S=32):
    """Inputs whose probed (split, cluster) groups take one shape:
    ``one-cluster`` (every slot of a split on one cluster: one group of
    NQ * Bq slots a split), ``distinct`` (no two slots share a cluster) or
    ``random``."""
    rng = np.random.RandomState(len(pattern) * 100 + NQ)
    V = max(16, NQ * Bq)
    Cs = rng.randn(2, V, Dh).astype(np.float32)
    Rs = (rng.randn(2, V, Dh, Dh) / np.sqrt(Dh)).astype(np.float32)
    mus = 0.1 * rng.randn(2, V, Dh).astype(np.float32)
    subs = rng.randn(2, F, S, Dh // F).astype(np.float32)
    x2 = rng.randn(NQ, 2, Dh).astype(np.float32)
    if pattern == "one-cluster":
        isel = np.full((NQ, 2, Bq), 5)
    elif pattern == "distinct":
        isel = np.stack([rng.permutation(V)[:NQ * Bq].reshape(NQ, Bq)
                         for _ in range(2)], 1)
    else:
        isel = rng.randint(0, V, (NQ, 2, Bq))
    return x2, isel.astype(np.int32), Cs, Rs, mus, subs


@pytest.mark.parametrize("pattern,NQ", [("one-cluster", 3),
                                        ("distinct", 3), ("distinct", 1)])
def test_plain_matches_pallas_interpret_on_grouping_edges(pattern, NQ):
    """The plain version against the Pallas kernel in interpret mode on the
    isel patterns the card's grouping has to handle (rtol 1e-4, atol
    1e-5, as above)."""
    import jax.numpy as jnp

    from columbiaimagesearch_tpu.index.tpu_query import build_luts_pallas

    x2, isel, Cs, Rs, mus, subs = _grouping_case(pattern, NQ)
    got = build_luts_plain(*_t(x2, isel, Cs, Rs, mus, subs)).numpy()
    for q in range(NQ):
        lut0, lut1 = build_luts_pallas(
            jnp.asarray(x2[q]), jnp.asarray(isel[q]), jnp.asarray(Cs),
            jnp.asarray(Rs), jnp.asarray(mus), jnp.asarray(subs),
            interpret=True)
        want = np.stack([np.asarray(lut0), np.asarray(lut1)])
        np.testing.assert_allclose(got[q], want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["one-cluster", "distinct", "random"])
@pytest.mark.parametrize("NQ", [1, 3, 8, 64])
def test_kernel_grouping_edges_on_card(cuda_device, pattern, NQ):
    """Kernel vs plain version on the card (rtol 1e-5, atol 1e-4) with
    every slot on one cluster, with all slots distinct, and at random.
    NQ > 1 groups the slots by a counting sort; NQ=1 makes each slot a
    group of its own, whose matrix's F row bands go to F blocks. An
    out-of-range id gives a NaN table and leaves the others bit-equal."""
    args = _t(*_grouping_case(pattern, NQ), device=cuda_device)
    got = build_luts(*args)
    torch.cuda.synchronize()
    want = build_luts_plain(*args)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    bad = args[1].clone()
    bad[NQ - 1, 0, 3] = -1
    bad[0, 1, 0] = args[2].shape[1]
    poisoned = build_luts(args[0], bad, *args[2:])
    assert torch.isnan(poisoned[NQ - 1, 0, 3]).all()
    assert torch.isnan(poisoned[0, 1, 0]).all()
    poisoned[NQ - 1, 0, 3] = got[NQ - 1, 0, 3]
    poisoned[0, 1, 0] = got[0, 1, 0]
    torch.testing.assert_close(poisoned, got, rtol=0, atol=0)


def test_all_clusters_entry_point_on_cpu():
    """``build_luts_all_clusters`` is ``build_luts`` with every query
    probing every cluster in order (the plain version on the CPU)."""
    x2, _, Cs, Rs, mus, subs = _grouping_case("random", 3)
    V = Cs.shape[1]
    isel = np.broadcast_to(np.arange(V, dtype=np.int32), (3, 2, V)).copy()
    want = build_luts(*_t(x2, isel, Cs, Rs, mus, subs))
    got = build_luts_all_clusters(*_t(x2, Cs, Rs, mus, subs))
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("NQ", [1, 3, 64])
def test_all_clusters_kernel_on_card(cuda_device, NQ):
    """The all-clusters grouping (no sort: cluster v's slots are the
    queries) against the plain version (rtol 1e-5, atol 1e-4), and
    bit-equal to ``build_luts`` on the same ids (sorted, or at NQ=1 one
    group a slot), whose slots take the same arithmetic."""
    x2, _, Cs, Rs, mus, subs = _grouping_case("random", NQ)
    V = Cs.shape[1]
    isel = np.broadcast_to(np.arange(V, dtype=np.int32), (NQ, 2, V)).copy()
    args = _t(x2, isel, Cs, Rs, mus, subs, device=cuda_device)
    before = build_luts.launches
    got = build_luts_all_clusters(args[0], *args[2:])
    torch.cuda.synchronize()
    assert build_luts.launches == before + 1
    torch.testing.assert_close(got, build_luts_plain(*args), rtol=1e-5,
                               atol=1e-4)
    assert torch.equal(got, build_luts(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["side stream", "second card"])
def test_kernel_launches_on_the_inputs_device(tables, cuda_device, where):
    """The kernel launches under its inputs' device and that device's
    current stream: on one card with a side stream current, the tables
    come out ordered on that stream; with two cards, a ``cuda:1`` tensor
    launches on card 1 while card 0 is current, then card 0 again (the
    per-device attribute caches). Each result equals the plain version
    (rtol 1e-5, atol 1e-4)."""
    if where == "second card" and torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    Cs, Rs, mus, subs, x2, isel = tables
    devs = ([torch.device("cuda", 0)] if where == "side stream"
            else [torch.device("cuda", 1), torch.device("cuda", 0)])
    for dev in devs:
        args = _t(x2, isel, Cs, Rs, mus, subs, device=dev)
        want = build_luts_plain(*args)
        torch.cuda.synchronize()
        before = build_luts.launches
        if where == "side stream":
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                got = build_luts(*args).clone()    # ordered on `side`
            torch.cuda.current_stream(dev).wait_stream(side)
        else:
            with torch.cuda.device(0):       # card 0 current throughout
                got = build_luts(*args)
        torch.cuda.synchronize()
        assert build_luts.launches == before + 1
        assert got.device == dev
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
