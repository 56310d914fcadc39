"""The table-free candidate route (index/cand_adc.py): on the CPU,
``lopq_query`` calls it once on every kind of rung that takes the route,
through the plain version, with ``+inf`` on exactly the invalid slots
(``test_torch_query.py`` holds the route's numbers to JAX); on the card the
kernel against the plain version.

Card tolerance: rtol 1e-5, atol 1e-6. Both sides are fp32; the kernel adds
each 32-term (16 at face) subvector sum in another order, with fused
multiply-adds, and its rotation is another batched GEMM than the plain
version's einsum. The card tests are marked ``cuda`` and skip elsewhere;
they take their inputs from ``chip_smoke.cand_inputs`` (no repo test
helpers: the card machine shadows the ``tests`` package) and import no
JAX.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from columbiaimagesearch_tpu_torch.index import query
from columbiaimagesearch_tpu_torch.index.cand_adc import (
    cand_adc,
    cand_dists,
    cand_dists_plain,
    rotated_residuals,
)
from columbiaimagesearch_tpu_torch.index.csr import build_csr
from columbiaimagesearch_tpu_torch.index.lut import build_luts
from columbiaimagesearch_tpu_torch.index.query import (
    LUT_MAX_Q,
    lopq_query,
    uses_lut,
)

N, QUOTA, K = 4000, 400, 32
CARD_RTOL, CARD_ATOL = chip_smoke.CAND_RTOL, chip_smoke.CAND_ATOL


def _tables(rng, V, D, M, S, device="cpu"):
    """Seeded model tables with orthonormal rotations."""
    Dh, F = D // 2, M // 2
    Cs = rng.randn(2, V, Dh).astype(np.float32)
    Rs = np.stack([np.stack([np.linalg.qr(rng.randn(Dh, Dh))[0]
                             for _ in range(V)])
                   for _ in range(2)]).astype(np.float32)
    mus = 0.1 * rng.randn(2, V, Dh).astype(np.float32)
    subs = rng.randn(2, F, S, Dh // F).astype(np.float32)
    return [torch.from_numpy(t).to(device) for t in (Cs, Rs, mus, subs)]


#: (id, V, D, M, S, B, SB, Q, wide-V): every kind of rung that takes the
#: table-free route
CASES = [pytest.param(16, 64, 8, 32, 8, 2, 1024, False, id="strip"),
         pytest.param(130, 32, 4, 16, 130, 0, 1024, False,
                      id="wide-square"),
         pytest.param(16, 64, 8, 32, 8, 0, LUT_MAX_Q + 1024, False,
                      id="Q-above-LUT_MAX_Q"),
         pytest.param(16, 64, 8, 32, 8, 2, 1024, True, id="wide-V")]


@pytest.mark.parametrize("V,D,M,S,B,SB,Q,wide_v", CASES)
def test_table_free_rung_takes_the_plain_route_once(monkeypatch, V, D, M, S,
                                                    B, SB, Q, wide_v):
    """One call of the route a wave, the plain version on the CPU, +inf on
    exactly the invalid slots, and ``lopq_query``'s distances the K
    smallest of the route's."""
    assert not uses_lut(B, SB, V, Q)
    rng = np.random.RandomState(V + B + SB + Q)
    tables = _tables(rng, V, D, M, S)
    coarse = torch.from_numpy(rng.randint(0, V, (N, 2)).astype(np.int32))
    fine = torch.from_numpy(rng.randint(0, S, (N, M)).astype(np.uint8))
    codes, cell_start, _ = build_csr(coarse, fine, V)
    cells_sorted = None
    if wide_v:
        counts = (cell_start[1:] - cell_start[:-1]).long()
        cells_sorted = torch.repeat_interleave(
            torch.arange(V * V, dtype=torch.int32), counts)
        cell_start = None
    X = torch.from_numpy(rng.randn(5, D).astype(np.float32))
    calls = []

    def spy(*args):
        out = cand_dists(*args)
        calls.append((args, out))
        return out

    monkeypatch.setattr(query, "cand_dists", spy)
    got = lopq_query(X, *tables, codes, cell_start, QUOTA, V=V, B=B, Q=Q,
                     K=K, SB=SB, cells_sorted=cells_sorted)
    assert len(calls) == 1
    args, out = calls[0]
    n_valid = args[-1]
    invalid = torch.arange(Q)[None, :] >= n_valid[:, None]
    assert bool(invalid.any()) and bool((~invalid).any())
    assert torch.equal(torch.isinf(out), invalid)
    assert torch.equal(cand_dists_plain(*args), out)
    assert torch.equal(got[1], torch.sort(out, dim=1)[0][:, :K])


def test_cpu_tensors_take_the_plain_version_and_others_raise():
    rng = np.random.RandomState(3)
    Cs, Rs, mus, subs = _tables(rng, 8, 16, 4, 8)
    NQ, Q, Bi = 2, 6, 4
    x2 = torch.from_numpy(rng.randn(NQ, 2, 8).astype(np.float32))
    codes = torch.from_numpy(rng.randint(0, 8, (20, 4)).astype(np.uint8))
    ids = [torch.from_numpy(rng.randint(0, hi, shape))
           for hi, shape in ((20, (NQ, Q)), (8, (NQ, Bi)), (8, (NQ, Bi)),
                             (Bi, (NQ, Q)), (Bi, (NQ, Q)))]
    n_valid = torch.tensor([6, 3])
    before = cand_dists.launches
    out = cand_dists(x2, Cs, Rs, mus, subs, codes, *ids, n_valid)
    assert cand_dists.launches == before
    assert torch.isinf(out[1, 3:]).all() and torch.isfinite(out[0]).all()
    meta = [t.to("meta") for t in (x2, Cs, Rs, mus, subs, codes, *ids,
                                   n_valid)]
    with pytest.raises(ValueError, match="unsupported device"):
        cand_dists(*meta)
    with pytest.raises(ValueError, match="unsupported device"):
        cand_adc(torch.zeros(2, 8, NQ, 8), subs, codes, *ids, n_valid)
    with pytest.raises(ValueError, match="unsupported device"):
        rotated_residuals(*meta[:4])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the H100)")
    return torch.device("cuda")


def direct_inputs(dev, seed, *shape):
    """``chip_smoke.cand_inputs`` (the arguments of ``cand_dists`` at a
    rung's shapes) from a generator seeded with ``seed``."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return chip_smoke.cand_inputs(dev, g, *shape)


#: (NQ, Q, V, Dh, F, S, rows, Bi): the release strip rung (256, 16) at
#: waves of 1, 16 and 100 (Q = 11,264, Bf = 2,049), the face strip rung
#: (128, 8) (Dh 64, Dsub 16, Bf = V = 256), and a shape with Dsub/4 = 3,
#: which takes the kernel's unspecialised loop
CARD_CASES = [pytest.param(1, 11264, 4096, 128, 4, 256, 1 << 20, 2049,
                           id="release-NQ1"),
              pytest.param(16, 11264, 4096, 128, 4, 256, 1 << 20, 2049,
                           id="release-NQ16"),
              pytest.param(100, 11264, 4096, 128, 4, 256, 1 << 20, 2049,
                           id="release-NQ100"),
              pytest.param(32, 11264, 256, 64, 4, 256, 1 << 20, 256,
                           id="face-NQ32"),
              pytest.param(5, 1000, 37, 24, 2, 32, 3000, 20,
                           id="odd-Dsub12")]


@pytest.mark.cuda
@pytest.mark.parametrize("NQ,Q,V,Dh,F,S,n_rows,Bi", CARD_CASES)
def test_kernel_matches_plain_on_card(cuda_device, NQ, Q, V, Dh, F, S,
                                      n_rows, Bi):
    args = direct_inputs(cuda_device, NQ + V, NQ, Q, V, Dh, F, S, n_rows, Bi)
    before = cand_dists.launches
    got = cand_dists(*args)
    torch.cuda.synchronize()
    assert cand_dists.launches == before + 1
    want = cand_dists_plain(*args)
    invalid = (torch.arange(Q, device=cuda_device)[None, :]
               >= args[-1][:, None])
    assert torch.equal(torch.isinf(got), invalid)
    assert torch.isfinite(got[~invalid]).all()
    torch.testing.assert_close(got, want, rtol=CARD_RTOL, atol=CARD_ATOL)
    # A query's distances do not depend on the rest of the wave.
    q = NQ - 1
    one = cand_dists(*(t[q:q + 1] if i in (0, 6, 7, 8, 9, 10, 11) else t
                       for i, t in enumerate(args)))
    torch.testing.assert_close(one, got[q:q + 1], rtol=CARD_RTOL,
                               atol=CARD_ATOL)
    # An out-of-range cluster id poisons exactly the slots that read it.
    pr = rotated_residuals(*args[:4])
    isel0 = args[7].clone()
    isel0[0, args[9][0, 0]] = V
    bad = cand_adc(pr, *args[4:7], isel0, *args[8:])
    hit = (args[9][0] == args[9][0, 0]) & ~invalid[0]
    assert torch.isnan(bad[0, hit]).all()
    assert not torch.isnan(bad[0, ~hit]).any()
    torch.testing.assert_close(bad[1:], got[1:], rtol=0, atol=0)


@pytest.mark.cuda
def test_launches_count_table_free_rungs_only(cuda_device):
    """On a small index on the card: the square rung builds tables and
    leaves ``cand_dists.launches`` alone; the strip rung and the budget
    above LUT_MAX_Q launch the kernel once each, and their distances match
    the same query on the CPU."""
    V, D, M, S = 16, 64, 8, 32
    rng = np.random.RandomState(7)
    tables = _tables(rng, V, D, M, S)
    coarse = torch.from_numpy(rng.randint(0, V, (N, 2)).astype(np.int32))
    fine = torch.from_numpy(rng.randint(0, S, (N, M)).astype(np.uint8))
    codes, cell_start, _ = build_csr(coarse, fine, V)
    X = torch.from_numpy(rng.randn(6, D).astype(np.float32))
    on_card = [t.to(cuda_device) for t in (X, *tables, codes, cell_start)]
    for B, SB, Q, table_free in ((8, 0, 1024, False), (8, 2, 1024, True),
                                 (8, 0, LUT_MAX_Q + 1024, True)):
        cands, luts = cand_dists.launches, build_luts.launches
        got = lopq_query(*on_card, QUOTA, V=V, B=B, Q=Q, K=K, SB=SB)
        torch.cuda.synchronize()
        assert cand_dists.launches - cands == int(table_free)
        assert build_luts.launches - luts == int(not table_free)
        want = lopq_query(X, *tables, codes, cell_start, QUOTA, V=V, B=B,
                          Q=Q, K=K, SB=SB)
        torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-4,
                                   atol=1e-5)
        for a, b in zip(got[2:], want[2:]):
            assert torch.equal(a.cpu(), b)
