"""The port's LU / substitution (plain torch versions, CPU) vs the JAX
package's Pallas lane kernels (interpret mode), f64."""
import numpy as np
import pytest
import torch

from lcp_physics_tpu.ops.linalg import plu_factor as jax_plu_factor
from lcp_physics_tpu.ops.linalg import plu_solve as jax_plu_solve

from chip_smoke import kkt_batch
from lcp_physics_tpu_torch.ops import linalg


@pytest.mark.parametrize("B", [3, 130])
@pytest.mark.parametrize("n", [5, 16, 88])
@pytest.mark.parametrize("trans", [0, 1])
def test_plu_matches_jax(B, n, trans):
    rng = np.random.default_rng(100 * n + B)
    K = kkt_batch(rng, B, n)
    r = rng.standard_normal((B, n))
    fac = jax_plu_factor(K)
    x_jax = np.asarray(jax_plu_solve(fac, r, trans=trans))
    lu_jax = np.transpose(np.asarray(fac[1]), (2, 0, 1))[:B, :n, :n]

    Kt = torch.tensor(K, dtype=torch.float64)
    lu = linalg.plu_factor(Kt)          # CPU tensor -> plain version
    x = linalg.plu_solve(lu, torch.tensor(r, dtype=torch.float64), trans)
    np.testing.assert_allclose(lu.numpy(), lu_jax, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(x.numpy(), x_jax, rtol=1e-10, atol=1e-12)
    # and it is a solve of the right system
    Kop = K if trans == 0 else K.transpose(0, 2, 1)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", Kop, x.numpy()), r,
                               rtol=1e-9, atol=1e-9)


def test_safe_inv_guards_tiny_pivots():
    d = torch.tensor([0.0, -0.0, 1e-30, -1e-30, 2.0], dtype=torch.float64)
    got = linalg._safe_inv(d)
    np.testing.assert_allclose(got.numpy(),
                               [1e20, 1e20, 1e20, -1e20, 0.5], rtol=1e-15)


def test_larger_systems_raise():
    """Past MAX_LANE_N the blocked factor takes over; past MAX_BLOCKED_N
    (where the JAX package falls back to its pivoted 'xla' LU) the
    pivotless factor raises and names backend='xla', the pivoted library
    LU the caller may ask for instead."""
    K = torch.eye(90, dtype=torch.float64).expand(2, 90, 90)
    assert isinstance(linalg.plu_factor(K), linalg.BlockedFactor)
    n = linalg.MAX_BLOCKED_N + 1
    K = torch.eye(n, dtype=torch.float64).expand(2, n, n)
    with pytest.raises(ValueError, match="backend='xla'"):
        linalg.plu_factor(K)
    r = torch.arange(2.0 * n, dtype=torch.float64).reshape(2, n)
    # one thread: the library LU's per-column barriers stall for minutes
    # when the test's process shares its cores with other busy processes
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        fac = linalg.xla_factor(K)
        assert isinstance(fac, linalg.PivotedLU)
        for trans in (0, 1):
            assert torch.equal(linalg.plu_solve(fac, r, trans), r)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("n,NB,lanes", [
    (1, 8, 8), (8, 8, 8), (9, 16, 16), (16, 16, 16), (17, 24, 32),
    (24, 24, 32), (25, 32, 32), (32, 32, 32), (33, 48, 64), (48, 48, 64),
    (49, 64, 64), (56, 64, 64), (64, 64, 64), (65, 88, 96), (88, 88, 96)])
def test_lane_launch_shape(n, NB, lanes):
    """csrc/lu.cu's launch: the least bucket of 8, 16, 24, 32, 48, 64, 88
    that holds n.  Up to 32 a world takes ``lanes`` threads (NB at 8 and
    16, else a warp) in 128-thread CTAs, for the factor and the
    substitution alike.  Past 32 the factor gives a world a CTA of
    ``lanes`` threads (whole warps, one row a thread) with two pivot rows
    of NB entries and 16 bytes in shared memory, and the substitution a
    warp."""
    for item in (4, 8):
        fac = linalg.lane_shape(n, item)
        sol = linalg.lane_shape(n, item, solve=True)
        assert fac.bucket == sol.bucket == NB
        if NB <= 32:
            assert fac == sol == (NB, lanes, 128 // lanes, 128, 0)
        else:
            assert fac == (NB, lanes, 1, lanes, 2 * (NB * item + 16))
            assert sol == (NB, 32, 4, 128, 0)
        assert fac.world_threads * fac.worlds_per_cta <= fac.cta_threads
    with pytest.raises(ValueError):
        linalg.lane_shape(linalg.MAX_LANE_N + 1, 4)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_gj_launch_shape(itemsize):
    """csrc/gj_inv.cu's scalar kernel (K5): the least bucket of 32, 64, 96,
    128 that holds P, a cluster of bucket / 32 CTAs a world, 256 threads a
    CTA, and in shared memory two 32-row strips and two pivot rows with
    their reciprocals, for every P from 1 to 128."""
    for P in range(1, 129):
        s = linalg.gj_shape(P, itemsize)
        PB = s.bucket
        assert PB == -(-P // 32) * 32 and PB in linalg.GJ_BUCKETS
        assert s.cluster == PB // 32 and s.cta_threads == 256
        assert s.smem == (64 * PB + 2 * PB + 2) * itemsize
        assert s.smem <= 232448
    for P in (0, 129):
        with pytest.raises(ValueError):
            linalg.gj_shape(P, itemsize)


@pytest.mark.parametrize("P", [1, 17, 40, 65, 127])
def test_gj_identity_padding_is_exact(P):
    """Padding a panel with the identity to its K5 bucket and inverting it
    by the plain scalar Gauss-Jordan gives the unpadded inverse bit for bit
    in the leading P x P block (and the identity beside it): a pivot on a
    padded row subtracts 0 * x from the real entries."""
    rng = np.random.default_rng(P)
    K = torch.tensor(kkt_batch(rng, 3, P), dtype=torch.float64)
    PB = linalg.gj_shape(P, 8).bucket
    Kp = torch.eye(PB, dtype=torch.float64).repeat(3, 1, 1)
    Kp[:, :P, :P] = K
    X, Xp = linalg.gj_inv_ref(K), linalg.gj_inv_ref(Kp)
    assert torch.equal(Xp[:, :P, :P], X)
    assert torch.equal(Xp[:, P:, P:], torch.eye(PB - P, dtype=torch.float64)
                       .expand(3, -1, -1))
    assert not Xp[:, :P, P:].any() and not Xp[:, P:, :P].any()
