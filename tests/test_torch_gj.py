"""The port's Gauss-Jordan panel inverses and blocked LU (plain torch
versions, CPU) vs the JAX package's Pallas kernels in interpret mode."""
import numpy as np
import pytest
import torch

import lcp_physics_tpu.ops.linalg as jax_linalg

from chip_smoke import kkt_batch
from lcp_physics_tpu_torch.ops import linalg


def test_gj_panel_size_rules():
    K = torch.zeros(2, 48, 40)
    with pytest.raises(ValueError):
        linalg.gj_inv(K)
    with pytest.raises(ValueError):
        linalg.gj_inv_blocked(torch.zeros(2, 40, 40))


@pytest.mark.parametrize("P", [64, 128])
def test_gj_inv_blocked_ref_matches_jax_kernel(P):
    """K4's algorithm (rank-16 steps with the exact pivot-column swap)
    against the blocked Pallas kernel itself, one level, and the port's
    panel dispatch (two-level split at P = 128) against the JAX one, on the
    matrices of tests/test_pallas_linalg.py::
    test_blocked_gj_kernel_matches_inverse."""
    rng = np.random.default_rng(7)
    B = 8
    K = (rng.standard_normal((B, P, P)) * 0.1 + np.eye(P) * 6.0).astype(
        np.float32)
    old = jax_linalg.GJ_BLOCKED
    try:
        jax_linalg.GJ_BLOCKED = "force"
        one_level = np.asarray(jax_linalg._gj_inv_blocked_call(K))
        dispatched = np.asarray(jax_linalg._gj_inverse(K))
    finally:
        jax_linalg.GJ_BLOCKED = old
    Kt = torch.tensor(K)
    got = linalg.gj_inv_blocked_ref(Kt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), one_level, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(linalg._gj_inverse(Kt).numpy(), dispatched,
                               rtol=2e-4, atol=2e-4)
    ref = np.linalg.inv(K.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)


def test_gj_inv_ref_matches_jax_scalar_kernel():
    """K5's algorithm against the scalar Pallas kernel at f64, on
    quasi-definite 128-panels."""
    rng = np.random.default_rng(11)
    K = kkt_batch(rng, 3, 128)
    want = np.asarray(jax_linalg._gj_inverse(K))     # f64 -> scalar kernel
    got = linalg.gj_inv_ref(torch.tensor(K))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    # f64 panels go to the scalar kernel in the port's dispatch too
    np.testing.assert_array_equal(
        linalg._gj_inverse(torch.tensor(K)).numpy(), got.numpy())


@pytest.mark.parametrize("n", [100, 200])   # one and two 128-panels
@pytest.mark.parametrize("trans", [0, 1])
def test_blocked_plu_matches_jax(n, trans):
    rng = np.random.default_rng(n + trans)
    B = 3
    K = kkt_batch(rng, B, n)
    r = rng.standard_normal((B, n))
    fac = jax_linalg.plu_factor(K)
    assert fac[0] == "blocked"
    x_jax = np.asarray(jax_linalg.plu_solve(fac, r, trans=trans))
    tfac = linalg.plu_factor(torch.tensor(K))
    assert isinstance(tfac, linalg.BlockedFactor)
    assert len(tfac.blocks) == -(-n // linalg.PANEL)
    x = linalg.plu_solve(tfac, torch.tensor(r), trans)
    np.testing.assert_allclose(x.numpy(), x_jax, rtol=1e-10, atol=1e-10)
    Kop = K if trans == 0 else K.transpose(0, 2, 1)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", Kop, x.numpy()), r,
                               rtol=1e-9, atol=1e-9)


def test_lane_blocked_boundary_matches_jax():
    """n = 88 stays on the lane LU, n = 89 takes the blocked factor, as
    the JAX package's _ru(n, 8) > MAX_LANE_N rule decides."""
    for n, blocked in ((88, False), (89, True)):
        assert linalg.blocked_path(n) == blocked
        K = kkt_batch(np.random.default_rng(n), 2, n)
        assert (jax_linalg.plu_factor(K)[0] == "blocked") == blocked
        assert isinstance(linalg.plu_factor(torch.tensor(K)),
                          linalg.BlockedFactor) == blocked


@pytest.mark.parametrize("exact", [False, True])
def test_f32_panel_dispatch_and_exact(monkeypatch, exact):
    """float32 panels go to the blocked kernel (two 64-panels per
    128-panel) unless ``exact`` asks for the scalar kernel, as in the JAX
    package's _gj_inverse."""
    calls = []
    for name in ("gj_inv", "gj_inv_blocked"):
        orig = getattr(linalg, name)
        monkeypatch.setattr(
            linalg, name,
            lambda K, _o=orig, _n=name: calls.append((_n, K.shape[-1]))
            or _o(K))
    K = torch.tensor(kkt_batch(np.random.default_rng(3), 2, 200),
                     dtype=torch.float32)
    fac = linalg.plu_factor(K, exact=exact)
    want = ([("gj_inv", 128)] * 2 if exact
            else [("gj_inv_blocked", 64)] * 4)
    assert calls == want
    r = torch.randn(2, 200, dtype=torch.float32,
                    generator=torch.Generator().manual_seed(0))
    x = linalg.plu_solve(fac, r)
    res = (K.double() @ x.double()[..., None])[..., 0] - r.double()
    assert float(res.abs().max()) < 1e-4
