"""The port's explicit-inverse factor (``inv_factor_blocks``) and its solves
(plain torch versions, CPU) vs the JAX package's, whose panel inverses run
the scalar Gauss-Jordan Pallas kernel in interpret mode, f64: one panel
(n = 100) and two (n = 200, the 2x2 block-Schur identity)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lcp_physics_tpu.ops.linalg as jax_linalg

from chip_smoke import kkt_batch
from lcp_physics_tpu_torch.ops import linalg


def jax_inv_factor(K):
    """The JAX package's explicit-inverse factor of K (B, n, n), from the
    padded panel grid its lazy block source would give."""
    B, n = K.shape[0], K.shape[-1]
    n_pad = jax_linalg._ru(n, jax_linalg.PANEL)
    Kp = np.zeros((B, n_pad, n_pad))
    Kp[:, :n, :n] = K
    Kp[:, np.arange(n, n_pad), np.arange(n, n_pad)] = 1.0
    Kp = jnp.asarray(Kp)
    P = jax_linalg.PANEL
    return jax_linalg.inv_factor_blocks(
        lambda t, s: Kp[:, t * P:(t + 1) * P, s * P:(s + 1) * P], B, n,
        Kp.dtype)


@pytest.mark.parametrize("n", [100, 200])
@pytest.mark.parametrize("trans", [0, 1])
def test_inv_factor_and_solve_match_jax(n, trans):
    rng = np.random.default_rng(n + trans)
    B = 2
    K = kkt_batch(rng, B, n)
    r = rng.standard_normal((B, n))
    fac_j = jax_inv_factor(K)
    assert fac_j[0] == "inv"
    fac = linalg.inv_factor_blocks(torch.tensor(K))
    assert isinstance(fac, linalg.InvFactor) and fac.n == n
    inv = fac.inv.numpy()
    np.testing.assert_allclose(inv, np.asarray(fac_j[1]), rtol=1e-10,
                               atol=1e-10)
    # ||K X - I|| on the unpadded block, identity on the padding
    eye = np.eye(n)
    assert np.abs(K @ inv[:, :n, :n] - eye).max() < 1e-10
    pad = inv[:, n:, n:]
    np.testing.assert_array_equal(pad, np.broadcast_to(
        np.eye(pad.shape[-1]), pad.shape))
    x = linalg.plu_solve(fac, torch.tensor(r), trans).numpy()
    np.testing.assert_allclose(
        x, np.asarray(jax_linalg.plu_solve(fac_j, r, trans=trans)),
        rtol=1e-10, atol=1e-10)
    Kop = K if trans == 0 else K.transpose(0, 2, 1)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", Kop, x), r,
                               rtol=1e-9, atol=1e-9)


def test_inv_factor_size_rules():
    """Past two panels the explicit inverse is refused, as inv_supported
    says; a right-hand side of another size is refused by plu_solve."""
    assert linalg.inv_supported(256) and not linalg.inv_supported(257)
    with pytest.raises(ValueError):
        linalg.inv_factor_blocks(torch.zeros(1, 300, 300))
    fac = linalg.inv_factor_blocks(torch.tensor(
        kkt_batch(np.random.default_rng(0), 2, 100)))
    with pytest.raises(ValueError):
        linalg.plu_solve(fac, torch.zeros(2, 99, dtype=torch.float64))
