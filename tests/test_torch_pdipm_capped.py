"""The port's unfused interior-point loop vs the JAX package's
(backend="pallas", its factors in interpret mode) at f64, on runs of a
fixed number of iterations: ``tol=0`` and ``not_improved_lim=0``, so no
stopping rule fires and both packages take the same iterations on every
world.  This holds the loop's arithmetic (factor, predictor, corrector,
step, clamp, pin, merit and best iterate) to 1e-10 on every instance,
including those where the full runs of ``test_torch_pdipm.py`` stop an
iteration apart on the stall rule at the f64 merit floor."""
import numpy as np
import pytest

from test_fused_ipm import engine_instance
from test_pdipm import _engine_layout_instance
from test_torch_pdipm import one_torch_thread, solve_both  # noqa: F401

from lcp_physics_tpu_torch.lcp import pdipm

TOL = 1e-10


def check_capped(got, ref, k):
    for f in ("z", "s", "lam", "nu"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=TOL,
                                   atol=TOL, err_msg=f)
    np.testing.assert_array_equal(got.iters.numpy(), k)
    np.testing.assert_array_equal(np.asarray(ref.iters), k)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("C,q,n", [(36, 3, 80), (48, 0, 100), (72, 2, 150)])
def test_capped_unfused_loop_matches_jax(C, q, n, seed):
    """Six iterations on the instances of test_unfused_loop_matches_jax,
    seeds C * 1000 + 0..3: the lane factor (K2 = 75), one blocked panel
    (K2 = 96) and two (K2 = 146, with equality rows)."""
    rng = np.random.default_rng(C * 1000 + seed)
    qd, p, G, h, A, b, F, rmask = engine_instance(rng, 3, n, C, q=q,
                                                  pair=True)
    k = 6
    kw = dict(max_iter=k, tol=0.0, q_is_diag=True, gamma_rows=C,
              fric_pair=True, not_improved_lim=0)
    before = pdipm.HOST_READS["ipm_loop"]
    got, ref = solve_both(qd, p, G, h, A, b, F, rmask, **kw)
    check_capped(got, ref, k)
    assert pdipm.HOST_READS["ipm_loop"] - before == k - 1


def test_capped_rot_blocked_replay_matches_jax():
    """test_rot_lazy_blocked_path_matches_jax's degenerate instance (51
    active contacts on 10 degrees of freedom), four iterations: lam and s
    to 1e-10 while they are still resolved."""
    rng = np.random.default_rng(29)
    C = 64
    qd, p, G, h, F, rmask = _engine_layout_instance(rng, 2, 10, C)
    k = 4
    kw = dict(max_iter=k, tol=0.0, q_is_diag=True, gamma_rows=C,
              fric_pair=True, not_improved_lim=0)
    got, ref = solve_both(qd, p, G, h, None, None, F, rmask, **kw)
    check_capped(got, ref, k)
