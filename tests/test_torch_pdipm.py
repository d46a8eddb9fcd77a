"""The port's unfused interior-point loop (plain torch versions on CPU) vs
the JAX package's with backend="pallas" (its pivotless lane and blocked
factors in interpret mode), f64: the rotated blocked factor (K2 > 88)
and the lane factor past the fused kernel (48 < K2 <= 88)."""
import jax
import numpy as np
import pytest
import torch

from lcp_physics_tpu.lcp import lcp_solve_full as jax_lcp_solve_full
from test_fused_ipm import engine_instance
from test_pdipm import _engine_layout_instance
from torch_inputs import kernel_counts, one_torch_thread  # noqa: F401

from lcp_physics_tpu_torch.lcp import ConeF, lcp_solve_full, pdipm
from lcp_physics_tpu_torch.ops import ipm, linalg


def to_port(*xs):
    return tuple(torch.tensor(np.asarray(x), dtype=torch.float64)
                 for x in xs)


def solve_both(qd, p, G, h, A, b, F, rmask, jit=False, worlds=None, **kw):
    """(port, JAX) solutions; ``jit`` compiles the JAX solve as one
    program (the same computation, about 2.5x faster to compile);
    ``worlds`` runs the port on the first ``worlds`` instances only (each
    world is solved on its own) and returns the JAX solution of those."""
    jax_solve = lambda *a: jax_lcp_solve_full(*a[:7], backend="pallas",
                                              row_mask=a[7], **kw)
    if jit:
        jax_solve = jax.jit(jax_solve)
    ref = jax_solve(qd, p, G, h, A, b, F, rmask)
    w = slice(None, worlds)
    if worlds is not None:
        ref = type(ref)(*(x[w] for x in ref))
    tq, tp, tG, th, trm, tmu, tv = (x[w] for x in to_port(
        qd, p, G, h, rmask, F.mu, F.valid))
    tA, tb = (None, None) if A is None else (x[w] for x in to_port(A, b))
    got = lcp_solve_full(tq, tp, tG, th, tA, tb, ConeF(tmu, tv, F.fd),
                         row_mask=trm, **kw)
    return got, ref


def check(got, ref, tol, tol_dual=None):
    for f, t in (("z", tol), ("nu", tol), ("lam", tol_dual or tol),
                 ("s", tol_dual or tol)):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=t,
                                   atol=t, err_msg=f)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))


def test_rot_lazy_blocked_path_matches_jax():
    """tests/test_pdipm.py::test_fric_pair_rotation_lazy_blocked_path's
    instance (K2 = 128, one panel) through the port's blocked factor.  Its
    ~51 active contacts on 10 degrees of freedom leave lam unresolved
    below the merit both packages stop at (4.9e-7, 4.1e-7: the stall rule
    at f64), so lam and s are held to that and z to 1e-8."""
    rng = np.random.default_rng(29)
    B, n, C = 2, 10, 64
    qd, p, G, h, F, rmask = _engine_layout_instance(rng, B, n, C)
    kw = dict(max_iter=20, tol=1e-10, q_is_diag=True, gamma_rows=C,
              fric_pair=True)
    got, ref = solve_both(qd, p, G, h, None, None, F, rmask, **kw)
    assert float((got.mu + got.resid).max()) < 1e-6
    check(got, ref, 1e-8, tol_dual=2e-6)


@pytest.mark.parametrize("C,q,n,seed", [(36, 3, 80, 36000),
                                        (48, 0, 100, 48000),
                                        (72, 2, 150, 72003)])
def test_unfused_loop_matches_jax(C, q, n, seed):
    """K2 = 75 (lane LU, past the fused kernel's 48), K2 = 96 (one blocked
    panel) and K2 = 146 (two panels, with equality rows), on instances
    with more degrees of freedom than rows, so the solution is unique; one
    host read per iteration.  These worlds reach the f64 merit floor
    (1e-11 to 2e-9) near tol = 1e-10 and mostly stop on the stall rule,
    where a merit change in the 12th digit decides whether a step
    improved.  Of seeds C * 1000 + 0..3, three stop one iteration apart in
    the two packages on one or two worlds each: 48001 (port 22 and 20
    iterations, JAX 23 and 21; merits 1.76e-10, 1.04e-10 in both), 72001
    (24 vs 23; 1.188e-10 vs 1.176e-10) and 72002 (25 vs 24; 1.780e-10 in
    both).  The seeds here have no such world; every seed, capped at a
    fixed number of iterations, agrees to 1e-10
    (test_torch_pdipm_capped.py)."""
    rng = np.random.default_rng(seed)
    B = 3
    qd, p, G, h, A, b, F, rmask = engine_instance(rng, B, n, C, q=q,
                                                  pair=True)
    K2 = 2 * C + q
    assert not ipm.fused_supported(3 * C, q, C, 2, fric_pair=True)
    assert linalg.blocked_path(K2) == (K2 > linalg.MAX_LANE_N)
    kw = dict(max_iter=25, tol=1e-10, q_is_diag=True, gamma_rows=C,
              fric_pair=True, not_improved_lim=3)
    before = pdipm.HOST_READS["ipm_loop"]
    got, ref = solve_both(qd, p, G, h, A, b, F, rmask, **kw)
    check(got, ref, 1e-8)
    assert float((got.mu + got.resid).max()) < 1e-9
    ran = int(got.iters.max()) + 1       # iterations the loop ran
    assert pdipm.HOST_READS["ipm_loop"] - before == min(ran, 24)
    # padded rows pinned exactly
    np.testing.assert_array_equal(
        np.where(np.asarray(rmask) > 0, 0.0,
                 got.s.numpy() - np.asarray(h)), 0.0)


@pytest.mark.parametrize("opts", [dict(fric_pair=True, gondzio=1),
                                  dict(fric_pair=True, max_iter=0),
                                  dict(fric_pair=False)],
                         ids=["gondzio", "max_iter0", "unrotated"])
def test_unported_loop_options_raise(opts):
    """These options once raised NotImplementedError; each now runs and
    matches the JAX package per world within 1e-10 on runs capped at 4
    iterations (tol=0, not_improved_lim=0): one Gondzio corrector on the
    rotated factor (K2 = 60, lane LU), max_iter=0 (the start point through
    the best-iterate tail) and the unrotated gamma factor (K = 90, one
    blocked panel)."""
    from test_torch_pdipm_capped import check_capped
    rng = np.random.default_rng(5)
    B, n, C = 2, 8, 30
    qd, p, G, h, A, b, F, rmask = engine_instance(rng, B, n, C, pair=True)
    kw = dict(dict(max_iter=4, tol=0.0, not_improved_lim=0, gamma_rows=C,
                   q_is_diag=True), **opts)
    before = kernel_counts()
    got, ref = solve_both(qd, p, G, h, None, None, F, rmask, jit=True, **kw)
    check_capped(got, ref, kw["max_iter"])
    assert kernel_counts() == before   # CPU: plain
