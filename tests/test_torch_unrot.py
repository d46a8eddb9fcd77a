"""The port's unrotated solver (no friction-pair rotation: the library's
default ``fric_pair=False``) vs the JAX package, f64 on CPU:

* the plain unrotated fused loop (``ops.ipm.fused_ipm`` with
  ``fric_pair=False``, K = (1 + fd)C + q) against the JAX package's fused
  whole-IPM Pallas kernel in interpret mode, from one shared start;
* the dispatch of ``lcp_solve_full`` to the rotated or the unrotated
  fused loop, against the JAX package's rule;
* the unfused loop over the unrotated gamma factor against JAX
  ``backend="pallas"`` (its factors in interpret mode), on the lane LU and
  on one and three blocked panels, with and without refinement.

Capped runs (``tol=0, not_improved_lim=0``) hold every world to 1e-10."""
import jax
import numpy as np
import pytest
import torch

from lcp_physics_tpu.lcp import lcp_solve_full as jax_lcp_solve_full
from lcp_physics_tpu.lcp.pdipm import _dtype_consts as jax_consts
import lcp_physics_tpu.ops.ipm as jax_ipm
from test_fused_ipm import engine_instance
from test_torch_pdipm import one_torch_thread, solve_both  # noqa: F401
from test_torch_pdipm_capped import check_capped

from lcp_physics_tpu_torch.lcp import ConeF, lcp_solve_full, pdipm
from lcp_physics_tpu_torch.ops import ipm, linalg

CONSTS = jax_consts(np.float64)


def start_point(rng, rmask, h, B, n, m, q):
    """A strictly interior start with the padded rows pinned."""
    z0 = 0.1 * rng.standard_normal((B, n))
    s0 = np.where(np.asarray(rmask) > 0, 1.0 + rng.random((B, m)),
                  np.asarray(h))
    lam0 = np.where(np.asarray(rmask) > 0, 1.0 + rng.random((B, m)), 1e-300)
    nu0 = 0.1 * rng.standard_normal((B, q))
    return z0, s0, lam0, nu0


def both_loops(seed, fd, q, **kw):
    """(port, JAX) fused-loop results from one start, unrotated."""
    rng = np.random.default_rng(seed)
    B, n, C = 4, 9, 4
    qd, p, G, h, A, b, F, rmask = engine_instance(rng, B, n, C, fd=fd, q=q)
    x0 = start_point(rng, rmask, h, B, n, G.shape[1], q)
    kw = dict(kw, C=C, fd=fd, fric_pair=False)
    ref = jax_ipm.fused_ipm(qd, p, G, h, A, b, F.mu, F.valid, rmask, *x0,
                            consts=CONSTS, **kw)
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float64)
    got = ipm.fused_ipm(ipm.unrot_operands(t(qd), t(G), t(A), C), t(p),
                        t(h), t(b), t(F.mu), t(F.valid), t(rmask),
                        *map(t, x0), consts=CONSTS, **kw)
    return got, ref


@pytest.mark.parametrize("fd,q", [(2, 0), (2, 3), (1, 0), (1, 3)])
def test_unrot_fused_loop_capped_matches_jax_kernel(fd, q):
    """Four iterations on every world (no stopping rule fires): z, s, lam,
    nu per world within 1e-10 of the Pallas kernel.  fd = 2 holds the
    gamma recovery's sum over both friction directions (fd = 1 alone
    would pass a kernel that reads only the first)."""
    got, ref = both_loops(60 + 10 * fd + q, fd, q, max_iter=4, tol=0.0,
                          not_improved_lim=0)
    for g, r, name in zip(got[:4], ref[:4], ("z", "s", "lam", "nu")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10,
                                   atol=1e-10, err_msg=name)
    np.testing.assert_array_equal(got[6].numpy(), 4)
    np.testing.assert_array_equal(np.asarray(ref[6]), 4)


def test_unrot_fused_loop_full_run_matches_jax_kernel():
    """The solver's own stopping rules (tol 1e-10, stall limit 3) on a seed
    where both stop at the same iterations: within 1e-8."""
    got, ref = both_loops(83, 2, 3, max_iter=25, tol=1e-10,
                          not_improved_lim=3)
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(ref[6]))
    for g, r in zip(got[:6], ref[:6]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-8,
                                   atol=1e-8)
    assert float((got[4] + got[5]).max()) < 1e-9


class _Stop(Exception):
    pass


@pytest.mark.parametrize("C,q,fd,fric_pair", [
    (4, 0, 2, False), (4, 0, 2, True), (12, 0, 2, False), (12, 0, 2, True),
    (16, 0, 2, False), (16, 1, 2, False), (18, 0, 2, False),
    (18, 0, 2, True), (24, 0, 2, True), (24, 1, 2, True), (12, 3, 1, True),
    (23, 2, 1, False), (24, 1, 1, False)])
def test_fused_dispatch_matches_jax(C, q, fd, fric_pair, monkeypatch):
    """``lcp_solve_full`` reaches the fused loop, rotated or unrotated,
    exactly where the JAX package's dispatch does (``lcp/pdipm.py``
    :1139-1183): the rotated kernel when ``fric_pair`` holds at fd = 2 and
    2C + q <= 48, else the unrotated one when (1 + fd)C + q <= 48 (with
    ``fric_pair`` at fd = 1 too, as there).  Each package's fused entry is
    replaced by a recorder that stops the solve."""
    seen = {}

    def recorder(pkg):
        def fake(*a, **k):   # the variant that runs: rotated or not
            seen[pkg] = bool(k["fric_pair"]) and k["fd"] == 2
            raise _Stop
        return fake

    monkeypatch.setattr(jax_ipm, "fused_ipm", recorder("jax"))
    monkeypatch.setattr(ipm, "fused_ipm", recorder("port"))
    rng = np.random.default_rng(C * 100 + q)
    qd, p, G, h, A, b, F, rmask = engine_instance(
        rng, 2, 6, C, fd=fd, q=q, pair=fric_pair and fd == 2)
    kw = dict(max_iter=1, tol=1e-10, q_is_diag=True, gamma_rows=C,
              fric_pair=fric_pair)
    # the JAX solve is traced, not compiled: the dispatch is trace-time
    for pkg, solve in (("jax", lambda: jax.make_jaxpr(
            lambda: jax_lcp_solve_full(qd, p, G, h, A, b, F, backend="fused",
                                       row_mask=rmask, **kw))()),
            ("port", lambda: lcp_solve_full(
                *(torch.tensor(np.asarray(x)) for x in (qd, p, G, h, A, b)),
                ConeF(torch.tensor(np.asarray(F.mu)),
                      torch.tensor(np.asarray(F.valid)), fd),
                row_mask=torch.tensor(np.asarray(rmask)), **kw))):
        try:
            solve()
        except _Stop:
            pass
    assert seen.get("port") == seen.get("jax")
    rot = fric_pair and fd == 2 and 2 * C + q <= ipm.MAX_FUSED_K
    fits = rot or (1 + fd) * C + q <= ipm.MAX_FUSED_K
    assert seen.get("port") == (rot if fits else None)


# (C, q, n, refine, factor the solves use): K = 3C + q unrotated rows
GAMMA = {"lane60": (20, 0, 30, 0, "Tensor"),
         "panel120": (38, 6, 60, 0, "BlockedFactor"),
         "panels270": (90, 0, 40, 0, "BlockedFactor"),
         "lane60_refine1": (20, 0, 30, 1, "Tensor")}


@pytest.mark.parametrize("case", list(GAMMA))
def test_capped_unrot_gamma_loop_matches_jax(case, monkeypatch):
    """The unfused loop over the unrotated gamma factor (K = 3C + q > 48,
    past the fused kernel) on runs capped at 5 iterations, every world
    within 1e-10 of JAX backend="pallas": the lane LU (K = 60), one blocked
    panel (K = 120, with equality rows), three panels (K = 270) and the
    lane LU at refine 1 (each solve refined once against the assembled
    system)."""
    C, q, n, refine, factor = GAMMA[case]
    seen = set()
    orig = pdipm._solve_refined

    def spy(fac, apply, rhs, trans, steps):
        seen.add((type(fac).__name__, trans, steps))
        return orig(fac, apply, rhs, trans, steps)

    monkeypatch.setattr(pdipm, "_solve_refined", spy)
    rng = np.random.default_rng(C * 10 + refine)
    qd, p, G, h, A, b, F, rmask = engine_instance(rng, 2, n, C, q=q)
    K = 3 * C + q
    assert not ipm.fused_supported(3 * C, q, C, 2)
    assert linalg.blocked_path(K) == (factor == "BlockedFactor")
    k = 5
    kw = dict(max_iter=k, tol=0.0, q_is_diag=True, gamma_rows=C,
              not_improved_lim=0, refine=refine)
    got, ref = solve_both(qd, p, G, h, A, b, F, rmask, jit=True, **kw)
    check_capped(got, ref, k)
    assert seen == {(factor, 0, refine)}
