"""The port's implicit-KKT backward of ``lcp_solve`` vs ``jax.grad`` of the
JAX package's (f64, CPU): gradients for all seven inputs (diagonal Q, p,
G, h, A, b and the friction coefficients of ``ConeF``) on each forward
path — the fused loop (K2 <= 48), the unfused loop over the lane LU
(48 < K2 <= 88) and over the blocked LU (K2 > 88) — plus a
finite-difference check of the port's own gradient."""
import jax
import numpy as np
import pytest
import torch

from lcp_physics_tpu.lcp import lcp_solve as jax_lcp_solve
from test_fused_ipm import engine_instance
from test_torch_pdipm import one_torch_thread  # noqa: F401

from lcp_physics_tpu_torch.lcp import ConeF, lcp_solve

# (C, q, n, seed, JAX backend): K2 = 2C + q = 18, 75 and 91
CASES = {"fused": (8, 2, 30, 8000, "fused"),
         "lane": (36, 3, 80, 36000, "pallas"),
         "blocked": (44, 3, 100, 44000, "pallas")}


def instance(case):
    C, q, n, seed, backend = CASES[case]
    rng = np.random.default_rng(seed)
    inst = engine_instance(rng, 3, n, C, q=q, pair=True)
    w = rng.standard_normal((3, n))
    kw = dict(max_iter=25, tol=1e-10, q_is_diag=True, gamma_rows=C,
              fric_pair=True, not_improved_lim=3)
    return inst, w, kw, backend


def port_loss(t, w, kw, rmask):
    qd, p, G, h, A, b, mu, valid = t
    z = lcp_solve(qd, p, G, h, A, b, ConeF(mu, valid, 2), row_mask=rmask,
                  **kw)
    return (z * w).sum()


@pytest.mark.parametrize("case", list(CASES))
def test_lcp_solve_grads_match_jax(case):
    (qd, p, G, h, A, b, F, rmask), w, kw, backend = instance(case)

    def loss(qd, p, G, h, A, b, F):
        z = jax_lcp_solve(qd, p, G, h, A, b, F, backend=backend,
                          row_mask=rmask, **kw)
        return (z * w).sum()

    want = jax.grad(loss, argnums=tuple(range(7)))(qd, p, G, h, A, b, F)
    want = [np.asarray(x) for x in want[:6]] + [np.asarray(want[6].mu)]
    t = [torch.tensor(np.asarray(x), dtype=torch.float64)
         for x in (qd, p, G, h, A, b, F.mu, F.valid)]
    for x in t[:7]:
        x.requires_grad_(True)
    port_loss(t, torch.tensor(w), kw,
              torch.tensor(np.asarray(rmask))).backward()
    for name, x, g in zip(("Q", "p", "G", "h", "A", "b", "mu"), t, want):
        assert x.grad is not None and x.grad.shape == x.shape, name
        scale = max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=1e-8,
                                   atol=1e-8 * scale, err_msg=name)
    assert t[7].grad is None            # the mask gets no gradient


def test_lcp_solve_grad_matches_finite_differences():
    """Central differences of the port's own solve, as tests/test_pdipm.py
    checks the JAX package's rotated path, in p: the KKT map is smooth in
    p at these solutions.  Not in h: a gamma row's h = 0 of a contact with
    no normal force sits on a kink, and a sticking contact's +- friction
    rows are active together, where the implicit gradient is the
    regularized system's and differences are one-sided."""
    (qd, p, G, h, A, b, F, rmask), w, kw, _ = instance("fused")
    t = [torch.tensor(np.asarray(x), dtype=torch.float64)
         for x in (qd, p, G, h, A, b, F.mu, F.valid)]
    tw, trm = torch.tensor(w), torch.tensor(np.asarray(rmask))
    t[1].requires_grad_(True)
    port_loss(t, tw, kw, trm).backward()
    g = t[1].grad
    eps = 1e-6
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for _ in range(6):
            b_, k_ = int(rng.integers(0, 3)), int(rng.integers(0, g.shape[1]))
            tp = [x.detach().clone() for x in t]
            tm = [x.detach().clone() for x in t]
            tp[1][b_, k_] += eps
            tm[1][b_, k_] -= eps
            fd = (port_loss(tp, tw, kw, trm) - port_loss(tm, tw, kw, trm)) \
                / (2 * eps)
            np.testing.assert_allclose(float(g[b_, k_]), float(fd),
                                       rtol=2e-3, atol=1e-5)
