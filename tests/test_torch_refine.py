"""The port's solver with iterative refinement (``refine`` > 0) vs the JAX
package's with backend="pallas" (its factors in interpret mode), f64 on
CPU, on each factor branch refinement rides:

* K2 <= 88 (K2 = 18 and 75): the lane LU, refined against the assembled
  Schur system.  At K2 = 18, within the whole-IPM kernel's size, refine
  must keep the solve out of that kernel as the JAX package does;
* 88 < K2 <= 256: the explicit inverse (one panel at K2 = 96, two at
  K2 = 146), refined ``INV_REFINE + refine`` times against the structured
  system;
* K2 > 256: the blocked LU, refined against the assembled system.

Every world is held on runs capped at 6 iterations (``tol=0``,
``not_improved_lim=0``: no stopping rule fires), as
test_torch_pdipm_capped.py holds the loop at refine 0.  The gradient of
``lcp_solve`` at refine 1 is held to ``jax.grad`` through an uncapped
solve, and its transposed solve to the forward's factor mode (at f64 the
refined and unrefined transposed solves agree to ~1e-15, so only the mode
shows a backward that drops ``refine``).  The dense grid of
test_torch_train.py runs with SimConfig(solver_refine=1) against the JAX
record tests/data/torch_refine_golden.json, which
``PYTHONPATH=. python tests/test_torch_refine.py`` (from the repository
root) rewrites.
"""
import functools
import os

import jax
import numpy as np
import pytest
import torch

from lcp_physics_tpu.lcp import lcp_solve as jax_lcp_solve
from test_fused_ipm import engine_instance
from test_torch_pdipm_capped import check_capped
from test_torch_pdipm import one_torch_thread, solve_both  # noqa: F401
from test_torch_train import (GRID, check, check_record, golden_record,
                              grid_start, port_train, write_record)

from lcp_physics_tpu_torch.lcp import ConeF, lcp_solve, pdipm
from lcp_physics_tpu_torch.ops import ipm, linalg

REFINE_GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                             "torch_refine_golden.json")

# (C, q, n, refine, factor the refined solves use)
CASES = {"lane": (8, 2, 30, 1, "Tensor"),
         "lane75": (36, 3, 80, 1, "Tensor"),
         "inv1": (48, 0, 100, 1, "InvFactor"),
         "inv2": (72, 2, 150, 2, "InvFactor"),
         "blocked": (130, 2, 270, 1, "BlockedFactor")}


@pytest.fixture
def solves(monkeypatch):
    """Records (factor type, trans, refinement steps) of every reduced
    solve, and the whole-IPM kernel's calls."""
    seen = {"solves": [], "fused_ipm": 0}
    orig = pdipm._solve_refined

    def spy(fac, apply, rhs, trans, steps):
        seen["solves"].append((type(fac).__name__, trans, steps))
        return orig(fac, apply, rhs, trans, steps)

    def no_fused(*a, **k):
        seen["fused_ipm"] += 1
        return orig_fused(*a, **k)

    orig_fused = ipm.fused_ipm
    monkeypatch.setattr(pdipm, "_solve_refined", spy)
    monkeypatch.setattr(ipm, "fused_ipm", no_fused)
    return seen


@pytest.mark.parametrize("case", list(CASES))
def test_capped_refined_loop_matches_jax(case, solves):
    C, q, n, refine, factor = CASES[case]
    rng = np.random.default_rng(C * 1000 + refine)
    qd, p, G, h, A, b, F, rmask = engine_instance(rng, 2, n, C, q=q,
                                                  pair=True)
    K2 = 2 * C + q
    steps = refine + (pdipm.INV_REFINE if factor == "InvFactor" else 0)
    assert linalg.blocked_path(K2) == (factor != "Tensor")
    assert linalg.inv_supported(K2) == (factor != "BlockedFactor")
    k = 6
    kw = dict(max_iter=k, tol=0.0, q_is_diag=True, gamma_rows=C,
              fric_pair=True, not_improved_lim=0, refine=refine)
    got, ref = solve_both(qd, p, G, h, A, b, F, rmask, jit=True, **kw)
    check_capped(got, ref, k)
    assert solves["fused_ipm"] == 0
    assert set(solves["solves"]) == {(factor, 0, steps)}


def test_refined_gradients_match_jax(solves):
    """Uncapped solve at refine 1 on a one-panel instance with equality
    rows (K2 = 91: explicit inverse, two refinement steps per solve), its
    z and the gradients of all seven inputs against jax.grad; the
    backward's transposed solve runs in the same mode.  The two-panel
    backward is held by the grid record below (K2 = 144)."""
    C, q, n = 44, 3, 100
    rng = np.random.default_rng(44001)
    qd, p, G, h, A, b, F, rmask = engine_instance(rng, 3, n, C, q=q,
                                                  pair=True)
    w = rng.standard_normal((3, n))
    kw = dict(max_iter=25, tol=1e-10, q_is_diag=True, gamma_rows=C,
              fric_pair=True, not_improved_lim=3, refine=1)

    def loss(qd, p, G, h, A, b, F):
        z = jax_lcp_solve(qd, p, G, h, A, b, F, backend="pallas",
                          row_mask=rmask, **kw)
        return (z * w).sum(), z

    (_, z_j), want = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(7)), has_aux=True))(qd, p, G, h, A, b, F)
    want = [np.asarray(x) for x in want[:6]] + [np.asarray(want[6].mu)]
    t = [torch.tensor(np.asarray(x), dtype=torch.float64)
         for x in (qd, p, G, h, A, b, F.mu, F.valid)]
    for x in t[:7]:
        x.requires_grad_(True)
    z = lcp_solve(*t[:6], ConeF(t[6], t[7], 2),
                  row_mask=torch.tensor(np.asarray(rmask)), **kw)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_j),
                               rtol=1e-8, atol=1e-8)
    forward = set(solves["solves"])
    (z * torch.tensor(w)).sum().backward()
    for name, x, g in zip(("Q", "p", "G", "h", "A", "b", "mu"), t, want):
        scale = max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=1e-8,
                                   atol=1e-8 * scale, err_msg=name)
    steps = pdipm.INV_REFINE + 1
    assert forward == {("InvFactor", 0, steps)}
    assert set(solves["solves"]) - forward == {("InvFactor", 1, steps)}


@functools.lru_cache(maxsize=None)
def refine_record():
    return golden_record("tests/test_torch_refine.py", solver_refine=1)


def test_refined_grid_train_step_matches_jax():
    """The 4x4 grid (K2 = 144: the explicit inverse over two panels) with
    SimConfig(solver_refine=1): loss 1e-10, gradients 1e-8."""
    rec = refine_record()
    p0, v0 = grid_start(GRID["B"], GRID["side"])
    got = port_train(p0, v0, GRID["c_max"], GRID["steps"], solver_refine=1)
    want = (rec["loss"], [np.asarray(rec["grad_" + k]) for k in
                          ("mass", "restitution", "fric_coeff", "v0")])
    check(got, want, 1e-8)


def test_refine_golden_record_matches_jax():
    check_record(REFINE_GOLDEN, refine_record())


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    write_record(REFINE_GOLDEN, refine_record())
