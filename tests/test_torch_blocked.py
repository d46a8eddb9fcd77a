"""The blocked factor and substitution a panel step at a time, against the
per-block transcription (``torch_inputs.per_block_factor`` and
``per_block_solve``, one product and one subtraction per 128 x 128
block), f64 on the CPU: the blocks and panel inverses, both solves, the
count of batched products and matvecs (``linalg.PANEL_PRODUCTS``) and
of padded copies (``linalg.LAUNCHES["pad"]``), the input left whole where the caller keeps it, and gradients where autograd
records through the factor.  The JAX package holds the same factor in
tests/test_torch_gj.py.
"""
import numpy as np
import pytest
import torch

from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import (engine_instance, kkt_batch, per_block_factor,
                          per_block_solve)
from lcp_physics_tpu_torch.lcp import pdipm
from lcp_physics_tpu_torch.lcp.cone import ConeF
from lcp_physics_tpu_torch.ops import ipm, linalg

P = linalg.PANEL
TOL = 1e-12


def case(T, padded, B=2, seed=0):
    """(K, r) f64 with T panels: n whole panels, or 37 rows short of them
    (one panel: 100 rows, past the lane path)."""
    n = T * P - (37 if padded and T > 1 else 28 if padded else 0)
    rng = np.random.default_rng(seed + 10 * T + padded)
    return (torch.tensor(kkt_batch(rng, B, n)),
            torch.tensor(rng.standard_normal((B, n))))


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("trans", [0, 1])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("T", [1, 2, 3, 4, 5])
def test_panel_steps_match_per_block(T, padded, trans, exact):
    K, r = case(T, padded)
    K0 = K.clone()
    fac = linalg.plu_factor(K, exact)
    assert isinstance(fac, linalg.BlockedFactor)
    assert torch.equal(K, K0)
    blocks, binv, n = per_block_factor(K, exact)
    assert fac.n == n and len(fac.blocks) == T
    assert rel(fac.binv, binv) <= TOL
    for row, ref_row in zip(fac.blocks, blocks):
        for got, want in zip(row, ref_row):
            assert rel(got, want) <= TOL
    x = linalg.plu_solve(fac, r, trans)
    assert rel(x, per_block_solve((blocks, binv, n), r, trans)) <= TOL
    Kop = K if trans == 0 else K.transpose(1, 2)
    assert rel(torch.einsum("bij,bj->bi", Kop, x), r) <= 1e-10


@pytest.mark.parametrize("T", [1, 2, 3, 4, 5])
def test_panel_products_a_factor_and_a_solve(T):
    """2(T - 1) batched products a factor (Uhat's row panel and the
    trailing update a panel step) and 3T - 2 matvecs a solve (one with
    each panel inverse, and in each sweep one a block but the first)."""
    K, r = case(T, False)
    before = dict(linalg.PANEL_PRODUCTS)
    fac = linalg.plu_factor(K)
    assert linalg.PANEL_PRODUCTS["factor"] - before["factor"] == 2 * (T - 1)
    for trans in (0, 1):
        before = dict(linalg.PANEL_PRODUCTS)
        linalg.plu_solve(fac, r, trans)
        assert linalg.PANEL_PRODUCTS["solve"] - before["solve"] == 3 * T - 2


@pytest.mark.parametrize("factor, n, pads", [
    ("blocked", 289, 1), ("blocked", 256, 0), ("blocked", 100, 1),
    ("inverse", 200, 1), ("inverse", 256, 0)])
def test_pad_count_once_per_padded_factor(factor, n, pads):
    """``LAUNCHES["pad"]`` counts one padded copy a factor of a system that
    is not whole panels (289 rows: the chain's rotated system, three
    panels) and none at whole panels, whatever the solves after it."""
    rng = np.random.default_rng(n)
    K = torch.tensor(kkt_batch(rng, 2, n))
    r = torch.tensor(rng.standard_normal((2, n)))
    make = linalg.plu_factor if factor == "blocked" else \
        linalg.inv_factor_blocks
    before = linalg.LAUNCHES["pad"]
    fac = make(K)
    for trans in (0, 1):
        linalg.plu_solve(fac, r, trans)
    assert linalg.LAUNCHES["pad"] - before == pads


@pytest.mark.parametrize("padded", [False, True])
def test_overwrite_takes_whole_panels_only(padded):
    """With ``overwrite`` the factor keeps Lhat in K's own storage when K
    is whole panels; a padded K stays as it was."""
    K, r = case(3, padded)
    K0 = K.clone()
    fac = linalg.plu_factor(K, overwrite=True)
    assert (fac.lower.data_ptr() == K.data_ptr()) == (not padded)
    assert torch.equal(K, K0) == padded
    want = per_block_solve(per_block_factor(K0), r)
    assert rel(linalg.plu_solve(fac, r), want) <= TOL


@pytest.fixture
def factored(monkeypatch):
    """Records, for every blocked factorization, whether ``overwrite`` was
    asked for, whether its input was left as it came, the input as it came
    and the factor."""
    seen = []
    orig = linalg.plu_factor_blocks

    def spy(K, exact=False, overwrite=False):
        K0 = K.clone()
        fac = orig(K, exact, overwrite)
        seen.append((overwrite, torch.equal(K, K0), K0, fac))
        return fac
    monkeypatch.setattr(linalg, "plu_factor_blocks", spy)
    return seen


@pytest.mark.parametrize("refine", [0, 1])
def test_rotated_factor_keeps_what_refinement_reads(factored, refine):
    """Past INV_MAX_PANELS (K2 = 384, three whole panels) a refined solve
    reads the Schur matrix again, so its factor leaves it whole; unrefined,
    the factor takes it over.  Either way the factor solves as the per-block
    factor of the same matrix."""
    C, q = 190, 4
    qd, p, G, h, A, b, mu, valid, _ = (
        torch.tensor(x) for x in engine_instance(
            np.random.default_rng(7), 2, 270, C, q))
    consts = pdipm._dtype_consts(torch.float64)
    factor = pdipm._rot_factor_factory(ipm.rot_operands(qd, G, A, C),
                                       ConeF(mu, valid), consts["reg"],
                                       refine=refine)
    factor(torch.tensor(np.random.default_rng(8).uniform(
        0.1, 10.0, (2, 4 * C))))
    [(overwrite, unchanged, S, fac)] = factored
    assert (overwrite, unchanged) == (not refine, bool(refine))
    want = per_block_factor(S)
    rhs = torch.tensor(np.random.default_rng(9).standard_normal(
        (2, 2 * C + q)))
    for trans in (0, 1):
        assert rel(linalg.plu_solve(fac, rhs, trans),
                   per_block_solve(want, rhs, trans)) <= TOL


@pytest.mark.parametrize("trans", [0, 1])
@pytest.mark.parametrize("padded", [False, True])
def test_gradients_through_the_factor(monkeypatch, padded, trans):
    """With autograd recording through K and r, the panel steps run out of
    place and give the per-block factor's gradients.  The panel inverse is
    ``torch.linalg.inv`` here (the plain Gauss-Jordan version works in
    place, the kernels are not differentiable); both factors take it."""
    monkeypatch.setattr(linalg, "_gj_inverse",
                        lambda A, exact=False: torch.linalg.inv(A))
    K, r = case(3, padded)
    w = torch.tensor(np.random.default_rng(3).standard_normal(r.shape))
    grads = []
    for factor, solve in ((linalg.plu_factor, linalg.plu_solve),
                          (per_block_factor, per_block_solve)):
        Kg, rg = K.clone().requires_grad_(), r.clone().requires_grad_()
        x = solve(factor(Kg), rg, trans)
        (x * w).sum().backward()
        grads.append((x.detach(), Kg.grad, rg.grad))
        assert torch.equal(Kg.detach(), K)
    for got, want in zip(*grads):
        assert rel(got, want) <= TOL


@pytest.mark.parametrize("trans", [0, 1])
def test_rhs_gradient_with_the_panel_kernels_path(trans):
    """The factor made without autograd (the solver's case: the panel
    inverses' plain versions), the substitution recording through r: the
    gradient is the transposed solve's, as the per-block substitution's."""
    K, r = case(4, True)
    fac = linalg.plu_factor(K)
    ref = per_block_factor(K)
    w = torch.tensor(np.random.default_rng(4).standard_normal(r.shape))
    got = []
    for f, solve in ((fac, linalg.plu_solve), (ref, per_block_solve)):
        rg = r.clone().requires_grad_()
        (solve(f, rg, trans) * w).sum().backward()
        got.append(rg.grad)
    assert rel(got[0], got[1]) <= TOL
    assert rel(got[0], linalg.plu_solve(fac, w, 1 - trans)) <= TOL
