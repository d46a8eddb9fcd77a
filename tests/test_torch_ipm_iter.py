"""The port's fused per-iteration loop (``ops.ipm_iter``, K6; its plain
torch iteration on CPU) vs the JAX package's (the Pallas kernel in
interpret mode), f64, with ``FUSE_ITER`` switched on in both packages as
tests/test_fused_ipm.py switches it.  The JAX kernel takes batches of 128
worlds only, so the comparisons with it run at B = 128 (n = 64, the
instances of test_fused_ipm.py); the port has no such rule, and the
tests that need no JAX kernel run smaller."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lcp_physics_tpu.lcp.pdipm as jax_pdipm
import lcp_physics_tpu.ops.ipm_iter as jax_ipm_iter
from lcp_physics_tpu.lcp import lcp_solve as jax_lcp_solve
from lcp_physics_tpu.lcp.pdipm import pdipm_solve as jax_pdipm_solve
from test_fused_ipm import engine_instance
from test_torch_pdipm import one_torch_thread, solve_both, to_port  # noqa: F401
from test_torch_pdipm_capped import check_capped

from lcp_physics_tpu_torch.lcp import ConeF, lcp_solve, lcp_solve_full, pdipm
from lcp_physics_tpu_torch.ops import ipm_iter

B, N = 128, 64


class Dispatched(Exception):
    pass


@pytest.fixture
def fuse_iter(monkeypatch):
    """FUSE_ITER on in both packages; counts the port's and the JAX
    package's calls of fused_iter_ipm."""
    calls = {"port": 0, "jax": 0}
    for mod in (pdipm, jax_pdipm):
        monkeypatch.setattr(mod, "FUSE_ITER", True)
    for key, mod in (("port", ipm_iter), ("jax", jax_ipm_iter)):
        def spy(*a, _o=mod.fused_iter_ipm, _k=key, **k):
            calls[_k] += 1
            return _o(*a, **k)
        monkeypatch.setattr(mod, "fused_iter_ipm", spy)
    return calls


@pytest.mark.parametrize("C,q", [(45, 0), (48, 8), (70, 0)])
def test_capped_fused_iter_matches_jax(C, q, fuse_iter):
    """Four iterations on every world (no stopping rule fires): K2 = 90
    (one panel), 104 (with equality rows) and 140 (two panels).  The JAX
    kernel solves all 128 worlds; the port, which solves each world on its
    own, the first 32 of them."""
    rng = np.random.default_rng(C + q)
    qd, p, G, h, A, b, F, rmask = engine_instance(rng, B, N, C, q=q,
                                                  pair=True)
    k = 4
    kw = dict(max_iter=k, tol=0.0, q_is_diag=True, gamma_rows=C,
              fric_pair=True, not_improved_lim=0)
    before = pdipm.HOST_READS["ipm_loop"]
    got, ref = solve_both(qd, p, G, h, A, b, F, rmask, jit=True, worlds=32,
                          **kw)
    assert fuse_iter == {"port": 1, "jax": 1}
    assert pdipm.HOST_READS["ipm_loop"] - before == k - 1
    check_capped(got, ref, k)


def test_fused_iter_matches_unfused_loop(fuse_iter):
    """A full run (tol = 1e-11, the stall rule on) held as
    tests/test_fused_ipm.py::test_fused_iter_kernel_matches_xla holds the
    JAX kernel: against the port's unfused loop, no world meaningfully
    worse, z to 1e-5 on the worlds the unfused loop solves to 1e-8, padded
    rows pinned exactly."""
    C, q, Bs = 48, 8, 16
    rng = np.random.default_rng(11)
    qd, p, G, h, A, b, F, rmask = engine_instance(rng, Bs, N, C, q=q,
                                                  pair=True)
    args = to_port(qd, p, G, h, A, b, F.mu, F.valid, rmask)
    kw = dict(max_iter=20, tol=1e-11, q_is_diag=True, gamma_rows=C,
              fric_pair=True, row_mask=args[8])
    tF = ConeF(args[6], args[7], 2)
    fus = lcp_solve_full(*args[:6], tF, **kw)
    assert fuse_iter["port"] == 1
    pdipm.FUSE_ITER = False
    ref = lcp_solve_full(*args[:6], tF, **kw)
    assert fuse_iter["port"] == 1
    ref_merit = (ref.resid + ref.mu).numpy()
    fus_merit = (fus.resid + fus.mu).numpy()
    np.testing.assert_array_less(fus_merit, ref_merit * 10 + 1e-8)
    ok = ref_merit < 1e-8
    assert ok.sum() >= int(0.9 * Bs)
    np.testing.assert_allclose(fus.z.numpy()[ok], ref.z.numpy()[ok],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        np.where(np.asarray(rmask) > 0, 0.0, fus.s.numpy() - np.asarray(h)),
        0.0)


@pytest.mark.parametrize("K2", [88, 90, 256, 264])
def test_fused_iter_dispatch_matches_jax(K2, fuse_iter, monkeypatch):
    """The port takes the fused per-iteration loop for the same K2 as the
    JAX package at B = 128: not at 88 (the lane LU) or 264 (three panels),
    at 90 and 256.  Each package's fused_iter_ipm is replaced by one that
    raises, and the JAX solve is only traced (jax.eval_shape).  The port's
    rule does not look at the batch, so it solves the first two worlds."""
    def stop(*a, **k):
        raise Dispatched

    monkeypatch.setattr(ipm_iter, "fused_iter_ipm", stop)
    monkeypatch.setattr(jax_ipm_iter, "fused_iter_ipm", stop)
    C, q = K2 // 2, K2 % 2
    rng = np.random.default_rng(K2)
    qd, p, G, h, A, b, F, rmask = engine_instance(rng, B, N, C, q=q,
                                                  pair=True)
    kw = dict(max_iter=1, tol=0.0, q_is_diag=True, gamma_rows=C,
              fric_pair=True, not_improved_lim=0)
    took = {}
    try:
        jax.eval_shape(lambda: jax_pdipm_solve(
            qd, p, G, h, A, b, F, backend="pallas", row_mask=rmask, **kw))
        took["jax"] = False
    except Dispatched:
        took["jax"] = True
    args = [x[:2] for x in to_port(qd, p, G, h, A, b, F.mu, F.valid, rmask)]
    try:
        lcp_solve_full(*args[:6], ConeF(args[6], args[7], 2),
                       row_mask=args[8], **kw)
        took["port"] = False
    except Dispatched:
        took["port"] = True
    assert took == {"jax": K2 in (90, 256), "port": K2 in (90, 256)}


@pytest.mark.parametrize("n,fused", [(3689, True), (3690, False)])
def test_fused_iter_dispatch_within_shared_memory(n, fused, fuse_iter,
                                                  monkeypatch):
    """At f64 and K2 = 90 the kernel's 232,448 B of shared memory per world
    hold the vectors of at most 3,689 unknowns; past that the port runs the
    unfused loop, as the JAX package's VMEM term sends large n to its
    own."""
    def stop(*a, **k):
        raise Dispatched

    monkeypatch.setattr(ipm_iter, "fused_iter_ipm", stop)
    C = 45
    assert (ipm_iter.smem_bytes(n, C, 0, 8) <= ipm_iter.SMEM_LIMIT) == fused
    qd, p, G, h, _, _, F, rmask = engine_instance(np.random.default_rng(n),
                                                  1, n, C, pair=True)
    t = to_port(qd, p, G, h, F.mu, F.valid, rmask)
    try:
        lcp_solve_full(*t[:4], None, None, ConeF(t[4], t[5], 2),
                       row_mask=t[6], max_iter=1, tol=0.0, q_is_diag=True,
                       gamma_rows=C, fric_pair=True, not_improved_lim=0)
        took = False
    except Dispatched:
        took = True
    assert took == fused


def test_fused_iter_gradients_match_jax(fuse_iter):
    """Gradients of lcp_solve through the port's fused per-iteration loop
    against jax.grad, on the worlds whose duals agree (as
    tests/test_fused_ipm.py::test_fused_iter_gradients_match compares the
    JAX package's two loops).  The implicit gradient is a function of the
    solution alone, so the JAX side runs its unfused loop, at a batch its
    kernel's 128-lane rule would refuse."""
    C, Bs = 48, 8
    rng = np.random.default_rng(13)
    qd, p, G, h, A, b, F, rmask = engine_instance(rng, Bs, N, C, pair=True)
    kw = dict(max_iter=20, tol=1e-11, q_is_diag=True, gamma_rows=C,
              fric_pair=True)
    jax_pdipm.FUSE_ITER = False

    @jax.jit
    def jax_side(h_):
        loss = lambda h_: jnp.sum(jax_lcp_solve(
            qd, p, G, h_, None, None, F, backend="pallas", row_mask=rmask,
            **kw) ** 2)
        sol = jax_pdipm_solve(qd, p, G, h_, A, b, F, backend="pallas",
                              row_mask=rmask, **kw)
        return jax.grad(loss)(h_), sol.lam

    g_j, lam_j = jax_side(h)
    t = to_port(qd, p, G, h, F.mu, F.valid, rmask)
    t[3].requires_grad_(True)
    z = lcp_solve(*t[:4], None, None, ConeF(t[4], t[5], 2), row_mask=t[6],
                  **kw)
    (z ** 2).sum().backward()
    assert fuse_iter == {"port": 1, "jax": 0}
    lam = lcp_solve_full(*(x.detach() for x in t[:4]), None, None,
                         ConeF(t[4], t[5], 2), row_mask=t[6], **kw).lam
    same = np.abs(lam.numpy() - np.asarray(lam_j)).max(-1) < 1e-5
    assert same.sum() >= int(0.8 * Bs)
    np.testing.assert_allclose(t[3].grad.numpy()[same],
                               np.asarray(g_j)[same], rtol=1e-4, atol=1e-5)


def _supported_rule(C, q, n, itemsize):
    """fused_iter_supported's rule written out: 88 < ru(K2, 8),
    K2 <= 256, and the world's vectors within 232,448 bytes."""
    m, K2 = 4 * C, 2 * C + q
    elems = (n + 2 * m + q) + 6 * n + 11 * m + 3 * max(q, 1) + 7 * C \
        + 6 * K2 + 32
    return -(-K2 // 8) * 8 > 88 and K2 <= 256 and elems * itemsize <= 232448


def test_fused_iter_supported_admits_the_same_shapes():
    grid = [(C, q, n, item) for C in (40, 44, 45, 52, 64, 100, 124, 128, 129)
            for q in (0, 1, 2, 8, 40) for n in (1, 64, 191, 1201, 2800, 3689,
                                                3690, 5000, 9000)
            for item in (4, 8)]
    for g in grid:
        assert ipm_iter.fused_iter_supported(*g) == _supported_rule(*g), g


# K6's card-test shapes (tests/test_torch_cuda.py::ITER_CASES)
ITER_CASES = [(44, 1, 63), (52, 0, 64), (48, 8, 65), (71, 2, 129),
              (128, 0, 191), (124, 8, 64), (124, 8, 193), (128, 0, 1201)]


@pytest.mark.parametrize("C,q,n", ITER_CASES)
def test_plain_f32_one_ulp_spread(C, q, n):
    """The plain f32 loop capped at 3 iterations, at p and at p moved by
    one ulp, on the card test's instances (13 worlds): the spread of z
    stays within 1e-4 on every shape but (124, 8, 64), a Schur system of
    rank 64 in 256 rows, where it passes 1e-3.  The card test holds K6's
    capped f32 runs to max(1e-3, 10x this spread)."""
    from chip_smoke import engine_iter_case, ulp_tensor, world_rel
    vecs, X0, fac, _, consts = engine_iter_case(
        torch, torch.device("cpu"), 13, n, C, q, torch.float32, C + q + n)
    cap = dict(C=C, consts=consts, max_iter=3, tol=0.0, not_improved_lim=0,
               inv_raw=fac.iter_inv_raw)
    r3 = ipm_iter.fused_iter_ipm(*vecs, X0, **cap)
    u3 = ipm_iter.fused_iter_ipm(vecs[0], vecs[1], ulp_tensor(torch, vecs[2]),
                                 *vecs[3:], X0, **cap)
    spread = float(world_rel(u3[0][:, :n], r3[0][:, :n]).max())
    if (C, q, n) == (124, 8, 64):
        assert spread > 1e-3
    else:
        assert spread <= 1e-4


@pytest.mark.parametrize("C,q,n", [(44, 1, 63), (71, 2, 129), (124, 8, 64)])
def test_iteration_copies_done_worlds_through(C, q, n):
    """On CPU tensors ``iteration`` runs the plain version (no launch): a
    world already done keeps X, bestX and its state bit for bit, and a live
    world moves."""
    from chip_smoke import engine_iter_case
    vecs, X0, _, inv, consts = engine_iter_case(
        torch, torch.device("cpu"), 7, n, C, q, torch.float64, C + q + n)
    state = ipm_iter.initial_state(7, 10, torch.float64, X0.device)
    state[::3, 1] = 1.0
    bestX = X0 + 1.0
    before = dict(ipm_iter.LAUNCHES)
    got = ipm_iter.iteration(inv, *vecs, X0, bestX, state, 2, C=C,
                             consts=consts, tol=1e-8, not_improved_lim=3,
                             stall_rtol=0.0)
    assert ipm_iter.LAUNCHES == before
    for g, x0 in zip(got, (X0, bestX, state)):
        assert torch.equal(g[::3], x0[::3])
    live = [i for i in range(7) if i % 3]
    assert not torch.equal(got[0][live], X0[live])
    assert bool(torch.isfinite(got[0]).all())
