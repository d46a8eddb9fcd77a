"""The port's solver (initial Newton solve + fused IPM loop, plain torch
versions on CPU) vs the JAX package's fused whole-IPM Pallas kernel
(interpret mode), f64, on the engine-layout instances of
tests/test_fused_ipm.py with the friction-pair structure."""
import numpy as np
import pytest
import torch

from lcp_physics_tpu.lcp.pdipm import _dtype_consts as jax_consts
from lcp_physics_tpu.lcp.pdipm import pdipm_solve as jax_pdipm_solve
from lcp_physics_tpu.ops.ipm import fused_ipm as jax_fused_ipm
from lcp_physics_tpu.ops.ipm import fused_supported as jax_fused_supported
from test_fused_ipm import engine_instance

from lcp_physics_tpu_torch.lcp import (ConeF, lcp_solve_full, pdipm,
                                       pdipm_solve)
from lcp_physics_tpu_torch.ops import ipm


def to_port(qd, p, G, h, A, b, F, rmask):
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float64)
    return (t(qd), t(p), t(G), t(h), t(A), t(b),
            ConeF(t(F.mu), t(F.valid), F.fd), t(rmask))


def check_solution(got, ref):
    np.testing.assert_allclose(got.z.numpy(), np.asarray(ref.z),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(ref.lam),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    assert got.iters.dtype == torch.int32


@pytest.mark.parametrize("case", ["q0", "q3", "K48_edge", "rot_past_cap"])
def test_pdipm_matches_jax_fused(case):
    """Same cases and tolerances as test_fused_ipm.py's rotated-kernel
    tests, plus the K = MAX_FUSED_K edge."""
    seed, B, n, C, q = {"q0": (31, 6, 9, 4, 0), "q3": (31, 6, 9, 4, 3),
                        "K48_edge": (41, 3, 12, 24, 0),
                        "rot_past_cap": (37, 3, 12, 18, 0)}[case]
    rng = np.random.default_rng(seed)
    qd, p, G, h, A, b, F, rmask = engine_instance(rng, B, n, C, q=q,
                                                  pair=True)
    kw = dict(max_iter=25, tol=1e-11, q_is_diag=True, gamma_rows=C,
              fric_pair=True)
    ref = jax_pdipm_solve(qd, p, G, h, A, b, F, backend="fused",
                          row_mask=rmask, **kw)
    tq, tp, tG, th, tA, tb, tF, trm = to_port(qd, p, G, h, A, b, F, rmask)
    got = pdipm_solve(tq, tp, tG, th, tA, tb, tF, row_mask=trm, **kw)
    check_solution(got, ref)
    # padded rows pinned exactly
    np.testing.assert_allclose(
        np.where(rmask > 0, 0.0, got.s.numpy() - np.asarray(h)), 0.0,
        atol=1e-12)


def test_fused_loop_matches_jax_kernel_from_same_start():
    """The loop alone, from one shared starting iterate: the plain torch
    transcription against the Pallas kernel, to rounding."""
    rng = np.random.default_rng(53)
    B, n, C, q = 5, 10, 6, 2
    qd, p, G, h, A, b, F, rmask = engine_instance(rng, B, n, C, q=q,
                                                  pair=True)
    m = G.shape[1]
    z0 = 0.1 * rng.standard_normal((B, n))
    s0 = np.where(np.asarray(rmask) > 0, 1.0 + rng.random((B, m)),
                  np.asarray(h))
    lam0 = np.where(np.asarray(rmask) > 0, 1.0 + rng.random((B, m)), 1e-300)
    nu0 = 0.1 * rng.standard_normal((B, q))
    kw = dict(C=C, fd=2, max_iter=20, tol=1e-10, not_improved_lim=3,
              fric_pair=True)
    ref = jax_fused_ipm(qd, p, G, h, A, b, F.mu, F.valid, rmask, z0, s0,
                        lam0, nu0, consts=jax_consts(np.float64), **kw)
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float64)
    got = ipm.fused_ipm(ipm.rot_operands(t(qd), t(G), t(A), C), t(p), t(h),
                        t(b), t(F.mu), t(F.valid), t(rmask), t(z0), t(s0),
                        t(lam0), t(nu0), consts=jax_consts(np.float64), **kw)
    for g, r in zip(got[:4], ref[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-9,
                                   atol=1e-11)
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(ref[6]))


def own_start_case(rot, seed, B=6, n=9, C=4, q=3):
    """An engine instance with padded rows, as JAX arrays, and the port's
    fused_ipm arguments without a start (f64)."""
    rng = np.random.default_rng(seed)
    inst = engine_instance(rng, B, n, C, q=q, pair=rot)
    tq, tp, tG, th, tA, tb, tF, trm = to_port(*inst)
    ops = (ipm.rot_operands if rot else ipm.unrot_operands)(tq, tG, tA, C)
    args = (ops, tp, th, tb, tF.mu, tF.valid, trm)
    return inst, args, tF, dict(C=C, fd=2, fric_pair=rot,
                                consts=pdipm._dtype_consts(torch.float64))


@pytest.mark.parametrize("rot", [True, False])
def test_fused_own_start_matches_jax_start_and_kernel(rot):
    """``fused_ipm`` with no start given (the plain loop takes the
    solver's start itself) against the JAX package's solve through its
    fused kernel (its host start, then the Pallas kernel in interpret
    mode), on runs capped at 4 iterations: per world within 1e-9."""
    (qd, p, G, h, A, b, F, rmask), args, _, kw = own_start_case(rot, 61)
    assert float(np.asarray(rmask).min()) == 0.0      # padded rows present
    ref = jax_pdipm_solve(qd, p, G, h, A, b, F, backend="fused",
                          row_mask=rmask, max_iter=4, tol=0.0,
                          not_improved_lim=0, q_is_diag=True, gamma_rows=4,
                          fric_pair=rot)
    got = ipm.fused_ipm(*args, max_iter=4, tol=0.0, not_improved_lim=0,
                        **kw)
    for g, r in zip(got[:4], (ref.z, ref.s, ref.lam, ref.nu)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-9,
                                   atol=1e-9)
    np.testing.assert_array_equal(got[6].numpy(), 4)


@pytest.mark.parametrize("rot", [True, False])
def test_fused_own_start_is_the_initial_point(rot):
    """With ``max_iter=0`` the loop returns its own start: within 1e-10 of
    ``pdipm.initial_point`` (the host's LU factor) at f64, the padded rows
    pinned exactly at s = h, lam = tiny."""
    _, args, F, kw = own_start_case(rot, 67)
    got = ipm.fused_ipm(*args, max_iter=0, tol=1e-8, not_improved_lim=3,
                        **kw)
    ops, p, h, b, _, _, rmask = args
    want = pdipm.initial_point(ops, p, h, b, F, rmask, kw["consts"],
                               fric_pair=rot)
    for g, r in zip(got[:4], want):
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-10)
    pad = rmask == 0
    assert torch.equal(got[1][pad], h[pad])
    assert bool((got[2][pad] == kw["consts"]["tiny"]).all())
    assert bool((got[1][~pad] > 0).all() and (got[2][~pad] > 0).all())
    assert got[6].tolist() == [0] * p.shape[0]


def test_fused_start_is_all_or_nothing():
    _, args, _, kw = own_start_case(True, 71)
    z0 = torch.zeros_like(args[1])
    with pytest.raises(ValueError, match="all of"):
        ipm.fused_ipm(*args, z0, max_iter=1, tol=0.0, **kw)


def test_lcp_solve_full_and_dispatch_rules():
    rng = np.random.default_rng(23)
    B, n, C = 4, 6, 3
    qd, p, G, h, A, b, F, rmask = engine_instance(rng, B, n, C, pair=True)
    ref = jax_pdipm_solve(qd, p, G, h, A, b, F, backend="fused",
                          max_iter=20, tol=1e-10, q_is_diag=True,
                          gamma_rows=C, row_mask=rmask, fric_pair=True,
                          not_improved_lim=3)
    tq, tp, tG, th, _, _, tF, trm = to_port(qd, p, G, h, A, b, F, rmask)
    got = lcp_solve_full(tq, tp, tG, th, None, None, tF, max_iter=20,
                         tol=1e-10, q_is_diag=True, gamma_rows=C,
                         row_mask=trm, fric_pair=True)
    check_solution(got, ref)
    for mg, q, Cc, fp in [(12, 0, 4, True), (72, 0, 24, True),
                          (72, 1, 24, True), (36, 0, 12, False),
                          (54, 0, 18, False), (0, 0, 0, True)]:
        assert ipm.fused_supported(mg, q, Cc, 2, fric_pair=fp) == \
            jax_fused_supported(mg, q, Cc, 2, fric_pair=fp)
    # Once raised: fric_pair=False now takes the unrotated kernel (K = 9)
    # and gondzio the unfused loop, as in the JAX package.  (refine > 0
    # runs outside the fused kernel: tests/test_torch_refine.py.)
    for opts in (dict(fric_pair=False), dict(fric_pair=True, gondzio=1)):
        kw = dict(max_iter=20, tol=1e-10, q_is_diag=True, gamma_rows=C,
                  not_improved_lim=3, **opts)
        ref = jax_pdipm_solve(qd, p, G, h, A, b, F, backend="fused",
                              row_mask=rmask, **kw)
        got = lcp_solve_full(tq, tp, tG, th, None, None, tF, row_mask=trm,
                             **kw)
        check_solution(got, ref)


@pytest.mark.parametrize("K,KB,lanes", [(1, 16, 16), (16, 16, 16),
                                        (17, 24, 32), (24, 24, 32),
                                        (25, 32, 32), (32, 32, 32),
                                        (33, 48, 32), (48, 48, 32)])
def test_fused_launch_shape_buckets(K, KB, lanes):
    """The fused kernel's compile-time bucket is the least of 16, 24, 32,
    48 that holds K; a world takes 16 lanes in bucket 16, else 32, and a
    128-thread CTA holds 8 or 4 small worlds with Ghat in shared memory."""
    assert ipm.fused_bucket(K) == KB and ipm.world_lanes(KB) == lanes
    assert ipm.launch_shape(24, 32, 0, 8, K, 4) == (KB, 128 // lanes, 1)


def test_fused_launch_shape_within_shared_memory():
    """The per-world count repeats the kernel's carve (16-byte rounded
    arrays); the worlds per CTA fit SMEM_LIMIT, Ghat leaves shared memory
    only when one world does not fit with it, and past that the wrapper
    raises."""
    # the forward slice's K3 (n = 24, m = 32, C = 8, K = 16, f32): P at
    # stride 20, Ghat at stride 25, 6 n-, 13 m-, 5 q-, 9 C-, 7 K-vectors
    want = (16 * 20 + 16 * 25 + 6 * 24 + 13 * 32 + 5 * 4 + 9 * 8
            + 7 * 16) * 4
    assert ipm.smem_bytes(24, 32, 0, 8, 16, 16, 4, 1) == want == 5936
    assert ipm.smem_bytes(24, 32, 0, 8, 16, 16, 4, 0) == want - 16 * 25 * 4
    # path (c)'s K3u at f64: odd sizes round up to 16 bytes
    assert ipm.smem_bytes(25, 32, 3, 8, 27, 32, 8, 1) == 8 * (
        27 * 34 + 27 * 25 + 1 + 6 * 26 + 13 * 32 + 5 * 4 + 9 * 8 + 7 * 32)
    for n in (24, 300, 600, 2000, 3000):
        for K, item in ((16, 4), (48, 8)):
            try:
                KB, W, ghat = ipm.launch_shape(n, 96, 0, 24, K, item)
            except ValueError:
                assert ipm.smem_bytes(n, 96, 0, 24, K, ipm.fused_bucket(K),
                                      item, 0) > ipm.SMEM_LIMIT
                continue
            per = ipm.smem_bytes(n, 96, 0, 24, K, KB, item, ghat)
            assert 1 <= W <= 128 // ipm.world_lanes(KB)
            assert W * per <= ipm.SMEM_LIMIT
            assert ghat == int(ipm.smem_bytes(n, 96, 0, 24, K, KB, item, 1)
                               <= ipm.SMEM_LIMIT)
    with pytest.raises(ValueError):
        ipm.fused_bucket(49)


def test_launch_fits_exactly_where_launch_shape_returns():
    for item in (4, 8):
        for K in (16, 24, 48, 49):
            for n in (24, 600, 4692, 4693, 9528, 9529, 20000):
                try:
                    ipm.launch_shape(n, 32, 0, 8, K, item)
                    fits = True
                except ValueError:
                    fits = False
                assert ipm.launch_fits(n, 32, 0, 8, K, item) == fits


class Dispatched(Exception):
    pass


@pytest.mark.parametrize("n,dtype,fused", [
    (24, torch.float32, True), (4692, torch.float64, True),
    (4693, torch.float64, False), (4800, torch.float64, False),
    (9600, torch.float32, False)])
def test_fused_dispatch_within_shared_memory(n, dtype, fused, monkeypatch):
    """The fused kernel takes a system only where one world fits its
    shared memory (``ipm.launch_fits``): at C = 8 and the rotated K = 16,
    up to n = 4,692 at f64 and 9,528 at f32.  Past that (1,600 bodies at
    f64, 3,200 at f32) the solver runs the unfused loop, where the
    kernel's launch would raise; the JAX package solves these too."""
    def stop(what):
        def f(*a, **k):
            raise Dispatched(what)
        return f

    monkeypatch.setattr(ipm, "fused_ipm", stop("fused"))
    monkeypatch.setattr(pdipm, "unfused_loop", stop("unfused"))
    C = 8
    assert ipm.launch_fits(n, 4 * C, 0, C, 2 * C, dtype.itemsize) == fused
    rng = np.random.default_rng(n)
    qd, p, G, h, A, b, F, rmask = engine_instance(rng, 1, n, C, pair=True)
    t = lambda x: torch.tensor(np.asarray(x), dtype=dtype)
    with pytest.raises(Dispatched) as took:
        pdipm_solve(t(qd), t(p), t(G), t(h), t(A), t(b),
                    ConeF(t(F.mu), t(F.valid), 2), row_mask=t(rmask),
                    max_iter=1, q_is_diag=True, gamma_rows=C, fric_pair=True)
    assert str(took.value) == ("fused" if fused else "unfused")
