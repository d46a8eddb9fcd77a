r"""Mehrotra predictor-corrector primal-dual interior-point solver for the
mixed LCP of contact dynamics — the engine layout of it.

Counterpart of ``lcp_physics_tpu/lcp/pdipm.py``.  Problem (batched):

    minimize_z   1/2 z^T Q z + p^T z
    subject to   G z + F lam + s = h,   s >= 0,  lam >= 0,  s ⊥ lam
                 A z = b

Ported: the engine layout (diagonal Q, ``ConeF`` friction coupling, the
friction-cone slack rows eliminated, the friction-pair rotation).  The
rotated Schur system (K2 = 2C + q rows) is formed whole and factored by
the lane LU (``ops.linalg``, K2 <= 88) or by the blocked LU over
128-panels (K2 > 88), and solved both ways (trans=0 for the iterations,
trans=1 for the implicit backward).  ``refine`` > 0 adds iterative
refinement to every solve: on blocked systems of at most two panels the
factor becomes the explicit inverse and each solve one matvec plus
``INV_REFINE + refine`` steps against the structured system; elsewhere
``refine`` steps against the assembled one.  After the initial Newton
solve the iterations run in the fused whole-IPM kernel
(``ops.ipm.fused_ipm``) when K2 <= 48 and refine is 0; with ``FUSE_ITER``
set, at refine 0 and 88 < K2 <= 256, in the fused per-iteration kernel
(``ops.ipm_iter.fused_iter_ipm``); otherwise in the packed unfused loop
of the JAX package.  Both host loops read one flag per iteration back to
stop once every world is done (``HOST_READS`` counts those reads).

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP item:
``gondzio``, dense Q, a dense F, ``m == 0`` and the systems without the
friction-pair structure (A3, B2b).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from lcp_physics_tpu_torch.lcp.cone import ConeF
from lcp_physics_tpu_torch.ops import ipm, ipm_iter, linalg

HOST_READS = {"ipm_loop": 0}
_SQ2 = math.sqrt(2.0)

# refine > 0 on a blocked system of at most linalg.INV_MAX_PANELS panels
# factors the rotated Schur system into its explicit inverse; each solve is
# one batched matvec plus INV_REFINE + refine refinement steps whose
# residual is one P2 matvec, the diagonal and the (v, c) band (the JAX
# package's explicit-inverse solve mode).
INV_REFINE = 1
# The fused per-iteration kernel (ops.ipm_iter, K6) for refine 0 and
# 88 < K2 <= 256.  Off by default, as in the JAX package.
FUSE_ITER = False


class PdipmSolution(NamedTuple):
    z: torch.Tensor      # primal solution (B, n)
    s: torch.Tensor      # inequality slacks (B, m)
    lam: torch.Tensor    # inequality multipliers (B, m)
    nu: torch.Tensor     # equality multipliers (B, q)
    mu: torch.Tensor     # final complementarity measure (B,)
    resid: torch.Tensor  # final max KKT residual (B,)
    iters: torch.Tensor  # per-instance iterations to convergence (B,) int32


def _dtype_consts(dtype):
    if dtype == torch.float64:
        return dict(dinv_min=1e-12, dinv_max=1e12, reg=1e-11, tiny=1e-300)
    return dict(dinv_min=1e-6, dinv_max=1e6, reg=1e-7, tiny=1e-30)


def _unported(item, what):
    return NotImplementedError(f"ROADMAP {item}: {what} is not ported yet")


def _solve_refined(fac, apply, rhs, trans, steps):
    """x = K^-1 rhs (K^-T rhs for trans=1) from ``fac``, then ``steps``
    refinement steps x += K^-1 (rhs - apply(x, trans)), ``apply`` being
    K (or K^T) times a vector."""
    x = linalg.plu_solve(fac, rhs, trans)
    for _ in range(steps):
        x = x + linalg.plu_solve(fac, rhs - apply(x, trans), trans)
    return x


def _rot_factor_factory(operands, F, reg, factor_precision=None, refine=0):
    r"""KKT solve operator factory ``factor(d_inv) -> solve`` for the engine
    layout with the gamma rows and the friction-pair rotation eliminated
    (the JAX package's ``_rot_factor_factory``; the caller guarantees the
    layout).  ``operands`` = (P2, Ghat2, Q^-1) from
    ``ops.ipm.rot_operands``; ``factor_precision='highest'`` (or
    ``'float32'``) sends float32 panel inverses of the blocked factor to
    the scalar Gauss-Jordan kernel.  ``refine`` adds refinement steps to
    every solve (module docstring).

    Kept rows [c (C), f1 (C), f2 (C), q] rotate to core rows
    [c (C), v (C), q], K2 = 2C + q, with u = (f1+f2)/sqrt2 and the gamma
    rows eliminated in closed form.  The factored system is
    S2 = -Ghat2 Q^-1 Ghat2^T - diag(dmain) + (v-row, c-col) band, with
    Ghat2 = [G_c; sqrt2 G_f1; A].

    ``solve(rhs, trans=0)`` returns [z; w] for K [z; w] = rhs (trans=0) or
    K^T [z; w] = rhs (trans=1); ``solve.reduced(rhs, trans, r1_zero)``
    returns (w, wk) without the z block (``r1_zero``: the caller
    guarantees rhs[:, :n] == 0) and ``solve.z_from(r1, wk)`` recovers z.
    ``factor.residual_ops`` are the compact residual products
    (G z | A z) and G^T lam + A^T nu over Ghat2; on blocked systems of at
    most two panels ``factor.iter_inv_raw(d_inv)`` is the padded explicit
    inverse (B, T*128, T*128) of S2, for the fused per-iteration kernel.
    """
    P2, Ghat2, qinv = operands
    n = qinv.shape[-1]
    C_ = F.C
    mg, m = 3 * C_, 4 * C_
    K2 = P2.shape[-1]
    v_, mu_v = F.valid, F.mu
    exact = factor_precision in ("highest", "float32")
    blocked = linalg.blocked_path(K2)
    inv_mode = refine > 0 and blocked and linalg.inv_supported(K2)

    def make_apply_S2(dmain, bn):
        """S2 (or S2^T) times x from its structured form: one P2 matvec (P2
        is symmetric), the diagonal and the (v-row, c-column) band."""
        def apply(x, trans=0):
            y = -torch.einsum("bij,bj->bi", P2, x) - dmain * x
            if trans == 0:
                y[:, C_:2 * C_] += bn * x[:, :C_]
            else:
                y[:, :C_] += bn * x[:, C_:2 * C_]
            return y
        return apply

    def factor_rot(d_inv):
        rs = ipm.rot_schur(P2, d_inv, mu_v, v_, C_, reg)
        if inv_mode:
            fac = linalg.inv_factor_blocks(rs.S, exact)
            apply, steps = make_apply_S2(rs.dmain, rs.bn), INV_REFINE + refine
        else:
            fac = linalg.plu_factor(rs.S, exact)
            S = rs.S
            apply = lambda x, trans: torch.einsum(
                "bij,bj->bi" if trans == 0 else "bji,bj->bi", S, x)
            steps = refine
        Dginv, cn, delta, g_u = rs.Dginv, rs.cn, rs.delta, rs.g_u

        def reduced(rhs, trans=0, r1_zero=False):
            r1, r2 = rhs[:, :n], rhs[:, n:]
            r_c, r_f1, r_f2 = (r2[:, :C_], r2[:, C_:2 * C_],
                               r2[:, 2 * C_:3 * C_])
            rg, r_q = r2[:, mg:m], r2[:, m:]
            ru = (r_f1 + r_f2) / _SQ2
            rv = (r_f1 - r_f2) / _SQ2
            if r1_zero:
                t_c, t_v, t_q = r_c, rv, r_q
            else:
                y = torch.einsum("bkn,bn->bk", Ghat2, qinv * r1)
                t_c = r_c - y[:, :C_]
                t_v = rv - y[:, C_:2 * C_]
                t_q = r_q - y[:, 2 * C_:]
            tD = Dginv * rg
            if trans == 0:
                t_u = ru - _SQ2 * v_ * tD
                rhs2 = torch.cat([t_c, t_v - (delta / g_u) * t_u, t_q], -1)
                wk = _solve_refined(fac, apply, rhs2, 0, steps)
                w_c, w_v = wk[:, :C_], wk[:, C_:2 * C_]
                w_u = (t_u - _SQ2 * cn * w_c - delta * w_v) / g_u
                wg = -Dginv * (rg - (-mu_v * w_c + _SQ2 * v_ * w_u))
            else:
                # S'^T: the gamma coupling's transpose, then u eliminated
                # from the transposed (u-row [0, g_u, delta]) system
                t_c = t_c - mu_v * tD
                t_u = ru + _SQ2 * v_ * tD
                rhs2 = torch.cat([t_c - _SQ2 * cn * t_u / g_u,
                                  t_v - (delta / g_u) * t_u, t_q], -1)
                wk = _solve_refined(fac, apply, rhs2, 1, steps)
                w_v = wk[:, C_:2 * C_]
                w_c = wk[:, :C_]
                w_u = (t_u - delta * w_v) / g_u
                wg = -Dginv * (rg + _SQ2 * v_ * w_u)
            w_full = torch.cat([w_c, (w_u + w_v) / _SQ2, (w_u - w_v) / _SQ2,
                                wg, wk[:, 2 * C_:]], -1)
            return w_full, wk

        def z_from(r1, wk):
            # the same for trans 0 and 1: the coupling blocks are Ghat2 and
            # Ghat2^T, exact transposes
            return qinv * (r1 - torch.einsum("bkn,bk->bn", Ghat2, wk))

        def solve(rhs, trans=0):
            w_full, wk = reduced(rhs, trans)
            return torch.cat([z_from(rhs[:, :n], wk), w_full], -1)

        solve.reduced = reduced
        solve.z_from = z_from
        return solve

    def res_down(z):
        y = torch.einsum("bkn,bn->bk", Ghat2, z)
        gf1 = y[:, C_:2 * C_] / _SQ2
        return torch.cat([y[:, :C_], gf1, -gf1, torch.zeros_like(y[:, :C_]),
                          y[:, 2 * C_:]], -1)

    def res_up(lam, nu):
        u = torch.cat([lam[:, :C_],
                       (lam[:, C_:2 * C_] - lam[:, 2 * C_:3 * C_]) / _SQ2,
                       nu], -1)
        return torch.einsum("bkn,bk->bn", Ghat2, u)

    factor_rot.residual_ops = (res_down, res_up)
    if blocked and linalg.inv_supported(K2):
        def iter_inv_raw(d_inv):
            rs = ipm.rot_schur(P2, d_inv, mu_v, v_, C_, reg)
            return linalg.inv_factor_blocks(rs.S, exact).inv

        factor_rot.iter_inv_raw = iter_inv_raw
    return factor_rot


def _expand_batch(arrays, base_rank):
    """Promote single-instance inputs to a batch of one; report whether any
    input was already batched."""
    batched = any(a.dim() == r + 1 for a, r in zip(arrays, base_rank))
    B = max((a.shape[0] for a, r in zip(arrays, base_rank)
             if a.dim() == r + 1), default=1)
    out = [a.expand((B,) + tuple(a.shape)) if a.dim() == r else a
           for a, r in zip(arrays, base_rank)]
    return batched, out


def _start(kkt_factor, p, h, b, row_mask, consts):
    """One Newton step from the origin with d_inv = 1, then (s, lam)
    shifted into the strict interior and the padded rows pinned."""
    B, n = p.shape
    m = h.shape[-1]
    maskb = row_mask > 0

    def masked_min(x):
        return torch.where(maskb, x, float("inf")).amin(-1)

    ones_m = torch.ones((B, m), dtype=p.dtype, device=p.device)
    sol0 = kkt_factor(ones_m)(torch.cat([-p, h, b], -1))
    z, lam, nu = sol0[:, :n], sol0[:, n:n + m], sol0[:, n + m:]
    s = -lam  # with d_inv = 1 and zero complementarity residual, ds = -dlam
    s = s + torch.relu(1.0 - masked_min(s))[:, None]
    lam = lam + torch.relu(1.0 - masked_min(lam))[:, None]
    s = torch.where(maskb, s, h)
    lam = torch.where(maskb, lam, torch.full_like(lam, consts["tiny"]))
    return z, s, lam, nu


def initial_point(operands, p, h, b, F, row_mask, consts):
    """The solver's starting iterate (z, s, lam, nu) through the rotated KKT
    factor.  ``operands`` = ``ops.ipm.rot_operands(q_diag, G, A, F.C)``."""
    return _start(_rot_factor_factory(operands, F, consts["reg"]),
                  p, h, b, row_mask, consts)


def _max_step(v, dv, mask):
    """Per-instance largest alpha in (0, 1] with v + alpha dv >= 0 on the
    ``mask`` rows."""
    neg = (dv < 0) & mask
    ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0), float("inf"))
    return torch.clamp(ratio.amin(-1), max=1.0)


class _Packed:
    """Residuals, merit and the best-iterate tail of the packed loops, on
    the iterate X = [z | s | lam | nu] (B, n + 2m + q); padded rows
    (``row_mask`` 0) are left out of the complementarity measure and the
    residual norm."""

    def __init__(self, kkt_factor, q_diag, p, h, b, F, row_mask):
        B, n = p.shape
        m, q = h.shape[-1], b.shape[-1]
        dev = p.device
        self.kkt_factor, self.q_diag, self.p, self.h, self.b, self.F = (
            kkt_factor, q_diag, p, h, b, F)
        self.n, self.m = n, m
        self.maskb = row_mask > 0
        self.maskf = row_mask.to(p.dtype)
        self.rcount = torch.clamp(self.maskf.sum(-1), min=1.0)
        self.rmask = torch.cat([torch.ones((B, n), dtype=torch.bool,
                                           device=dev), self.maskb,
                                torch.ones((B, q), dtype=torch.bool,
                                           device=dev)], -1)

    def split(self, X):
        n, m = self.n, self.m
        return X[:, :n], X[:, n:n + m], X[:, n + m:n + 2 * m], \
            X[:, n + 2 * m:]

    def comp_mu(self, s, lam):
        return (s * lam * self.maskf).sum(-1) / self.rcount

    def residuals(self, X):
        z, s, lam, nu = self.split(X)
        res_down, res_up = self.kkt_factor.residual_ops
        ga = res_down(z)
        rx = self.q_diag * z + self.p + res_up(lam, nu)
        rz = ga[:, :self.m] + self.F.matvec(lam) + s - self.h
        ry = ga[:, self.m:] - self.b
        return torch.cat([rx, rz, ry], -1)

    def resid_norm(self, r):
        return torch.where(self.rmask, r, 0.0).abs().amax(-1)

    def merit(self, X):
        r = self.residuals(X)
        _, s, lam, _ = self.split(X)
        return self.comp_mu(s, lam) + self.resid_norm(r), r

    def solution(self, X, bestX, best_merit, iters):
        """The best iterate seen where it beats the final one (non-monotone
        tails), as a :class:`PdipmSolution`."""
        final_merit, _ = self.merit(X)
        X = torch.where((best_merit < final_merit)[:, None], bestX, X)
        z, s, lam, nu = self.split(X)
        return PdipmSolution(z, s, lam, nu, self.comp_mu(s, lam),
                             self.resid_norm(self.residuals(X)), iters)


def unfused_loop(kkt_factor, q_diag, p, h, b, F, row_mask, z, s, lam, nu, *,
                 max_iter, tol, consts, not_improved_lim, stall_rtol):
    """The packed unfused interior-point loop of the JAX package from the
    iterate (z, s, lam, nu): the state is one (B, n + 2m + q) tensor
    X = [z | s | lam | nu]; per iteration one factor of the rotated Schur
    system, the predictor solve and the corrector as a delta solve, one
    z-recovery, the 0.99 step, the floor clamp, the pin of padded rows and
    the divergence guard; stall counter, ``stall_rtol``, best-iterate
    return.  Stops after ``max_iter`` iterations or once every world is
    done (one host read per iteration).  Returns a :class:`PdipmSolution`.
    """
    B, n = p.shape
    m, q = h.shape[-1], b.shape[-1]
    dt, dev = p.dtype, p.device
    tiny = consts["tiny"]
    pk = _Packed(kkt_factor, q_diag, p, h, b, F, row_mask)
    maskb = pk.maskb
    sls = slice(n, n + 2 * m)
    ones_n = torch.ones((B, n), dtype=torch.bool, device=dev)
    ones_q = torch.ones((B, q), dtype=torch.bool, device=dev)
    fmax = torch.finfo(dt).max
    floor_row = torch.cat([torch.full((n,), -fmax, dtype=dt, device=dev),
                           torch.full((2 * m,), tiny, dtype=dt, device=dev),
                           torch.full((q,), -fmax, dtype=dt, device=dev)])
    pinm = torch.cat([ones_n, maskb, maskb, ones_q], -1)
    pinv = torch.cat([torch.zeros((B, n), dtype=dt, device=dev), h,
                      torch.full((B, m), tiny, dtype=dt, device=dev),
                      torch.zeros((B, q), dtype=dt, device=dev)], -1)
    mask2 = torch.cat([maskb, maskb], -1)
    comp_mu = pk.comp_mu

    X = torch.cat([z, s, lam, nu], -1)
    bestX = X
    best_merit = torch.full((B,), fmax / 8, dtype=dt, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.full((B,), max_iter, dtype=torch.int32, device=dev)
    stall = torch.zeros(B, dtype=torch.int32, device=dev)
    for i in range(max_iter):
        if i:
            HOST_READS["ipm_loop"] += 1
            if bool(done.all()):
                break
        merit, r = pk.merit(X)
        _, s, lam, _ = pk.split(X)
        mu = comp_mu(s, lam)
        improved = merit < best_merit
        bestX = torch.where(improved[:, None], X, bestX)
        sig = (merit < best_merit * (1.0 - stall_rtol) if stall_rtol > 0
               else improved)
        best_merit = torch.minimum(merit, best_merit)
        stall = torch.where(sig, 0, stall + 1)
        if not_improved_lim > 0 and i >= not_improved_lim + 2:
            stalled = stall >= not_improved_lim
        else:
            stalled = torch.zeros_like(done)
        new_done = done | (merit < tol) | stalled
        iters = torch.where(new_done & ~done, i, iters)

        lam_safe = torch.clamp(lam, min=tiny)
        d_inv = torch.clamp(s / lam_safe, consts["dinv_min"],
                            consts["dinv_max"])
        kkt_solve = kkt_factor(d_inv)

        # predictor: rhs = -r with the complementarity term on the rz rows
        r4 = s * lam
        rhs_aff = -r
        rhs_aff[:, n:n + m] += r4 / lam_safe
        wa_full, wk_a = kkt_solve.reduced(rhs_aff)
        dlam_a = wa_full[:, :m]
        ds_a = -r4 / lam_safe - d_inv * dlam_a
        dsl_a = torch.cat([ds_a, dlam_a], -1)
        sl = X[:, sls]
        alpha_a = _max_step(sl, dsl_a, mask2)
        sl_aff = sl + alpha_a[:, None] * dsl_a
        mu_aff = comp_mu(sl_aff[:, :m], sl_aff[:, m:])
        sigma = torch.clamp(mu_aff / torch.clamp(mu, min=tiny), 0.0,
                            1.0) ** 3

        # corrector, solved as a delta on the predictor (r1 block zero)
        r4c = r4 + ds_a * dlam_a - (sigma * mu)[:, None]
        rhs_d = torch.zeros_like(r)
        rhs_d[:, n:n + m] = (r4c - r4) / lam_safe
        wd_full, wk_d = kkt_solve.reduced(rhs_d, r1_zero=True)
        w_full = wa_full + wd_full
        dlam = w_full[:, :m]
        ds = -r4c / lam_safe - d_inv * dlam
        dz = kkt_solve.z_from(rhs_aff[:, :n], wk_a + wk_d)
        dX = torch.cat([dz, ds, dlam, w_full[:, m:]], -1)
        alpha = 0.99 * _max_step(sl, dX[:, sls], mask2)

        X_n = torch.maximum(X + alpha[:, None] * dX, floor_row)
        X_n = torch.where(pinm, X_n, pinv)
        bad = ~torch.isfinite(X_n).all(-1)     # divergence guard
        halt = new_done | bad
        X = torch.where(halt[:, None], X, X_n)
        done = done | halt
    return pk.solution(X, bestX, best_merit, iters)


def pdipm_solve(Q, p, G, h, A, b, F, *, max_iter=20, tol=1e-7,
                q_is_diag=None, gamma_rows=0, row_mask=None, refine=0,
                not_improved_lim=3, fric_pair=False, gondzio=0,
                stall_rtol=0.0, factor_precision=None):
    """Solve a batch of mixed-LCP instances (single instances are promoted
    to a batch of one and squeezed back).  Same arguments and semantics as
    the JAX package's ``pdipm_solve`` for the ported layout (module
    docstring); ``row_mask`` (B, m) is 1.0 on real inequality rows and 0.0
    on padding, which is pinned at s = h, lam = tiny.
    ``factor_precision='highest'`` (or ``'float32'``) sends the blocked
    factor's float32 panel inverses to the scalar Gauss-Jordan kernel, as
    in the JAX package.  Returns a :class:`PdipmSolution`."""
    diag_form = (Q.shape == p.shape if q_is_diag is None
                 else bool(q_is_diag))
    if not diag_form:
        raise _unported("A3", "the solver for a dense Q")
    if not isinstance(F, ConeF):
        raise _unported("A3", "the solver for a dense F")
    if gondzio:
        raise _unported("A3", "gondzio")
    batched, (Q, p, G, h, A, b, mu_f, v_f) = _expand_batch(
        (Q, p, G, h, A, b, F.mu, F.valid), (1, 1, 2, 1, 2, 1, 1, 1))
    F = ConeF(mu_f, v_f, F.fd)
    B, n = p.shape
    m, q = G.shape[-2], A.shape[-2]
    dt = Q.dtype
    consts = _dtype_consts(dt)
    if m == 0 or max_iter <= 0:
        raise _unported("A3", "the solver without inequality rows or "
                        "iterations")
    if not (gamma_rows == F.C and fric_pair and F.fd == 2 and m == 4 * F.C):
        raise _unported("A3/B2b", "the solver for systems without the "
                        "friction-pair rotation (the plain gamma "
                        "elimination and the unrotated fused kernel)")
    if row_mask is None:
        row_mask = torch.ones((B, m), dtype=dt, device=p.device)
    row_mask = row_mask.expand(B, m).to(dt)
    operands = ipm.rot_operands(Q, G, A, F.C)
    kkt_factor = _rot_factor_factory(operands, F, consts["reg"],
                                     factor_precision, refine)
    z, s, lam, nu = _start(kkt_factor, p, h, b, row_mask, consts)
    kw = dict(max_iter=max_iter, tol=tol, consts=consts,
              not_improved_lim=not_improved_lim,
              stall_rtol=float(stall_rtol))
    plain_mehrotra = refine == 0 and gondzio == 0
    if plain_mehrotra and ipm.fused_supported(m - F.C, q, F.C, F.fd,
                                              fric_pair=True):
        sol = PdipmSolution(*ipm.fused_ipm(
            operands, p, h, b, F.mu, F.valid, row_mask, z, s, lam, nu,
            C=F.C, fd=F.fd, fric_pair=True, **kw))
    elif FUSE_ITER and plain_mehrotra and ipm_iter.fused_iter_supported(
            F.C, q, n, p.element_size()):
        X, bestX, best_merit, iters = ipm_iter.fused_iter_ipm(
            operands[1], operands[2], p, h, b, F.mu, F.valid, row_mask,
            torch.cat([z, s, lam, nu], -1), C=F.C,
            inv_raw=kkt_factor.iter_inv_raw, host_reads=HOST_READS, **kw)
        sol = _Packed(kkt_factor, Q, p, h, b, F, row_mask).solution(
            X, bestX, best_merit, iters)
    else:
        sol = unfused_loop(kkt_factor, Q, p, h, b, F, row_mask, z, s, lam,
                           nu, **kw)
    if not batched:
        sol = PdipmSolution(*(x[0] for x in sol))
    return sol
