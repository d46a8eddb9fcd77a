"""The mixed LCP of a contact step, solved and differentiated plainly.

The solver's clamps of s / lam and its regularisation depend on the
precision it is configured for (``consts``); the reference takes those of
the configuration's dtype and may run its arithmetic in another, so that
float64 arithmetic follows the float32 solver's algorithm exactly.

Problem, batched over a leading axis (diagonal Q; the equality rows
A z = b, with multipliers nu, only where A is given)::

    minimize_z   1/2 z' diag(Q) z + p' z
    subject to   G z + F lam + s = h,   s >= 0,  lam >= 0,  s . lam = 0
                 A z = b

``solve`` runs the Mehrotra predictor-corrector that the engine's solver
runs: one Newton step from the origin with d = 1 as the start, sigma =
(mu_aff / mu)^3, the 0.99 step, the floor on s and lam, padded rows
(``row_mask`` 0) pinned at s = h and lam = tiny, the merit (mean
complementarity over the real rows plus the largest KKT residual), a world
stopping once its merit is under ``tol`` or it has not improved for
``stall_lim`` iterations (from iteration ``stall_lim + 2`` on), and the
best iterate returned where it beats the last.  Each Newton system is
reduced to the dense Schur complement over the rows Ghat = [G; A],

    S(d) = Bd - Ghat diag(1 / (Q + reg)) Ghat',
    Bd = [[F - diag(d) - reg I, 0], [0, -reg I]],

formed with a batched product and factored by ``torch.linalg.lu_factor``
(partial pivoting): the equality rows take d = 0, their residual A z - b
enters the KKT residual and the merit, nu is free, and only s and lam
limit the step.  ``LcpSolve`` adds the implicit backward: one
transposed solve K(d)' [w_z; w_l; w_n] = [g; 0; 0] at the solution, then
dQ = -w_z z, dp = -w_z, dG = -(w_l z' + lam w_z'), dh = w_l,
dF = -w_l lam', dA = -(w_n z' + nu w_z'), db = w_n.  Without A and b
every function runs the operations of the inequality rows alone.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def consts(dtype):
    """Clamps and the regularisation of the solver at ``dtype``."""
    if dtype == torch.float64:
        return dict(dinv_min=1e-12, dinv_max=1e12, reg=1e-11, tiny=1e-300)
    return dict(dinv_min=1e-6, dinv_max=1e6, reg=1e-7, tiny=1e-30)


class Newton:
    """The reduced KKT system K(d) = [[diag(Q) + reg, Ghat'], [Ghat, Bd]]
    of one iteration (module docstring; Ghat = G without A), factored
    once; ``solve(rhs, trans)`` returns [z; w] for K x = rhs (trans 0) or
    K' x = rhs (trans 1), w = [lam; nu] rows."""

    def __init__(self, Qd, G, F, d_inv, reg, A=None):
        self.qr = Qd + reg
        if A is not None:
            q = A.shape[-2]
            G = torch.cat([G, A], 1)
            F = torch.nn.functional.pad(F, (0, q, 0, q))
            d_inv = torch.nn.functional.pad(d_inv, (0, q))
        self.G = G
        m = G.shape[-2]
        eye = torch.eye(m, dtype=G.dtype, device=G.device)
        S = (F - d_inv[..., None] * eye - reg * eye
             - (G / self.qr[:, None, :]) @ G.transpose(1, 2))
        self.lu, self.piv = torch.linalg.lu_factor(S)

    def solve(self, rhs, trans=0):
        n = self.qr.shape[-1]
        r1, r2 = rhs[:, :n], rhs[:, n:]
        t = r2 - (self.G @ (r1 / self.qr)[..., None])[..., 0]
        w = torch.linalg.lu_solve(self.lu, self.piv, t[..., None],
                                  adjoint=bool(trans))[..., 0]
        z = (r1 - (self.G.transpose(1, 2) @ w[..., None])[..., 0]) / self.qr
        return torch.cat([z, w], -1)


def _max_step(v, dv, mask):
    """Largest alpha in (0, 1] with v + alpha dv >= 0 on the mask rows."""
    neg = (dv < 0) & mask
    ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0), float("inf"))
    return torch.clamp(ratio.amin(-1), max=1.0)


class Solution(NamedTuple):
    z: torch.Tensor       # (B, n)
    s: torch.Tensor       # (B, m)
    lam: torch.Tensor     # (B, m)
    iters: torch.Tensor   # (B,) int32
    nu: torch.Tensor      # (B, q); (B, 0) without equality rows


def _no_rows(A, b):
    """(A, b), or (None, None) where there are no equality rows."""
    if A is None or A.shape[-2] == 0:
        return None, None
    return A, b


def solve(Qd, p, G, h, F, row_mask, *, max_iter, tol, stall_lim,
          solver_dtype, A=None, b=None):
    """Solve the batch.  Qd (B, n), p (B, n), G (B, m, n), h (B, m), F
    (B, m, m) dense, row_mask (B, m), and optionally A (B, q, n), b
    (B, q); the clamps and the regularisation are those of
    ``solver_dtype`` (the configuration's), whatever the dtype the
    arithmetic runs in.  Returns a :class:`Solution`."""
    A, b = _no_rows(A, b)
    B, n = p.shape
    m = h.shape[-1]
    dt, dev = p.dtype, p.device
    c = consts(solver_dtype)
    tiny = c["tiny"]
    maskb = row_mask > 0
    maskf = row_mask.to(dt)
    rcount = torch.clamp(maskf.sum(-1), min=1.0)
    eq = A is not None
    q = A.shape[-2] if eq else 0
    tail = lambda x: [x] if eq else []      # the nu rows, where any
    ones_n = torch.ones((B, n), dtype=torch.bool, device=dev)
    ones_q = torch.ones((B, q), dtype=torch.bool, device=dev)
    rmask = torch.cat([ones_n, maskb] + tail(ones_q), -1)

    def comp_mu(s, lam):
        return (s * lam * maskf).sum(-1) / rcount

    def merit(X):
        z, s, lam = X[:, :n], X[:, n:n + m], X[:, n + m:n + 2 * m]
        rx = Qd * z + p + (G.transpose(1, 2) @ lam[..., None])[..., 0]
        rz = (G @ z[..., None])[..., 0] + (F @ lam[..., None])[..., 0] \
            + s - h
        if eq:
            nu = X[:, n + 2 * m:]
            rx = rx + (A.transpose(1, 2) @ nu[..., None])[..., 0]
            ry = (A @ z[..., None])[..., 0] - b
            r = torch.cat([rx, rz, ry], -1)
        else:
            r = torch.cat([rx, rz], -1)
        return comp_mu(s, lam) + torch.where(rmask, r, 0.0).abs().amax(-1), r

    def masked_min(x):
        return torch.where(maskb, x, float("inf")).amin(-1)

    ones = torch.ones((B, m), dtype=dt, device=dev)
    sol0 = Newton(Qd, G, F, ones, c["reg"], A).solve(
        torch.cat([-p, h] + tail(b), -1))
    z, lam, nu = sol0[:, :n], sol0[:, n:n + m], sol0[:, n + m:]
    s = -lam
    s = s + torch.relu(1.0 - masked_min(s))[:, None]
    lam = lam + torch.relu(1.0 - masked_min(lam))[:, None]
    s = torch.where(maskb, s, h)
    lam = torch.where(maskb, lam, torch.full_like(lam, tiny))

    fmax = torch.finfo(dt).max
    floor = torch.cat([torch.full((n,), -fmax, dtype=dt, device=dev),
                       torch.full((2 * m,), tiny, dtype=dt, device=dev)]
                      + tail(torch.full((q,), -fmax, dtype=dt, device=dev)))
    pinm = torch.cat([ones_n, maskb, maskb] + tail(ones_q), -1)
    pinv = torch.cat([torch.zeros((B, n), dtype=dt, device=dev), h,
                      torch.full((B, m), tiny, dtype=dt, device=dev)]
                     + tail(torch.zeros((B, q), dtype=dt, device=dev)), -1)
    mask2 = torch.cat([maskb, maskb], -1)
    sls = slice(n, n + 2 * m)

    X = torch.cat([z, s, lam] + tail(nu), -1)
    bestX = X
    best = torch.full((B,), fmax / 8, dtype=dt, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.full((B,), max_iter, dtype=torch.int32, device=dev)
    stall = torch.zeros(B, dtype=torch.int32, device=dev)
    for i in range(max_iter):
        if i and bool(done.all()):
            break
        mer, r = merit(X)
        s, lam = X[:, n:n + m], X[:, n + m:n + 2 * m]
        mu = comp_mu(s, lam)
        improved = mer < best
        bestX = torch.where(improved[:, None], X, bestX)
        best = torch.minimum(mer, best)
        stall = torch.where(improved, 0, stall + 1)
        if stall_lim > 0 and i >= stall_lim + 2:
            stalled = stall >= stall_lim
        else:
            stalled = torch.zeros_like(done)
        new_done = done | (mer < tol) | stalled
        iters = torch.where(new_done & ~done, i, iters)

        lam_safe = torch.clamp(lam, min=tiny)
        d_inv = torch.clamp(s / lam_safe, c["dinv_min"], c["dinv_max"])
        kkt = Newton(Qd, G, F, d_inv, c["reg"], A)
        r4 = s * lam
        rhs_a = -r
        rhs_a[:, n:n + m] += r4 / lam_safe
        sol_a = kkt.solve(rhs_a)
        dlam_a = sol_a[:, n:n + m]
        ds_a = -r4 / lam_safe - d_inv * dlam_a
        dsl_a = torch.cat([ds_a, dlam_a], -1)
        sl = X[:, sls]
        alpha_a = _max_step(sl, dsl_a, mask2)
        sl_aff = sl + alpha_a[:, None] * dsl_a
        mu_aff = comp_mu(sl_aff[:, :m], sl_aff[:, m:])
        sigma = torch.clamp(mu_aff / torch.clamp(mu, min=tiny), 0.0,
                            1.0) ** 3
        r4c = r4 + ds_a * dlam_a - (sigma * mu)[:, None]
        rhs_d = torch.zeros_like(rhs_a)
        rhs_d[:, n:n + m] = (r4c - r4) / lam_safe
        sol = sol_a + kkt.solve(rhs_d)
        dlam = sol[:, n:n + m]
        ds = -r4c / lam_safe - d_inv * dlam
        dX = torch.cat([sol[:, :n], ds, dlam] + tail(sol[:, n + m:]), -1)
        alpha = 0.99 * _max_step(sl, dX[:, sls], mask2)
        X_n = torch.maximum(X + alpha[:, None] * dX, floor)
        X_n = torch.where(pinm, X_n, pinv)
        halt = new_done | ~torch.isfinite(X_n).all(-1)
        X = torch.where(halt[:, None], X, X_n)
        done = done | halt
    final, _ = merit(X)
    X = torch.where((best < final)[:, None], bestX, X)
    return Solution(X[:, :n], X[:, n:n + m], X[:, n + m:n + 2 * m], iters,
                    X[:, n + 2 * m:])


class LcpSolve(torch.autograd.Function):
    """z of :func:`solve` with the implicit KKT backward (module
    docstring); ``kw`` holds max_iter, tol, stall_lim and solver_dtype;
    A and b are None without equality rows."""

    @staticmethod
    def forward(ctx, Qd, p, G, h, F, row_mask, A, b, kw):
        sol = solve(Qd, p, G, h, F, row_mask, A=A, b=b, **kw)
        ctx.save_for_backward(sol.z, sol.s, sol.lam, sol.nu, Qd, G, F, A)
        ctx.solver_dtype = kw["solver_dtype"]
        return sol.z

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        z, s, lam, nu, Qd, G, F, A = ctx.saved_tensors
        c = consts(ctx.solver_dtype)
        d_inv = torch.clamp(s / torch.clamp(lam, min=c["tiny"]),
                            c["dinv_min"], c["dinv_max"])
        eq = A is not None
        w = Newton(Qd, G, F, d_inv, c["reg"], A).solve(
            torch.cat([g, torch.zeros_like(s)]
                      + ([torch.zeros_like(nu)] if eq else []), -1),
            trans=1)
        n, m = z.shape[-1], s.shape[-1]
        wz, wl = w[:, :n], w[:, n:n + m]
        outer = lambda a, b: a[:, :, None] * b[:, None, :]
        grads = (-(wz * z), -wz, -(outer(wl, z) + outer(lam, wz)), wl,
                 -outer(wl, lam), None)
        if not eq:
            return grads + (None, None, None)
        wn = w[:, n + m:]
        return grads + (-(outer(wn, z) + outer(nu, wz)), wn, None)


def lcp_solve(Qd, p, G, h, F, row_mask, *, max_iter, tol, stall_lim,
              solver_dtype, A=None, b=None):
    """Differentiable z of the batch (:class:`LcpSolve`), with the
    equality rows A z = b where A has any."""
    A, b = _no_rows(A, b)
    return LcpSolve.apply(Qd, p, G, h, F, row_mask, A, b,
                          dict(max_iter=max_iter, tol=tol,
                               stall_lim=stall_lim,
                               solver_dtype=solver_dtype))
