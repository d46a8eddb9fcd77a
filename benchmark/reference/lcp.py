"""The mixed LCP of a contact step, solved and differentiated plainly.

The solver's clamps of s / lam and its regularisation depend on the
precision it is configured for (``consts``); the reference takes those of
the configuration's dtype and may run its arithmetic in another, so that
float64 arithmetic follows the float32 solver's algorithm exactly.

Problem, batched over a leading axis (diagonal Q, no equality rows)::

    minimize_z   1/2 z' diag(Q) z + p' z
    subject to   G z + F lam + s = h,   s >= 0,  lam >= 0,  s . lam = 0

``solve`` runs the Mehrotra predictor-corrector that the engine's solver
runs: one Newton step from the origin with d = 1 as the start, sigma =
(mu_aff / mu)^3, the 0.99 step, the floor on s and lam, padded rows
(``row_mask`` 0) pinned at s = h and lam = tiny, the merit (mean
complementarity over the real rows plus the largest KKT residual), a world
stopping once its merit is under ``tol`` or it has not improved for
``stall_lim`` iterations (from iteration ``stall_lim + 2`` on), and the
best iterate returned where it beats the last.  Each Newton system is
reduced to the dense Schur complement over the inequality rows,

    S(d) = F - diag(d) - reg I - G diag(1 / (Q + reg)) G',

formed with a batched product and factored by ``torch.linalg.lu_factor``
(partial pivoting).  ``LcpSolve`` adds the implicit backward: one
transposed solve K(d)' [w_z; w_l] = [g; 0] at the solution, then
dQ = -w_z z, dp = -w_z, dG = -(w_l z' + lam w_z'), dh = w_l,
dF = -w_l lam'.
"""
from __future__ import annotations

import torch


def consts(dtype):
    """Clamps and the regularisation of the solver at ``dtype``."""
    if dtype == torch.float64:
        return dict(dinv_min=1e-12, dinv_max=1e12, reg=1e-11, tiny=1e-300)
    return dict(dinv_min=1e-6, dinv_max=1e6, reg=1e-7, tiny=1e-30)


class Newton:
    """The reduced KKT system K(d) = [[diag(Q) + reg, G'], [G, F - diag(d)
    - reg]] of one iteration, factored once; ``solve(rhs, trans)`` returns
    [z; w] for K x = rhs (trans 0) or K' x = rhs (trans 1)."""

    def __init__(self, Qd, G, F, d_inv, reg):
        self.qr = Qd + reg
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


def solve(Qd, p, G, h, F, row_mask, *, max_iter, tol, stall_lim,
          solver_dtype):
    """Solve the batch.  Qd (B, n), p (B, n), G (B, m, n), h (B, m), F
    (B, m, m) dense, row_mask (B, m); the clamps and the regularisation
    are those of ``solver_dtype`` (the configuration's), whatever the
    dtype the arithmetic runs in.  Returns (z, s, lam, iters)."""
    B, n = p.shape
    m = h.shape[-1]
    dt, dev = p.dtype, p.device
    c = consts(solver_dtype)
    tiny = c["tiny"]
    maskb = row_mask > 0
    maskf = row_mask.to(dt)
    rcount = torch.clamp(maskf.sum(-1), min=1.0)
    rmask = torch.cat([torch.ones((B, n), dtype=torch.bool, device=dev),
                       maskb], -1)

    def comp_mu(s, lam):
        return (s * lam * maskf).sum(-1) / rcount

    def merit(X):
        z, s, lam = X[:, :n], X[:, n:n + m], X[:, n + m:]
        rx = Qd * z + p + (G.transpose(1, 2) @ lam[..., None])[..., 0]
        rz = (G @ z[..., None])[..., 0] + (F @ lam[..., None])[..., 0] \
            + s - h
        r = torch.cat([rx, rz], -1)
        return comp_mu(s, lam) + torch.where(rmask, r, 0.0).abs().amax(-1), r

    def masked_min(x):
        return torch.where(maskb, x, float("inf")).amin(-1)

    ones = torch.ones((B, m), dtype=dt, device=dev)
    sol0 = Newton(Qd, G, F, ones, c["reg"]).solve(torch.cat([-p, h], -1))
    z, lam = sol0[:, :n], sol0[:, n:]
    s = -lam
    s = s + torch.relu(1.0 - masked_min(s))[:, None]
    lam = lam + torch.relu(1.0 - masked_min(lam))[:, None]
    s = torch.where(maskb, s, h)
    lam = torch.where(maskb, lam, torch.full_like(lam, tiny))

    fmax = torch.finfo(dt).max
    floor = torch.cat([torch.full((n,), -fmax, dtype=dt, device=dev),
                       torch.full((2 * m,), tiny, dtype=dt, device=dev)])
    pinm = torch.cat([torch.ones((B, n), dtype=torch.bool, device=dev),
                      maskb, maskb], -1)
    pinv = torch.cat([torch.zeros((B, n), dtype=dt, device=dev), h,
                      torch.full((B, m), tiny, dtype=dt, device=dev)], -1)
    mask2 = torch.cat([maskb, maskb], -1)
    sls = slice(n, n + 2 * m)

    X = torch.cat([z, s, lam], -1)
    bestX = X
    best = torch.full((B,), fmax / 8, dtype=dt, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.full((B,), max_iter, dtype=torch.int32, device=dev)
    stall = torch.zeros(B, dtype=torch.int32, device=dev)
    for i in range(max_iter):
        if i and bool(done.all()):
            break
        mer, r = merit(X)
        s, lam = X[:, n:n + m], X[:, n + m:]
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
        kkt = Newton(Qd, G, F, d_inv, c["reg"])
        r4 = s * lam
        rhs_a = -r
        rhs_a[:, n:] += r4 / lam_safe
        sol_a = kkt.solve(rhs_a)
        dlam_a = sol_a[:, n:]
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
        rhs_d[:, n:] = (r4c - r4) / lam_safe
        sol = sol_a + kkt.solve(rhs_d)
        dlam = sol[:, n:]
        ds = -r4c / lam_safe - d_inv * dlam
        dX = torch.cat([sol[:, :n], ds, dlam], -1)
        alpha = 0.99 * _max_step(sl, dX[:, sls], mask2)
        X_n = torch.maximum(X + alpha[:, None] * dX, floor)
        X_n = torch.where(pinm, X_n, pinv)
        halt = new_done | ~torch.isfinite(X_n).all(-1)
        X = torch.where(halt[:, None], X, X_n)
        done = done | halt
    final, _ = merit(X)
    X = torch.where((best < final)[:, None], bestX, X)
    return X[:, :n], X[:, n:n + m], X[:, n + m:], iters


class LcpSolve(torch.autograd.Function):
    """z of :func:`solve` with the implicit KKT backward (module
    docstring); ``kw`` holds max_iter, tol and stall_lim."""

    @staticmethod
    def forward(ctx, Qd, p, G, h, F, row_mask, kw):
        z, s, lam, _ = solve(Qd, p, G, h, F, row_mask, **kw)
        ctx.save_for_backward(z, s, lam, Qd, G, F)
        ctx.solver_dtype = kw["solver_dtype"]
        return z

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        z, s, lam, Qd, G, F = ctx.saved_tensors
        c = consts(ctx.solver_dtype)
        d_inv = torch.clamp(s / torch.clamp(lam, min=c["tiny"]),
                            c["dinv_min"], c["dinv_max"])
        w = Newton(Qd, G, F, d_inv, c["reg"]).solve(
            torch.cat([g, torch.zeros_like(s)], -1), trans=1)
        n = z.shape[-1]
        wz, wl = w[:, :n], w[:, n:]
        outer = lambda a, b: a[:, :, None] * b[:, None, :]
        return (-(wz * z), -wz, -(outer(wl, z) + outer(lam, wz)), wl,
                -outer(wl, lam), None, None)


def lcp_solve(Qd, p, G, h, F, row_mask, *, max_iter, tol, stall_lim,
              solver_dtype):
    """Differentiable z of the batch (:class:`LcpSolve`)."""
    return LcpSolve.apply(Qd, p, G, h, F, row_mask,
                          dict(max_iter=max_iter, tol=tol,
                               stall_lim=stall_lim,
                               solver_dtype=solver_dtype))
