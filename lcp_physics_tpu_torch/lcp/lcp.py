"""Differentiable-LCP entry points around the interior-point solver.

Counterpart of ``lcp_physics_tpu/lcp/lcp.py``.  ``lcp_solve`` is a
``torch.autograd.Function``: the forward runs the interior-point solver;
the backward differentiates the KKT optimality conditions at the
epsilon-interior solution (z, s, lam, nu) by the implicit function
theorem, with ONE transposed solve of the reduced KKT system the forward's
last iteration factored,

    K(d)^T [w_z; w_l; w_n] = [g; 0; 0],   d = s / lam,

and the cotangents (Q diagonal, F the ``ConeF`` coefficients)

    dQ = -(w_z o z)         dp = -w_z
    dG = -(w_l z^T + lam w_z^T)            dh = w_l
    dA = -(w_n z^T + nu w_z^T)             db = w_n
    dmu = w_l[gamma] o lam[normal],

the solver iterations never being differentiated.
"""
from __future__ import annotations

import torch

from lcp_physics_tpu_torch.lcp.cone import ConeF
from lcp_physics_tpu_torch.lcp.pdipm import (PdipmSolution, _dtype_consts,
                                             _rot_factor_factory,
                                             _unported, pdipm_solve)
from lcp_physics_tpu_torch.ops import ipm


def _normalize(Q, p, G, h, A, b, F, q_is_diag=None):
    """Common dtype, default A/b, and whether Q is a diagonal (same rules
    as the JAX package, including refusing the ambiguous batched B == n
    diagonal without ``q_is_diag``).  F must be a ``ConeF``."""
    dt = torch.promote_types(Q.dtype, p.dtype)
    Q, p, G, h = (x.to(dt) for x in (Q, p, G, h))
    batched = p.dim() == 2
    n = p.shape[-1]
    if q_is_diag is not None:
        diag_q = bool(q_is_diag)
        allowed = {1, p.dim()} if diag_q else {2, p.dim() + 1}
        if Q.dim() not in allowed:
            raise ValueError(
                f"q_is_diag={q_is_diag} but Q.ndim={Q.dim()} does not match "
                f"p.ndim={p.dim()} (diagonal Q must be (n,) or (B, n); dense "
                "Q must be (n, n) or (B, n, n))")
    elif batched:
        B_ = p.shape[0]
        if Q.dim() == 2 and tuple(Q.shape) == (B_, n) and B_ == n:
            raise ValueError(
                f"Q shape {tuple(Q.shape)} with batch B == n == {n} is "
                "ambiguous: pass q_is_diag=True (per-instance diagonals) or "
                "q_is_diag=False (shared dense Q)")
        diag_q = Q.dim() == 1 or (Q.dim() == 2 and tuple(Q.shape) == (B_, n))
    else:
        diag_q = Q.dim() == 1
    if diag_q and batched and Q.dim() == 1:
        Q = Q.expand(p.shape[0], n)
    lead = (p.shape[0],) if batched else ()
    opts = dict(dtype=dt, device=p.device)
    if A is None:
        A = torch.zeros(lead + (0, n), **opts)
        b = torch.zeros(lead + (0,), **opts)
    else:
        A, b = A.to(dt), b.to(dt)
    if not isinstance(F, ConeF):
        raise NotImplementedError(
            "ROADMAP A3: the solver for a dense or absent F is not ported "
            "yet; pass the engine's ConeF")
    F = ConeF(F.mu.to(dt), F.valid.to(dt), F.fd)
    return diag_q, (Q, p, G, h, A, b, F)


def _lcp_bwd_impl(z, s, lam, nu, Q, G, A, F, g, factor_precision=None,
                  refine=0):
    """Cotangents (dQ, dp, dG, dh, dA, db, dmu) of ``lcp_solve`` for the
    output cotangent ``g``, at the solution (z, s, lam, nu) of the rotated
    engine layout (diagonal Q, ``ConeF``).  The transposed solve uses the
    forward's factor mode: ``factor_precision`` and ``refine`` as given to
    the forward."""
    single = G.dim() == 2
    if single:
        z, s, lam, nu, Q, G, A, g = (x[None] for x in (z, s, lam, nu, Q, G,
                                                       A, g))
        F = ConeF(F.mu[None], F.valid[None], F.fd)
    n, m, C = G.shape[-1], G.shape[-2], F.C
    if not (F.fd == 2 and m == 4 * C):
        raise _unported("A3/B2b", "the backward without the friction-pair "
                        "rotation")
    consts = _dtype_consts(Q.dtype)
    d_inv = torch.clamp(s / torch.clamp(lam, min=consts["tiny"]),
                        consts["dinv_min"], consts["dinv_max"])
    solve = _rot_factor_factory(ipm.rot_operands(Q, G, A, C), F,
                                consts["reg"], factor_precision,
                                refine)(d_inv)
    w = solve(torch.cat([g, torch.zeros_like(s), torch.zeros_like(nu)], -1),
              trans=1)
    wz, wl, wn = w[:, :n], w[:, n:n + m], w[:, n + m:]
    outer = lambda a, c: a[:, :, None] * c[:, None, :]
    grads = (-(wz * z), -wz, -(outer(wl, z) + outer(lam, wz)), wl,
             -(outer(wn, z) + outer(nu, wz)), wn, wl[:, 3 * C:] * lam[:, :C])
    if single:
        grads = tuple(x[0] for x in grads)
    return grads


class _LcpSolve(torch.autograd.Function):
    """z of the mixed LCP, with the implicit-KKT backward."""

    @staticmethod
    def forward(ctx, Q, p, G, h, A, b, mu, valid, row_mask, fd, kw):
        sol = pdipm_solve(Q, p, G, h, A, b, ConeF(mu, valid, fd),
                          row_mask=row_mask, **kw)
        ctx.save_for_backward(sol.z, sol.s, sol.lam, sol.nu, Q, G, A, mu,
                              valid)
        ctx.fd = fd
        ctx.factor_precision = kw["factor_precision"]
        ctx.refine = kw["refine"]
        return sol.z

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_z):
        z, s, lam, nu, Q, G, A, mu, valid = ctx.saved_tensors
        grads = _lcp_bwd_impl(z, s, lam, nu, Q, G, A,
                              ConeF(mu, valid, ctx.fd), grad_z,
                              ctx.factor_precision, ctx.refine)
        # valid and row_mask are masks: zero cotangent (None)
        return grads + (None, None, None, None)


def lcp_solve(Q, p, G, h, A=None, b=None, F=None, *, max_iter=20, tol=1e-7,
              gamma_rows=0, q_is_diag=None, row_mask=None, refine=0,
              not_improved_lim=3, fric_pair=False, gondzio=0,
              stall_rtol=0.0, factor_precision=None):
    """Differentiable mixed-LCP solve returning the primal solution ``z``;
    see the JAX package's ``lcp_solve`` for shapes and knobs.  Gradients
    reach Q (diagonal), p, G, h, A, b and ``F.mu`` through the implicit
    backward (module docstring).  ``factor_precision='highest'`` selects
    the exact scalar panel kernel for the blocked factor's float32 panels,
    in the forward and in the backward."""
    diag_q, (Q, p, G, h, A, b, F) = _normalize(Q, p, G, h, A, b, F,
                                               q_is_diag)
    if row_mask is not None:
        row_mask = row_mask.to(h.dtype)
    kw = dict(max_iter=max_iter, tol=tol, q_is_diag=diag_q,
              gamma_rows=gamma_rows, refine=refine,
              not_improved_lim=not_improved_lim, fric_pair=fric_pair,
              gondzio=gondzio, stall_rtol=float(stall_rtol),
              factor_precision=factor_precision)
    return _LcpSolve.apply(Q, p, G, h, A, b, F.mu, F.valid, row_mask, F.fd,
                           kw)


def lcp_solve_full(Q, p, G, h, A=None, b=None, F=None, *, max_iter=20,
                   tol=1e-7, gamma_rows=0, q_is_diag=None, row_mask=None,
                   refine=0, not_improved_lim=3, fric_pair=False, gondzio=0,
                   stall_rtol=0.0, factor_precision=None) -> PdipmSolution:
    """Non-differentiable solve returning the full :class:`PdipmSolution`."""
    diag_q, (Q, p, G, h, A, b, F) = _normalize(Q, p, G, h, A, b, F,
                                               q_is_diag)
    if row_mask is not None:
        row_mask = row_mask.to(h.dtype)
    with torch.no_grad():
        return pdipm_solve(Q, p, G, h, A, b, F, max_iter=max_iter, tol=tol,
                           q_is_diag=diag_q, gamma_rows=gamma_rows,
                           row_mask=row_mask, refine=refine,
                           not_improved_lim=not_improved_lim,
                           fric_pair=fric_pair, gondzio=gondzio,
                           stall_rtol=stall_rtol,
                           factor_precision=factor_precision)
