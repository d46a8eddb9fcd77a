"""Differentiable-LCP entry points around the interior-point solver.

Counterpart of ``lcp_physics_tpu/lcp/lcp.py``.  ``lcp_solve`` is a
``torch.autograd.Function``: the forward runs the interior-point solver;
the backward differentiates the KKT optimality conditions at the
epsilon-interior solution (z, s, lam, nu) by the implicit function
theorem, with ONE transposed solve of the reduced KKT system in the
forward's factor mode,

    K(d)^T [w_z; w_l; w_n] = [g; 0; 0],   d = s / lam,

and the cotangents

    dQ = -(w_z z^T)  (-(w_z o z) for a diagonal Q)      dp = -w_z
    dG = -(w_l z^T + lam w_z^T)                          dh = w_l
    dA = -(w_n z^T + nu w_z^T)                           db = w_n
    dF = -(w_l lam^T)  (a ``ConeF``: dmu = w_l[gamma] o lam[normal]),

the solver iterations never being differentiated.  Without inequality
rows (m == 0) the transposed system is the equality-only KKT of
``solve_eq_kkt``.
"""
from __future__ import annotations

import torch

from lcp_physics_tpu_torch.lcp.cone import ConeF
from lcp_physics_tpu_torch.lcp.pdipm import (PdipmSolution, _dtype_consts,
                                             _expand_batch, make_kkt_factor,
                                             pdipm_solve, solve_eq_kkt)
from lcp_physics_tpu_torch.lcp.util import bger
from lcp_physics_tpu_torch.utils.observe import span


def _normalize(Q, p, G, h, A, b, F, q_is_diag=None):
    """Common dtype, default A/b (empty) and F (zeros), and whether Q is a
    diagonal (same rules as the JAX package, including refusing the
    ambiguous batched B == n diagonal without ``q_is_diag``); then every
    input expanded to the batch when any carries one."""
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
    m = G.shape[-2]
    lead = (p.shape[0],) if batched else ()
    opts = dict(dtype=dt, device=p.device)
    if A is None:
        A = torch.zeros(lead + (0, n), **opts)
        b = torch.zeros(lead + (0,), **opts)
    else:
        A, b = A.to(dt), b.to(dt)
    if F is None:
        F = torch.zeros(lead + (m, m), **opts)
    elif isinstance(F, ConeF):
        F = ConeF(F.mu.to(dt), F.valid.to(dt), F.fd)
    else:
        F = F.to(dt)
    ranks = (1 if diag_q else 2, 1, 2, 1, 2, 1)
    cone = isinstance(F, ConeF)
    xs = (Q, p, G, h, A, b) + ((F.mu, F.valid) if cone else (F,))
    any_batched, expanded = _expand_batch(xs, ranks + ((1, 1) if cone
                                                       else (2,)))
    xs = list(expanded if any_batched else xs)
    if cone:
        xs = xs[:6] + [ConeF(xs[6], xs[7], F.fd)]
    return diag_q, tuple(xs[:7])


def _lcp_bwd_impl(z, s, lam, nu, Q, G, A, F, g, diag_q=True, gamma_rows=0,
                  fric_pair=False, backend="auto", factor_precision=None,
                  refine=0):
    """Cotangents (dQ, dp, dG, dh, dA, db, dF) of ``lcp_solve`` for the
    output cotangent ``g`` at the solution (z, s, lam, nu); dF is the
    cotangent of ``F.mu`` for a ``ConeF``.  The transposed solve uses the
    forward's factor: the same ``gamma_rows``, ``fric_pair``, ``backend``,
    ``factor_precision`` and ``refine``."""
    single = G.dim() == 2
    cone = isinstance(F, ConeF)
    if single:
        z, s, lam, nu, Q, G, A, g = (x[None] for x in (z, s, lam, nu, Q, G,
                                                       A, g))
        F = ConeF(F.mu[None], F.valid[None], F.fd) if cone else F[None]
    n, m = G.shape[-1], G.shape[-2]
    consts = _dtype_consts(Q.dtype)
    dQ_of = lambda wz: -(wz * z) if diag_q else -bger(wz, z)
    if m == 0:
        Qd = torch.diag_embed(Q) if diag_q else Q
        wz, wn = solve_eq_kkt(Qd, g, A, torch.zeros_like(nu),
                              backend=backend)
        wz, wn = -wz, -wn   # solve_eq_kkt's rhs is [-p; b], ours [g; 0]
        wl = torch.zeros_like(s)
    else:
        d_inv = torch.clamp(s / torch.clamp(lam, min=consts["tiny"]),
                            consts["dinv_min"], consts["dinv_max"])
        solve = make_kkt_factor(Q, Q if diag_q else None, G, A, F,
                                consts["reg"], backend,
                                gamma_rows if diag_q else 0, refine,
                                factor_precision, fric_pair)(d_inv)
        w = solve(torch.cat([g, torch.zeros_like(s), torch.zeros_like(nu)],
                            -1), trans=1)
        wz, wl, wn = w[:, :n], w[:, n:n + m], w[:, n + m:]
    if cone:
        # F carries only mu (at [gamma_i, normal_i] = -mu_i): the dense
        # cotangent -(w_l lam^T) there, chained through the -1
        dF = wl[:, m - F.C:] * lam[:, :F.C]
    else:
        dF = -bger(wl, lam)
    grads = (dQ_of(wz), -wz, -(bger(wl, z) + bger(lam, wz)), wl,
             -(bger(wn, z) + bger(nu, wz)), wn, dF)
    if single:
        grads = tuple(x[0] for x in grads)
    return grads


class _LcpSolve(torch.autograd.Function):
    """z of the mixed LCP, with the implicit-KKT backward.  F is passed as
    a dense tensor (``valid`` None) or as a ``ConeF``'s (mu, valid)."""

    @staticmethod
    def forward(ctx, Q, p, G, h, A, b, F_or_mu, valid, row_mask, fd, kw):
        F = F_or_mu if valid is None else ConeF(F_or_mu, valid, fd)
        sol = pdipm_solve(Q, p, G, h, A, b, F, row_mask=row_mask, **kw)
        ctx.save_for_backward(sol.z, sol.s, sol.lam, sol.nu, Q, G, A,
                              F_or_mu, valid)
        ctx.fd = fd
        ctx.bwd = dict(diag_q=kw["q_is_diag"], gamma_rows=kw["gamma_rows"],
                       fric_pair=kw["fric_pair"], backend=kw["backend"],
                       factor_precision=kw["factor_precision"],
                       refine=kw["refine"])
        return sol.z

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_z):
        z, s, lam, nu, Q, G, A, F_or_mu, valid = ctx.saved_tensors
        F = F_or_mu if valid is None else ConeF(F_or_mu, valid, ctx.fd)
        with span("solver.bwd"):
            grads = _lcp_bwd_impl(z, s, lam, nu, Q, G, A, F, grad_z,
                                  **ctx.bwd)
        # valid and row_mask are masks: zero cotangent (None)
        return grads + (None, None, None, None)


def _solver_kw(diag_q, max_iter, tol, backend, gamma_rows, refine,
               not_improved_lim, factor_precision, fric_pair, gondzio,
               verbose, stall_rtol):
    return dict(max_iter=max_iter, tol=tol, backend=backend,
                q_is_diag=diag_q, gamma_rows=gamma_rows, refine=refine,
                not_improved_lim=not_improved_lim,
                factor_precision=factor_precision, fric_pair=fric_pair,
                gondzio=gondzio, verbose=bool(verbose),
                stall_rtol=float(stall_rtol))


def lcp_solve(Q, p, G, h, A=None, b=None, F=None, *, max_iter=20, tol=1e-7,
              backend="auto", gamma_rows=0, q_is_diag=None, row_mask=None,
              refine=0, not_improved_lim=3, factor_precision=None,
              fric_pair=False, gondzio=0, bwd_precision=None, verbose=False,
              stall_rtol=0.0):
    """Differentiable mixed-LCP solve returning the primal solution ``z``;
    the JAX package's ``lcp_solve``, same shapes and knobs (single
    instance or a leading batch axis; A/b default to an empty equality
    block, F to zeros).  Gradients reach Q (dense or diagonal), p, G, h,
    A, b and F (dense, or ``F.mu`` of a ``ConeF``) through the implicit
    backward (module docstring).  ``factor_precision='highest'`` selects
    the exact scalar panel kernel for the blocked factor's float32 panels,
    in the forward and in the backward.  ``bwd_precision`` is accepted
    and has no effect: the port's backward products are full float32 or
    float64 already.  ``verbose`` prints one line per iteration and keeps
    the solve out of the fused kernels."""
    diag_q, (Q, p, G, h, A, b, F) = _normalize(Q, p, G, h, A, b, F,
                                               q_is_diag)
    if row_mask is not None:
        row_mask = row_mask.to(h.dtype)
    kw = _solver_kw(diag_q, max_iter, tol, backend, gamma_rows, refine,
                    not_improved_lim, factor_precision, fric_pair, gondzio,
                    verbose, stall_rtol)
    if isinstance(F, ConeF):
        return _LcpSolve.apply(Q, p, G, h, A, b, F.mu, F.valid, row_mask,
                               F.fd, kw)
    return _LcpSolve.apply(Q, p, G, h, A, b, F, None, row_mask, None, kw)


def lcp_solve_full(Q, p, G, h, A=None, b=None, F=None, *, max_iter=20,
                   tol=1e-7, backend="auto", gamma_rows=0, q_is_diag=None,
                   row_mask=None, refine=0, not_improved_lim=3,
                   factor_precision=None, fric_pair=False, gondzio=0,
                   verbose=False, stall_rtol=0.0) -> PdipmSolution:
    """Non-differentiable diagnostic solve returning the full
    :class:`PdipmSolution` (slacks, multipliers, residuals, iteration
    counts)."""
    diag_q, (Q, p, G, h, A, b, F) = _normalize(Q, p, G, h, A, b, F,
                                               q_is_diag)
    if row_mask is not None:
        row_mask = row_mask.to(h.dtype)
    with torch.no_grad():
        return pdipm_solve(Q, p, G, h, A, b, F, row_mask=row_mask,
                           **_solver_kw(diag_q, max_iter, tol, backend,
                                        gamma_rows, refine, not_improved_lim,
                                        factor_precision, fric_pair, gondzio,
                                        verbose, stall_rtol))


class LCPFunction:
    """API-parity shim for the reference's ``LCPFunction`` (an old-style
    torch autograd Function instantiated per call: ``LCPFunction(eps,
    verbose, notImprovedLim, maxIter)(Q, p, G, h, A, b, F)``), mapping its
    constructor knobs onto :func:`lcp_solve` so reference user code ports
    mechanically.  ``notImprovedLim`` is the solver's per-instance stall
    exit (``not_improved_lim``)."""

    def __init__(self, eps=1e-7, verbose=0, notImprovedLim=3, maxIter=20,
                 backend="auto"):
        self.eps = eps
        self.verbose = verbose
        self.notImprovedLim = notImprovedLim
        self.maxIter = maxIter
        self.backend = backend
        # populated after a call, as the reference keeps its solution
        self.zhats = None

    def __call__(self, Q, p, G, h, A=None, b=None, F=None):
        self.zhats = lcp_solve(Q, p, G, h, A, b, F, max_iter=self.maxIter,
                               tol=self.eps, backend=self.backend,
                               not_improved_lim=self.notImprovedLim,
                               verbose=bool(self.verbose))
        return self.zhats
