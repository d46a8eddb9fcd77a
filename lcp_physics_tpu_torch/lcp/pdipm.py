r"""Mehrotra predictor-corrector primal-dual interior-point solver for the
mixed LCP / QP that underlies contact dynamics.

Counterpart of ``lcp_physics_tpu/lcp/pdipm.py``.  Problem (batched):

    minimize_z   1/2 z^T Q z + p^T z
    subject to   G z + F lam + s = h,   s >= 0,  lam >= 0,  s ⊥ lam
                 A z = b

The KKT factor (``make_kkt_factor``) takes the JAX package's four forms:

* dense (Q dense): the reduced KKT matrix K(d) assembled and factored;
* Schur (Q diagonal, ``gamma_rows`` 0): the (m + q)-row complement
  S = B(d) - Ghat Q^-1 Ghat^T with a dense F (a ``ConeF`` made dense);
* gamma elimination (Q diagonal, the trailing ``gamma_rows`` of G zero):
  the gamma rows eliminated in closed form, leaving K = m - gamma + q rows,
  with the ``ConeF`` bands (``ops.ipm.unrot_schur``) or a dense F;
* the friction-pair rotation (``fric_pair=True`` on the engine layout):
  also the u rows eliminated, K2 = 2C + q rows (``_rot_factor_factory``).

Each system is formed whole and factored by the lane LU (``ops.linalg``,
K <= 88) or the blocked LU over 128-panels (K > 88); ``backend='xla'``
takes the row-pivoted library LU instead.  As in the JAX package, a
system past ``linalg.MAX_BLOCKED_N`` rows takes the library LU under
every backend (``resolve_backend``, counted in ``ROUTES``).  A positive
``refine`` adds iterative refinement to every solve: on rotated blocked
systems of at most two panels the factor becomes the explicit
inverse and each solve one matvec plus ``INV_REFINE + refine`` steps
against the structured system; elsewhere ``refine`` steps against the
assembled one.  After the initial Newton solve the iterations run in the
fused whole-IPM kernel (``ops.ipm.fused_ipm``, rotated or unrotated) on
the engine layout when K <= 48, refine and gondzio are 0 and the caller is
not verbose; with ``FUSE_ITER`` set, at refine 0 and rotated 88 < K2 <=
256, in the fused per-iteration kernel (``ops.ipm_iter.fused_iter_ipm``);
otherwise in the packed unfused loop of the JAX package, with its Gondzio
correctors and its per-iteration ``verbose`` line.  Both host loops read
one flag per iteration back to stop once every world is done
(``HOST_READS["ipm_loop"]`` counts those reads; ``verbose`` adds one more
read per iteration, counted as ``HOST_READS["verbose"]``).  ``m == 0`` is
the equality-only KKT solve ``solve_eq_kkt``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from lcp_physics_tpu_torch.lcp.cone import ConeF
from lcp_physics_tpu_torch.ops import ipm, ipm_iter, linalg
from lcp_physics_tpu_torch.utils import bump

HOST_READS = {"ipm_loop": 0, "verbose": 0}
# Factor sites whose system the size rule of resolve_backend sent to the
# pivoted library LU (torch.linalg.lu_factor).
ROUTES = {"library_lu": 0}
BACKENDS = ("auto", "pallas", "fused", "xla")
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


def _check_backend(backend):
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")


def resolve_backend(backend, nk):
    """The backend a factor site uses for an ``nk``-row system: the size
    rule of the JAX package's ``resolve_backend`` without its platform
    rule.  Past ``linalg.MAX_BLOCKED_N`` rows, where the port's pivotless
    factors stop, every backend becomes ``'xla'`` (the pivoted library LU,
    each such routing counted in ``ROUTES``); otherwise the backend stays.
    Every factor site treats a backend other than ``'xla'`` alike (as the
    JAX package treats ``'fused'`` outside its fused loop): the port's
    kernels on a CUDA tensor, their plain versions on a CPU tensor."""
    if backend != "xla" and nk > linalg.MAX_BLOCKED_N:
        bump(ROUTES, "library_lu")
        return "xla"
    return backend


def _factor(K, backend, exact=False):
    """The pivoted library LU for ``backend='xla'``, else the port's
    pivotless factor (kernels on a CUDA tensor)."""
    if backend == "xla":
        return linalg.xla_factor(K)
    return linalg.plu_factor(K, exact)


def _solve_refined(fac, apply, rhs, trans, steps):
    """x = K^-1 rhs (K^-T rhs for trans=1) from ``fac``, then ``steps``
    refinement steps x += K^-1 (rhs - apply(x, trans)), ``apply`` being
    K (or K^T) times a vector."""
    x = linalg.plu_solve(fac, rhs, trans)
    for _ in range(steps):
        x = x + linalg.plu_solve(fac, rhs - apply(x, trans), trans)
    return x


def _dense_apply(K):
    """K (or K^T) times a vector, for the refinement residual."""
    return lambda x, trans: torch.einsum(
        "bij,bj->bi" if trans == 0 else "bji,bj->bi", K, x)


def _rot_factor_factory(operands, F, reg, factor_precision=None, refine=0,
                        backend="auto"):
    r"""KKT solve operator factory ``factor(d_inv) -> solve`` for the engine
    layout with the gamma rows and the friction-pair rotation eliminated
    (the JAX package's ``_rot_factor_factory``; the caller guarantees the
    layout).  ``operands`` = (P2, Ghat2, Q^-1) from
    ``ops.ipm.rot_operands``; ``factor_precision='highest'`` (or
    ``'float32'``) sends float32 panel inverses of the blocked factor to
    the scalar Gauss-Jordan kernel.  ``refine`` adds refinement steps to
    every solve (module docstring); ``backend='xla'`` factors with the
    pivoted library LU.

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
    Past ``linalg.MAX_BLOCKED_N`` rows every backend factors with the
    pivoted library LU (:func:`resolve_backend`).
    """
    P2, Ghat2, qinv = operands
    n = qinv.shape[-1]
    C_ = F.C
    mg, m = 3 * C_, 4 * C_
    K2 = P2.shape[-1]
    backend = resolve_backend(backend, K2)
    v_, mu_v = F.valid, F.mu
    exact = factor_precision in ("highest", "float32")
    pivoted = backend == "xla"
    blocked = not pivoted and linalg.blocked_path(K2)
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
            fac = _factor(rs.S, backend, exact)
            apply, steps = _dense_apply(rs.S), refine
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

        def solve(rhs, trans=0, r1_zero=False):
            w_full, wk = reduced(rhs, trans, r1_zero)
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
    factor_rot.has_reduced = True
    factor_rot.operands = operands
    if blocked and linalg.inv_supported(K2):
        def iter_inv_raw(d_inv):
            rs = ipm.rot_schur(P2, d_inv, mu_v, v_, C_, reg)
            return linalg.inv_factor_blocks(rs.S, exact).inv

        factor_rot.iter_inv_raw = iter_inv_raw
    return factor_rot


def _gamma_factor_factory(operands, F, m, g_, reg, factor_precision=None,
                          refine=0, backend="auto"):
    r"""KKT solve operator factory for a diagonal Q with the trailing
    ``g_`` inequality rows eliminated in closed form (the JAX package's
    ``factor_schur_gamma``): those rows have zero G rows and a zero F
    diagonal block, so their Schur block is diagonal.  ``operands`` =
    (P, Ghat, Q^-1) from ``ops.ipm.unrot_operands`` (Ghat = [G_kept; A],
    K = m - g_ + q rows); F is a ``ConeF`` (the cone bands of
    ``ops.ipm.unrot_schur``, never materialized) or a dense (B, m, m) F.
    The factored system S is formed whole; ``refine`` adds refinement steps
    against it.  Same ``solve`` / ``reduced`` / ``z_from`` /
    ``residual_ops`` interface as :func:`_rot_factor_factory`."""
    P, Ghat, qinv = operands
    B, n = qinv.shape
    K = P.shape[-1]
    backend = resolve_backend(backend, K)
    mg = m - g_
    q = K - mg
    dt, dev = P.dtype, P.device
    cone = isinstance(F, ConeF)
    exact = factor_precision in ("highest", "float32")
    if cone:
        C_, fd, v_, mu_v = F.C, F.fd, F.valid, F.mu
        if not (g_ == C_ and mg == C_ * (1 + fd)):
            raise ValueError("gamma elimination with a ConeF expects the "
                             "engine row layout")
        pad_q = lambda x: torch.nn.functional.pad(x, (0, q))

        def wf_of(wk):
            return sum(wk[:, C_ * (1 + d):C_ * (2 + d)] for d in range(fd))

        # Skg = [0_C; -E; 0_q], Sgk = [-diag(mu), E^T, 0_q]: O(C) products
        skg_apply = lambda tD: pad_q(torch.cat(
            [torch.zeros_like(tD)] + [-v_ * tD] * fd, -1))
        sgk_t_apply = lambda tD: pad_q(torch.cat(
            [-mu_v * tD] + [v_ * tD] * fd, -1))
        sgk_apply = lambda wk: -mu_v * wk[:, :C_] + v_ * wf_of(wk)
        skg_t_apply = lambda wk: -v_ * wf_of(wk)
    else:
        zeros_qg = torch.zeros((B, q, g_), dtype=dt, device=dev)
        Skg = torch.cat([F[:, :mg, mg:m], zeros_qg], 1)           # (B, K, g)
        Sgk = torch.cat([F[:, mg:m, :mg], zeros_qg.transpose(1, 2)], 2)
        skg_apply = lambda tD: torch.einsum("bkg,bg->bk", Skg, tD)
        sgk_t_apply = lambda tD: torch.einsum("bgk,bg->bk", Sgk, tD)
        sgk_apply = lambda wk: torch.einsum("bgk,bk->bg", Sgk, wk)
        skg_t_apply = lambda wk: torch.einsum("bkg,bk->bg", Skg, wk)
        eye_mg = torch.eye(mg, dtype=dt, device=dev)
        F_kk = F[:, :mg, :mg]

    def factor_schur_gamma(d_inv):
        if cone:
            S, _, Dginv, _, _ = ipm.unrot_schur(P, d_inv, mu_v, v_, C_, fd,
                                                reg)
        else:
            Dginv = 1.0 / (d_inv[:, mg:] + reg)
            S = -P
            S[:, :mg, :mg] += (F_kk - d_inv[:, :mg, None] * eye_mg
                               - reg * eye_mg)
            S[:, mg:, mg:].diagonal(dim1=1, dim2=2).sub_(reg)
            S = S + torch.einsum("bkg,bg,bgj->bkj", Skg, Dginv, Sgk)
        fac = _factor(S, backend, exact)
        apply = _dense_apply(S)

        def reduced(rhs, trans=0, r1_zero=False):
            r1, r2 = rhs[:, :n], rhs[:, n:]
            rk = torch.cat([r2[:, :mg], r2[:, m:]], -1)
            tg = r2[:, mg:m]                     # gamma G rows are zero
            tk = rk if r1_zero else rk - torch.einsum(
                "bkn,bn->bk", Ghat, qinv * r1)
            if trans == 0:
                wk = _solve_refined(fac, apply, tk + skg_apply(Dginv * tg),
                                    0, refine)
                wg = -Dginv * (tg - sgk_apply(wk))
            else:
                wk = _solve_refined(fac, apply,
                                    tk + sgk_t_apply(Dginv * tg), 1, refine)
                wg = -Dginv * (tg - skg_t_apply(wk))
            return torch.cat([wk[:, :mg], wg, wk[:, mg:]], -1), wk

        def z_from(r1, wk):
            return qinv * (r1 - torch.einsum("bkn,bk->bn", Ghat, wk))

        def solve(rhs, trans=0, r1_zero=False):
            w_full, wk = reduced(rhs, trans, r1_zero)
            return torch.cat([z_from(rhs[:, :n], wk), w_full], -1)

        solve.reduced = reduced
        solve.z_from = z_from
        return solve

    # compact residual products over Ghat: G's gamma rows are zero
    def res_down(z):
        y = torch.einsum("bkn,bn->bk", Ghat, z)
        return torch.cat([y[:, :mg], y.new_zeros((B, g_)), y[:, mg:]], -1)

    def res_up(lam, nu):
        return torch.einsum("bkn,bk->bn", Ghat,
                            torch.cat([lam[:, :mg], nu], -1))

    factor_schur_gamma.residual_ops = (res_down, res_up)
    factor_schur_gamma.has_reduced = True
    factor_schur_gamma.operands = operands
    return factor_schur_gamma


def _assemble_kkt(Q, G, A, F, d_inv, reg):
    """Reduced (slack-eliminated) KKT matrix K(d), batched: Q (B, n, n),
    G (B, m, n), A (B, q, n), F (B, m, m), d_inv (B, m) = s / lam."""
    B, n = Q.shape[0], Q.shape[-1]
    m, q = G.shape[-2], A.shape[-2]
    opts = dict(dtype=Q.dtype, device=Q.device)
    eye = lambda k: torch.eye(k, **opts)
    top = torch.cat([Q + reg * eye(n), G.transpose(1, 2), A.transpose(1, 2)],
                    -1)
    mid = torch.cat([G, F - d_inv[..., None] * eye(m) - reg * eye(m),
                     torch.zeros((B, m, q), **opts)], -1)
    bot = torch.cat([A, torch.zeros((B, q, m), **opts),
                     (-reg * eye(q)).expand(B, q, q)], -1)
    return torch.cat([top, mid, bot], -2)


def make_kkt_factor(Q, q_diag, G, A, F, reg, backend="auto", gamma_rows=0,
                    refine=0, factor_precision=None, fric_pair=False):
    """KKT solve operator factory ``factor(d_inv) -> solve(rhs, trans=0,
    r1_zero=False)`` for the reduced KKT system K(d) (the JAX package's
    ``make_kkt_factor``): the dense K(d) when ``q_diag`` is None, else the
    Schur complement over P = Ghat Q^-1 Ghat^T, with the gamma rows (and,
    with ``fric_pair`` on the engine layout, the friction pair's u rows)
    eliminated when ``gamma_rows`` > 0 (module docstring).  All inputs
    batched; F a dense (B, m, m) tensor or a ``ConeF``."""
    n = Q.shape[-1]
    m, q = G.shape[-2], A.shape[-2]
    cone = isinstance(F, ConeF)
    exact = factor_precision in ("highest", "float32")
    if q_diag is None:
        Fd = F.dense() if cone else F

        def factor_dense(d_inv):
            K = _assemble_kkt(Q, G, A, Fd, d_inv, reg)
            fac = _factor(K, resolve_backend(backend, n + m + q), exact)
            apply = _dense_apply(K)
            # r1_zero accepted for interface parity: nothing to skip here
            return lambda rhs, trans=0, r1_zero=False: _solve_refined(
                fac, apply, rhs, trans, refine)

        return factor_dense

    if gamma_rows == 0 or gamma_rows > m:
        Fd = F.dense() if cone else F
        be = resolve_backend(backend, m + q)
        P, Ghat, qinv = ipm.unrot_operands(q_diag, G, A, 0)   # [G; A]
        eye_m = torch.eye(m, dtype=Q.dtype, device=Q.device)

        def factor_schur(d_inv):
            S = -P
            S[:, :m, :m] += Fd - d_inv[..., None] * eye_m - reg * eye_m
            S[:, m:, m:].diagonal(dim1=1, dim2=2).sub_(reg)
            fac = _factor(S, be, exact)
            apply = _dense_apply(S)

            def solve(rhs, trans=0, r1_zero=False):
                r1, r2 = rhs[:, :n], rhs[:, n:]
                t = r2 if r1_zero else r2 - torch.einsum(
                    "bmn,bn->bm", Ghat, qinv * r1)
                w = _solve_refined(fac, apply, t, trans, refine)
                z = qinv * (r1 - torch.einsum("bmn,bm->bn", Ghat, w))
                return torch.cat([z, w], -1)

            return solve

        return factor_schur

    if (cone and fric_pair and F.fd == 2 and gamma_rows == F.C
            and m - gamma_rows == 3 * F.C):
        return _rot_factor_factory(ipm.rot_operands(q_diag, G, A, F.C), F,
                                   reg, factor_precision, refine, backend)
    return _gamma_factor_factory(ipm.unrot_operands(q_diag, G, A,
                                                    gamma_rows),
                                 F, m, gamma_rows, reg, factor_precision,
                                 refine, backend)


def _expand_batch(arrays, base_rank):
    """Promote single-instance inputs to a batch of one; report whether any
    input was already batched."""
    batched = any(a.dim() == r + 1 for a, r in zip(arrays, base_rank))
    B = max((a.shape[0] for a, r in zip(arrays, base_rank)
             if a.dim() == r + 1), default=1)
    out = [a.expand((B,) + tuple(a.shape)) if a.dim() == r else a
           for a, r in zip(arrays, base_rank)]
    return batched, out


def solve_eq_kkt(Q, p, A, b, reg=None, backend="auto"):
    """Equality-only KKT solve: [[Q, A^T], [A, 0]] [z; nu] = [-p; b], with
    the solver's regularization (the JAX package's ``solve_eq_kkt``; the
    reference's contact-free path).  Single-instance or batched; returns
    (z, nu).  The pivotless factor (kernels on a CUDA tensor), or the
    pivoted library LU with ``backend='xla'`` or past
    ``linalg.MAX_BLOCKED_N`` rows (:func:`resolve_backend`)."""
    _check_backend(backend)
    single = Q.dim() == 2
    if single:
        Q, p, A, b = Q[None], p[None], A[None], b[None]
    B, n = Q.shape[0], Q.shape[-1]
    q = A.shape[-2]
    opts = dict(dtype=Q.dtype, device=Q.device)
    if reg is None:
        reg = _dtype_consts(Q.dtype)["reg"]
    K = torch.cat([
        torch.cat([Q + reg * torch.eye(n, **opts), A.transpose(1, 2)], -1),
        torch.cat([A, (-reg * torch.eye(q, **opts)).expand(B, q, q)], -1),
    ], -2)
    sol = linalg.plu_solve(_factor(K, resolve_backend(backend, n + q)),
                           torch.cat([-p, b], -1))
    z, nu = sol[:, :n], sol[:, n:]
    if single:
        z, nu = z[0], nu[0]
    return z, nu


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


def initial_point(operands, p, h, b, F, row_mask, consts, fric_pair=True):
    """The solver's starting iterate (z, s, lam, nu) through the rotated
    KKT factor (``operands`` = ``ops.ipm.rot_operands(q_diag, G, A, F.C)``)
    or, with ``fric_pair=False``, the unrotated gamma factor
    (``ops.ipm.unrot_operands``)."""
    if fric_pair:
        fac = _rot_factor_factory(operands, F, consts["reg"])
    else:
        fac = _gamma_factor_factory(operands, F, F.m, F.C, consts["reg"])
    return _start(fac, p, h, b, row_mask, consts)


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
    residual norm.  The residual products ride the factor's compact
    ``residual_ops`` where it has them, else dense G, A, F and Q (or its
    diagonal ``q_diag``)."""

    def __init__(self, kkt_factor, Q, q_diag, G, A, p, h, b, F, row_mask):
        B, n = p.shape
        m, q = h.shape[-1], b.shape[-1]
        dev = p.device
        self.res_ops = getattr(kkt_factor, "residual_ops", None)
        self.Q, self.q_diag, self.G, self.A = Q, q_diag, G, A
        self.p, self.h, self.b, self.F = p, h, b, F
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
        bmv = lambda M, x: torch.einsum("bij,bj->bi", M, x)
        bmtv = lambda M, x: torch.einsum("bij,bi->bj", M, x)
        Qz = (self.q_diag * z if self.q_diag is not None
              else bmv(self.Q, z))
        Flam = (self.F.matvec(lam) if isinstance(self.F, ConeF)
                else bmv(self.F, lam))
        if self.res_ops is not None:
            res_down, res_up = self.res_ops
            ga = res_down(z)
            rx = Qz + self.p + res_up(lam, nu)
            rz = ga[:, :self.m] + Flam + s - self.h
            ry = ga[:, self.m:] - self.b
        else:
            rx = Qz + self.p + bmtv(self.G, lam) + bmtv(self.A, nu)
            rz = bmv(self.G, z) + Flam + s - self.h
            ry = bmv(self.A, z) - self.b
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


def unfused_loop(kkt_factor, pk, z, s, lam, nu, *, max_iter, tol, consts,
                 not_improved_lim, stall_rtol, gondzio=0, verbose=False):
    """The packed unfused interior-point loop of the JAX package from the
    iterate (z, s, lam, nu), with ``pk`` the loop's :class:`_Packed`: the
    state is one (B, n + 2m + q) tensor X = [z | s | lam | nu]; per
    iteration one factor, the predictor solve and the corrector as a delta
    solve (through ``solve.reduced`` and one z-recovery where the factor
    has them, else full solves), ``gondzio`` Gondzio centrality correctors,
    the 0.99 step, the floor clamp, the pin of padded rows and the
    divergence guard; stall counter, ``stall_rtol``, best-iterate return.
    ``verbose`` prints the JAX package's line per iteration.  Stops after
    ``max_iter`` iterations or once every world is done (one host read per
    iteration).  Returns a :class:`PdipmSolution`."""
    B, n = pk.p.shape
    m, q = pk.m, pk.b.shape[-1]
    dt, dev = pk.p.dtype, pk.p.device
    tiny = consts["tiny"]
    has_reduced = getattr(kkt_factor, "has_reduced", False)
    maskb = pk.maskb
    sls = slice(n, n + 2 * m)
    ones_n = torch.ones((B, n), dtype=torch.bool, device=dev)
    ones_q = torch.ones((B, q), dtype=torch.bool, device=dev)
    fmax = torch.finfo(dt).max
    floor_row = torch.cat([torch.full((n,), -fmax, dtype=dt, device=dev),
                           torch.full((2 * m,), tiny, dtype=dt, device=dev),
                           torch.full((q,), -fmax, dtype=dt, device=dev)])
    pinm = torch.cat([ones_n, maskb, maskb, ones_q], -1)
    pinv = torch.cat([torch.zeros((B, n), dtype=dt, device=dev), pk.h,
                      torch.full((B, m), tiny, dtype=dt, device=dev),
                      torch.zeros((B, q), dtype=dt, device=dev)], -1)
    mask2 = torch.cat([maskb, maskb], -1)
    comp_mu = pk.comp_mu

    def rz_rhs(like, rows):
        """A right-hand side that is zero but on the rz rows."""
        rhs = torch.zeros_like(like)
        rhs[:, n:n + m] = rows
        return rhs

    X = torch.cat([z, s, lam, nu], -1)
    bestX = X
    best_merit = torch.full((B,), fmax / 8, dtype=dt, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.full((B,), max_iter, dtype=torch.int32, device=dev)
    stall = torch.zeros(B, dtype=torch.int32, device=dev)
    for i in range(max_iter):
        if i:
            bump(HOST_READS, "ipm_loop")
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
        if verbose:   # the reference's residual dump: one host read
            bump(HOST_READS, "verbose")
            mu_max, r_max, d = torch.stack([
                mu.amax(), pk.resid_norm(r).amax(),
                new_done.sum().to(dt)]).tolist()
            print(f"pdipm iter {i}: mu={mu_max:.3e} resid={r_max:.3e} "
                  f"done={int(d)}/{B}", flush=True)

        lam_safe = torch.clamp(lam, min=tiny)
        d_inv = torch.clamp(s / lam_safe, consts["dinv_min"],
                            consts["dinv_max"])
        kkt_solve = kkt_factor(d_inv)

        # predictor: rhs = -r with the complementarity term on the rz rows
        r4 = s * lam
        rhs_aff = -r
        rhs_aff[:, n:n + m] += r4 / lam_safe
        if has_reduced:
            wa_full, wk_a = kkt_solve.reduced(rhs_aff)
            dlam_a = wa_full[:, :m]
        else:
            sol_a = kkt_solve(rhs_aff)
            dlam_a = sol_a[:, n:n + m]
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
        rhs_d = rz_rhs(r, (r4c - r4) / lam_safe)
        if has_reduced:
            wd_full, wk_d = kkt_solve.reduced(rhs_d, r1_zero=True)
            w_full = wa_full + wd_full
            dlam = w_full[:, :m]
            ds = -r4c / lam_safe - d_inv * dlam
            wk_tot = wk_a + wk_d
            # with gondzio, z waits for the accepted correctors' wk
            dz = (kkt_solve.z_from(rhs_aff[:, :n], wk_tot) if gondzio == 0
                  else torch.zeros((B, n), dtype=dt, device=dev))
            tail = w_full[:, m:]
        else:
            sol_c = sol_a + kkt_solve(rhs_d, r1_zero=True)
            dlam = sol_c[:, n:n + m]
            ds = -r4c / lam_safe - d_inv * dlam
            dz, tail = sol_c[:, :n], sol_c[:, n + m:]
        dX = torch.cat([dz, ds, dlam, tail], -1)
        alpha_raw = _max_step(sl, dX[:, sls], mask2)

        # Gondzio multiple centrality correctors: each reuses the factor
        # for one more solve toward the box [0.1, 10] * sigma mu, accepted
        # per world only where it buys step length
        if gondzio > 0:
            mu_t = (sigma * mu)[:, None]
            for _ in range(gondzio):
                a_hat = torch.clamp(alpha_raw + 0.08, max=1.0)[:, None]
                sl_t = sl + a_hat * dX[:, sls]
                v_t = sl_t[:, :m] * sl_t[:, m:]
                r4g = v_t - torch.clamp(v_t, min=0.1 * mu_t, max=10.0 * mu_t)
                r4g = torch.where(maskb, r4g, 0.0)
                rhs_g = rz_rhs(r, r4g / lam_safe)
                if has_reduced:
                    wg_full, wk_g = kkt_solve.reduced(rhs_g, r1_zero=True)
                    dlam_g = wg_full[:, :m]
                    dz_g, tail_g = torch.zeros_like(dz), wg_full[:, m:]
                else:
                    sol_g = kkt_solve(rhs_g, r1_zero=True)
                    dlam_g = sol_g[:, n:n + m]
                    dz_g, tail_g = sol_g[:, :n], sol_g[:, n + m:]
                ds_g = -r4g / lam_safe - d_inv * dlam_g
                dX_c = dX + torch.cat([dz_g, ds_g, dlam_g, tail_g], -1)
                alpha_c = _max_step(sl, dX_c[:, sls], mask2)
                ok = alpha_c >= torch.clamp(alpha_raw + 0.008, max=1.0)
                dX = torch.where(ok[:, None], dX_c, dX)
                if has_reduced:
                    wk_tot = wk_tot + torch.where(ok[:, None], wk_g, 0.0)
                alpha_raw = torch.where(ok, alpha_c, alpha_raw)
            if has_reduced:
                dX = torch.cat([kkt_solve.z_from(rhs_aff[:, :n], wk_tot),
                                dX[:, n:]], -1)
        alpha = 0.99 * alpha_raw

        X_n = torch.maximum(X + alpha[:, None] * dX, floor_row)
        X_n = torch.where(pinm, X_n, pinv)
        bad = ~torch.isfinite(X_n).all(-1)     # divergence guard
        halt = new_done | bad
        X = torch.where(halt[:, None], X, X_n)
        done = done | halt
    return pk.solution(X, bestX, best_merit, iters)


def pdipm_solve(Q, p, G, h, A, b, F, *, max_iter=20, tol=1e-7,
                backend="auto", q_diag=None, verbose=False, gamma_rows=0,
                q_is_diag=None, row_mask=None, refine=0, not_improved_lim=3,
                factor_precision=None, fric_pair=False, gondzio=0,
                stall_rtol=0.0):
    """Solve a batch of mixed-LCP instances (single instances are promoted
    to a batch of one and squeezed back).  Same arguments and semantics as
    the JAX package's ``pdipm_solve``: Q dense or diagonal (``q_is_diag``,
    None infers it from the shape), or dense with its diagonal ``q_diag``
    for the Schur path; F a dense tensor or a ``ConeF``; ``row_mask``
    (B, m) 1.0 on real inequality rows and 0.0 on padding, which is pinned
    at s = h, lam = tiny.  ``backend``: ``'auto'``, ``'pallas'`` and
    ``'fused'`` run the port's kernels on CUDA tensors (their plain
    versions on CPU tensors) and the fused loops where they fit;
    ``'xla'`` the pivoted library LU and the unfused loop.  A factored
    system past ``linalg.MAX_BLOCKED_N`` rows takes the library LU under
    every backend, as in the JAX package (:func:`resolve_backend`).
    ``factor_precision='highest'`` (or ``'float32'``) sends the blocked
    factor's float32 panel inverses to the scalar Gauss-Jordan kernel.
    ``verbose`` prints one line per iteration (one host read each) and
    keeps the solve in the unfused loop.  Returns a
    :class:`PdipmSolution`."""
    _check_backend(backend)
    stall_rtol = float(stall_rtol)
    if q_is_diag is None:
        diag_form = tuple(Q.shape) == tuple(p.shape) or (
            Q.dim() == 1 and p.dim() == 2 and Q.shape[0] == p.shape[-1])
    else:
        diag_form = bool(q_is_diag)
    q_rank = 1 if diag_form else 2
    cone = isinstance(F, ConeF)
    if cone:
        batched, (Q, p, G, h, A, b, mu_f, v_f) = _expand_batch(
            (Q, p, G, h, A, b, F.mu, F.valid), (q_rank, 1, 2, 1, 2, 1, 1, 1))
        F = ConeF(mu_f, v_f, F.fd)
    else:
        batched, (Q, p, G, h, A, b, F) = _expand_batch(
            (Q, p, G, h, A, b, F), (q_rank, 1, 2, 1, 2, 1, 2))
    B, n = p.shape
    m, q = G.shape[-2], A.shape[-2]
    dt, dev = Q.dtype, p.device
    consts = _dtype_consts(dt)
    if diag_form and q_diag is None:
        q_diag = Q
    if q_diag is not None:
        q_diag = q_diag.expand(B, n)

    def squeeze(sol):
        return sol if batched else PdipmSolution(*(x[0] for x in sol))

    if m == 0:
        z, nu = solve_eq_kkt(torch.diag_embed(Q) if diag_form else Q, p, A,
                             b, consts["reg"], backend)
        zero_m = torch.zeros((B, 0), dtype=dt, device=dev)
        zero_b = torch.zeros((B,), dtype=dt, device=dev)
        return squeeze(PdipmSolution(
            z, zero_m, zero_m, nu, zero_b, zero_b,
            torch.zeros((B,), dtype=torch.int32, device=dev)))

    if row_mask is None:
        row_mask = torch.ones((B, m), dtype=dt, device=dev)
    row_mask = row_mask.expand(B, m).to(dt)
    kkt_factor = make_kkt_factor(Q, q_diag, G, A, F, consts["reg"], backend,
                                 gamma_rows if q_diag is not None else 0,
                                 refine, factor_precision, fric_pair)
    # the fused whole-IPM kernel: the JAX package's dispatch, with the
    # rotated kernel preferred where the caller guarantees the +- pair,
    # and only where a world fits the kernel's shared memory
    fuse = fuse_rot = False
    plain_mehrotra = refine == 0 and gondzio == 0 and not verbose
    if (cone and q_diag is not None and gamma_rows == F.C and plain_mehrotra
            and max_iter > 0 and backend != "xla"):
        fits = lambda K: ipm.launch_fits(n, m, q, F.C, K, p.element_size())
        fuse_rot = (bool(fric_pair) and ipm.fused_supported(
            m - F.C, q, F.C, F.fd, fric_pair=True) and fits(2 * F.C + q))
        fuse = fuse_rot or (ipm.fused_supported(m - F.C, q, F.C, F.fd)
                            and fits(m - F.C + q))
    z, s, lam, nu = _start(kkt_factor, p, h, b, row_mask, consts)
    kw = dict(max_iter=max_iter, tol=tol, consts=consts,
              not_improved_lim=not_improved_lim, stall_rtol=stall_rtol)
    pk = lambda: _Packed(kkt_factor, Q, q_diag, G, A, p, h, b, F, row_mask)
    iter_inv_raw = getattr(kkt_factor, "iter_inv_raw", None)
    if fuse:
        sol = PdipmSolution(*ipm.fused_ipm(
            kkt_factor.operands, p, h, b, F.mu, F.valid, row_mask, z, s,
            lam, nu, C=F.C, fd=F.fd, fric_pair=fuse_rot, **kw))
    elif (FUSE_ITER and plain_mehrotra and cone and max_iter > 0
          and iter_inv_raw is not None
          and ipm_iter.fused_iter_supported(F.C, q, n, p.element_size())):
        X, bestX, best_merit, iters = ipm_iter.fused_iter_ipm(
            kkt_factor.operands[1], kkt_factor.operands[2], p, h, b, F.mu,
            F.valid, row_mask, torch.cat([z, s, lam, nu], -1), C=F.C,
            inv_raw=iter_inv_raw, host_reads=HOST_READS, **kw)
        sol = pk().solution(X, bestX, best_merit, iters)
    else:
        sol = unfused_loop(kkt_factor, pk(), z, s, lam, nu, gondzio=gondzio,
                           verbose=verbose, **kw)
    return squeeze(sol)
