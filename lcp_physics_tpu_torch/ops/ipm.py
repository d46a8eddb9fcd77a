"""The whole interior-point loop in one kernel, for small contact systems.

Counterpart of ``lcp_physics_tpu/ops/ipm.py``.  For the engine layout
(diagonal Q, ``ConeF`` friction coupling, gamma rows eliminated) with a
Schur system of at most ``MAX_FUSED_K`` rows, every Mehrotra iteration —
residuals, Schur assembly, Gauss-Jordan explicit inverse, predictor and
corrector solves with one refinement step each, ratio tests and masked
updates, stall and best-iterate bookkeeping — runs inside
``csrc/fused_ipm.cu``, 16 or 32 lanes of a warp per world and several
worlds per CTA (``launch_shape``).  Two variants, as in the JAX package:

* rotated (``fric_pair=True``, fd = 2): the two friction rows of a contact
  are exact negatives, so the Schur system has K = 2C + q rows over
  ``rot_operands``' Ghat = [G_c; sqrt2 G_f1; A];
* unrotated (otherwise): K = (1 + fd)C + q rows over ``unrot_operands``'
  Ghat = [G_kept; A], with the per-contact cone bands of ``unrot_schur``.

``fused_ipm`` runs the loop on the operands (P = Ghat Q^-1 Ghat^T, Ghat,
Q^-1) with the CUDA kernel on GPU tensors and the plain torch
transcription of the same loop on CPU tensors, from a given start or from
the solver's own, which the kernel then takes before its first iteration
(one more inverse and KKT solve, at d_inv = 1).  ``fused_ipm_ref`` always
runs the plain version.  ``LAUNCHES`` counts kernel launches,
``"fused_ipm"`` the rotated variant and ``"fused_ipm_unrot"`` the
unrotated one.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from lcp_physics_tpu_torch.lcp.cone import ConeF
from lcp_physics_tpu_torch.ops import _build
from lcp_physics_tpu_torch.ops.linalg import gj_inv_ref
from lcp_physics_tpu_torch.utils import bump

MAX_FUSED_K = 48
LAUNCHES = {"fused_ipm": 0, "fused_ipm_unrot": 0}
SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on Hopper
FUSED_BUCKETS = (16, 24, 32, 48)   # the kernel's compile-time Schur sizes
CTA_THREADS = 128

_SQ2 = math.sqrt(2.0)


def fused_supported(mg, q, C, fd, fric_pair=False):
    """Whether the fused loop can take this engine-layout system (same
    rule as the JAX package)."""
    if not (0 < C and mg == C * (1 + fd)):
        return False
    K = (2 * C + q) if (fric_pair and fd == 2) else (mg + q)
    return K <= MAX_FUSED_K


def launch_fits(n, m, q, C, K, itemsize):
    """Whether :func:`launch_shape` takes the system: K within the largest
    bucket and one world, with Ghat left in global memory, within
    SMEM_LIMIT.  Past it (from n = 4,693 at f64 and 9,529 at f32 with
    C = 8, rotated) the solver runs its unfused loop."""
    return K <= MAX_FUSED_K and smem_bytes(
        n, m, q, C, K, fused_bucket(K), itemsize, 0) <= SMEM_LIMIT


def _operands(Ghat, q_diag):
    qinv = 1.0 / q_diag
    P = (Ghat * qinv[:, None, :]) @ Ghat.transpose(1, 2)
    return P, Ghat, qinv


def rot_operands(q_diag, G, A, C):
    """Ghat = [G_c; sqrt2 G_f1; A] (B, K, n), P = Ghat Q^-1 Ghat^T (B, K, K)
    and Q^-1 (B, n): the fixed operands of the rotated Schur system."""
    return _operands(torch.cat([G[:, :C], _SQ2 * G[:, C:2 * C], A], dim=1),
                     q_diag)


def unrot_operands(q_diag, G, A, C):
    """Ghat = [G_kept; A] (B, K, n) (the G rows above the C gamma rows),
    P = Ghat Q^-1 Ghat^T (B, K, K) and Q^-1 (B, n): the fixed operands of
    the unrotated Schur system."""
    return _operands(torch.cat([G[:, :G.shape[1] - C], A], dim=1), q_diag)


class RotSchur(NamedTuple):
    S: torch.Tensor      # (B, K, K) rotated Schur matrix
    dmain: torch.Tensor  # (B, K) S = -P - diag(dmain) + band
    bn: torch.Tensor     # (B, C) its (v row, c column) band
    Dginv: torch.Tensor  # (B, C) the eliminated gamma rows' inverse pivots
    cn: torch.Tensor     # (B, C) u-row coupling to the c rows
    delta: torch.Tensor  # (B, C) u-row coupling to the v rows
    g_u: torch.Tensor    # (B, C) the eliminated u rows' pivots


def rot_schur(P, d_inv, mu_v, valid, C, reg):
    """The rotated Schur system for the scaling ``d_inv`` (B, 4C): the
    gamma rows and the friction pair's u rows eliminated in closed form
    (the JAX package's ``_rot_factor_factory`` scalars)."""
    B, K = P.shape[:2]
    Dginv = 1.0 / (d_inv[:, 3 * C:] + reg)
    cn = valid * mu_v * Dginv
    cf = -valid * Dginv
    a1 = -(d_inv[:, C:2 * C] + reg) + cf
    a2 = -(d_inv[:, 2 * C:3 * C] + reg) + cf
    alpha = 0.5 * (a1 + a2)
    delta = 0.5 * (a1 - a2)
    g_u = alpha + cf
    dmain = torch.cat([d_inv[:, :C] + reg,
                       -(alpha - cf - delta * delta / g_u),
                       torch.full((B, K - 2 * C), reg, dtype=P.dtype,
                                  device=P.device)], -1)
    bn = -_SQ2 * cn * delta / g_u
    S = -P
    S.diagonal(dim1=1, dim2=2).sub_(dmain)
    S[:, C:2 * C, :C].diagonal(dim1=1, dim2=2).add_(bn)
    return RotSchur(S, dmain, bn, Dginv, cn, delta, g_u)


class UnrotSchur(NamedTuple):
    S: torch.Tensor      # (B, K, K) Schur matrix, K = (1 + fd)C + q
    dmain: torch.Tensor  # (B, K) S = -P - diag(dmain) + the cone bands
    Dginv: torch.Tensor  # (B, C) the eliminated gamma rows' inverse pivots
    cn: torch.Tensor     # (B, C) band (friction row, normal column)
    cf: torch.Tensor     # (B, C) band (friction row, friction column)


def unrot_schur(P, d_inv, mu_v, valid, C, fd, reg):
    """The Schur system of the kept rows [normal (C); friction (fd*C); q]
    for the scaling ``d_inv`` (B, (2 + fd)C), the gamma rows eliminated in
    closed form (the JAX package's ``factor_schur_gamma`` with a
    ``ConeF``): S = -P - diag(dmain) plus, for each contact i and
    directions d, d2, cn_i at (C(1+d)+i, i) and cf_i at
    (C(1+d)+i, C(1+d2)+i)."""
    B, K = P.shape[:2]
    mg = C * (1 + fd)
    Dginv = 1.0 / (d_inv[:, mg:] + reg)
    cn = valid * mu_v * Dginv
    cf = -valid * Dginv
    dmain = torch.cat([d_inv[:, :mg] + reg,
                       torch.full((B, K - mg), reg, dtype=P.dtype,
                                  device=P.device)], -1)
    S = -P
    S.diagonal(dim1=1, dim2=2).sub_(dmain)
    for d in range(fd):
        rows = slice(C * (1 + d), C * (2 + d))
        S[:, rows, :C].diagonal(dim1=1, dim2=2).add_(cn)
        for d2 in range(fd):
            S[:, rows, C * (1 + d2):C * (2 + d2)].diagonal(
                dim1=1, dim2=2).add_(cf)
    return UnrotSchur(S, dmain, Dginv, cn, cf)


def unrot_apply(us, P, x, C, fd):
    """S x from the structured form of :func:`unrot_schur`: one P matvec,
    the diagonal and the cone bands (the kernel's refinement residual)."""
    y = -torch.einsum("bij,bj->bi", P, x) - us.dmain * x
    xf = sum(x[:, C * (1 + d):C * (2 + d)] for d in range(fd))
    band = us.cn * x[:, :C] + us.cf * xf
    return y + torch.nn.functional.pad(torch.cat([band] * fd, -1),
                                       (C, x.shape[1] - C * (1 + fd)))


def _loop_ref(P, Ghat, qinv, p, h, b, mu_v, valid, row_mask, z, s, lam, nu,
              *, C, fd, rot, max_iter, tol, consts, not_improved_lim,
              stall_rtol):
    """Plain torch transcription of the kernel's loop, vectorized over B;
    ``rot`` picks the variant.  With ``z`` None the loop takes its own
    start, as the kernel does: one Newton step from the origin at d_inv = 1
    through the loop's inverse, refined solve and KKT solve, then
    ``lcp.pdipm._start``'s shift and pin."""
    B, n = p.shape
    q = b.shape[-1]
    mg = C * (1 + fd)
    kq = 2 * C if rot else mg          # first equality row of the K system
    dt, dev = p.dtype, p.device
    tiny = torch.tensor(consts["tiny"], dtype=dt, device=dev)
    reg = consts["reg"]
    qd = 1.0 / qinv
    rmask = row_mask > 0
    rcount = torch.clamp(row_mask.sum(-1), min=1.0)
    cone = ConeF(mu_v, valid, fd)

    def measures(z, s, lam, nu):
        if rot:
            lam_v = (lam[:, C:2 * C] - lam[:, 2 * C:3 * C]) / _SQ2
            lam_k = torch.cat([lam[:, :C], lam_v, nu], dim=-1)
        else:
            lam_k = torch.cat([lam[:, :mg], nu], dim=-1)
        rx = qd * z + p + torch.einsum("bkn,bk->bn", Ghat, lam_k)
        y = torch.einsum("bkn,bn->bk", Ghat, z)
        if rot:
            gf1 = y[:, C:2 * C] / _SQ2
            gz = torch.cat([y[:, :C], gf1, -gf1], -1)
        else:
            gz = y[:, :mg]
        Flam = cone.matvec(lam)
        rz = torch.cat([gz + Flam[:, :mg], Flam[:, mg:]], -1) + s - h
        ry = y[:, kq:] - b
        mu_c = torch.where(rmask, s * lam, 0.0).sum(-1) / rcount
        resid = torch.maximum(rx.abs().amax(-1),
                              torch.where(rmask, rz.abs(), 0.0).amax(-1))
        if q:
            resid = torch.maximum(resid, ry.abs().amax(-1))
        return rx, rz, ry, mu_c, resid

    def max_step(v, dv):
        neg = (dv < 0) & rmask
        ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0),
                            float("inf"))
        return torch.clamp(ratio.amin(-1), max=1.0)

    def newton(d_inv, rx, ry):
        """The Newton system of the scaling ``d_inv`` at the residuals
        (rx, ry): its Gauss-Jordan explicit inverse, and (kkt_solve, z_of)
        with kkt_solve(r2m) = (wk, dlam) for the rhs [-rx; r2m; -ry] and
        z_of(wk) its z block."""
        if rot:
            rs = rot_schur(P, d_inv, mu_v, valid, C, reg)
            apply_S = lambda x: (
                -torch.einsum("bij,bj->bi", P, x) - rs.dmain * x
                + torch.nn.functional.pad(rs.bn * x[:, :C], (C, q)))
        else:
            rs = unrot_schur(P, d_inv, mu_v, valid, C, fd, reg)
            apply_S = lambda x: unrot_apply(rs, P, x, C, fd)
        S = gj_inv_ref(rs.S)

        def solve_S(rhs):
            x = torch.einsum("bij,bj->bi", S, rhs)
            return x + torch.einsum("bij,bj->bi", S, rhs - apply_S(x))

        y1 = torch.einsum("bkn,bn->bk", Ghat, qinv * -rx)

        def kkt_solve(r2m):
            tg = r2m[:, mg:]
            tD = rs.Dginv * tg
            if not rot:
                skg = torch.cat([torch.zeros_like(tD)]
                                + [-valid * tD] * fd, -1)
                tk = torch.cat([r2m[:, :mg], -ry], -1) - y1
                wk = solve_S(tk + torch.nn.functional.pad(skg, (0, q)))
                wf = sum(wk[:, C * (1 + d):C * (2 + d)] for d in range(fd))
                wg = -rs.Dginv * (tg - (-mu_v * wk[:, :C] + valid * wf))
                return wk, torch.cat([wk[:, :mg], wg], -1)
            ru = (r2m[:, C:2 * C] + r2m[:, 2 * C:3 * C]) / _SQ2
            rv = (r2m[:, C:2 * C] - r2m[:, 2 * C:3 * C]) / _SQ2
            t_u = ru - _SQ2 * valid * tD
            rhs2 = torch.cat([r2m[:, :C] - y1[:, :C],
                              (rv - y1[:, C:2 * C])
                              - (rs.delta / rs.g_u) * t_u,
                              -ry - y1[:, 2 * C:]], -1)
            wk = solve_S(rhs2)
            w_c, w_v = wk[:, :C], wk[:, C:2 * C]
            w_u = (t_u - _SQ2 * rs.cn * w_c - rs.delta * w_v) / rs.g_u
            wg = -rs.Dginv * (tg - (-mu_v * w_c + _SQ2 * valid * w_u))
            dlam = torch.cat([w_c, (w_u + w_v) / _SQ2, (w_u - w_v) / _SQ2,
                              wg], -1)
            return wk, dlam

        def z_of(wk):
            return qinv * (-rx - torch.einsum("bkn,bk->bn", Ghat, wk))

        return kkt_solve, z_of

    if z is None:
        # the start: the rhs [-p; h; b] at d_inv = 1, then shift and pin
        kkt_solve, z_of = newton(torch.ones_like(h), p, -b)
        wk, lam = kkt_solve(h)
        z, nu = z_of(wk), wk[:, kq:]

        def shift(x):
            least = torch.where(rmask, x, float("inf")).amin(-1)
            return x + torch.relu(1.0 - least)[:, None]

        s = torch.where(rmask, shift(-lam), h)
        lam = torch.where(rmask, shift(lam), tiny)

    big = torch.finfo(dt).max / 8
    best = [x.clone() for x in (z, s, lam, nu)]
    best_merit = torch.full((B,), big, dtype=dt, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.full((B,), max_iter, dtype=torch.int32, device=dev)
    stall = torch.zeros(B, dtype=dt, device=dev)
    for it in range(max_iter):
        if bool(done.all()):   # every world frozen: nothing can change
            break
        rx, rz, ry, mu_c, resid = measures(z, s, lam, nu)
        merit = mu_c + resid
        improved = merit < best_merit
        best = [torch.where(improved[:, None], x, bx)
                for x, bx in zip((z, s, lam, nu), best)]
        sig = (merit < best_merit * (1.0 - stall_rtol) if stall_rtol > 0
               else improved)
        best_merit = torch.minimum(merit, best_merit)
        stall = torch.where(sig, 0.0, stall + 1.0)
        if not_improved_lim > 0 and it >= not_improved_lim + 2:
            stalled = stall >= not_improved_lim
        else:
            stalled = torch.zeros_like(done)
        new_done = done | (merit < tol) | stalled
        iters = torch.where(new_done & ~done, it, iters)

        lam_safe = torch.maximum(lam, tiny)
        d_inv = torch.clamp(s / lam_safe, consts["dinv_min"],
                            consts["dinv_max"])
        kkt_solve, z_of = newton(d_inv, rx, ry)

        # predictor
        r4 = s * lam
        _, dlam_a = kkt_solve(-rz + r4 / lam_safe)
        ds_a = -r4 / lam_safe - d_inv * dlam_a
        alpha_a = torch.minimum(max_step(s, ds_a), max_step(lam, dlam_a))
        mu_aff = torch.where(rmask, (s + alpha_a[:, None] * ds_a)
                             * (lam + alpha_a[:, None] * dlam_a),
                             0.0).sum(-1) / rcount
        sigma = torch.clamp(mu_aff / torch.maximum(mu_c, tiny), 0.0, 1.0) ** 3

        # corrector
        r4c = s * lam + ds_a * dlam_a - (sigma * mu_c)[:, None]
        wk, dlam = kkt_solve(-rz + r4c / lam_safe)
        dz = z_of(wk)
        dnu = wk[:, kq:]
        ds = -r4c / lam_safe - d_inv * dlam
        alpha = (0.99 * torch.minimum(max_step(s, ds),
                                      max_step(lam, dlam)))[:, None]
        z_n = z + alpha * dz
        s_n = torch.where(rmask, torch.maximum(s + alpha * ds, tiny), h)
        lam_n = torch.where(rmask, torch.maximum(lam + alpha * dlam, tiny),
                            tiny)
        nu_n = nu + alpha * dnu
        bad = ~(torch.isfinite(z_n).all(-1) & torch.isfinite(s_n).all(-1)
                & torch.isfinite(lam_n).all(-1))
        halt = (new_done | bad)[:, None]
        z = torch.where(halt, z, z_n)
        s = torch.where(halt, s, s_n)
        lam = torch.where(halt, lam, lam_n)
        nu = torch.where(halt, nu, nu_n)
        done = done | halt[:, 0]

    # return the best iterate seen (non-monotone tails)
    _, _, _, mu_f, resid_f = measures(z, s, lam, nu)
    use_best = (best_merit < mu_f + resid_f)[:, None]
    z, s, lam, nu = [torch.where(use_best, bx, x)
                     for x, bx in zip((z, s, lam, nu), best)]
    _, _, _, mu_c, resid = measures(z, s, lam, nu)
    return z, s, lam, nu, mu_c, resid, iters


def _lib():
    lib = _build.load("fused_ipm")
    if not getattr(lib, "_lcp_typed", False):
        P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for ct in ("f32", "f64"):
            f = getattr(lib, f"lcp_fused_ipm_{ct}")
            f.argtypes = [P] * 20 + [I] * 8 + [D] * 5 + [I, D, I, I, I, P]
            f.restype = I
        f = lib.lcp_fused_ipm_smem_bytes
        f.argtypes, f.restype = [I] * 9, ctypes.c_longlong
        lib._lcp_typed = True
    return lib


def fused_bucket(K):
    """The kernel's compile-time Schur size for a K-row system: the least
    of ``FUSED_BUCKETS`` that holds it (rows past K are identity rows)."""
    for kb in FUSED_BUCKETS:
        if K <= kb:
            return kb
    raise ValueError(f"the fused IPM kernel takes K <= {FUSED_BUCKETS[-1]}, "
                     f"got {K}")


def world_lanes(KB):
    """Lanes of a warp that one world takes in bucket KB."""
    return 16 if KB == 16 else 32


def smem_bytes(n, m, q, C, K, KB, itemsize, ghat_smem):
    """Shared memory of one world in bucket KB: the arrays that ``carve``
    in csrc/fused_ipm.cu lays out, each rounded up to 16 bytes -- P at row
    stride KB + 16 bytes, Ghat at row stride n | 1 when ``ghat_smem``, 6
    n-, 13 m-, 5 q-, 9 C- and 7 KB-vectors."""
    v = 16 // itemsize
    ru = lambda c: -(-c // v) * v
    elems = (ru(K * (KB + v)) + (ru(K * (n | 1)) if ghat_smem else 0)
             + 6 * ru(n) + 13 * ru(m) + 5 * ru(max(q, 1)) + 9 * ru(C)
             + 7 * ru(KB))
    return elems * itemsize


def launch_shape(n, m, q, C, K, itemsize):
    """(KB, W, ghat_smem) of a launch: the bucket, the worlds per CTA (up
    to CTA_THREADS threads at ``world_lanes(KB)`` lanes a world, as many
    as SMEM_LIMIT holds) and whether Ghat sits in shared memory (when one
    world fits with it)."""
    KB = fused_bucket(K)
    most = CTA_THREADS // world_lanes(KB)
    for ghat in (1, 0):
        W = min(most, SMEM_LIMIT // smem_bytes(n, m, q, C, K, KB, itemsize,
                                               ghat))
        if W >= 1:
            return KB, W, ghat
    raise ValueError(
        f"fused IPM needs {smem_bytes(n, m, q, C, K, KB, itemsize, 0)} B of "
        f"shared memory per world (n={n}, m={m}, q={q}, C={C}, K={K}); the "
        f"limit is {SMEM_LIMIT}")


def _loop_cuda(P, Ghat, qinv, p, h, b, mu_v, valid, row_mask, z0, s0, lam0,
               nu0, *, C, fd, rot, max_iter, tol, consts, not_improved_lim,
               stall_rtol):
    start = [z0, s0, lam0, nu0]
    own = z0 is None                  # the kernel takes its own start
    ins = [P, Ghat, qinv, p, h, b, mu_v, valid, row_mask] + (
        [] if own else start)
    ins = [x.contiguous() for x in ins]
    dt, dev = p.dtype, p.device
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"fused IPM kernel takes float32/float64, got {dt}")
    if any(x.dtype != dt or x.device != dev for x in ins):
        raise ValueError("fused IPM operands differ in dtype or device")
    B, n = p.shape
    m, q = h.shape[-1], b.shape[-1]
    K = 2 * C + q if rot else C * (1 + fd) + q
    want = [(B, K, K), (B, K, n), (B, n), (B, n), (B, m), (B, q), (B, C),
            (B, C), (B, m)] + ([] if own else [(B, n), (B, m), (B, m), (B, q)])
    if (m != C * (2 + fd) or (rot and fd != 2)
            or any(tuple(x.shape) != w for x, w in zip(ins, want))):
        raise ValueError(
            "fused IPM operand shapes "
            f"{[tuple(x.shape) for x in ins]} do not fit B={B}, n={n}, "
            f"C={C}, fd={fd}, q={q}, rot={rot} with m = (2 + fd)C rows")
    KB, W, ghat_smem = launch_shape(n, m, q, C, K, p.element_size())
    lib = _lib()
    empty = lambda *shape: torch.empty(shape, dtype=dt, device=dev)
    z, s, lam, nu = empty(B, n), empty(B, m), empty(B, m), empty(B, q)
    mu_c, resid = empty(B), empty(B)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    outs = [z, s, lam, nu, mu_c, resid, iters]
    f64 = dt == torch.float64
    ptrs = [_build.ptr(x) for x in ins]
    if own:                           # null start pointers
        ptrs += [ctypes.c_void_p(None)] * 4
    rc = getattr(lib, "lcp_fused_ipm_" + ("f64" if f64 else "f32"))(
        *ptrs, *[_build.ptr(x) for x in outs], B, n, m, q, C, fd, int(rot),
        int(max_iter), float(tol), float(consts["tiny"]),
        float(consts["reg"]), float(consts["dinv_min"]),
        float(consts["dinv_max"]), int(not_improved_lim), float(stall_rtol),
        ghat_smem, KB, W, _build.stream_ptr(lib, dev))
    _build.check(lib, rc, "fused_ipm")
    bump(LAUNCHES, "fused_ipm" if rot else "fused_ipm_unrot")
    return z, s, lam, nu, mu_c, resid, iters


def _fused(loop, operands, p, h, b, mu_v, valid, row_mask, z0=None, s0=None,
           lam0=None, nu0=None, *, C, fd, max_iter, tol, consts,
           not_improved_lim=0, fric_pair=False, stall_rtol=0.0):
    start = (z0, s0, lam0, nu0)
    if any(x is None for x in start) and any(x is not None for x in start):
        raise ValueError("fused IPM takes all of (z0, s0, lam0, nu0) or "
                         "none of them")
    return loop(*operands, p, h, b, mu_v, valid, row_mask, *start, C=C,
                fd=fd, rot=bool(fric_pair) and fd == 2, max_iter=max_iter,
                tol=tol, consts=consts, not_improved_lim=not_improved_lim,
                stall_rtol=stall_rtol)


def fused_ipm(operands, p, h, b, mu_v, valid, row_mask, z0=None, s0=None,
              lam0=None, nu0=None, **kw):
    """Run the fused IPM loop from (z0, s0, lam0, nu0) or, with none of
    them given, from the solver's own start (``lcp.pdipm._start``: one
    Newton step from the origin at d_inv = 1, shifted into the interior),
    taken inside the loop.  ``operands`` is ``rot_operands(q_diag, G, A,
    C)`` with ``fric_pair`` (and fd = 2), ``unrot_operands(q_diag, G, A,
    C)`` otherwise; the other inputs in the solver's (B, ...) layout.  The
    gamma rows of G must be zero and, with ``fric_pair``, the two friction
    rows per contact exact negatives.  Keywords: C, fd, max_iter (0 returns
    the start), tol, consts, not_improved_lim=0, fric_pair=False,
    stall_rtol=0.0.  Returns (z, s, lam, nu, mu, resid, iters) with iters
    int32.  The CUDA kernel on GPU tensors, the plain version on CPU
    tensors."""
    return _fused(_loop_cuda if p.is_cuda else _loop_ref, operands, p, h, b,
                  mu_v, valid, row_mask, z0, s0, lam0, nu0, **kw)


def fused_ipm_ref(*args, **kw):
    """:func:`fused_ipm` through the plain torch loop on any device."""
    return _fused(_loop_ref, *args, **kw)
