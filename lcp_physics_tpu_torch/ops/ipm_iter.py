"""One interior-point iteration in one kernel, for rotated contact systems
past the whole-loop kernel.

Counterpart of ``lcp_physics_tpu/ops/ipm_iter.py``.  For the engine layout
with the friction-pair rotation whose Schur system (K2 = 2C + q rows) is
too large for ``ops.ipm`` and fits the explicit-inverse factor
(88 < K2 <= ``MAX_ITER_K``), ``fused_iter_ipm`` runs the interior-point
loop on the host.  Per iteration: the explicit inverse of the rotated
Schur system from the iterate's scaling (the caller's ``inv_raw``: the
Gauss-Jordan panel kernels and ``torch.matmul``), then ONE launch of
``csrc/ipm_iter.cu`` for everything else — residuals, merit, best-iterate
and stall bookkeeping, the Mehrotra predictor and corrector-delta solves
as matvecs against the inverse, the closed-form u/gamma recoveries, one
z-recovery, the ratio tests, the 0.99 step, the clamp, the pinning of
padded rows and the divergence guard — then one host read of "every world
done".

``iteration`` is one iteration: the CUDA kernel on GPU tensors, the plain
torch transcription ``_iter_ref`` on CPU tensors.  ``fused_iter_ipm_ref``
runs the loop through ``_iter_ref`` on any device.  ``LAUNCHES["ipm_iter"]``
counts kernel launches.  The iterate is packed as X = [z | s | lam | nu]
(B, n + 2m + q); the per-world state (B, 4) holds [best merit, done,
iters, stall count].
"""
from __future__ import annotations

import ctypes
import math

import torch

from lcp_physics_tpu_torch.ops import _build
from lcp_physics_tpu_torch.ops.ipm import SMEM_LIMIT
from lcp_physics_tpu_torch.ops.linalg import MAX_LANE_N, PANEL, _ru
from lcp_physics_tpu_torch.utils import bump, host_read

MAX_ITER_K = 2 * PANEL
LAUNCHES = {"ipm_iter": 0}

_SQ2 = math.sqrt(2.0)


def smem_bytes(n, C, q, itemsize):
    """Shared memory the kernel needs per world: the arrays that
    ``carve`` in csrc/ipm_iter.cu lays out, for m = 4C rows."""
    m, K2 = 4 * C, 2 * C + q
    elems = (n + 2 * m + q) + 6 * n + 11 * m + 3 * max(q, 1) + 7 * C \
        + 6 * K2 + 32
    return elems * itemsize


def fused_iter_supported(C, q, n, itemsize):
    """Whether the rotated system K2 = 2C + q with n unknowns takes the
    fused per-iteration loop: 88 < ru(K2, 8) and K2 <= MAX_ITER_K, the JAX
    package's rule, and the world's vectors fit the kernel's shared memory
    (``smem_bytes``; past it the unfused loop runs, as the JAX package's
    VMEM term sends large n there).  Its other two terms are Mosaic tiling
    policy and are not carried over: a batch that is a multiple of 128
    lanes, and the VMEM budget itself (at K2 = 256 it admits n up to about
    246; shared memory admits n up to about 2,800 at f64).  Within them
    the port takes the kernel exactly where the JAX package does."""
    K2 = 2 * C + q
    return (_ru(K2, 8) > MAX_LANE_N and K2 <= MAX_ITER_K
            and smem_bytes(n, C, q, itemsize) <= SMEM_LIMIT)


def initial_state(B, max_iter, dtype, device):
    """The (B, 4) state before the first iteration: best merit finfo.max/8,
    not done, iters = max_iter, stall count 0."""
    state = torch.zeros((B, 4), dtype=dtype, device=device)
    state[:, 0] = torch.finfo(dtype).max / 8
    state[:, 2] = max_iter
    return state


def _iter_ref(inv, Ghat, qinv, p, h, b, mu_v, valid, row_mask, X, bestX,
              state, it, *, C, consts, tol, not_improved_lim, stall_rtol):
    """Plain torch transcription of one kernel iteration, vectorized over
    the worlds.  A world already done passes X, bestX and its state
    through unchanged."""
    B, n = p.shape
    m, q = h.shape[-1], b.shape[-1]
    mg, K2 = 3 * C, 2 * C + q
    tiny, reg = consts["tiny"], consts["reg"]
    z, s, lam, nu = (X[:, :n], X[:, n:n + m], X[:, n + m:n + 2 * m],
                     X[:, n + 2 * m:])
    rmask = row_mask > 0
    rcount = torch.clamp(row_mask.sum(-1), min=1.0)
    zeros_c = torch.zeros_like(valid)

    def max_step(v, dv):
        neg = (dv < 0) & rmask
        ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0),
                            float("inf"))
        return torch.clamp(ratio.amin(-1), max=1.0)

    # residuals in the original row layout, the products on Ghat
    lam_v = (lam[:, C:2 * C] - lam[:, 2 * C:3 * C]) / _SQ2
    lam_k = torch.cat([lam[:, :C], lam_v, nu], -1)
    rx = (1.0 / qinv) * z + p + torch.einsum("bkn,bk->bn", Ghat, lam_k)
    y0 = torch.einsum("bkn,bn->bk", Ghat, z)
    gf1 = y0[:, C:2 * C] / _SQ2
    gamma = lam[:, mg:]
    bsum = lam[:, C:2 * C] + lam[:, 2 * C:3 * C]
    Flam = torch.cat([zeros_c, -(valid * gamma), -(valid * gamma),
                      -mu_v * lam[:, :C] + valid * bsum], -1)
    rz = torch.cat([y0[:, :C], gf1, -gf1, zeros_c], -1) + Flam + s - h
    ry = y0[:, 2 * C:] - b
    mu_c = torch.where(rmask, s * lam, 0.0).sum(-1) / rcount
    resid = torch.maximum(rx.abs().amax(-1),
                          torch.where(rmask, rz.abs(), 0.0).amax(-1))
    if q:
        resid = torch.maximum(resid, ry.abs().amax(-1))
    merit = mu_c + resid

    # merit, best-iterate and stall bookkeeping
    best_merit, done = state[:, 0], state[:, 1] > 0.5
    iters, stall = state[:, 2], state[:, 3]
    improved = merit < best_merit
    bestX_n = torch.where(improved[:, None], X, bestX)
    sig = (merit < best_merit * (1.0 - stall_rtol) if stall_rtol > 0
           else improved)
    stall = torch.where(sig, 0.0, stall + 1.0)
    if not_improved_lim > 0 and it >= not_improved_lim + 2:
        stalled = stall >= not_improved_lim
    else:
        stalled = torch.zeros_like(done)
    new_done = done | (merit < tol) | stalled
    iters = torch.where(new_done & ~done, float(it), iters)
    best_merit = torch.minimum(merit, best_merit)

    # the rotated Schur system's scalars
    lam_safe = torch.clamp(lam, min=tiny)
    d_inv = torch.clamp(s / lam_safe, consts["dinv_min"], consts["dinv_max"])
    Dginv = 1.0 / (d_inv[:, mg:] + reg)
    cn = valid * mu_v * Dginv
    cf = -valid * Dginv
    a1 = -(d_inv[:, C:2 * C] + reg) + cf
    a2 = -(d_inv[:, 2 * C:3 * C] + reg) + cf
    delta = 0.5 * (a1 - a2)
    g_u = 0.5 * (a1 + a2) + cf
    inv_k = inv[:, :K2, :K2]

    def kkt_parts(r2m, y=None, ry_=None):
        """The rotated reduced solve (trans=0) for the rhs [r1; r2m; ry]
        with y = Ghat (Q^-1 r1), without the z-recovery: (wk, dlam).
        Without y, r1 and ry are zero (the corrector delta)."""
        tg = r2m[:, mg:]
        tD = Dginv * tg
        ru = (r2m[:, C:2 * C] + r2m[:, 2 * C:3 * C]) / _SQ2
        rv = (r2m[:, C:2 * C] - r2m[:, 2 * C:3 * C]) / _SQ2
        if y is None:
            t_c, t_v, t_q = r2m[:, :C], rv, torch.zeros_like(b)
        else:
            t_c, t_v, t_q = (r2m[:, :C] - y[:, :C], rv - y[:, C:2 * C],
                             ry_ - y[:, 2 * C:])
        t_u = ru - _SQ2 * valid * tD
        rhs2 = torch.cat([t_c, t_v - (delta / g_u) * t_u, t_q], -1)
        wk = torch.einsum("bij,bj->bi", inv_k, rhs2)
        w_c, w_v = wk[:, :C], wk[:, C:2 * C]
        w_u = (t_u - _SQ2 * cn * w_c - delta * w_v) / g_u
        wg = -Dginv * (tg - (-mu_v * w_c + _SQ2 * valid * w_u))
        return wk, torch.cat([w_c, (w_u + w_v) / _SQ2, (w_u - w_v) / _SQ2,
                              wg], -1)

    # predictor
    r4 = s * lam
    r1 = -rx
    y = torch.einsum("bkn,bn->bk", Ghat, qinv * r1)
    wk_a, dlam_a = kkt_parts(-rz + r4 / lam_safe, y, -ry)
    ds_a = -r4 / lam_safe - d_inv * dlam_a
    alpha_a = torch.minimum(max_step(s, ds_a), max_step(lam, dlam_a))[:, None]
    mu_aff = torch.where(rmask, (s + alpha_a * ds_a) * (lam + alpha_a
                                                        * dlam_a),
                         0.0).sum(-1) / rcount
    sigma = torch.clamp(mu_aff / torch.clamp(mu_c, min=tiny), 0.0, 1.0) ** 3

    # corrector, as a delta on the predictor (r1 and ry zero)
    r4c = r4 + ds_a * dlam_a - (sigma * mu_c)[:, None]
    wk_d, dlam_d = kkt_parts((r4c - r4) / lam_safe)
    wk = wk_a + wk_d
    dlam = dlam_a + dlam_d
    ds = -r4c / lam_safe - d_inv * dlam
    dz = qinv * (r1 - torch.einsum("bkn,bk->bn", Ghat, wk))
    alpha = 0.99 * torch.minimum(max_step(s, ds), max_step(lam, dlam))[:, None]

    s_n = torch.clamp(s + alpha * ds, min=tiny)
    lam_n = torch.clamp(lam + alpha * dlam, min=tiny)
    X_n = torch.cat([z + alpha * dz, torch.where(rmask, s_n, h),
                     torch.where(rmask, lam_n, tiny),
                     nu + alpha * wk[:, 2 * C:]], -1)
    bad = ~torch.isfinite(X_n).all(-1)          # divergence guard
    halt = new_done | bad
    X_n = torch.where(halt[:, None], X, X_n)
    state_n = torch.stack([best_merit, (halt | done).to(X.dtype), iters,
                           stall], -1)
    keep = done[:, None]
    return (torch.where(keep, X, X_n), torch.where(keep, bestX, bestX_n),
            torch.where(keep, state, state_n))


def _lib():
    lib = _build.load("ipm_iter")
    if not getattr(lib, "_lcp_typed", False):
        P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for ct in ("f32", "f64"):
            f = getattr(lib, f"lcp_ipm_iter_{ct}")
            f.argtypes = [P] * 15 + [I] * 7 + [D] * 5 + [I, D, P]
            f.restype = I
        f = lib.lcp_ipm_iter_smem_bytes
        f.argtypes, f.restype = [I] * 5, ctypes.c_longlong
        f = lib.lcp_ipm_iter_attrs
        f.argtypes, f.restype = [I, ctypes.POINTER(I)], I
        lib._lcp_typed = True
    return lib


def _iter_cuda(inv, Ghat, qinv, p, h, b, mu_v, valid, row_mask, X, bestX,
               state, it, *, C, consts, tol, not_improved_lim, stall_rtol):
    ins = [inv, Ghat, qinv, p, h, b, mu_v, valid, row_mask, X, bestX, state]
    ins = [x.contiguous() for x in ins]
    dt, dev = p.dtype, p.device
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"ipm_iter kernel takes float32/float64, got {dt}")
    if any(x.dtype != dt or x.device != dev for x in ins):
        raise ValueError("ipm_iter operands differ in dtype or device")
    B, n = p.shape
    m, q = h.shape[-1], b.shape[-1]
    K2, Kp = 2 * C + q, inv.shape[-1]
    L = n + 2 * m + q
    want = [(B, Kp, Kp), (B, K2, n), (B, n), (B, n), (B, m), (B, q), (B, C),
            (B, C), (B, m), (B, L), (B, L), (B, 4)]
    if (m != 4 * C or Kp < K2
            or any(tuple(x.shape) != w for x, w in zip(ins, want))):
        raise ValueError(
            "ipm_iter operand shapes "
            f"{[tuple(x.shape) for x in ins]} do not fit B={B}, n={n}, "
            f"C={C}, q={q} with m = 4C rows and an inverse of >= K2 rows")
    lib = _lib()
    f64 = int(dt == torch.float64)
    need = lib.lcp_ipm_iter_smem_bytes(n, m, q, C, f64)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"ipm_iter needs {need} B of shared memory per world (n={n}, "
            f"m={m}, q={q}, C={C}); the limit is {SMEM_LIMIT}")
    outs = [torch.empty_like(ins[9]), torch.empty_like(ins[10]),
            torch.empty_like(ins[11])]
    rc = getattr(lib, "lcp_ipm_iter_" + ("f64" if f64 else "f32"))(
        *[_build.ptr(x) for x in ins + outs], B, n, m, q, C, Kp, int(it),
        float(tol), float(consts["tiny"]), float(consts["reg"]),
        float(consts["dinv_min"]), float(consts["dinv_max"]),
        int(not_improved_lim), float(stall_rtol),
        _build.stream_ptr(lib, dev))
    _build.check(lib, rc, "ipm_iter")
    bump(LAUNCHES, "ipm_iter")
    return tuple(outs)


def iteration(inv, Ghat, qinv, p, h, b, mu_v, valid, row_mask, X, bestX,
              state, it, **kw):
    """One iteration from (X, bestX, state) at iteration index ``it``
    against ``inv`` (B, Kp, Kp), the explicit inverse of the rotated Schur
    system at X's scaling (rows and columns past K2 unused).  Ghat
    (B, K2, n) and qinv (B, n) are ``ops.ipm.rot_operands``' Ghat and
    Q^-1; p, h, b, mu_v, valid, row_mask in the solver's (B, ...) layout.
    Keywords: C, consts, tol, not_improved_lim, stall_rtol.  Returns the
    new (X, bestX, state).  The CUDA kernel on GPU tensors, the plain
    version on CPU tensors."""
    f = _iter_cuda if p.is_cuda else _iter_ref
    return f(inv, Ghat, qinv, p, h, b, mu_v, valid, row_mask, X, bestX,
             state, it, **kw)


def _loop(step, Ghat, qinv, p, h, b, mu_v, valid, row_mask, X0, *, C,
          max_iter, tol, consts, not_improved_lim, inv_raw, stall_rtol=0.0,
          host_reads=None):
    B, n = p.shape
    m = h.shape[-1]
    reads = {"ipm_loop": 0} if host_reads is None else host_reads
    X, bestX = X0, X0
    state = initial_state(B, max_iter, p.dtype, p.device)
    for i in range(max_iter):
        if i and host_read(reads, "ipm_loop", "solver",
                           (state[:, 1] > 0.5).all()):
            break
        s, lam = X[:, n:n + m], X[:, n + m:n + 2 * m]
        d_inv = torch.clamp(s / torch.clamp(lam, min=consts["tiny"]),
                            consts["dinv_min"], consts["dinv_max"])
        X, bestX, state = step(
            inv_raw(d_inv), Ghat, qinv, p, h, b, mu_v, valid, row_mask, X,
            bestX, state, i, C=C, consts=consts, tol=tol,
            not_improved_lim=not_improved_lim, stall_rtol=stall_rtol)
    return X, bestX, state[:, 0], state[:, 2].to(torch.int32)


def fused_iter_ipm(Ghat, qinv, p, h, b, mu_v, valid, row_mask, X0, **kw):
    """Run the per-iteration-fused loop from the packed iterate X0.
    ``kw["inv_raw"](d_inv)`` builds the explicit inverse for the scaling
    d_inv = s / lam (the rotated factor's ``iter_inv_raw``).  Keywords: C,
    max_iter, tol, consts, not_improved_lim, inv_raw, stall_rtol=0.0,
    host_reads (a dict whose "ipm_loop" entry counts the host reads).
    Stops after ``max_iter`` iterations or once every world is done.
    Returns (X, bestX, best_merit, iters); the caller picks the better of X
    and bestX.  Launches the kernel on GPU tensors (or raises), runs the
    plain version on CPU tensors."""
    return _loop(_iter_cuda if p.is_cuda else _iter_ref, Ghat, qinv, p, h,
                 b, mu_v, valid, row_mask, X0, **kw)


def fused_iter_ipm_ref(*args, **kw):
    """:func:`fused_iter_ipm` through the plain iteration on any device."""
    return _loop(_iter_ref, *args, **kw)
