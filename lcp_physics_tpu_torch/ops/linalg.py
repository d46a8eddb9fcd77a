"""Pivotless LU factorization, substitution and Gauss-Jordan panel inverses
for batches of small and medium systems.

Counterpart of ``lcp_physics_tpu/ops/linalg.py``.  Pivotless elimination
is stable here because the regularized KKT matrices the interior-point
solver produces are quasi-definite.  Two factor layouts, chosen by size
with the JAX package's boundary:

* lane (n <= ``MAX_LANE_N``): the in-place Doolittle LU, a (B, n, n)
  tensor holding the strictly-lower unit-L and the upper U
  (``lu_factor`` / ``lu_solve``, the kernels of ``csrc/lu.cu``);
* blocked (``MAX_LANE_N`` < n <= ``MAX_BLOCKED_N``): the right-looking
  block LU over ``PANEL``-wide panels with full inverses of the diagonal
  panels (:class:`BlockedFactor`).  Its only sequential work is the panel
  inverse (``_gj_inverse``): the rank-16 blocked Gauss-Jordan kernel
  ``gj_inv_blocked`` at float32, under a two-level split of each
  128-panel into two 64-panels, and the scalar Gauss-Jordan kernel
  ``gj_inv`` at float64 or when ``exact`` is asked for (both in
  ``csrc/gj_inv.cu``; the scalar kernel spreads a world over a
  thread-block cluster, ``gj_shape``).  The panel products around them are
  ``torch.matmul`` in the input dtype, as the JAX package leaves them to
  XLA;
* explicit inverse (``MAX_LANE_N`` < n, at most ``INV_MAX_PANELS``
  panels): the whole inverse from the same panel kernels by the 2x2
  block-Schur identity (:class:`InvFactor`), each solve one batched
  matvec — the interior-point solver's factor when it refines its solves.

``plu_factor`` / ``plu_solve`` route by size.  ``xla_factor`` is the
row-pivoted library LU (``torch.linalg.lu_factor``), the JAX package's
``backend='xla'``; the solver takes it when the caller names that
backend or, as the JAX package does, for a system past ``MAX_BLOCKED_N``
rows (``lcp.pdipm.resolve_backend``), and ``plu_solve`` solves with it as
with the others.  Each kernel wrapper dispatches on the device of its
tensors: on a CUDA tensor it launches the hand-written kernel (and raises
if that fails); on a CPU tensor it runs the plain torch version of the
same algorithm (the ``*_ref`` functions).
``LAUNCHES`` counts the kernel launches, trans=1 substitutions apart.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from lcp_physics_tpu_torch.ops import _build
from lcp_physics_tpu_torch.utils import bump

MAX_LANE_N = 88
LANE_BUCKETS = (8, 16, 24, 32, 48, 64, 88)   # csrc/lu.cu's compile-time sizes
LANE_CTA_THREADS = 128
PANEL = 128
MAX_BLOCKED_N = 1536
GJ_BLOCK = 16
GJ_BUCKETS = (32, 64, 96, 128)   # csrc/gj_inv.cu's scalar kernel sizes
GJ_ROWS = 32                     # rows of a panel one CTA of it holds
GJ_THREADS = 256
LAUNCHES = {"lu": 0, "solve": 0, "solve_t": 0, "gj_inv_blocked": 0,
            "gj_inv": 0}

_CT = {torch.float32: "f32", torch.float64: "f64"}


def _ru(x, m):
    return (x + m - 1) // m * m


def _safe_inv(d):
    """1/d with pivots below 1e-20 in magnitude replaced by +-1e-20."""
    tiny = torch.full_like(d, 1e-20)
    safe = torch.where(d.abs() < tiny, torch.where(d < 0, -tiny, tiny), d)
    return 1.0 / safe


class LaneShape(NamedTuple):
    bucket: int           # compile-time size NB >= n
    world_threads: int    # threads one world takes
    worlds_per_cta: int
    cta_threads: int
    smem: int             # static shared bytes a CTA


def lane_shape(n, itemsize, solve=False):
    """The launch of csrc/lu.cu's factor (K1) or substitution (K2,
    ``solve``) for n-row systems: the least bucket of ``LANE_BUCKETS``
    that holds n; up to bucket 32 a world takes the bucket's lanes (8, 16)
    or a warp and a 128-thread CTA holds several worlds; past it the
    factor gives a world a CTA of whole warps, one row a thread, with a
    double-buffered pivot row in shared memory (NB entries and 16 bytes
    for the pivot's reciprocal), and the substitution a warp."""
    NB = next((nb for nb in LANE_BUCKETS if n <= nb), None)
    if NB is None:
        raise ValueError(f"the lane kernels take n <= {MAX_LANE_N}, got {n}")
    if NB <= 32 or solve:
        lanes = NB if NB <= 16 else 32
        return LaneShape(NB, lanes, LANE_CTA_THREADS // lanes,
                         LANE_CTA_THREADS, 0)
    threads = -(-NB // 32) * 32
    return LaneShape(NB, threads, 1, threads, 2 * (NB * itemsize + 16))


class GjShape(NamedTuple):
    bucket: int           # compile-time size PB >= P
    cluster: int          # CTAs a world (a thread-block cluster)
    cta_threads: int
    smem: int             # dynamic shared bytes a CTA


def gj_shape(P, itemsize):
    """The launch of csrc/gj_inv.cu's scalar kernel (K5) for P x P panels:
    the least bucket PB of ``GJ_BUCKETS`` that holds P, a cluster of
    PB / GJ_ROWS CTAs a world, each of 256 threads holding GJ_ROWS rows,
    with in shared memory its finished rows, a copy of another CTA's
    (GJ_ROWS x PB each) and two pivot rows with their reciprocals."""
    PB = next((pb for pb in GJ_BUCKETS if P <= pb), None)
    if PB is None or P < 1:
        raise ValueError(f"the scalar panel kernel takes 1 <= P <= "
                         f"{GJ_BUCKETS[-1]}, got {P}")
    smem = (2 * GJ_ROWS * PB + 2 * PB + 2) * itemsize
    return GjShape(PB, PB // GJ_ROWS, GJ_THREADS, smem)


def blocked_path(n):
    """Whether an n-row system takes the blocked factor (the JAX package's
    ``_ru(n, 8) > MAX_LANE_N`` rule); past ``MAX_BLOCKED_N`` it raises."""
    if n > MAX_BLOCKED_N:
        raise ValueError(
            f"n={n} > MAX_BLOCKED_N={MAX_BLOCKED_N}: pass backend='xla' for "
            "the pivoted library LU")
    return _ru(n, 8) > MAX_LANE_N


# ---------------------------------------------------------------------------
# Plain torch versions of the kernels (CPU tensors, and the comparison path
# on the card).
# ---------------------------------------------------------------------------

def plu_factor_ref(K):
    """Plain torch pivotless LU of K (B, n, n), vectorized over B."""
    A = K.clone()
    n = A.shape[-1]
    for k in range(n):
        dinv = _safe_inv(A[:, k, k])
        A[:, k + 1:, k] *= dinv[:, None]
        A[:, k + 1:, k + 1:] -= A[:, k + 1:, k, None] * A[:, k, None, k + 1:]
    return A


def plu_solve_ref(lu, r, trans=0):
    """Plain torch substitution: K x = r (trans=0) or K^T x = r (trans=1)
    from the factor ``lu`` (B, n, n); r (B, n)."""
    x = r.clone()
    n = x.shape[-1]
    if trans == 0:
        for k in range(n):
            x[:, k] = x[:, k] - (lu[:, k, :k] * x[:, :k]).sum(-1)
        for k in reversed(range(n)):
            x[:, k] = ((x[:, k] - (lu[:, k, k + 1:] * x[:, k + 1:]).sum(-1))
                       * _safe_inv(lu[:, k, k]))
    else:
        for k in range(n):
            x[:, k] = ((x[:, k] - (lu[:, :k, k] * x[:, :k]).sum(-1))
                       * _safe_inv(lu[:, k, k]))
        for k in reversed(range(n)):
            x[:, k] = x[:, k] - (lu[:, k + 1:, k] * x[:, k + 1:]).sum(-1)
    return x


def _gj_steps(A, ks):
    """In-place scalar Gauss-Jordan pivot steps ``ks`` on A (B, P, P): per
    pivot k, row k is scaled by 1/A[k, k], every other entry loses
    A[i, k] * row[j], column k becomes -A[i, k]/A[k, k] and the pivot
    1/A[k, k].  After all P steps A holds K^-1 (the [K | I] augmented
    elimination, stored in place)."""
    for k in ks:
        dinv = _safe_inv(A[:, k, k])[:, None]
        col = A[:, :, k].clone()
        row = A[:, k, :] * dinv
        A -= col[:, :, None] * row[:, None, :]
        A[:, :, k] = -col * dinv
        A[:, k, :] = row
        A[:, k, k] = dinv[:, 0]
    return A


def gj_inv_ref(K):
    """Plain torch scalar Gauss-Jordan inverse of (B, P, P) panels, one
    pivot per step, no pivoting (the algorithm of ``gj_inv``)."""
    return _gj_steps(K.clone(), range(K.shape[-1]))


def gj_inv_blocked_ref(K):
    """Plain torch rank-16 blocked Gauss-Jordan inverse of (B, P, P)
    panels, P % 16 == 0 (the algorithm of ``gj_inv_blocked``).  Per block
    step kb, with pivot block column C = A[:, kb:kb+16] and pivot block
    D = A[kb:kb+16, kb:kb+16]: D^-1 by scalar Gauss-Jordan; R = D^-1
    A[kb:kb+16, :] with its own block column set to exactly D^-1 (Rp); the
    block column becomes -C Rp there, every other column A - C Rp, and the
    pivot rows Rp."""
    b = GJ_BLOCK
    A = K.clone()
    P = A.shape[-1]
    for kb in range(0, P, b):
        blk = slice(kb, kb + b)
        C = A[:, :, blk].clone()
        Dinv = _gj_steps(C[:, blk, :].clone(), range(b))
        Rp = Dinv @ A[:, blk, :]
        Rp[:, :, blk] = Dinv
        upd = C @ Rp
        A -= upd
        A[:, :, blk] = -upd[:, :, blk]
        A[:, blk, :] = Rp
    return A


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def _check_cuda(what, *ts):
    for t in ts:
        if t.dtype not in _CT:
            raise TypeError(f"CUDA {what} takes float32/float64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"CUDA {what} takes contiguous tensors")
        if t.dtype != ts[0].dtype or t.device != ts[0].device:
            raise ValueError(f"CUDA {what} operands differ in dtype or device")


def _lu_lib():
    lib = _build.load("lu")
    if not getattr(lib, "_lcp_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        for ct in ("f32", "f64"):
            f = getattr(lib, f"lcp_lu_factor_{ct}")
            f.argtypes, f.restype = [P, P, I, I, I, I, P], I
            f = getattr(lib, f"lcp_lu_solve_{ct}")
            f.argtypes, f.restype = [P, P, P, I, I, I, I, I, P], I
        lib.lcp_lu_attrs.argtypes = [I, I, I, ctypes.POINTER(I)]
        lib.lcp_lu_attrs.restype = I
        lib._lcp_typed = True
    return lib


def _gj_lib():
    lib = _build.load("gj_inv")
    if not getattr(lib, "_lcp_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.lcp_gj_inv_blocked_f32.argtypes = [P, P, I, I, P]
        lib.lcp_gj_inv_blocked_f32.restype = I
        for ct in ("f32", "f64"):
            f = getattr(lib, f"lcp_gj_inv_{ct}")
            f.argtypes, f.restype = [P, P, I, I, I, I, P], I
        lib.lcp_gj_inv_attrs.argtypes = [I, I, ctypes.POINTER(I)]
        lib.lcp_gj_inv_attrs.restype = I
        lib._lcp_typed = True
    return lib


def lu_factor(K):
    """Pivotless LU of K (B, n, n), n <= MAX_LANE_N: the CUDA kernel on a
    GPU tensor, the plain version on a CPU tensor."""
    B, n = K.shape[0], K.shape[-1]
    if n > MAX_LANE_N:
        raise ValueError(f"lu_factor takes n <= {MAX_LANE_N}, got {n}")
    if not K.is_cuda:
        return plu_factor_ref(K)
    K = K.contiguous()
    _check_cuda("LU", K)
    lib = _lu_lib()
    shape = lane_shape(n, K.element_size())
    lu = torch.empty_like(K)
    rc = getattr(lib, f"lcp_lu_factor_{_CT[K.dtype]}")(
        _build.ptr(K), _build.ptr(lu), B, n, shape.bucket,
        shape.worlds_per_cta, _build.stream_ptr(lib, K.device))
    _build.check(lib, rc, "lu_factor")
    bump(LAUNCHES, "lu")
    return lu


def lu_solve(lu, r, trans=0):
    """K x = r (trans=0) or K^T x = r (trans=1) from :func:`lu_factor`'s
    result: the CUDA kernel on a GPU tensor, the plain version on a CPU
    tensor."""
    B, n = r.shape
    if not r.is_cuda:
        return plu_solve_ref(lu, r, trans)
    r = r.contiguous()
    _check_cuda("LU", lu, r)
    lib = _lu_lib()
    shape = lane_shape(n, r.element_size(), solve=True)
    x = torch.empty_like(r)
    rc = getattr(lib, f"lcp_lu_solve_{_CT[r.dtype]}")(
        _build.ptr(lu), _build.ptr(r), _build.ptr(x), B, n, int(trans),
        shape.bucket, shape.worlds_per_cta, _build.stream_ptr(lib, r.device))
    _build.check(lib, rc, "lu_solve")
    bump(LAUNCHES, "solve_t" if trans else "solve")
    return x


def _check_panels(K, what, block=1):
    B, P = K.shape[0], K.shape[-1]
    if K.dim() != 3 or K.shape[1] != P or P > PANEL or P % block:
        raise ValueError(f"{what} takes (B, P, P) panels with P <= {PANEL}"
                         f" and P % {block} == 0, got {tuple(K.shape)}")
    return B, P


def gj_inv_blocked(K):
    """Rank-16 blocked Gauss-Jordan inverse of float32 (B, P, P) panels:
    the CUDA kernel on a GPU tensor, the plain version on a CPU tensor."""
    B, P = _check_panels(K, "gj_inv_blocked", GJ_BLOCK)
    if not K.is_cuda:
        return gj_inv_blocked_ref(K)
    if K.dtype != torch.float32:
        raise TypeError(f"gj_inv_blocked takes float32, got {K.dtype}")
    K = K.contiguous()
    lib = _gj_lib()
    out = torch.empty_like(K)
    rc = lib.lcp_gj_inv_blocked_f32(_build.ptr(K), _build.ptr(out), B, P,
                                    _build.stream_ptr(lib, K.device))
    _build.check(lib, rc, "gj_inv_blocked")
    bump(LAUNCHES, "gj_inv_blocked")
    return out


def gj_inv(K):
    """Scalar Gauss-Jordan inverse of (B, P, P) panels, float32 or float64:
    the CUDA kernel (a cluster of CTAs a world, ``gj_shape``) on a GPU
    tensor, the plain version on a CPU tensor."""
    B, P = _check_panels(K, "gj_inv")
    if not K.is_cuda:
        return gj_inv_ref(K)
    K = K.contiguous()
    _check_cuda("gj_inv", K)
    lib = _gj_lib()
    shape = gj_shape(P, K.element_size())
    out = torch.empty_like(K)
    rc = getattr(lib, f"lcp_gj_inv_{_CT[K.dtype]}")(
        _build.ptr(K), _build.ptr(out), B, P, shape.bucket, shape.cluster,
        _build.stream_ptr(lib, K.device))
    _build.check(lib, rc, "gj_inv")
    bump(LAUNCHES, "gj_inv")
    return out


# ---------------------------------------------------------------------------
# The blocked factor (plain torch around the panel kernels).
# ---------------------------------------------------------------------------

class BlockedFactor(NamedTuple):
    """Block LU K = Lhat Uhat over PANEL-wide panels: ``blocks[t][s]`` the
    (B, P, P) off-diagonal blocks (Lhat below, Uhat above the diagonal;
    Uhat has identity diagonal blocks), ``binv`` (B, T, P, P) the inverses
    of Lhat's diagonal blocks, ``n`` the unpadded size."""

    blocks: tuple
    binv: torch.Tensor
    n: int


def _gj_inverse(K, exact=False):
    """Inverse of (B, P, P) diagonal panels (quasi-definite: every leading
    principal block is nonsingular).  float32 and not ``exact``: the
    blocked kernel, a 128-panel split in two 64-panels by the block
    inverse identity; otherwise the scalar kernel."""
    P = K.shape[-1]
    if not exact and K.dtype == torch.float32 and P % GJ_BLOCK == 0:
        if P >= 128 and (P // 2) % GJ_BLOCK == 0:
            H = P // 2
            return _block_inverse(K[:, :H, :H], K[:, :H, H:], K[:, H:, :H],
                                  K[:, H:, H:], _gj_inverse)
        return gj_inv_blocked(K.contiguous())
    return gj_inv(K.contiguous())


def _block_inverse(A_, B_, C_, D_, inverse):
    """[[A, B], [C, D]]^-1 by the 2x2 block-Schur identity

        [[A^-1 + X S^-1 Y, -X S^-1], [-S^-1 Y, S^-1]],
        X = A^-1 B,  Y = C A^-1,  S = D - C X,

    with ``inverse`` for the two diagonal inverses and ``torch.matmul``
    for the block products."""
    Ainv = inverse(A_)
    X = Ainv @ B_
    Y = C_ @ Ainv
    Sinv = inverse(D_ - C_ @ X)
    M21 = -(Sinv @ Y)
    M12 = -(X @ Sinv)
    M11 = Ainv - X @ M21
    return torch.cat([torch.cat([M11, M12], -1),
                      torch.cat([M21, Sinv], -1)], -2)


def _panel_grid(K, what):
    """K (B, n, n), n past the lane path, padded to T PANEL-wide panels
    (identity on the padded diagonal) as the T x T grid of its
    (B, PANEL, PANEL) blocks."""
    B, n = K.shape[0], K.shape[-1]
    if not blocked_path(n):
        raise ValueError(f"{what} takes n > {MAX_LANE_N}, got {n}")
    T = _ru(n, PANEL) // PANEL
    Kp = K
    if T * PANEL > n:
        Kp = K.new_zeros((B, T * PANEL, T * PANEL))
        Kp[:, :n, :n] = K
        Kp.diagonal(dim1=1, dim2=2)[:, n:] = 1.0
    return [[Kp[:, t * PANEL:(t + 1) * PANEL, s * PANEL:(s + 1) * PANEL]
             for s in range(T)] for t in range(T)]


def plu_factor_blocks(K, exact=False):
    """Blocked factorization of K (B, n, n), n past the lane path: K padded
    to a multiple of PANEL (identity on the padded diagonal), then the
    right-looking block LU.  Returns a :class:`BlockedFactor`."""
    n = K.shape[-1]
    blk = _panel_grid(K, "plu_factor_blocks")
    T = len(blk)
    binvs = []
    for t in range(T):
        binv_t = _gj_inverse(blk[t][t], exact)
        binvs.append(binv_t)
        for s in range(t + 1, T):          # Uhat row: binv_t @ K[t, s]
            blk[t][s] = binv_t @ blk[t][s]
        for i in range(t + 1, T):          # trailing update
            for s in range(t + 1, T):
                blk[i][s] = blk[i][s] - blk[i][t] @ blk[t][s]
    return BlockedFactor(tuple(tuple(row) for row in blk),
                         torch.stack(binvs, dim=1), n)


def _blocked_solve(fac, r, trans=0):
    """Block substitution on a :class:`BlockedFactor`: one batched matvec
    with each diagonal-panel inverse, unit-upper back substitution."""
    blocks, binv, n = fac
    T = len(blocks)
    B = r.shape[0]
    rp = r.new_zeros((B, T * PANEL))
    rp[:, :n] = r
    part = lambda t: rp[:, t * PANEL:(t + 1) * PANEL]
    mv = lambda M, v: torch.einsum("bij,bj->bi", M, v)
    mtv = lambda M, v: torch.einsum("bij,bi->bj", M, v)
    xs = [None] * T
    if trans == 0:
        ys = []
        for t in range(T):                 # Lhat y = r
            acc = part(t)
            for s in range(t):
                acc = acc - mv(blocks[t][s], ys[s])
            ys.append(mv(binv[:, t], acc))
        for t in reversed(range(T)):       # Uhat x = y
            acc = ys[t]
            for s in range(t + 1, T):
                acc = acc - mv(blocks[t][s], xs[s])
            xs[t] = acc
    else:
        zs = []
        for t in range(T):                 # Uhat^T z = r
            acc = part(t)
            for s in range(t):
                acc = acc - mtv(blocks[s][t], zs[s])
            zs.append(acc)
        for t in reversed(range(T)):       # Lhat^T x = z
            acc = zs[t]
            for s in range(t + 1, T):
                acc = acc - mtv(blocks[s][t], xs[s])
            xs[t] = mtv(binv[:, t], acc)
    return torch.cat(xs, dim=-1)[:, :n]


# ---------------------------------------------------------------------------
# The explicit-inverse factor (systems of at most INV_MAX_PANELS panels).
# ---------------------------------------------------------------------------

INV_MAX_PANELS = 2


def inv_supported(n):
    """Whether an n-row system fits the explicit-inverse factor."""
    return _ru(n, PANEL) // PANEL <= INV_MAX_PANELS


class InvFactor(NamedTuple):
    """The explicit inverse (B, T*PANEL, T*PANEL) of K padded to whole
    panels (identity on the padding), ``n`` the unpadded size."""

    inv: torch.Tensor
    n: int


def inv_factor_blocks(K, exact=False):
    """Explicit inverse of K (B, n, n), n past the lane path and at most
    INV_MAX_PANELS panels, padded as :func:`plu_factor_blocks` pads it:
    for T = 1 the panel inverse, for T = 2 :func:`_block_inverse` over the
    2x2 panel grid, every panel inverse by ``_gj_inverse``.  Returns an
    :class:`InvFactor`, which :func:`plu_solve` solves with one batched
    matvec."""
    n = K.shape[-1]
    if not inv_supported(n):
        raise ValueError(f"inv_factor_blocks takes at most {INV_MAX_PANELS}"
                         f" panels, got n={n}")
    blk = _panel_grid(K, "inv_factor_blocks")
    if len(blk) == 1:
        return InvFactor(_gj_inverse(blk[0][0], exact), n)
    (A_, B_), (C_, D_) = blk
    return InvFactor(_block_inverse(A_, B_, C_, D_,
                                    lambda P: _gj_inverse(P, exact)), n)


def _inv_solve(fac, r, trans=0):
    """x = K^-1 r (trans=0) or K^-T r (trans=1): one batched matvec with
    the stored inverse."""
    inv, n = fac
    rp = r.new_zeros((r.shape[0], inv.shape[-1]))
    rp[:, :n] = r
    eq = "bij,bj->bi" if trans == 0 else "bij,bi->bj"
    return torch.einsum(eq, inv, rp)[:, :n]


class PivotedLU(NamedTuple):
    """Row-pivoted LU of K (B, n, n) from ``torch.linalg.lu_factor``."""

    lu: torch.Tensor
    pivots: torch.Tensor


def xla_factor(K):
    """Row-pivoted LU of K (B, n, n) by the library (``torch.linalg.
    lu_factor``): the JAX package's ``backend='xla'``, which is XLA's LU
    and not a TPU kernel.  Taken when the caller names that backend, and
    past ``MAX_BLOCKED_N`` rows (``lcp.pdipm.resolve_backend``)."""
    return PivotedLU(*torch.linalg.lu_factor(K))


def plu_factor(K, exact=False):
    """Pivotless LU of K (B, n, n): the lane factor (a (B, n, n) tensor)
    for n <= MAX_LANE_N, the blocked factor (:class:`BlockedFactor`) up to
    MAX_BLOCKED_N.  ``exact`` sends the blocked factor's float32 panel
    inverses to the scalar kernel."""
    n = K.shape[-1]
    if K.dim() != 3 or K.shape[-2] != n:
        raise ValueError(f"plu_factor needs (B, n, n) matrices, got {K.shape}")
    if blocked_path(n):
        return plu_factor_blocks(K, exact)
    return lu_factor(K)


def plu_solve(fac, r, trans=0):
    """Solve K x = r (trans=0) or K^T x = r (trans=1) from
    :func:`plu_factor`'s, :func:`plu_factor_blocks`',
    :func:`inv_factor_blocks`' or :func:`xla_factor`'s result; r (B, n)."""
    if trans not in (0, 1):
        raise ValueError(f"trans must be 0 or 1, got {trans}")
    B, n = r.shape
    if isinstance(fac, PivotedLU):
        return torch.linalg.lu_solve(fac.lu, fac.pivots, r[..., None],
                                     adjoint=bool(trans))[..., 0]
    if isinstance(fac, (BlockedFactor, InvFactor)):
        Bf = (fac.binv if isinstance(fac, BlockedFactor) else fac.inv).shape[0]
        if fac.n != n or Bf != B:
            raise ValueError(f"{type(fac).__name__} (B={Bf}, n={fac.n}) does "
                             f"not match rhs {(B, n)}")
        if isinstance(fac, InvFactor):
            return _inv_solve(fac, r, trans)
        return _blocked_solve(fac, r, trans)
    if fac.shape != (B, n, n):
        raise ValueError(f"factor {tuple(fac.shape)} does not match rhs "
                         f"{(B, n)}")
    return lu_solve(fac, r, trans)
