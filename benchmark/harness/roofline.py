"""The least work of the cells' layers, counted from shapes and measured
iteration counts, and the card's peaks.

A frozen, reduced copy of ``lcp_physics_tpu_torch/tools/roofline.py``'s
``counts``: least work only.  A multiply-add is 2 FLOPs; float32 is 4
bytes.  For one world's mixed LCP with n velocities, C contact slots and
the rotated Schur system of K = 2C + q rows (the gamma and u rows
eliminated in closed form):

* the Schur product Ghat Q^-1 Ghat' once a solve, symmetric: K(K+1)n;
* a factor a Newton system, an LU: (2/3)K^3;
* a solve: two triangular substitutions, 2K^2, and the transforms of the
  right-hand side and of z against Ghat, 4Kn;
* a residual pair Ghat z, Ghat' lam: 4Kn;
* the start is one factor and one solve, an iteration one factor, two
  solves (predictor, corrector) and one residual pair.

The implementation's own extra work, such as the Gauss-Jordan inverses of
the blocked factor's panels, is not counted.  Bytes: each input of the
layer read once and each output written once; nothing the layer makes and
uses itself (a Newton system fits no cache at every size, but it need not
leave the chip on the fused path).  A narrowphase pair of circles is 20
FLOPs (difference, distance, normal, depth, the margin test); the
assembly 40 FLOPs a contact slot (three Jacobian rows of two bodies, the
targets) and 10 a body (mass, force, momentum).

Peaks: an H100 SXM at its full 700 W (NVIDIA's data sheet): 67 TFLOP/s
in float32 outside the tensor cores (TF32 is off in the program) and
3.35 TB/s of HBM3.
"""
from __future__ import annotations

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
F32 = 4


def lcp_flops(n, K, iters):
    """FLOPs of one world's solve that took ``iters`` iterations."""
    schur = K * (K + 1) * n
    lu = (2.0 / 3.0) * K ** 3
    solve = 2 * K * K + 4 * K * n
    resid = 4 * K * n
    return schur + (iters + 1) * lu + (2 * iters + 1) * solve + iters * resid


def lcp_bytes(n, m, C):
    """Bytes of one world's solve: Q, p (n each), G (m x n), h and the row
    mask (m each), the cone's mu and valid mask (C each) read; z (n)
    written."""
    return F32 * (2 * n + m * n + 2 * m + 2 * C + n)


def step_flops(N, C, K, iters):
    """FLOPs of one world's step of N circles with C contact slots whose
    LCP took ``iters`` iterations."""
    narrow = 20 * N * (N - 1) // 2
    assembly = 40 * C + 10 * N
    return narrow + assembly + lcp_flops(3 * N, K, iters)


def step_bytes(N):
    """Bytes of one world's step: p and v (3N each) and five per-body
    parameters read, p' and v' written."""
    return F32 * (4 * 3 * N + 5 * N)


def least_seconds(flops, nbytes):
    """The roofline's least time: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
