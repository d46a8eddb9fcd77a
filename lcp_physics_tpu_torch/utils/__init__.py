"""Simulation defaults, the static configuration, the 2D math helpers and
the host-side recording utilities.

Counterpart of ``lcp_physics_tpu/utils/__init__.py``.  The helpers are plain
functions on tensors that broadcast over any leading (batch) dimensions;
``Recorder`` and ``plot`` are host-side only and import pygame and
matplotlib when called.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import threading

import numpy as np
import torch

from lcp_physics_tpu_torch.utils.observe import span

_COUNT_LOCK = threading.Lock()
_TALLY = threading.local()


def bump(counts, key, n=1):
    """``counts[key] += n`` under one process-wide lock.  The port's
    launch and host-read counters are bumped from the worker threads of a
    sharded step (``parallel``), where a bare ``+=`` can lose counts.
    Inside :func:`tally` the bump is also logged."""
    with _COUNT_LOCK:
        counts[key] += n
    log = getattr(_TALLY, "log", None)
    if log is not None:
        log.append((counts, key, n))


@contextlib.contextmanager
def tally():
    """Log the bumps this thread makes inside the context, as
    ``(counts, key, n)``, in a list it yields (other threads' bumps are
    not logged)."""
    outer = getattr(_TALLY, "log", None)
    _TALLY.log = log = []
    try:
        yield log
    finally:
        _TALLY.log = outer


def host_read(counts, key, layer, x):
    """One counted host read: ``counts[key]`` bumped, then ``x.tolist()``
    (a bool for a 0-d flag) read back inside the span
    ``<layer>.read.<key>`` (``observe.span``)."""
    bump(counts, key)
    with span(f"{layer}.read.{key}"):
        return x.tolist()


class Indices:
    """Index layout of the per-body generalized coordinate [rot, x, y]."""

    ROT = 0
    X = 1
    Y = 2


class _DefaultsMeta(type):
    # ENGINE/CONTACT resolve lazily: the physics package imports utils, so
    # binding the classes here would be an import cycle.
    @property
    def ENGINE(cls):
        from lcp_physics_tpu_torch.physics.engines import PdipmEngine
        return PdipmEngine

    @property
    def CONTACT(cls):
        from lcp_physics_tpu_torch.physics.contacts import DiffContactHandler
        return DiffContactHandler


class Defaults(metaclass=_DefaultsMeta):
    """Default simulation constants (same values as the JAX package);
    ``Defaults.ENGINE`` is ``PdipmEngine`` and ``Defaults.CONTACT``
    ``DiffContactHandler``.

    There is no default dtype: every constructor of this package takes its
    ``dtype`` and ``device`` explicitly instead of relying on torch's
    float32 default.
    """

    DT = 1.0 / 30.0
    EPSILON = 1e-7
    MAX_ITER = 20
    TOL = 1e-6
    FRIC_DIRS = 2
    FRIC_COEFF = 0.9
    RESTITUTION = 0.5
    POST_STABILIZATION = False


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation configuration.  Same fields, defaults and
    validation as ``lcp_physics_tpu.utils.SimConfig``; see that class for
    what each knob means.

    Where the port differs:

    * ``lcp_backend``: the port dispatches each kernel by the device of its
      tensors (CUDA kernel on a GPU tensor, plain torch on a CPU tensor).
      ``"auto"``, ``"fused"`` and ``"pallas"`` all mean that; ``"xla"``
      is the unfused loop over the row-pivoted library LU
      (``torch.linalg.lu_factor``).  As in the JAX package, a factored
      system past ``ops.linalg.MAX_BLOCKED_N`` rows takes that library LU
      under every backend (``lcp.pdipm.resolve_backend``).
    * ``solver_factor_precision='highest'`` (or ``'float32'``) does what it
      does in the JAX package: at float32 the blocked KKT factor inverts
      its panels with the exact scalar Gauss-Jordan kernel in place of the
      rank-16 blocked one, in the forward and in the backward.  The JAX
      package's other use of it, the matmul precision of the forward
      factor, has no counterpart: every float32 product of the port runs
      in full float32 (TF32 is never enabled), and the factor is stored
      in float32 (no bfloat16 storage).
    * ``solver_bwd_precision`` has no effect, for the same reason: the
      backward's products are full float32 already.
    * ``stop_contact_grad`` stops gradients through the contact geometry
      (normals, offsets, depths), as in the JAX package.
    * ``solver_refine`` > 0 refines every KKT solve, forward and backward,
      as in the JAX package: on systems of 89 to 256 rotated rows the
      factor is the explicit inverse and each solve takes
      ``lcp.pdipm.INV_REFINE + solver_refine`` refinement steps against
      the structured system; elsewhere ``solver_refine`` steps against the
      assembled one.  Like the JAX package's dispatch, it keeps the solve
      out of the fused whole-IPM kernel.
    * ``solver_gondzio`` > 0 adds the Gondzio correctors to the unfused
      loop and, as in the JAX package, keeps the solve out of the fused
      kernels.
    * ``penetration_backtrack`` loops on the host: one host read per try
      (``core.step.HOST_READS["backtrack"]``), as post-stabilization's
      choice between the LCP and its closed form takes one
      (``HOST_READS["post_stab"]``).
    """

    fric_dirs: int = Defaults.FRIC_DIRS
    max_iter: int = Defaults.MAX_ITER
    solver_eps: float = Defaults.EPSILON
    tol: float = Defaults.TOL
    post_stabilization: bool = Defaults.POST_STABILIZATION
    strict_no_penetration: bool = True
    max_dt_halvings: int = 6
    speculative: bool = True
    stop_contact_grad: bool = False
    lcp_backend: str = "auto"
    solver_refine: int = 0
    solver_factor_precision: str | None = None
    solver_bwd_precision: str | None = None
    solver_stall_lim: int = 1
    solver_stall_rtol: float = 0.0
    solver_gondzio: int = 0
    batch_tile: int = 0
    hull_pair_budget: int = 0
    penetration_backtrack: bool = False
    contact_free_fast_path: bool = True

    def __post_init__(self):
        if self.fric_dirs != 2:
            raise ValueError(
                f"fric_dirs={self.fric_dirs}: 2D friction needs exactly 2 "
                "tangent directions (+t, -t); other counts would leave the "
                "cone one-sided (1) or include non-tangent directions (>2)")


def cross_2d(a, b):
    """Scalar 2D cross product a_x b_y - a_y b_x (broadcasts on leading dims)."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def left_orthogonal(v):
    """Rotate v by -90 degrees: (x, y) -> (y, -x)."""
    return torch.stack([v[..., 1], -v[..., 0]], dim=-1)


def perp_2d(v):
    """Rotate v by +90 degrees: (x, y) -> (-y, x).  omega x r = omega * perp(r)."""
    return torch.stack([-v[..., 1], v[..., 0]], dim=-1)


def rotate(vec, theta):
    """Rotate 2-vector(s) by angle(s) theta. vec: (..., 2), theta: (...)."""
    c, s = torch.cos(theta), torch.sin(theta)
    x = c * vec[..., 0] - s * vec[..., 1]
    y = s * vec[..., 0] + c * vec[..., 1]
    return torch.stack([x, y], dim=-1)


def orthogonal_tangents(n, fric_dirs=2):
    """Friction tangent directions (..., 2, 2) for contact normals n (..., 2):
    the pair (+t, -t) with t = perp(n)."""
    if fric_dirs != 2:
        raise ValueError(
            f"2D friction needs exactly 2 tangent directions (+t, -t); "
            f"got fric_dirs={fric_dirs}")
    t = perp_2d(n)
    return torch.stack([t, -t], dim=-2)


def polygon_inertia(verts, mass):
    """Moment of inertia about the centroid of a convex polygon with
    vertices ``verts`` (V, 2) and total ``mass``."""
    v = verts
    v2 = torch.roll(v, -1, dims=0)
    cross = cross_2d(v, v2)
    num = torch.sum(cross * (torch.sum(v * v, dim=-1)
                             + torch.sum(v * v2, dim=-1)
                             + torch.sum(v2 * v2, dim=-1)))
    den = 6.0 * torch.sum(cross)
    return mass * num / den


def polygon_centroid(verts):
    """Centroid (2,) of a convex polygon with vertices ``verts`` (V, 2)."""
    v = verts
    v2 = torch.roll(v, -1, dims=0)
    cross = cross_2d(v, v2)
    area6 = 3.0 * torch.sum(cross)
    cx = torch.sum((v[:, 0] + v2[:, 0]) * cross) / area6
    cy = torch.sum((v[:, 1] + v2[:, 1]) * cross) / area6
    return torch.stack([cx, cy])


def get_tensor(x, dtype=None, device=None):
    """Scalars, lists, arrays or tensors as a tensor.  A tensor keeps its
    dtype and device unless they are given; anything else becomes float64
    on the CPU unless they are given (host-side values of the object
    layer)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype or x.dtype, device=device or x.device)
    return torch.as_tensor(np.asarray(x, dtype=np.float64),
                           dtype=dtype or torch.float64,
                           device=device or "cpu")


def rotation_matrix(theta):
    """2x2 rotation matrices (..., 2, 2) for angles theta (...)."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], dim=-1),
                        torch.stack([s, c], dim=-1)], dim=-2)


def cart_to_polar(v, positive=True):
    """(r, theta) of 2-vectors v (..., 2); theta in [0, 2 pi) when
    ``positive``."""
    r = torch.linalg.vector_norm(v, dim=-1)
    theta = torch.atan2(v[..., 1], v[..., 0])
    if positive:
        theta = torch.where(theta < 0, theta + 2 * math.pi, theta)
    return r, theta


def polar_to_cart(r, theta):
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


class Recorder:
    """Dump rendered frames to disk at a fixed recording dt (host-side)."""

    def __init__(self, dt, screen, path=os.path.join(".", "videos", "frames")):
        self.dt = dt
        self.prev_t = 0.0
        self.frame = 0
        self.screen = screen
        self.path = path
        os.makedirs(path, exist_ok=True)

    def record(self, t):
        if t - self.prev_t >= self.dt:
            import pygame  # lazy: never on the math path

            pygame.image.save(
                self.screen, os.path.join(self.path, f"{self.frame:07d}.bmp"))
            self.frame += 1
            self.prev_t += self.dt


def plot(y_axis, x_axis=None):
    """Quick matplotlib line plot (host-side debugging helper)."""
    import matplotlib.pyplot as plt  # lazy

    y = np.asarray(torch.as_tensor(y_axis).detach().cpu())
    x = (np.arange(len(y)) if x_axis is None
         else np.asarray(torch.as_tensor(x_axis).detach().cpu()))
    plt.plot(x, y)
    plt.show()
