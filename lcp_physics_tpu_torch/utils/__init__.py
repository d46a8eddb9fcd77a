"""Simulation defaults, the static configuration and the 2D math helpers.

Counterpart of ``lcp_physics_tpu/utils/__init__.py``.  The helpers are plain
functions on tensors that broadcast over any leading (batch) dimensions.
The host-side ``Recorder``/``plot`` utilities and the lazy
``Defaults.ENGINE``/``Defaults.CONTACT`` bindings belong to the object layer,
which this package does not carry yet (ROADMAP A7).
"""
from __future__ import annotations

import dataclasses

import torch


class Defaults:
    """Default simulation constants (same values as the JAX package).

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
      (``torch.linalg.lu_factor``), taken only when asked for.
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
    * ``post_stabilization`` and ``penetration_backtrack`` (ROADMAP A6)
      raise until they are ported.
      ``hull_pair_budget`` only acts on hull pairs, which the port's
      narrowphase does not take yet (ROADMAP A5).
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
