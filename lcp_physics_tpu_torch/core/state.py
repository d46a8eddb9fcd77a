"""World state, scene parameters and the static scene description.

Counterpart of ``lcp_physics_tpu/core/state.py``.  ``WorldState`` and
``SceneParams`` are dataclasses of tensors; a leading batch axis on the
state (``p`` (B, N, 3)) makes it a batch of worlds.  ``SceneStatic`` and
``JointSpec`` are the same host-side description as in the JAX package.

``params_from_numpy`` / ``state_from_numpy`` carry a scene from the JAX
package into this one: they read any object with the JAX dataclasses'
fields whose leaves convert with ``numpy.asarray``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from lcp_physics_tpu_torch.core.geometry import split_pairs_by_kind
from lcp_physics_tpu_torch.utils import polygon_inertia


@dataclasses.dataclass
class WorldState:
    """p (N, 3) = [rot, x, y] per body; v (N, 3) = [omega, vx, vy]; t sim
    time.  With a leading batch axis: p, v (B, N, 3) and t (B,)."""

    p: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor


@dataclasses.dataclass
class SceneParams:
    """Per-body scene parameters: (N,) each, verts (N, V, 2), gravity (2,);
    a leading batch axis gives per-world parameters."""

    mass: torch.Tensor
    inertia: torch.Tensor
    restitution: torch.Tensor
    fric_coeff: torch.Tensor
    radius: torch.Tensor
    verts: torch.Tensor
    gravity: torch.Tensor
    force_params: Any = ()


@dataclasses.dataclass(frozen=True)
class JointSpec:
    """Static description of one constraint; see the JAX package's
    ``JointSpec`` for the meaning of each field."""

    kind: str
    body1: int
    body2: int = -1
    local1: Tuple[float, float] = (0.0, 0.0)
    local2: Tuple[float, float] = (0.0, 0.0)
    ref: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    @property
    def rows(self) -> int:
        return {"joint": 2, "fixed": 3, "x": 1, "y": 1, "rot": 1,
                "total": 3}[self.kind]


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Host-side scene structure: vertex counts, joints, contact capacity,
    the collidable-pair table and an optional force hook.

    ``force_fn(force_params, state, t)`` receives the batched state and
    returns (B, N, 3) generalized forces added to gravity."""

    counts: tuple
    joints: Tuple[JointSpec, ...]
    c_max: int
    allowed: tuple
    force_fn: Optional[Callable] = None

    @property
    def n_bodies(self) -> int:
        return len(self.counts)

    @property
    def n_eq(self) -> int:
        return sum(j.rows for j in self.joints)

    def counts_np(self):
        return np.asarray(self.counts, np.int32)

    def allowed_np(self):
        return np.asarray(self.allowed, bool)

    def pair_lists(self):
        return split_pairs_by_kind(self.counts_np(), self.allowed_np())

    @functools.cached_property
    def on_device(self) -> dict:
        """Tensors made from this scene once and kept, keyed by their use,
        device and dtype (``core.jacobians``'s joint tables).  Held on the
        instance: the dataclass hashes its N x N ``allowed``, too dear a
        key for a lookup every step.  Not a field, so equality, hashing
        and ``dataclasses.replace`` ignore it."""
        return {}


def make_scene_static(counts, joints=(), c_max=None, no_contact=(),
                      force_fn=None, exclude_jointed=True):
    """Build a :class:`SceneStatic` (same rules as the JAX package)."""
    counts = tuple(int(c) for c in counts)
    N = len(counts)
    allowed = np.ones((N, N), bool)
    np.fill_diagonal(allowed, False)
    for i, j in no_contact:
        allowed[i, j] = allowed[j, i] = False
    joints = tuple(joints)
    if exclude_jointed:
        for js in joints:
            if js.body2 >= 0:
                allowed[js.body1, js.body2] = False
                allowed[js.body2, js.body1] = False
    if c_max is None:
        n_pairs = int(allowed[np.triu_indices(N, 1)].sum())
        c_max = min(2 * n_pairs, max(4 * N, 8))
    return SceneStatic(
        counts=counts,
        joints=joints,
        c_max=int(c_max),
        allowed=tuple(tuple(bool(x) for x in row) for row in allowed),
        force_fn=force_fn,
    )


def default_params(static: SceneStatic, verts, radius, *, dtype, device,
                   mass=1.0, restitution=0.5, fric_coeff=0.9,
                   gravity=(0.0, 10.0), inertia=None, force_params=()):
    """Per-body parameter tensors (same defaults as the JAX package)."""
    N = static.n_bodies
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    mass = as_t(mass).expand(N).clone()
    restitution = as_t(restitution).expand(N).clone()
    fric_coeff = as_t(fric_coeff).expand(N).clone()
    radius = as_t(radius)
    verts = as_t(verts)
    if inertia is None:
        inertias = []
        for k in range(N):
            c = static.counts[k]
            if c == 1:
                inertias.append(0.5 * mass[k] * radius[k] ** 2)
            else:
                inertias.append(polygon_inertia(verts[k, :c], mass[k]))
        inertia = torch.stack(inertias)
    else:
        inertia = as_t(inertia).expand(N).clone()
    return SceneParams(mass=mass, inertia=inertia, restitution=restitution,
                       fric_coeff=fric_coeff, radius=radius, verts=verts,
                       gravity=as_t(gravity), force_params=force_params)


_PARAM_FIELDS = ("mass", "inertia", "restitution", "fric_coeff", "radius",
                 "verts", "gravity")


def params_from_numpy(params, *, dtype, device) -> SceneParams:
    """The JAX package's ``SceneParams`` (leaves convertible with
    ``numpy.asarray``) as this package's.  ``force_params`` is passed
    through unchanged."""
    conv = {f: torch.tensor(np.asarray(getattr(params, f)), dtype=dtype,
                            device=device) for f in _PARAM_FIELDS}
    return SceneParams(**conv, force_params=params.force_params)


def state_from_numpy(state, *, dtype, device) -> WorldState:
    """The JAX package's ``WorldState`` as this package's."""
    conv = lambda x: torch.tensor(np.asarray(x), dtype=dtype, device=device)
    return WorldState(p=conv(state.p), v=conv(state.v), t=conv(state.t))
