"""User-facing body classes (counterpart of
``lcp_physics_tpu/physics/bodies.py``): ``Body``, ``Circle``, ``Hull`` and
``Rect``, with the reference API (``p`` = [rot, x, y], ``v`` = [omega, vx,
vy], ``mass``, ``ang_inertia``, ``restitution``/``eps``, ``fric_coeff``,
``forces``, ``move``, ``set_p``, ``apply_forces``, ``add_force``,
``add_no_contact``, ``draw``, ``_create_M``).

Bodies are host-side scene description and rendering.  A body holds its
pose and velocity as float64 tensors on the CPU until a ``World`` takes
it; the world gathers the fields into its tensors (its dtype, its device)
and writes each step's result back, so ``body.p`` is then a row of the
world's state on the world's device.
"""
from __future__ import annotations

import numpy as np
import torch

from lcp_physics_tpu_torch.physics.utils import (Defaults, get_tensor,
                                                 polygon_centroid,
                                                 polygon_inertia, rotate)


def _pose(pos):
    pos = np.array(pos, float)   # a copy: never the caller's array
    if pos.shape == (2,):
        pos = np.concatenate([[0.0], pos])
    return pos


class Body:
    """Abstract rigid body."""

    kind = "abstract"

    def __init__(self, pos, mass=1.0, restitution=Defaults.RESTITUTION,
                 fric_coeff=Defaults.FRIC_COEFF, eps=None,
                 col=(255, 0, 0), thickness=1):
        self.p = get_tensor(_pose(pos))            # [rot, x, y]
        self.v = get_tensor(np.zeros(3))           # [omega, vx, vy]
        self.mass = float(mass)
        # the reference exposes restitution under both names
        self.restitution = float(restitution if eps is None else eps)
        self.fric_coeff = float(fric_coeff)
        self.forces = []
        self.no_contact = set()
        self.col = col
        self.thickness = thickness
        self.world = None
        self.index = None
        self.ang_inertia = self._compute_ang_inertia()

    def _compute_ang_inertia(self):
        raise NotImplementedError

    def local_vertices(self):
        """Padded local-frame vertex list (list of (2,))."""
        raise NotImplementedError

    @property
    def geom(self):
        """Geometry descriptor (the reference exposes the ODE geom here)."""
        return {"kind": self.kind, "verts": self.local_vertices(),
                "radius": getattr(self, "rad", 0.0)}

    @property
    def eps(self):
        return self.restitution

    @property
    def pos(self):
        return self.p[1:3]

    @property
    def rot(self):
        return self.p[0]

    def set_p(self, new_p):
        self.p = get_tensor(new_p)
        if self.world is not None:
            self.world.invalidate_state()

    def set_v(self, new_v):
        self.v = get_tensor(new_v)
        if self.world is not None:
            self.world.invalidate_state()

    def move(self, dt):
        """Semi-implicit Euler position update (the solver already set v)."""
        self.set_p(self.p + dt * self.v)

    def add_force(self, force):
        self.forces.append(force)
        if self.world is not None:
            self.world.invalidate_scene()

    def apply_forces(self, t):
        """Sum (3,) of the attached external forces at time t."""
        f = torch.zeros(3, dtype=self.p.dtype, device=self.p.device)
        for force in self.forces:
            f = f + torch.as_tensor(force(t), dtype=f.dtype, device=f.device)
        return f

    def add_no_contact(self, other):
        self.no_contact.add(other)
        other.no_contact.add(self)
        if self.world is not None:
            self.world.invalidate_scene()

    def _create_M(self):
        """Per-body 3x3 generalized mass diag([I, m, m])."""
        return torch.diag(torch.tensor(
            [self.ang_inertia, self.mass, self.mass], dtype=self.p.dtype,
            device=self.p.device))

    def draw(self, screen, pixels_per_meter=1):
        raise NotImplementedError


class Circle(Body):
    kind = "circle"

    def __init__(self, pos, rad, mass=1.0, restitution=Defaults.RESTITUTION,
                 fric_coeff=Defaults.FRIC_COEFF, eps=None,
                 col=(255, 0, 0), thickness=1):
        self.rad = float(rad)
        super().__init__(pos, mass=mass, restitution=restitution,
                         fric_coeff=fric_coeff, eps=eps, col=col,
                         thickness=thickness)

    def _compute_ang_inertia(self):
        return 0.5 * self.mass * self.rad ** 2

    def local_vertices(self):
        return [(0.0, 0.0)]

    def draw(self, screen, pixels_per_meter=1):
        import pygame

        s = pixels_per_meter
        rot, x, y = (float(a) for a in self.p)
        c = (int(x * s), int(y * s))
        pygame.draw.circle(screen, self.col, c, int(self.rad * s),
                           self.thickness)
        # orientation tick, like the reference's circle marker
        end = (int(c[0] + self.rad * s * np.cos(rot)),
               int(c[1] + self.rad * s * np.sin(rot)))
        pygame.draw.line(screen, self.col, c, end, 1)


class Hull(Body):
    """Convex polygon body.  Vertices are given relative to ``pos`` (either
    winding); they are re-centred on the centroid like the reference Hull.
    A concave polygon raises ``ValueError``: the narrowphase assumes
    convex hulls."""

    kind = "hull"

    def __init__(self, pos, verts, mass=1.0,
                 restitution=Defaults.RESTITUTION,
                 fric_coeff=Defaults.FRIC_COEFF, eps=None,
                 col=(255, 0, 0), thickness=1):
        verts = np.asarray(verts, float)
        if verts.ndim != 2 or verts.shape[1] != 2 or len(verts) < 3:
            raise ValueError(f"Hull needs (V >= 3, 2) vertices, got shape "
                             f"{verts.shape}")
        # ensure CCW ordering (positive signed area)
        area2 = np.sum(verts[:, 0] * np.roll(verts[:, 1], -1)
                       - np.roll(verts[:, 0], -1) * verts[:, 1])
        if area2 < 0:
            verts = verts[::-1].copy()
        # convex: the cross product of consecutive edges keeps its sign
        e = np.roll(verts, -1, axis=0) - verts
        turns = e[:, 0] * np.roll(e[:, 1], -1) - e[:, 1] * np.roll(e[:, 0], -1)
        scale = max(float(np.abs(turns).max()), 1e-30)
        if np.any(turns < -1e-9 * scale):
            raise ValueError(
                "Hull vertices must describe a convex polygon "
                "(counter-clockwise); got a concave corner")
        centroid = polygon_centroid(torch.as_tensor(verts)).numpy()
        self.verts = verts - centroid
        pos = _pose(pos)
        pos[1:3] = pos[1:3] + centroid
        super().__init__(pos, mass=mass, restitution=restitution,
                         fric_coeff=fric_coeff, eps=eps, col=col,
                         thickness=thickness)

    def _compute_ang_inertia(self):
        return float(polygon_inertia(torch.as_tensor(self.verts), self.mass))

    def local_vertices(self):
        return [tuple(v) for v in self.verts]

    def world_vertices(self):
        return rotate(torch.as_tensor(self.verts, dtype=self.p.dtype,
                                      device=self.p.device),
                      self.p[0]) + self.p[1:3]

    def draw(self, screen, pixels_per_meter=1):
        import pygame

        s = pixels_per_meter
        pts = [(int(float(x) * s), int(float(y) * s))
               for x, y in self.world_vertices().detach().cpu().numpy()]
        pygame.draw.polygon(screen, self.col, pts, self.thickness)


class Rect(Hull):
    """Rectangle of full dimensions ``dims`` = (w, h), axis-aligned at
    rotation 0."""

    def __init__(self, pos, dims, mass=1.0,
                 restitution=Defaults.RESTITUTION,
                 fric_coeff=Defaults.FRIC_COEFF, eps=None,
                 col=(255, 0, 0), thickness=1):
        w, h = float(dims[0]), float(dims[1])
        self.dims = (w, h)
        hw, hh = w / 2.0, h / 2.0
        verts = [(-hw, -hh), (hw, -hh), (hw, hh), (-hw, hh)]
        super().__init__(pos, verts, mass=mass, restitution=restitution,
                         fric_coeff=fric_coeff, eps=eps, col=col,
                         thickness=thickness)

    def _compute_ang_inertia(self):
        w, h = self.dims
        return self.mass * (w ** 2 + h ** 2) / 12.0
