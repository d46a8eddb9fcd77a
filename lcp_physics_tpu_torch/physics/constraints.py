"""User-facing joint and constraint classes (counterpart of
``lcp_physics_tpu/physics/constraints.py``): ``Joint`` (2 rows),
``FixedJoint`` (3), ``XConstraint``/``YConstraint``/``RotConstraint`` (1
each) and ``TotalConstraint`` (3).

Each class lowers to a static :class:`JointSpec`; the Jacobian rows are
assembled inside the step (``core/jacobians.py``) from the current poses,
so there is no anchor cache to advance (``move`` and ``update_pos`` are
no-ops kept for the reference API).
"""
from __future__ import annotations

import numpy as np
import torch

from lcp_physics_tpu_torch.core.state import JointSpec
from lcp_physics_tpu_torch.physics.utils import rotate


class Constraint:
    """Base: lowers to one JointSpec given the world's body->index map."""

    num_constraints = 0

    def spec(self, index_of) -> JointSpec:
        raise NotImplementedError

    def J(self):
        """Per-body Jacobian blocks ``(J1, J2)`` at the bodies' current
        poses, each (rows, 3) over [omega, vx, vy]; ``J2`` is None for a
        world-anchored constraint.  Slices ``core.jacobians.assemble_Je``,
        so the two cannot drift apart."""
        from lcp_physics_tpu_torch.core.jacobians import assemble_Je
        from lcp_physics_tpu_torch.core.state import make_scene_static

        body2 = getattr(self, "body2", None)
        bodies = [self.body1] + ([body2] if body2 is not None else [])
        index_of = {b: i for i, b in enumerate(bodies)}
        static = make_scene_static([1] * len(bodies),
                                   joints=(self.spec(index_of),), c_max=0)
        p = torch.stack([torch.as_tensor(b.p, dtype=torch.float64)
                         .detach().cpu() for b in bodies])
        Je = assemble_Je(static, p[None])[0]
        return Je[:, 0:3], (Je[:, 3:6] if body2 is not None else None)

    def move(self, dt=None):
        return None

    def update_pos(self, dt=None):
        return None

    def draw(self, screen, pixels_per_meter=1):
        pass


def _to_local(world_pos, p):
    """World anchor -> body-local offset given body pose p = [rot, x, y]."""
    p = np.asarray(torch.as_tensor(p).detach().cpu(), float)
    d = torch.as_tensor(np.asarray(world_pos, float) - p[1:3])
    return tuple(rotate(d, torch.tensor(-p[0], dtype=torch.float64))
                 .numpy().tolist())


def _pose(body):
    return np.asarray(torch.as_tensor(body.p).detach().cpu(), float)


class Joint(Constraint):
    """Pin joint between two bodies, or body1 and the world, at the
    world-frame anchor ``pos``."""

    num_constraints = 2

    def __init__(self, body1, body2, pos):
        self.body1 = body1
        self.body2 = body2
        self.pos = np.asarray(pos, float)
        self.local1 = _to_local(self.pos, body1.p)
        if body2 is not None:
            self.local2 = _to_local(self.pos, body2.p)
            body1.add_no_contact(body2)
        else:
            self.local2 = (0.0, 0.0)

    def spec(self, index_of):
        return JointSpec(
            kind="joint", body1=index_of[self.body1],
            body2=index_of[self.body2] if self.body2 is not None else -1,
            local1=self.local1, local2=self.local2,
            ref=(0.0, float(self.pos[0]), float(self.pos[1])))

    def draw(self, screen, pixels_per_meter=1):
        import pygame

        s = pixels_per_meter
        p = _pose(self.body1)
        anchor = p[1:3] + rotate(torch.tensor(self.local1),
                                 torch.tensor(p[0])).numpy()
        pygame.draw.circle(screen, (0, 255, 0),
                           (int(anchor[0] * s), int(anchor[1] * s)), 2)


class FixedJoint(Constraint):
    """Welds two bodies: pin joint + locked relative rotation (3 rows)."""

    num_constraints = 3

    def __init__(self, body1, body2, pos=None):
        if pos is None:
            pos = _pose(body2)[1:3]
        self.body1 = body1
        self.body2 = body2
        self.pos = np.asarray(pos, float)
        self.local1 = _to_local(self.pos, body1.p)
        self.local2 = _to_local(self.pos, body2.p)
        self.rel_rot = float(_pose(body1)[0]) - float(_pose(body2)[0])
        body1.add_no_contact(body2)

    def spec(self, index_of):
        return JointSpec(
            kind="fixed", body1=index_of[self.body1],
            body2=index_of[self.body2],
            local1=self.local1, local2=self.local2,
            ref=(self.rel_rot, float(self.pos[0]), float(self.pos[1])))


class _SingleAxisConstraint(Constraint):
    num_constraints = 1
    kind = None

    def __init__(self, body1):
        self.body1 = body1
        self.ref = tuple(float(x) for x in _pose(body1))

    def spec(self, index_of):
        # core.jacobians indexes ref[col] in the p layout (rot, x, y)
        return JointSpec(kind=self.kind, body1=index_of[self.body1],
                         ref=self.ref)


class XConstraint(_SingleAxisConstraint):
    """Freezes the body's x coordinate at its construction-time value."""

    kind = "x"


class YConstraint(_SingleAxisConstraint):
    kind = "y"


class RotConstraint(_SingleAxisConstraint):
    kind = "rot"


class TotalConstraint(_SingleAxisConstraint):
    """Freezes all 3 DOF (the reference's way of making static geometry)."""

    num_constraints = 3
    kind = "total"
