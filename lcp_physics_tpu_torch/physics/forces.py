"""External forces (counterpart of ``lcp_physics_tpu/physics/forces.py``):
``ExternalForce(force_func, multiplier)`` and the force profiles
``gravity``/``down_force``, ``vert_impulse``, ``hor_impulse`` and
``rot_impulse``, each a generalized 3-vector [torque, fx, fy].

A profile takes the time ``t``: a number, or a tensor of any shape — the
step passes the batch's (B,) times — and returns ``t.shape + (3,)`` in
``t``'s dtype and device (a number gives float64 on the CPU).  The impulse
windows are tensor comparisons, not Python branches.  The ``multiplier``
is the differentiable knob: ``World`` hoists it into the scene parameters.
"""
from __future__ import annotations

import torch


class ExternalForce:
    """A time-dependent force attached to a body: ``multiplier *
    force_func(t)``, ``force_func(t) -> (..., 3)``."""

    def __init__(self, force_func=None, multiplier=100.0):
        self.force_func = force_func if force_func is not None else gravity
        self.multiplier = multiplier

    def __call__(self, t):
        return self.multiplier * self.force_func(t)


def _time(t):
    if isinstance(t, torch.Tensor) and t.is_floating_point():
        return t
    return torch.as_tensor(t, dtype=torch.float64)


def _profile(t, direction):
    t = _time(t)
    d = torch.tensor(direction, dtype=t.dtype, device=t.device)
    return d.expand(t.shape + (3,))


def gravity(t):
    """Unit downward force direction (y grows downward on screen)."""
    return _profile(t, (0.0, 0.0, 1.0))


# The reference exposes both names for the same downward profile.
down_force = gravity


def _window(t, direction, window):
    """``direction`` while t < window, else 0, at t's dtype."""
    t = _time(t)
    return _profile(t, direction) * (t < window).to(t.dtype)[..., None]


def vert_impulse(t, window=0.1):
    """Downward force active only for t < window."""
    return _window(t, (0.0, 0.0, 1.0), window)


def hor_impulse(t, window=0.1):
    """Horizontal (+x) force active only for t < window."""
    return _window(t, (0.0, 1.0, 0.0), window)


def rot_impulse(t, window=0.1):
    """Pure torque active only for t < window."""
    return _window(t, (1.0, 0.0, 0.0), window)
