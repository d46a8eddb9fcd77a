"""The user-facing World: scene container, stepper and ``run_world`` loop
(counterpart of ``lcp_physics_tpu/physics/world.py``).

``World(bodies, constraints, dt, engine, contact_callback, eps, tol,
fric_dirs, post_stab, strict_no_penetration, ..., dtype, device)`` owns the
mutable host-side scene; every ``step()`` runs the engine's single-world
step (``core.make_step``) on the world's tensors, which live on ``device``
— the card (``"cuda"``) unless the caller names another — in ``dtype``.
The reference's dt-halving on fresh penetration is host control flow
around that step: one host read of the step's diagnostics per try,
counted in ``HOST_READS["world_step"]``.  For batched rollouts use
``world.functional()`` to take (static, params, state) to
``core.make_step_batched`` or ``core.rollout``.
"""
from __future__ import annotations

import time as _time
import warnings

import numpy as np
import torch

from lcp_physics_tpu_torch.core.geometry import aabbs, find_contacts
from lcp_physics_tpu_torch.core.jacobians import assemble_Je
from lcp_physics_tpu_torch.core.state import (SceneParams, WorldState,
                                              make_scene_static)
from lcp_physics_tpu_torch.core.step import (generalized_mass,
                                             motion_margins, total_force)
from lcp_physics_tpu_torch.physics.contacts import (DiffContactHandler,
                                                    OdeContactHandler)
from lcp_physics_tpu_torch.physics.engines import Engine, PdipmEngine
from lcp_physics_tpu_torch.physics.utils import Defaults, SimConfig
from lcp_physics_tpu_torch.utils import bump

HOST_READS = {"world_step": 0}


def _batched(state):
    return WorldState(state.p[None], state.v[None], state.t.reshape(1))


class World:
    def __init__(self, bodies, constraints=(), dt=Defaults.DT, engine=None,
                 contact_callback=None, eps=Defaults.EPSILON,
                 tol=Defaults.TOL, fric_dirs=Defaults.FRIC_DIRS,
                 post_stab=Defaults.POST_STABILIZATION,
                 strict_no_penetration=True, gravity=(0.0, 0.0),
                 c_max=None, max_dt_halvings=None, speculative=True,
                 dtype=torch.float32, device="cuda"):
        self.bodies = list(bodies)
        self.constraints = list(constraints)
        self.dt = float(dt)
        self.dtype = dtype
        self.device = torch.device(device)
        self.engine: Engine = engine if engine is not None else PdipmEngine()
        if contact_callback is None:
            contact_callback = DiffContactHandler()
        elif contact_callback in ("ode", OdeContactHandler):
            contact_callback = OdeContactHandler()
        elif contact_callback is DiffContactHandler:
            contact_callback = DiffContactHandler()
        self.contact_callback = contact_callback
        self.eps = float(eps)
        self.tol = float(tol)
        self.fric_dirs = int(fric_dirs)
        if self.fric_dirs != 2:
            raise ValueError(
                f"fric_dirs={self.fric_dirs}: 2D friction needs exactly 2 "
                "tangent directions (+t, -t)")
        self.post_stab = bool(post_stab)
        self.strict_no_penetration = bool(strict_no_penetration)
        self.max_dt_halvings = int(SimConfig.max_dt_halvings
                                   if max_dt_halvings is None
                                   else max_dt_halvings)
        self.speculative = bool(speculative)
        self.gravity = tuple(float(g) for g in gravity)
        self._c_max = c_max

        for i, b in enumerate(self.bodies):
            b.world = self
            b.index = i
        self._index_of = {b: i for i, b in enumerate(self.bodies)}

        self.t = 0.0
        self._scene_dirty = True
        self._state_dirty = True
        self._static = None
        self._params = None
        self._state = None

        if self.strict_no_penetration:
            pen = float(self.max_penetration())
            if pen > self.tol:
                raise AssertionError(
                    f"Initial penetration {pen:.3g} exceeds tol {self.tol:.3g}"
                    " (strict_no_penetration)")

    # -- scene lowering ---------------------------------------------------
    def invalidate_scene(self):
        self._scene_dirty = True

    def invalidate_state(self):
        self._state_dirty = True

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _build_scene(self):
        bodies = self.bodies
        N = len(bodies)
        counts = [len(b.local_vertices()) for b in bodies]
        V = max(counts)
        verts = np.zeros((N, V, 2))
        radius = np.zeros(N)
        for i, b in enumerate(bodies):
            lv = np.asarray(b.local_vertices(), float)
            verts[i, :len(lv)] = lv
            verts[i, len(lv):] = lv[-1]
            radius[i] = getattr(b, "rad", 0.0)

        no_contact = [(self._index_of[a], self._index_of[c])
                      for a in bodies for c in a.no_contact
                      if c in self._index_of]
        joints = tuple(c.spec(self._index_of) for c in self.constraints)

        # Force table: one (body_index, force_func) slot per attached force;
        # the multipliers become the differentiable force_params tuple.
        force_specs = tuple((i, f.force_func)
                            for i, b in enumerate(bodies) for f in b.forces)
        multipliers = tuple(self._tensor(f.multiplier)
                            for b in bodies for f in b.forces)

        # SceneStatic (and so the engine's step cache key) hashes force_fn
        # by identity: reuse the closure while the force table is
        # unchanged, so an identical scene keeps its step.
        if force_specs:
            force_key = (N, force_specs)
            if getattr(self, "_force_key", None) == force_key:
                force_fn = self._force_fn
            else:
                def force_fn(force_params, state, t):
                    # batched: state.p (B, N, 3), t (B,) -> (B, N, 3)
                    f = torch.zeros_like(state.p)
                    for k, (bi, func) in enumerate(force_specs):
                        f[..., bi, :] += force_params[k] * torch.as_tensor(
                            func(t), dtype=f.dtype, device=f.device)
                    return f
                self._force_key, self._force_fn = force_key, force_fn
        else:
            force_fn = None

        self._static = make_scene_static(
            counts, joints=joints, c_max=self._c_max,
            no_contact=no_contact, force_fn=force_fn)
        self._params = SceneParams(
            mass=self._tensor([b.mass for b in bodies]),
            inertia=self._tensor([b.ang_inertia for b in bodies]),
            restitution=self._tensor([b.restitution for b in bodies]),
            fric_coeff=self._tensor([b.fric_coeff for b in bodies]),
            radius=self._tensor(radius), verts=self._tensor(verts),
            gravity=self._tensor(self.gravity), force_params=multipliers)
        self._scene_dirty = False

    def _build_state(self):
        opts = dict(dtype=self.dtype, device=self.device)
        self._state = WorldState(
            p=torch.stack([torch.as_tensor(b.p, **opts)
                           for b in self.bodies]),
            v=torch.stack([torch.as_tensor(b.v, **opts)
                           for b in self.bodies]),
            t=torch.tensor(self.t, **opts))
        self._state_dirty = False

    @property
    def scene_static(self):
        if self._scene_dirty:
            self._build_scene()
        return self._static

    @property
    def scene_params(self):
        if self._scene_dirty:
            self._build_scene()
        return self._params

    @property
    def world_state(self):
        if self._scene_dirty:
            self._build_scene()
        if self._state_dirty:
            self._build_state()
        return self._state

    def functional(self):
        """(static, params, state) for driving the functional core or the
        batch APIs directly."""
        return self.scene_static, self.scene_params, self.world_state

    # -- stepping ---------------------------------------------------------
    def step(self, fixed_dt=False):
        """Advance by ``self.dt``.

        fixed_dt=False (the reference default): take one solver step of
        size ``dt``; if it CREATES new penetration deeper than ``tol`` (at
        the post-step positions), retry with dt/2, dt/4, ... up to
        ``max_dt_halvings`` times and advance time by the accepted step;
        past the budget, take the shallowest sub-step with a
        ``RuntimeWarning``.  fixed_dt=True: keep sub-stepping until a full
        ``dt`` of simulated time is covered.
        """
        target = self.dt
        advanced = 0.0
        step_fn = self.engine.compiled_step(self)
        cfg = self.engine._config(self)
        tol = self.tol
        while True:
            dt_try = target - advanced
            state = self.world_state
            params = self.scene_params
            if not cfg.strict_no_penetration:
                # no penetration gate: no host read of the diagnostics
                new_state, _ = step_fn(params, state, dt_try)
                best, ok = (0.0, new_state, dt_try), True
            else:
                best = None  # (post_penetration, new_state, dt_used)
                ok = False
                for _ in range(cfg.max_dt_halvings + 1):
                    new_state, diag = step_fn(params, state, dt_try)
                    bump(HOST_READS, "world_step")
                    post, pre = torch.stack(
                        [diag.max_penetration, diag.pre_penetration]
                    ).tolist()
                    if best is None or post < best[0]:
                        best = (post, new_state, dt_try)
                    ok = post <= tol or post - pre <= tol
                    if ok:
                        best = (post, new_state, dt_try)
                        break
                    dt_try = dt_try / 2.0
            if not ok:
                warnings.warn(
                    "strict_no_penetration: dt-halving budget exhausted; "
                    "accepting the smallest-penetration sub-step",
                    RuntimeWarning, stacklevel=2)
            _, new_state, dt_used = best
            self._state = new_state
            self._state_dirty = False
            advanced += dt_used
            self.t += dt_used
            if not fixed_dt or advanced >= target - 1e-12:
                break
        self._scatter_state()
        return self._state

    def _scatter_state(self):
        for i, b in enumerate(self.bodies):
            # direct attribute writes: don't re-mark the state dirty
            b.__dict__["p"] = self._state.p[i]
            b.__dict__["v"] = self._state.v[i]

    # -- reference accessors ----------------------------------------------
    def get_p(self):
        return self.world_state.p.reshape(-1)

    def get_v(self):
        return self.world_state.v.reshape(-1)

    def set_p(self, p):
        p = self._tensor_like(p)
        self._state = WorldState(p=p, v=self.world_state.v,
                                 t=self.world_state.t)
        self._state_dirty = False
        self._scatter_state()

    def set_v(self, v):
        v = self._tensor_like(v)
        self._state = WorldState(p=self.world_state.p, v=v,
                                 t=self.world_state.t)
        self._state_dirty = False
        self._scatter_state()

    def _tensor_like(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device) \
            .reshape(len(self.bodies), 3)

    def apply_forces(self, t):
        """Total generalized force vector (3N,) of the current state."""
        return total_force(self.scene_static, self.scene_params,
                           _batched(self.world_state))[0].reshape(-1)

    def M(self):
        """Generalized mass matrix (3N, 3N), block diag([I, m, m])."""
        return torch.diag(generalized_mass(self.scene_params))

    def Je(self):
        return assemble_Je(self.scene_static, self.world_state.p[None])[0]

    def restitutions(self):
        return self.scene_params.restitution

    def find_collisions(self):
        """Refresh ``self.collisions`` in the reference's format: a list of
        ((normal, p1, p2, penetration), b1_idx, b2_idx).  With
        ``speculative=True`` it lists the contacts the engine sees,
        near-contacts inside the one-step motion margin included."""
        static, params, state = self.functional()
        states = _batched(state)
        margin = (motion_margins(params, states,
                                 states.t.new_full((1,), self.dt),
                                 static.counts_np(), self.tol)
                  if self.speculative else None)
        cts = self.contact_callback.find(
            states.p, params.verts, params.radius, static.counts_np(),
            static.pair_lists(), static.c_max, margin=margin)
        cts = type(cts)(*(x[0] for x in cts))
        collisions = []
        for k in torch.nonzero(cts.valid).flatten().tolist():
            collisions.append(((cts.normal[k], cts.ra[k], cts.rb[k],
                                cts.depth[k]), int(cts.ia[k]),
                               int(cts.ib[k])))
        self.collisions = collisions
        return collisions

    def broadphase_pairs(self):
        """Host-side broadphase: overlapping-AABB body index pairs by the
        native sweep-and-prune (``native.sap_pairs``)."""
        from lcp_physics_tpu_torch import native

        static, params, state = self.functional()
        boxes = aabbs(state.p, params.verts, params.radius,
                      static.counts_np()).detach().cpu().numpy()
        return native.sap_pairs(np.concatenate([boxes[:, 0, :],
                                                boxes[:, 1, :]], axis=-1))

    def max_penetration(self):
        """Deepest penetration (a () tensor) of the current state."""
        static, params, state = self.functional()
        cts = find_contacts(state.p[None], params.verts, params.radius,
                            static.counts_np(), static.pair_lists(),
                            static.c_max)
        d = torch.where(cts.valid[0], cts.depth[0], 0.0)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        return torch.maximum(d.amax(), zero) if d.numel() else zero


def run_world(world, run_time=10.0, print_time=False, screen=None,
              recorder=None, pixels_per_meter=1, background=(0, 0, 0)):
    """Drive ``world`` until ``world.t >= run_time``, optionally rendering
    to a pygame screen and recording frames (reference ``run_world``)."""
    import sys

    wall_start = _time.time()
    while world.t < run_time:
        world.step()
        if screen is not None:
            import pygame

            for event in pygame.event.get():
                if event.type == pygame.QUIT:
                    return
            screen.fill(background)
            for b in world.bodies:
                b.draw(screen, pixels_per_meter)
            for c in world.constraints:
                c.draw(screen, pixels_per_meter)
            pygame.display.flip()
            if recorder is not None:
                recorder.record(world.t)
            # pace to real time like the reference viewer
            ahead = world.t - (_time.time() - wall_start)
            if ahead > 0:
                _time.sleep(min(ahead, world.dt))
        elif recorder is not None:
            recorder.record(world.t)
        if print_time:
            print(f"\rt={world.t:.3f} wall={_time.time() - wall_start:.3f}",
                  end="", file=sys.stderr)
    if print_time:
        print(file=sys.stderr)
