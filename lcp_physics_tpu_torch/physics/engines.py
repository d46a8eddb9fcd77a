"""Dynamics engines (counterpart of ``lcp_physics_tpu/physics/engines.py``):
the abstract ``Engine`` and ``PdipmEngine``, the object facade ``World``
steps through.  The assembly and solve are the functional core's
(``core/step.py::make_step``); the engine keeps the made steps in an LRU
keyed by (SceneStatic, SimConfig), so a world that keeps its scene reuses
its step closure.
"""
from __future__ import annotations

from collections import OrderedDict

from lcp_physics_tpu_torch.core.step import make_assemble, make_step
from lcp_physics_tpu_torch.lcp import lcp_solve
from lcp_physics_tpu_torch.physics.utils import SimConfig


class Engine:
    def solve_dynamics(self, world, dt):
        raise NotImplementedError

    def post_stabilization(self, world):
        raise NotImplementedError


class PdipmEngine(Engine):
    """The batched interior-point LCP engine (the reference's only
    concrete engine)."""

    # A run that keeps changing its scene makes a new step each time: the
    # cache is an LRU of at most CACHE_MAX steps.
    CACHE_MAX = 32

    def __init__(self, max_iter=None, eps=None, stall_lim=None, refine=None,
                 stall_rtol=None):
        self.max_iter = max_iter
        self.eps = eps
        # accuracy-profile overrides (None: the SimConfig defaults)
        self.stall_lim = stall_lim
        self.stall_rtol = stall_rtol
        self.refine = refine
        self._cache = OrderedDict()

    def _config(self, world, post_stab=None):
        return SimConfig(
            fric_dirs=world.fric_dirs,
            max_iter=self.max_iter or SimConfig.max_iter,
            solver_eps=self.eps or world.eps,
            tol=world.tol,
            post_stabilization=(world.post_stab if post_stab is None
                                else post_stab),
            stop_contact_grad=not world.contact_callback.diff,
            strict_no_penetration=world.strict_no_penetration,
            max_dt_halvings=getattr(world, "max_dt_halvings",
                                    SimConfig.max_dt_halvings),
            speculative=getattr(world, "speculative", SimConfig.speculative),
            solver_stall_lim=(SimConfig.solver_stall_lim
                              if self.stall_lim is None else self.stall_lim),
            solver_stall_rtol=(SimConfig.solver_stall_rtol
                               if self.stall_rtol is None
                               else self.stall_rtol),
            solver_refine=(SimConfig.solver_refine
                           if self.refine is None else self.refine),
        )

    def compiled_step(self, world, post_stab=None):
        """The world's single-world step, made once per (SceneStatic,
        SimConfig) value."""
        key = (world.scene_static, self._config(world, post_stab))
        if key not in self._cache:
            self._cache[key] = make_step(world.scene_static,
                                         self._config(world, post_stab))
            while len(self._cache) > self.CACHE_MAX:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(key)
        return self._cache[key]

    def solve_dynamics(self, world, dt):
        """One velocity solve and integration on the world's current
        state; returns (new_state, diagnostics)."""
        step = self.compiled_step(world)
        return step(world.scene_params, world.world_state, dt)

    def post_stabilization(self, world):
        """One position-projection solve on the world's current state (the
        reference's ``engine.post_stabilization(world)``)."""
        static, params, state = world.functional()
        config = self._config(world)
        _, assemble_ps = make_assemble(static, config)
        blocks = assemble_ps(params, state.p[None])
        dp = lcp_solve(**blocks, max_iter=config.max_iter,
                       tol=config.solver_eps, backend=config.lcp_backend,
                       q_is_diag=True)
        world.set_p(state.p + dp.reshape(state.p.shape))
        return world
