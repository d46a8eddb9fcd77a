"""lcp_physics_tpu_torch — the PyTorch/CUDA port of ``lcp_physics_tpu``.

The JAX package beside it stays the reference; each module here mirrors the
module of the same path there and is held against it by the tests under
``tests/test_torch_*.py``.  This package imports ``torch`` and never
``jax``.  Its kernels (``ops/``) are hand-written CUDA C++ for Hopper
(``csrc/``), built with ``nvcc`` at first use; on CPU tensors every kernel
wrapper runs its plain torch version instead.

- ``utils``    — ``SimConfig``, ``Defaults``, 2D math helpers and
  ``utils.observe`` (solver statistics, guards, timer, profiler trace).
- ``core``     — state, the circle and hull narrowphase, Jacobians, the
  batched and single-world steps (post-stabilization, the penetration
  backtrack) and rollout.
- ``physics``  — the object layer: ``World``, ``run_world``, bodies,
  constraints, forces, contact handlers and ``PdipmEngine``.
- ``lcp``      — the batched differentiable mixed-LCP/QP solver
  (``lcp_solve``, ``lcp_solve_full``, ``LCPFunction``, ``solve_eq_kkt``).
- ``ops``      — the LU, substitution, Gauss-Jordan and fused-IPM kernels.
- ``parallel`` — the batched step, and worlds sharded over a mesh of
  devices (``make_mesh``, ``make_sharded_step``, ``batched_rollout``).
- ``entry``    — the driver entry analogs (``entry``,
  ``dryrun_multichip``).
- ``native``   — the host-side sweep-and-prune broadphase (C++).
- ``demos``    — hello_world, chain, inference, billiards and
  sharded_inference.
"""

__version__ = "0.1.0"

from lcp_physics_tpu_torch import (utils, lcp, core, ops, parallel,  # noqa: F401
                                   physics)
