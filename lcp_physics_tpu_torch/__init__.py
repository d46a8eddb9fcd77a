"""lcp_physics_tpu_torch — the PyTorch/CUDA port of ``lcp_physics_tpu``.

The JAX package beside it stays the reference; each module here mirrors the
module of the same path there and is held against it by the tests under
``tests/test_torch_*.py``.  This package imports ``torch`` and never
``jax``.  Its kernels (``ops/``) are hand-written CUDA C++ for Hopper
(``csrc/``), built with ``nvcc`` at first use; on CPU tensors every kernel
wrapper runs its plain torch version instead.

- ``utils``    — ``SimConfig``, ``Defaults``, 2D math helpers and
  ``utils.observe`` (solver statistics, guards, timer, profiler trace).
- ``core``     — state, circle narrowphase, Jacobians, the batched step and
  rollout.
- ``lcp``      — the batched differentiable mixed-LCP/QP solver
  (``lcp_solve``, ``lcp_solve_full``, ``LCPFunction``, ``solve_eq_kkt``).
- ``ops``      — the LU, substitution, Gauss-Jordan and fused-IPM kernels.
- ``parallel`` — world-batch helpers.
"""

__version__ = "0.1.0"

from lcp_physics_tpu_torch import utils, lcp, core, ops, parallel  # noqa: F401
