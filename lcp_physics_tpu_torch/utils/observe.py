"""Observability: profiler traces, solver statistics, divergence guards.

Counterpart of ``lcp_physics_tpu/utils/observe.py``:

* :func:`trace` — a ``torch.profiler`` context writing a trace of what
  runs inside it (host and, on a GPU, device activity) into ``logdir``;
* :func:`span` — a named range of the port's own layers (``step``,
  ``solver``, their stages and counted host reads) in the profiler's
  trace, and nothing while no profiler records;
* :func:`solver_stats` — per-world interior-point diagnostics (iterations,
  complementarity, KKT residual) from the blocks the step assembles; run
  it on demand, not in the gradient path;
* :func:`finite_or_raise` / :func:`finite_mask` — NaN and divergence
  guards for rollouts.
"""
from __future__ import annotations

import contextlib
import os

import torch
import torch.autograd.profiler

# What span() returns while no profiler records: one shared null context.
_NULL = contextlib.nullcontext()


def activities():
    """The profiler activities :func:`trace` records: the host, and the
    device when there is a card."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir):
    """Profile everything inside the context; the trace (Chrome trace
    format, one file) is written into ``logdir`` on exit.  Yields the
    ``torch.profiler.profile`` object."""
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def span(name):
    """A ``torch.profiler.record_function(name)`` range while a profiler
    records, else the shared null context (an unguarded
    ``record_function`` costs ~20x the check when nothing records).  The
    ranges land in the profiler's own trace, on the clock of its device
    events.  Names start with their layer: ``step``, ``step.<stage>``,
    ``solver``, ``solver.<stage>``, ``<layer>.read.<key>``."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL


def solver_stats(static, config, params, state, dt=1e-2):
    """One diagnostic interior-point solve on the current configuration of
    a batch of worlds (state (B, N, 3)), returning the full
    ``PdipmSolution`` (per-world iterations, mu, residuals).  Like the JAX
    package's, it passes no ``fric_pair``: the library default, the
    unrotated solver.  Not differentiable, not part of the stepping
    path."""
    from lcp_physics_tpu_torch.core.step import make_assemble
    from lcp_physics_tpu_torch.lcp import lcp_solve_full

    assemble, _ = make_assemble(static, config)
    single = state.p.dim() == 2
    if single:
        state = type(state)(state.p[None], state.v[None],
                            torch.as_tensor(state.t)[None])
    B = state.p.shape[0]
    dt_w = torch.as_tensor(dt, dtype=state.p.dtype,
                           device=state.p.device).expand(B)
    with torch.no_grad():
        blocks, _ = assemble(params, state, dt_w)
        sol = lcp_solve_full(**blocks, max_iter=config.max_iter,
                             tol=config.solver_eps,
                             backend=config.lcp_backend, q_is_diag=True,
                             gamma_rows=static.c_max,
                             refine=config.solver_refine,
                             not_improved_lim=config.solver_stall_lim)
    if single:
        sol = type(sol)(*(x[0] for x in sol))
    return sol


def finite_mask(state):
    """(B,) or scalar bool: world state entirely finite."""
    ok_p = torch.isfinite(state.p).all(-1).all(-1)
    ok_v = torch.isfinite(state.v).all(-1).all(-1)
    return ok_p & ok_v


def finite_or_raise(state, context=""):
    """Host-side assertion that a (possibly batched) state is finite."""
    if not bool(finite_mask(state).all()):
        raise FloatingPointError(
            f"non-finite world state detected {context}")
    return state
