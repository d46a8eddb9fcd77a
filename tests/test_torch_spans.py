"""The port's spans (``utils.observe.span``) under a CPU-only profiler:
which spans the batched step and the solver open, how they nest, that
``solver.iter`` counts the unfused loop's iterations, that tracing
changes no output, and that with no profiler a span is the shared null
context."""
import numpy as np
import pytest
import torch

from test_torch_pdipm import one_torch_thread  # noqa: F401

from lcp_physics_tpu_torch.core import (WorldState, default_params,
                                        make_scene_static)
from lcp_physics_tpu_torch.core import step as step_mod
from lcp_physics_tpu_torch.lcp import lcp_solve, pdipm
from lcp_physics_tpu_torch.parallel import make_batched_step
from lcp_physics_tpu_torch.tools.bench import lcp_problem
from lcp_physics_tpu_torch.utils import SimConfig, observe

F64 = dict(dtype=torch.float64, device="cpu")
LAYERS = ("step", "solver")
SIDE, C_MAX = 4, 32
CONFIG = SimConfig(max_iter=12, solver_eps=1e-9)


def grid(B, spacing, v_std, seed=5):
    """B worlds of a 4 x 4 grid of radius-1 circles, jittered by 0.01 and
    given velocities normal(0, v_std), each world its own draw.  c_max 32:
    the rotated system has K2 = 64 rows, past the fused kernel's 48, so a
    contact step runs the unfused loop.  Returns (step, params, states)."""
    N = SIDE * SIDE
    rng = np.random.default_rng(seed)
    static = make_scene_static([1] * N, c_max=C_MAX)
    params = default_params(static, verts=np.zeros((N, 1, 2)),
                            radius=np.ones(N), restitution=0.4, **F64)
    gx, gy = np.meshgrid(np.arange(SIDE), np.arange(SIDE))
    pos = np.stack([gx.ravel(), gy.ravel()], -1) * spacing
    pos = pos + rng.uniform(-0.01, 0.01, (B, N, 2))
    p = np.concatenate([np.zeros((B, N, 1)), pos], -1)
    v = rng.normal(0.0, v_std, (B, N, 3))
    states = WorldState(torch.tensor(p, **F64), torch.tensor(v, **F64),
                        torch.zeros(B, **F64))
    return make_batched_step(static, CONFIG), params, states


def traced(fn):
    """(fn(), [(name, start, end)] of the port's spans, by start)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.name.split(".")[0] in LAYERS), key=lambda s: s[1])
    return out, spans


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def named(spans, name):
    return [s for s in spans if s[0] == name]


def test_contact_step_nests_step_solver_and_iterations():
    step, params, states = grid(3, 2.01, 0.5)
    reads = pdipm.HOST_READS["ipm_loop"]
    starts = dict(pdipm.STARTS)
    _, spans = traced(lambda: step(params, states, 0.01))
    loop_reads = pdipm.HOST_READS["ipm_loop"] - reads
    (outer,) = named(spans, "step")
    (solver,) = named(spans, "solver")
    iters = named(spans, "solver.iter")
    assert inside(solver, outer)
    assert iters and all(inside(s, solver) for s in iters)
    assert len(iters) in (loop_reads, loop_reads + 1) and loop_reads > 2
    assert len(named(spans, "solver.read.ipm_loop")) == loop_reads
    assert not named(spans, "solver.fused")
    assert len(named(spans, "solver.start")) == 1
    assert pdipm.STARTS == dict(starts, host=starts["host"] + 1)
    for stage in ("step.narrowphase", "step.assemble", "step.integrate",
                  "step.penetration", "step.read.contact_gate",
                  "step.read.penetration_gate"):
        assert named(spans, stage), stage
    assert all(inside(s, outer) for s in spans if s[0].startswith("step"))


def test_lcp_solve_of_eight_circles_opens_the_fused_span():
    args, kw, _ = lcp_problem(8, torch.float64, "cpu")
    p = args[1].clone().requires_grad_(True)
    args[1] = p
    starts = dict(pdipm.STARTS)
    _, spans = traced(lambda: lcp_solve(*args, **kw).sum().backward())
    (solver,) = named(spans, "solver")
    (fused,) = named(spans, "solver.fused")
    (bwd,) = named(spans, "solver.bwd")
    assert inside(fused, solver) and bwd[1] >= solver[2]
    # the fused kernel takes the start itself: no host start
    assert not named(spans, "solver.start")
    assert pdipm.STARTS == dict(starts, kernel=starts["kernel"] + 1)
    assert p.grad is not None
    assert not named(spans, "solver.iter")
    assert not named(spans, "step")


def test_contact_free_step_opens_no_solver_span():
    step, params, states = grid(3, 2.6, 0.0)
    reads = dict(step_mod.HOST_READS)
    _, spans = traced(lambda: step(params, states, 0.01))
    names = {s[0] for s in spans}
    assert not any(n.split(".")[0] == "solver" for n in names)
    assert {"step", "step.read.contact_gate",
            "step.read.penetration_gate"} <= names
    for key in ("contact_gate", "penetration_gate"):
        assert step_mod.HOST_READS[key] - reads[key] == len(
            named(spans, f"step.read.{key}"))


def test_outputs_bit_identical_with_the_profiler_on_and_off():
    step, params, states = grid(3, 2.01, 0.5)
    flat = lambda out: (out[0].p, out[0].v, out[0].t, *out[1])
    plain = flat(step(params, states, 0.01))
    on, _ = traced(lambda: step(params, states, 0.01))
    assert len(plain) == 7
    for a, b in zip(plain, flat(on)):
        assert torch.equal(a, b)


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first = observe.span("step")
    assert first is observe.span("solver.iter") is observe._NULL
    with observe.span("step"):
        pass
    with pytest.raises(AssertionError, match="entered"):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            observe.span("step")
