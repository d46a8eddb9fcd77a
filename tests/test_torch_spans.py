"""The port's spans (``utils.observe.span``) under a CPU-only profiler:
which spans the batched step and the solver open, how they nest, that
``solver.iter`` counts the unfused loop's iterations, that the hull/hull
narrowphase, the compaction and each rotated Schur factor open theirs,
that the joints' equality rows open theirs only in a jointed scene and
make their tables once a scene, that tracing changes no output, and that
with no profiler a span is the shared null context."""
import numpy as np
import pytest
import torch

from test_torch_pdipm import one_torch_thread  # noqa: F401

from lcp_physics_tpu_torch.core import (JointSpec, WorldState,
                                        default_params, make_scene_static)
from lcp_physics_tpu_torch.core import jacobians
from lcp_physics_tpu_torch.core import step as step_mod
from lcp_physics_tpu_torch.lcp import lcp_solve, pdipm
from lcp_physics_tpu_torch.parallel import make_batched_step
from lcp_physics_tpu_torch.tools.bench import lcp_problem
from lcp_physics_tpu_torch.utils import SimConfig, observe

F64 = dict(dtype=torch.float64, device="cpu")
LAYERS = ("step", "solver")
SIDE, C_MAX = 4, 32
CONFIG = SimConfig(max_iter=12, solver_eps=1e-9)
SQUARE = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])


def grid(B, spacing, v_std, seed=5, side=SIDE, c_max=C_MAX, shape="circle"):
    """B worlds of a ``side`` x ``side`` grid of radius-1 circles (or 2 x 2
    squares of radius 0), jittered by 0.01 and given velocities
    normal(0, v_std), each world its own draw.  A world has side^2
    (side^2 - 1) / 2 candidate rows of circles and twice as many of squares
    (two a hull pair).  Past 24 slots the rotated system (K2 = 2 c_max) is
    past the fused kernel's 48 rows, so a contact step runs the host start
    and the unfused loop.  Returns (step, params, states)."""
    N = side * side
    rng = np.random.default_rng(seed)
    if shape == "square":
        static = make_scene_static([4] * N, c_max=c_max)
        verts, radius = np.broadcast_to(SQUARE, (N, 4, 2)), np.zeros(N)
    else:
        static = make_scene_static([1] * N, c_max=c_max)
        verts, radius = np.zeros((N, 1, 2)), np.ones(N)
    params = default_params(static, verts=verts, radius=radius,
                            restitution=0.4, **F64)
    gx, gy = np.meshgrid(np.arange(side), np.arange(side))
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


def test_eager_loop_opens_one_iter_span_a_pass():
    """On CPU tensors the unfused loop runs eagerly: one ``solver.iter``
    a pass, each counted in ``LOOP_ROUTES['eager']``, and no
    ``solver.graph`` (the graphed route's replay span)."""
    step, params, states = grid(3, 2.01, 0.5)
    routes = dict(pdipm.LOOP_ROUTES)
    _, spans = traced(lambda: step(params, states, 0.01))
    iters = named(spans, "solver.iter")
    assert len(iters) == pdipm.LOOP_ROUTES["eager"] - routes["eager"] > 2
    assert pdipm.LOOP_ROUTES["graph"] == routes["graph"]
    assert not named(spans, "solver.graph")


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


def two_steps(step, params, states):
    s, _ = step(params, states, 0.01)
    return step(params, s, 0.01)


def test_hull_step_opens_the_hull_span_once_a_step():
    step, params, states = grid(2, 2.01, 0.5, side=3, c_max=24, shape="square")
    _, spans = traced(lambda: two_steps(step, params, states))
    hull = named(spans, "step.narrowphase.hull")
    narrow = named(spans, "step.narrowphase")
    assert len(hull) == 2 == len(named(spans, "step"))
    assert all(any(inside(h, n) for n in narrow) for h in hull)


@pytest.mark.parametrize("shape, c_max, compactions", [
    ("square", 11, 1), ("square", 12, 0), ("circle", 5, 1),
    ("circle", 6, 0)])
def test_compact_span_opens_exactly_when_rows_exceed_c_max(shape, c_max,
                                                          compactions):
    """A 2 x 2 pile has 12 candidate rows of squares, 6 of circles."""
    step, params, states = grid(2, 2.01, 0.5, side=2, c_max=c_max, shape=shape)
    _, spans = traced(lambda: step(params, states, 0.01))
    narrow = named(spans, "step.narrowphase")
    compact = named(spans, "step.narrowphase.compact")
    assert len(compact) == compactions
    assert all(any(inside(c, n) for n in narrow) for c in compact)


def test_circle_step_opens_no_hull_span():
    step, params, states = grid(2, 2.01, 0.5, side=3, c_max=24)
    _, spans = traced(lambda: step(params, states, 0.01))
    assert named(spans, "step.narrowphase")
    assert not named(spans, "step.narrowphase.hull")


@pytest.mark.parametrize("shape", ["circle", "square"])
def test_factor_span_opens_once_per_factor(shape, monkeypatch):
    """Every rotated Schur factor of the host start, the unfused loop and
    the backward is one ``solver.factor``: one in the start, one in each
    iteration, one in the backward."""
    step, params, states = grid(2, 2.01, 0.5, side=3, c_max=32, shape=shape)
    factors = []
    real = pdipm._factor

    def counted(*a, **kw):
        factors.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(pdipm, "_factor", counted)
    v = states.v.clone().requires_grad_(True)
    s = WorldState(states.p, v, states.t)
    _, spans = traced(lambda: step(params, s, 0.01)[0].p.sum().backward())
    fac = named(spans, "solver.factor")
    assert len(fac) == len(factors) and v.grad is not None
    (start,) = named(spans, "solver.start")
    (bwd,) = named(spans, "solver.bwd")
    iters = named(spans, "solver.iter")
    assert iters and sum(inside(f, start) for f in fac) == 1
    assert sum(inside(f, bwd) for f in fac) == 1
    for it in iters:
        assert sum(inside(f, it) for f in fac) == 1
    assert len(fac) == len(iters) + 2


def test_hull_step_outputs_bit_identical_with_the_profiler_on_and_off():
    step, params, states = grid(2, 2.01, 0.5, side=3, c_max=24, shape="square")
    flat = lambda out: (out[0].p, out[0].v, out[0].t, *out[1])
    plain = flat(two_steps(step, params, states))
    on, spans = traced(lambda: two_steps(step, params, states))
    assert len(named(spans, "step.narrowphase.compact")) == 2
    for a, b in zip(plain, flat(on)):
        assert torch.equal(a, b)


def chain(B, jointed=True, post_stab=False, links=4, rain=4):
    """B worlds of ``links`` radius-0.5 circles along x, pinned to the world
    by a joint and a rot and linked by joints (q = 2 + 1 + 2 (links - 1)
    rows; ``jointed=False``: the same bodies unlinked), with ``rain``
    radius-1 circles spread over the chain 1.6 above it, falling at 4,
    each world its own jitter.  Returns (step, params, states)."""
    N = links + rain
    js = [JointSpec(kind="joint", body1=0, local1=(-0.5, 0.0),
                    ref=(0.0, 0.0, 0.0)), JointSpec(kind="rot", body1=0)]
    js += [JointSpec(kind="joint", body1=k, body2=k + 1, local1=(0.5, 0.0),
                     local2=(-0.5, 0.0)) for k in range(links - 1)]
    static = make_scene_static([1] * N, joints=js if jointed else (),
                               c_max=16)
    radius = np.full(N, 1.0)
    radius[:links] = 0.5
    params = default_params(static, verts=np.zeros((N, 1, 2)), radius=radius,
                            restitution=0.4, **F64)
    rng = np.random.default_rng(7)
    pos = np.zeros((B, N, 2))
    pos[:, :links, 0] = 0.5 + np.arange(links)
    pos[:, links:, 0] = np.arange(rain) * links / rain
    pos[:, links:, 1] = -1.6
    pos[:, links:] += rng.uniform(-0.1, 0.1, (B, rain, 2))
    v = np.zeros((B, N, 3))
    v[:, links:, 2] = 4.0
    states = WorldState(
        torch.tensor(np.concatenate([np.zeros((B, N, 1)), pos], -1), **F64),
        torch.tensor(v, **F64), torch.zeros(B, **F64))
    config = SimConfig(max_iter=12, solver_eps=1e-9,
                       post_stabilization=post_stab)
    return make_batched_step(static, config), params, states


@pytest.mark.parametrize("jointed, post_stab", [
    (True, False), (True, True), (False, False)])
def test_joint_span_opens_once_a_step_where_the_scene_has_joints(
        jointed, post_stab):
    """``step.assemble.joints`` (``assemble_Je``) opens once a step inside
    ``step.assemble``, and once more inside ``step.integrate`` with
    post-stabilization; never in a scene without joints."""
    step, params, states = chain(2, jointed, post_stab)
    (s, d), spans = traced(lambda: two_steps(step, params, states))
    assert int(d.n_contacts.sum()) > 0
    rows = named(spans, "step.assemble.joints")
    assert len(named(spans, "step")) == 2
    for outer, count in (("step.assemble", 2 * jointed),
                         ("step.integrate", 2 * post_stab)):
        assert sum(any(inside(r, o) for o in named(spans, outer))
                   for r in rows) == count, outer
    assert len(rows) == 2 * jointed * (1 + post_stab)


@pytest.mark.parametrize("jointed, post_stab", [
    (True, False), (True, True), (False, False)])
def test_joint_tables_are_made_once_a_scene_and_used_every_step(
        jointed, post_stab):
    """``jacobians.JOINT_TABLES``: a jointed scene's tables are made at its
    first step and not again; every call of the rows (and of the position
    error) is served from them: one a step, three with post-stabilization
    (its rows and its error besides).  A scene without joints moves
    neither count."""
    step, params, states = chain(2, jointed, post_stab)
    counts = jacobians.JOINT_TABLES
    seen = [dict(counts)]
    s, _ = step(params, states, 0.01)
    seen.append(dict(counts))
    step(params, s, 0.01)
    seen.append(dict(counts))
    moved = lambda key: [b[key] - a[key] for a, b in zip(seen, seen[1:])]
    assert moved("made") == [int(jointed), 0]
    assert moved("used") == [jointed * (1 + 2 * post_stab)] * 2
