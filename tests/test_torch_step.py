"""The PyTorch port's batched step and rollout vs the JAX package (f64, CPU).

The scene is the headline LCP benchmark's (bench.py::bench_lcp_solves):
8 radius-1 circles per world at uniform(0, 5) positions with standard-normal
velocities, c_max = 8, dt = 0.01, SimConfig(max_iter=15, solver_eps=1e-6).
The JAX side runs with lcp_backend="fused" (the fused IPM kernel in
interpret mode); the port runs its plain torch kernels on CPU tensors.

``PYTHONPATH=. python tests/test_torch_step.py`` (from the repository root)
rewrites tests/data/torch_slice_golden.json, the JAX record of this scene
at B = 8 that tests/test_torch_cuda_paths.py holds the GPU kernels to;
``test_golden_record_matches_jax`` keeps the file honest.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcp_physics_tpu.core import WorldState as JWorldState
from lcp_physics_tpu.core import default_params as jax_default_params
from lcp_physics_tpu.core import make_scene_static as jax_scene_static
from lcp_physics_tpu.core.step import rollout as jax_rollout
from lcp_physics_tpu.parallel import make_batched_step as jax_batched_step
from lcp_physics_tpu.utils import SimConfig as JaxSimConfig
from torch_inputs import kernel_counts, one_torch_thread  # noqa: F401

import lcp_physics_tpu_torch as port
from lcp_physics_tpu_torch.core import (JointSpec, SceneStatic, WorldState,
                                        make_scene_static, params_from_numpy,
                                        rollout, state_from_numpy)
from lcp_physics_tpu_torch.parallel import make_batched_step
from lcp_physics_tpu_torch.utils import SimConfig

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_slice_golden.json")
N, C, DT = 8, 8, 0.01
F64 = dict(dtype=torch.float64, device="cpu")


def slice_scene(B, seed=0, spread=5.0):
    """numpy (p0, v0) of the benchmark scene."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, spread, (B, N, 2))
    p = np.concatenate([np.zeros((B, N, 1)), pos], -1)
    v = rng.standard_normal((B, N, 3))
    return p, v


def jax_scene(p, v):
    static = jax_scene_static([1] * N, c_max=C)
    params = jax_default_params(
        static, verts=np.zeros((N, 1, 2)), radius=np.full(N, 1.0),
        gravity=(0.0, 10.0), restitution=0.4, dtype=jnp.float64)
    state = JWorldState(p=jnp.asarray(p), v=jnp.asarray(v),
                        t=jnp.zeros(p.shape[0]))
    return static, params, state


def jax_run(p, v, n_steps):
    static, params, state = jax_scene(p, v)
    step = jax_batched_step(static, JaxSimConfig(
        max_iter=15, solver_eps=1e-6, lcp_backend="fused"))
    s1, _ = jax.jit(step)(params, state, DT)
    final, _ = jax.jit(lambda pr, s: jax_rollout(step, pr, s, DT, n_steps))(
        params, state)
    return s1, final


def port_run(p, v, n_steps):
    static, params, state = jax_scene(p, v)
    tp = params_from_numpy(params, **F64)
    ts = state_from_numpy(state, **F64)
    step = make_batched_step(make_scene_static([1] * N, c_max=C),
                             SimConfig(max_iter=15, solver_eps=1e-6))
    s1, diag = step(tp, ts, DT)
    final, traj = rollout(step, tp, ts, DT, n_steps)
    return s1, diag, final, traj


def port_static(jstatic):
    """The JAX package's SceneStatic as the port's (same fields)."""
    return SceneStatic(
        counts=jstatic.counts,
        joints=tuple(JointSpec(**dataclasses.asdict(j))
                     for j in jstatic.joints),
        c_max=jstatic.c_max, allowed=jstatic.allowed)


def golden_record():
    p, v = slice_scene(8)
    s1, s3 = jax_run(p, v, 3)
    return dict(
        about=("JAX package (lcp_backend='fused', f64, CPU) on the "
               "bench_lcp_solves scene: B=8 worlds of 8 radius-1 circles, "
               "c_max=8, dt=0.01, SimConfig(max_iter=15, solver_eps=1e-6), "
               "restitution 0.4, gravity (0, 10); written by "
               "tests/test_torch_step.py"),
        p0=p.tolist(), v0=v.tolist(),
        p1=np.asarray(s1.p).tolist(), v1=np.asarray(s1.v).tolist(),
        p3=np.asarray(s3.p).tolist(), v3=np.asarray(s3.v).tolist())


def test_step_and_rollout_match_jax():
    p, v = slice_scene(8)
    j1, j3 = jax_run(p, v, 3)
    t1, diag, t3, traj = port_run(p, v, 3)
    np.testing.assert_allclose(t1.p.numpy(), np.asarray(j1.p), atol=1e-8)
    np.testing.assert_allclose(t1.v.numpy(), np.asarray(j1.v), atol=1e-8)
    np.testing.assert_allclose(t3.p.numpy(), np.asarray(j3.p), atol=1e-6)
    np.testing.assert_allclose(t3.v.numpy(), np.asarray(j3.v), atol=1e-6)
    np.testing.assert_allclose(t3.t.numpy(), np.asarray(j3.t), atol=1e-15)
    assert traj.p.shape == (3, 8, N, 3)
    assert int(diag.n_contacts.sum()) > 0     # the contact branch ran


def test_loose_scene_takes_equality_branch(monkeypatch):
    """Bodies far apart: the AABB predicate proves the batch contact-free
    and the step is the closed-form equality solve, as in JAX."""
    from lcp_physics_tpu_torch.lcp import lcp as port_lcp
    p, v = slice_scene(4, seed=3)
    p[..., 1:3] = np.stack(np.meshgrid(np.arange(4) * 40.0,
                                       np.arange(2) * 40.0), -1).reshape(
        1, N, 2)
    v = 0.1 * v
    j1, _ = jax_run(p, v, 1)

    def no_solver(*a, **k):
        raise AssertionError("contact solver ran on a contact-free batch")

    monkeypatch.setattr(port_lcp._LcpSolve, "apply", no_solver)
    t1, diag, _, _ = port_run(p, v, 1)
    np.testing.assert_allclose(t1.p.numpy(), np.asarray(j1.p), atol=1e-12)
    np.testing.assert_allclose(t1.v.numpy(), np.asarray(j1.v), atol=1e-12)
    assert int(diag.n_contacts.sum()) == 0


def test_state_and_params_conversion():
    p, v = slice_scene(2)
    static, params, state = jax_scene(p, v)
    tp = params_from_numpy(params, dtype=torch.float32, device="cpu")
    ts = state_from_numpy(state, dtype=torch.float32, device="cpu")
    assert isinstance(ts, WorldState)
    for f in ("mass", "inertia", "restitution", "fric_coeff", "radius",
              "verts", "gravity"):
        got = getattr(tp, f)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(params, f)),
                                   rtol=1e-7)
    np.testing.assert_allclose(ts.p.numpy(), p, rtol=1e-7)
    # the port's own constructor gives the JAX package's parameters
    own = port.core.default_params(
        make_scene_static([1] * N, c_max=C), verts=np.zeros((N, 1, 2)),
        radius=np.full(N, 1.0), gravity=(0.0, 10.0), restitution=0.4, **F64)
    for f in ("mass", "inertia", "restitution", "fric_coeff", "gravity"):
        np.testing.assert_allclose(getattr(own, f).numpy(),
                                   np.asarray(getattr(params, f)))


def test_import_leaves_jax_out():
    """The package, its object layer, sharding, entry analogs, demos,
    tools, native broadphase and checkpoints, and the tests' inputs
    (tests/torch_inputs.py, which the card's tests and
    tools/time_kernels.py import) import neither jax, nor the JAX package,
    nor the repository's tools/."""
    mods = ["lcp_physics_tpu_torch", "lcp_physics_tpu_torch.physics",
            "lcp_physics_tpu_torch.native",
            "lcp_physics_tpu_torch.parallel", "lcp_physics_tpu_torch.entry",
            "lcp_physics_tpu_torch.utils.checkpoint",
            "lcp_physics_tpu_torch.tools.validate_f32",
            "lcp_physics_tpu_torch.tools.bigworld",
            "lcp_physics_tpu_torch.tools.bench",
            "lcp_physics_tpu_torch.tools.iter_bench",
            "lcp_physics_tpu_torch.tools.roofline",
            "lcp_physics_tpu_torch.tools.bwd_roofline",
            "lcp_physics_tpu_torch.tools.asm_vjp_probe",
            "lcp_physics_tpu_torch.tools.parity", "torch_inputs"] + [
        f"lcp_physics_tpu_torch.demos.{d}"
        for d in ("hello_world", "chain", "inference", "billiards",
                  "sharded_inference")]
    code = (f"import sys; sys.path.insert(0, 'tests'); "
            f"import {', '.join(mods)}; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'lcp_physics_tpu.', 'tools.')) or "
            "m in ('lcp_physics_tpu', 'tools')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_cpu_tensors_run_the_plain_versions():
    """On CPU tensors the wrappers dispatch to their plain versions: the
    kernels' launch counters stay at zero through a contact step."""
    before = kernel_counts()
    p, v = slice_scene(2)
    _, diag, _, _ = port_run(p, v, 1)
    assert int(diag.n_contacts.sum()) > 0
    assert kernel_counts() == before == {
        "lu": 0, "solve": 0, "solve_t": 0, "gj_inv_blocked": 0, "gj_inv": 0,
        "fused_ipm": 0, "fused_ipm_unrot": 0, "ipm_iter": 0}


def test_unported_options_raise():
    """Once raised NotImplementedError (ROADMAP A6); now both run and match
    JAX: SimConfig(post_stabilization=True) and
    SimConfig(penetration_backtrack=True) on two steps of the benchmark
    scene."""
    for case in ("post_stabilization", "backtrack"):
        check_option_case(case)


def test_hull_pair_step_matches_jax():
    """Once raised NotImplementedError (ROADMAP A5): one step of a circle
    resting on a square (a circle/hull pair) matches JAX."""
    check_option_case("hull_pair")


def check_option_case(case):
    if case == "hull_pair":
        jstatic = jax_scene_static([1, 4], c_max=4)
        verts = np.array([[[0, 0]] * 4, [[-1, -1], [1, -1], [1, 1], [-1, 1]]],
                         float)
        jparams = jax_default_params(jstatic, verts=verts,
                                     radius=np.array([1.0, 0.0]),
                                     dtype=jnp.float64)
        p = np.array([[[0, 0, 0], [0, 0, 1.99]]], float)
        jstate = JWorldState(jnp.asarray(p), jnp.zeros((1, 2, 3)),
                             jnp.zeros(1))
        cfg, n = {}, 1
    else:
        p, v = slice_scene(8)
        jstatic, jparams, jstate = jax_scene(p, v)
        cfg = dict(max_iter=15, solver_eps=1e-6,
                   **({"post_stabilization": True}
                      if case == "post_stabilization"
                      else {"penetration_backtrack": True}))
        n = 2
    jstep = jax_batched_step(jstatic, JaxSimConfig(**cfg))
    _, jtraj = jax.jit(lambda pr, s: jax_rollout(jstep, pr, s, DT, n))(
        jparams, jstate)
    step = make_batched_step(port_static(jstatic), SimConfig(**cfg))
    _, traj, rd = rollout(step, params_from_numpy(jparams, **F64),
                          state_from_numpy(jstate, **F64), DT, n,
                          with_diagnostics=True)
    for k in ("p", "v", "t"):
        np.testing.assert_allclose(getattr(traj, k).numpy(),
                                   np.asarray(getattr(jtraj, k)), rtol=1e-8,
                                   atol=1e-8, err_msg=k)
    assert int(rd.total_contacts.sum()) > 0


@pytest.mark.parametrize("cfg,jax_backend", [
    (dict(lcp_backend="xla"), "xla"), (dict(solver_gondzio=1), "pallas")],
    ids=["xla", "gondzio"])
def test_step_options_match_jax(cfg, jax_backend, monkeypatch):
    """Two steps of the benchmark scene (B = 8) with SimConfig
    (lcp_backend="xla") — the pivoted library LU and the unfused loop —
    and with solver_gondzio=1 — one Gondzio corrector per iteration in the
    unfused loop, against the JAX step with the same option
    (lcp_backend="pallas" for gondzio: the port's pivotless factor).
    Neither may reach the fused kernel, as in the JAX package."""
    from lcp_physics_tpu_torch.ops import ipm
    monkeypatch.setattr(ipm, "fused_ipm", None)   # any call would raise
    p, v = slice_scene(8)
    static, params, state = jax_scene(p, v)
    jcfg = dict(cfg, lcp_backend=jax_backend)
    jstep = jax_batched_step(static, JaxSimConfig(
        max_iter=15, solver_eps=1e-6, **jcfg))
    _, jtraj = jax.jit(lambda pr, s: jax_rollout(jstep, pr, s, DT, 2))(
        params, state)
    step = make_batched_step(make_scene_static([1] * N, c_max=C),
                             SimConfig(max_iter=15, solver_eps=1e-6, **cfg))
    _, traj = rollout(step, params_from_numpy(params, **F64),
                      state_from_numpy(state, **F64), DT, 2)
    for k in ("p", "v"):
        np.testing.assert_allclose(getattr(traj, k).numpy(),
                                   np.asarray(getattr(jtraj, k)), rtol=1e-8,
                                   atol=1e-8, err_msg=k)


def test_lcp_solve_backward_raises():
    """Once raised (no backward); now the same step's backward gives
    finite gradients equal to JAX's (fused forward, lane-LU trans=1
    backward solve)."""
    p, v = slice_scene(2)
    static, params, state = jax_scene(p, v)
    jstep = jax_batched_step(static, JaxSimConfig(
        max_iter=15, solver_eps=1e-6, lcp_backend="fused"))
    g_jax = jax.grad(lambda v_: jnp.sum(
        jstep(params, JWorldState(state.p, v_, state.t), DT)[0].v))(state.v)
    tp = params_from_numpy(params, **F64)
    ts = state_from_numpy(state, **F64)
    ts.v.requires_grad_(True)
    step = make_batched_step(make_scene_static([1] * N, c_max=C),
                             SimConfig(max_iter=15, solver_eps=1e-6))
    s1, _ = step(tp, ts, DT)
    s1.v.sum().backward()
    assert bool(torch.isfinite(ts.v.grad).all())
    np.testing.assert_allclose(ts.v.grad.numpy(), np.asarray(g_jax),
                               rtol=1e-8, atol=1e-10)


def test_golden_record_matches_jax():
    with open(GOLDEN) as f:
        rec = json.load(f)
    new = golden_record()
    for k in ("p0", "v0", "p1", "v1", "p3", "v3"):
        np.testing.assert_allclose(np.asarray(rec[k]), np.asarray(new[k]),
                                   rtol=0, atol=1e-12, err_msg=k)


# ---------------------------------------------------------------------------
# Post-stabilization, the in-step backtrack and make_step (ROADMAP A6),
# on the scenes of tests/test_step.py, held to the JAX package.
# ---------------------------------------------------------------------------

def both(jstatic, jparams):
    """The port's (static, params) of a JAX scene."""
    return port_static(jstatic), params_from_numpy(jparams, **F64)


def jax_states(p0, v0):
    return JWorldState(jnp.asarray(p0), jnp.asarray(v0),
                       jnp.zeros(p0.shape[0]))


def assert_step_matches(got, ref, tol, halvings=True):
    (s, d), (js, jd) = got, ref
    for k in ("p", "v", "t"):
        np.testing.assert_allclose(getattr(s, k).detach().numpy(),
                                   np.asarray(getattr(js, k)), rtol=tol,
                                   atol=tol, err_msg=k)
    if halvings:
        np.testing.assert_array_equal(d.halvings.numpy(),
                                      np.asarray(jd.halvings))
    np.testing.assert_allclose(d.max_penetration.numpy(),
                               np.asarray(jd.max_penetration), atol=tol)


def test_post_stabilization_pendulum_matches_jax():
    """tests/test_step.py's pendulum on a world joint (no contact
    capacity: the projection is the equality-only KKT) through make_step
    with post_stabilization: two steps against JAX at 1e-10, and the
    anchor held to 2e-3 L over 60 steps."""
    from lcp_physics_tpu.core import make_step as jax_make_step
    from lcp_physics_tpu_torch.core import make_step
    from test_step import G, circle_world
    from lcp_physics_tpu.core import JointSpec as JJointSpec
    L = 2.0
    joints = (JJointSpec(kind="joint", body1=0, body2=-1, local1=(-L, 0.0),
                         ref=(0.0, 0.0, 0.0)),)
    jstatic, jparams = circle_world(1, radius=0.1, joints=joints,
                                    gravity=(0.0, G))
    cfg = dict(post_stabilization=True)
    s0 = JWorldState(jnp.array([[0., L, 0.]]), jnp.zeros((1, 3)),
                     jnp.zeros(()))
    jstep = jax.jit(jax_make_step(jstatic, JaxSimConfig(**cfg)))
    js = s0
    static, params = both(jstatic, jparams)
    step = make_step(static, SimConfig(**cfg))
    s = state_from_numpy(s0, **F64)
    for _ in range(2):
        js, jd = jstep(jparams, js, 0.01)
        s, d = step(params, s, 0.01)
        assert_step_matches((s, d), (js, jd), 1e-10)
    final, traj = rollout(step, params, s, 0.01, 58)
    p = traj.p[:, 0].numpy()
    anchors = p[:, 1:3] + np.stack([-L * np.cos(p[:, 0]),
                                    -L * np.sin(p[:, 0])], -1)
    assert np.abs(anchors).max() < 2e-3 * L


def test_post_stabilization_contacts_matches_jax():
    """Post-stabilization with contact rows: a box sunk into the ground
    and one above it (B = 2), two batched steps against JAX at 1e-10; the
    sunk box is pushed out."""
    from test_step import G, box_ground_world
    jstatic, jparams = box_ground_world(body_kind="box", gravity=(0.0, G),
                                        restitution=0.2)
    p0 = np.array([[[0., 0., -1.9], [0., 0., 0.]],
                   [[0.1, 0., -6.0], [0., 0., 0.]]])
    jstate = jax_states(p0, np.zeros((2, 2, 3)))
    cfg = JaxSimConfig(post_stabilization=True)
    jstep = jax.jit(jax_batched_step(jstatic, cfg))
    static, params = both(jstatic, jparams)
    step = make_batched_step(static, SimConfig(post_stabilization=True))
    s, js = state_from_numpy(jstate, **F64), jstate
    for _ in range(2):
        js, jd = jstep(jparams, js, 0.01)
        s, d = step(params, s, 0.01)
        assert_step_matches((s, d), (js, jd), 1e-10)
    assert float(s.p[0, 0, 2]) < -1.95


def backtrack_case(kind):
    """The scenes of tests/test_step.py's backtrack tests: 'batched' (a
    fast ball and a far one), 'noop' (nothing penetrates), 'exhaust' (one
    halving cannot cure the impact), 'hull' (a fast unit box)."""
    from test_step import G, box_ground_world
    body = "box" if kind == "hull" else "circle"
    jstatic, jparams = box_ground_world(
        body_kind=body, gravity=(0.0, G),
        restitution=0.3 if kind == "noop" else 0.0)
    if kind == "noop":
        p0 = np.array([[[0., 0., -5.], [0., 0., 0.]],
                       [[0., 1., -4.], [0., 0., 0.]]])
        v0 = np.zeros((2, 2, 3))
        cfg, dt = dict(penetration_backtrack=True), 0.01
    else:
        p0 = np.array([[[0., 0., -2.4], [0., 0., 0.]],
                       [[0., 0., -30.], [0., 0., 0.]]])
        v0 = np.zeros((2, 2, 3))
        v0[0, 0, 2] = 30.0 if kind == "exhaust" else 12.0
        cfg = dict(speculative=False, tol=1e-6, penetration_backtrack=True,
                   max_dt_halvings=1 if kind == "exhaust" else 8)
        dt = 0.05
    return jstatic, jparams, jax_states(p0, v0), cfg, dt


@pytest.mark.parametrize("kind", ["batched", "noop", "exhaust", "hull"])
def test_backtrack_matches_jax(kind):
    """One batched step with the backtrack: states, penetration and
    halvings (exactly) against JAX; the invariants of tests/test_step.py
    (fast worlds halve, far and resting worlds keep the full dt, the
    exhausted world reports max_dt_halvings + 1)."""
    jstatic, jparams, jstate, cfg, dt = backtrack_case(kind)
    ref = jax.jit(jax_batched_step(jstatic, JaxSimConfig(**cfg)))(
        jparams, jstate, dt)
    static, params = both(jstatic, jparams)
    step = make_batched_step(static, SimConfig(**cfg))
    got = step(params, state_from_numpy(jstate, **F64), dt)
    assert_step_matches(got, ref, 1e-10)
    h = got[1].halvings.tolist()
    if kind == "noop":
        assert h == [0, 0]
        off = make_batched_step(static, SimConfig())(
            params, state_from_numpy(jstate, **F64), dt)[0]
        assert torch.equal(got[0].p, off.p) and torch.equal(got[0].v, off.v)
    elif kind == "exhaust":
        assert h[0] == cfg["max_dt_halvings"] + 1
    else:
        assert 1 <= h[0] <= 8 and h[1] == 0
        assert float(got[0].t[0]) < dt - 1e-9


def test_backtrack_gradients_match_jax():
    """Gradients through the accepted step on the no-op scene (full step
    accepted: the caller's dt keeps its gradient): d loss / d v0 and
    d loss / d dt against jax.grad at 1e-8, and equal to the plain
    step's."""
    jstatic, jparams, jstate, cfg, dt = backtrack_case("noop")
    jstate = JWorldState(jstate.p, jstate.v.at[:, 0, 1:].set(1.5),
                         jstate.t)
    jstep = jax_batched_step(jstatic, JaxSimConfig(**cfg))

    def jloss(v0, dt_):
        out, _ = jstep(jparams, JWorldState(jstate.p, v0, jstate.t), dt_)
        return jnp.sum(out.p ** 2) + jnp.sum(out.v ** 2)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jstate.v, dt)
    static, params = both(jstatic, jparams)
    grads = {}
    for on in (True, False):
        step = make_batched_step(static, SimConfig(penetration_backtrack=on))
        state = state_from_numpy(jstate, **F64)
        state.v.requires_grad_(True)
        dt_t = torch.tensor(dt, **F64, requires_grad=True)
        out, _ = step(params, state, dt_t)
        loss = (out.p ** 2).sum() + (out.v ** 2).sum()
        grads[on] = torch.autograd.grad(loss, (state.v, dt_t))
    for k in range(2):
        assert float(grads[True][k].abs().max()) > 1e-8
        np.testing.assert_allclose(grads[True][k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(grads[True][k].numpy(),
                                   grads[False][k].numpy(), rtol=1e-10)


def test_backtrack_tiles_and_per_world_params_match_jax():
    """The backtrack composed with batch_tile = 2 and per-world parameters
    (B = 4: two fast worlds, two far ones, masses differing per world)
    against JAX's lax.map over tiles."""
    jstatic, jparams, jstate, cfg, dt = backtrack_case("batched")
    B = 4
    rep = lambda x: jnp.concatenate([x, x])
    jstate = JWorldState(rep(jstate.p), rep(jstate.v), rep(jstate.t))
    jparams = jparams.__class__(**{
        f: (jnp.stack([getattr(jparams, f)] * B) if f != "force_params"
            else ()) for f in jparams.__dict__})
    jparams = jparams.__class__(**{**jparams.__dict__, "mass":
                                   jparams.mass * jnp.asarray(
                                       [[1.0], [1.0], [2.0], [0.5]])})
    cfg = dict(cfg, batch_tile=2)
    ref = jax.jit(jax_batched_step(jstatic, JaxSimConfig(**cfg),
                                   params_batched=True))(jparams, jstate, dt)
    static, params = both(jstatic, jparams)
    step = make_batched_step(static, SimConfig(**cfg), params_batched=True)
    got = step(params, state_from_numpy(jstate, **F64), dt)
    assert_step_matches(got, ref, 1e-10)
    assert got[1].halvings.tolist()[1::2] == [0, 0]
    assert min(got[1].halvings.tolist()[0::2]) >= 1


def test_make_step_jointed_hulls_matches_jax():
    """The single-world make_step on a jointed hull scene: a chain of
    three Rects hung from the world by revolute joints above a held
    floor, with a box falling on it; four steps against the JAX make_step
    at 1e-10."""
    from lcp_physics_tpu.core import JointSpec as JJointSpec
    from lcp_physics_tpu.core import make_step as jax_make_step
    from lcp_physics_tpu_torch.core import make_step
    N = 5
    counts = [4] * N
    verts = np.zeros((N, 4, 2))
    half = [(0.5, 0.1)] * 3 + [(5.0, 0.5), (0.4, 0.4)]
    for k, (hx, hy) in enumerate(half):
        verts[k] = [[-hx, -hy], [hx, -hy], [hx, hy], [-hx, hy]]
    joints = [JJointSpec(kind="joint", body1=0, local1=(-0.5, 0.0),
                         ref=(0.0, 0.0, 0.0))]
    joints += [JJointSpec(kind="joint", body1=k, body2=k - 1,
                          local1=(-0.5, 0.0), local2=(0.5, 0.0))
               for k in (1, 2)]
    joints += [JJointSpec(kind="total", body1=3, ref=(0.0, 1.5, 3.0))]
    jstatic = jax_scene_static(counts, joints=joints)
    jparams = jax_default_params(jstatic, verts=verts, radius=np.zeros(N),
                                 gravity=(0.0, 10.0), restitution=0.2,
                                 fric_coeff=0.5, dtype=jnp.float64)
    p0 = np.array([[0., 0.5, 0.], [0., 1.5, 0.], [0., 2.5, 0.],
                   [0., 1.5, 3.0], [0.0, 2.6, 2.11]])
    v0 = np.zeros((N, 3))
    v0[4, 2] = 3.0
    js = JWorldState(jnp.asarray(p0), jnp.asarray(v0), jnp.zeros(()))
    jstep = jax.jit(jax_make_step(jstatic, JaxSimConfig()))
    static, params = both(jstatic, jparams)
    step = make_step(static, SimConfig())
    s = state_from_numpy(js, **F64)
    ncon = 0
    for _ in range(4):
        js, jd = jstep(jparams, js, 0.05)
        s, d = step(params, s, 0.05)
        assert s.p.shape == (N, 3) and d.halvings.shape == ()
        assert_step_matches((s, d), (js, jd), 1e-10)
        ncon += int(jd.n_contacts)
    assert ncon > 0


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    with open(GOLDEN, "w") as f:
        json.dump(golden_record(), f)
        f.write("\n")
    print("wrote", GOLDEN)
