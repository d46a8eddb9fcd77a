"""The port's f32 physics-quality guard (``lcp_physics_tpu_torch.tools.
validate_f32``) against the JAX package's ``tools/validate_f32.py``, on CPU.

* Its four scenes, built from the same numpy arrays, step in both packages
  at f64 to within 1e-8 over 3 steps, at the production profile, and the
  dense grid at the refine-2 profile too.
* Its check functions read the same values as the JAX tool's formulas
  (copied below from tools/validate_f32.py) on a fixed synthetic
  trajectory, the bounce check's apex window y[hit:hit + 260] included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcp_physics_tpu.core import JointSpec as JJointSpec
from lcp_physics_tpu.core import WorldState as JWorldState
from lcp_physics_tpu.core import default_params as jax_default_params
from lcp_physics_tpu.core import make_scene_static as jax_scene_static
from lcp_physics_tpu.core import make_step_batched as jax_step_batched
from lcp_physics_tpu.core import rollout as jax_rollout
from lcp_physics_tpu.utils import SimConfig as JaxSimConfig
from test_torch_pdipm import one_torch_thread  # noqa: F401

from lcp_physics_tpu_torch.core import WorldState, make_step_batched, rollout
from lcp_physics_tpu_torch.tools import validate_f32 as V

STEPS = 3
F64 = dict(dtype=torch.float64, device="cpu")


def jax_scene(spec):
    """The JAX package's scene of ``spec`` at f64, as one world of a batch
    (the JAX tool's states[None])."""
    joints = [JJointSpec(**dataclasses.asdict(j)) for j in spec.joints]
    static = jax_scene_static(spec.counts, joints=joints, c_max=spec.c_max)
    params = jax_default_params(
        static, verts=spec.verts, radius=spec.radius, gravity=spec.gravity,
        restitution=spec.restitution, fric_coeff=spec.fric_coeff,
        dtype=jnp.float64)
    state = JWorldState(p=jnp.asarray(spec.p, jnp.float64)[None],
                        v=jnp.asarray(spec.v, jnp.float64)[None],
                        t=jnp.zeros((1,), jnp.float64))
    return static, params, state


@pytest.mark.parametrize("scene,profile", [
    ("dense", "production"), ("dense", "refine2"), ("free", "production"),
    ("stack", "production"), ("bounce", "production")])
def test_scene_steps_match_jax(scene, profile):
    """Three steps of the scene from the same numpy arrays in both
    packages, f64: positions and velocities after each step within 1e-8."""
    spec = V.SPECS[scene]()
    dt = V.LENGTHS[scene][0]
    cfg = V.PROFILES[profile]
    jstatic, jparams, jstate = jax_scene(spec)
    jstep = jax_step_batched(jstatic, JaxSimConfig(
        **dataclasses.asdict(cfg)))
    _, jtraj = jax.jit(lambda pr, s: jax_rollout(jstep, pr, s, dt, STEPS))(
        jparams, jstate)
    static, params, state = V.build(spec, **F64)
    states = WorldState(state.p[None], state.v[None], state.t[None])
    with torch.no_grad():
        _, traj = rollout(make_step_batched(static, cfg), params, states, dt,
                          STEPS)
    for f in ("p", "v"):
        np.testing.assert_allclose(getattr(traj, f).numpy(),
                                   np.asarray(getattr(jtraj, f)), rtol=1e-8,
                                   atol=1e-8, err_msg=f)


def test_run_scene_is_the_rollout():
    """run_scene (the guard's rollout) returns the port's own rollout of
    the scene: final state, trajectory and max penetration."""
    static, params, state = V.build(V.stack_spec(), **F64)
    fp, fv, tp, pen = V.run_scene(static, V.PROFILES["production"], params,
                                  state, 0.01, STEPS)
    states = WorldState(state.p[None], state.v[None], state.t[None])
    final, traj, rd = rollout(make_step_batched(
        static, V.PROFILES["production"]), params, states, 0.01, STEPS,
        with_diagnostics=True)
    np.testing.assert_array_equal(fp, final.p[0].detach().numpy())
    np.testing.assert_array_equal(fv, final.v[0].detach().numpy())
    np.testing.assert_array_equal(tp, traj.p[:, 0].detach().numpy())
    assert pen == float(rd.max_penetration[0])
    assert tp.shape == (STEPS, 5, 3)


# --- the JAX tool's formulas, as tools/validate_f32.py computes them ------

def jax_tool_values(traj_p, final_p, final_v, p0, v0, mass, max_pen, y):
    pen = float(max_pen)
    ok_pen = np.isfinite(traj_p).all() and pen <= 0.06
    m = np.asarray(mass)[:, None]
    p0m = (m * np.asarray(v0)[:, 1:3]).sum(0)
    p1m = (m * final_v[:, 1:3]).sum(0)
    scale = max(float(np.linalg.norm(p0m)), 1.0)
    drift = float(np.linalg.norm(p1m - p0m)) / scale
    ok_mom = np.isfinite(traj_p).all() and drift <= 1e-2 \
        and float(np.abs(final_p).max()) < 100.0
    top = int(np.argmin(np.asarray(p0)[:, 2]))
    drift_x = float(abs(final_p[top, 1] - np.asarray(p0)[top, 1]))
    tilt = float(abs(final_p[top, 0]))
    ok_stack = (np.isfinite(traj_p).all() and drift_x < 0.2 and tilt < 0.2
                and float(max_pen) < 0.1)
    e, h0 = 0.7, 0.5 + 4.0
    hit = np.argmax(y > 0.45)
    apex = float(y[hit:hit + 260].min())
    h1 = 0.5 - apex
    rel = abs(h1 - e * e * h0) / (e * e * h0)
    ok_bounce = np.isfinite(y).all() and rel < 0.15
    return dict(pen=(ok_pen, pen), mom=(ok_mom, drift),
                stack=(ok_stack, (drift_x, tilt, float(max_pen))),
                bounce=(ok_bounce, rel))


def synthetic(seed, pen, kick, rebound):
    """A fixed synthetic trajectory: random states, and a bounce curve y
    that falls to rest, rebounds to ``rebound`` above the rest height and
    later dips further, past the apex window."""
    rng = np.random.default_rng(seed)
    traj_p = rng.uniform(-5, 5, (40, 5, 3))
    p0 = rng.uniform(-1, 1, (5, 3))
    final_p = p0 + kick * rng.standard_normal((5, 3))
    v0 = rng.normal(0, 2, (5, 3))
    final_v = v0 + kick * rng.standard_normal((5, 3))
    mass = rng.uniform(0.5, 2.0, 5)
    t = np.arange(900)
    y = np.where(t < 100, -4.0 + 4.5 * (t / 100.0) ** 2, 0.5)
    up = (t >= 100) & (t < 300)
    y = np.where(up, 0.5 - rebound * np.sin(np.pi * (t - 100) / 200.0), y)
    y = np.where(t >= 400, 0.5 - 3.5 * np.sin(np.pi * (t - 400) / 500.0), y)
    return traj_p, final_p, final_v, p0, v0, mass, pen, y


@pytest.mark.parametrize("seed,pen,kick,rebound", [
    (0, 0.03, 0.05, 2.2), (1, 0.08, 0.3, 1.5), (2, 0.2, 0.001, 2.6)])
def test_checks_read_the_jax_tool_values(seed, pen, kick, rebound):
    """The port's check functions against the JAX tool's formulas on the
    same synthetic trajectory: the same verdicts and values.  The bounce
    curve's deeper dip starts 300 steps after the hit, past the 260-step
    apex window, so a wrong window reads another apex."""
    traj_p, final_p, final_v, p0, v0, mass, mp, y = synthetic(
        seed, pen, kick, rebound)
    want = jax_tool_values(traj_p, final_p, final_v, p0, v0, mass, mp, y)
    assert V.penetration_check(traj_p, mp, 40)[:2] == want["pen"]
    assert V.momentum_check(mass, v0, final_v, final_p, traj_p,
                            40)[:2] == want["mom"]
    assert V.stack_check(p0, final_p, traj_p, mp, 40)[:2] == want["stack"]
    assert V.bounce_check(y)[:2] == want["bounce"]
    hit = int(np.argmax(y > 0.45))
    assert y[hit:].min() < y[hit:hit + 260].min()    # the window matters
    bad = traj_p.copy()
    bad[3, 1, 2] = np.nan
    assert not V.penetration_check(bad, mp, 40)[0]


def test_profiles_and_lengths_are_the_jax_tools():
    """The two profiles, rollout lengths and dt of the JAX tool."""
    assert V.PROFILES["production"] == V.SimConfig(max_iter=12,
                                                   solver_eps=1e-5)
    assert V.PROFILES["refine2"] == V.SimConfig(max_iter=12, solver_eps=1e-5,
                                                solver_refine=2)
    assert V.LENGTHS == {"dense": (0.01, 500, 100), "free": (0.01, 200, 50),
                         "stack": (0.01, 300, 80),
                         "bounce": (0.005, 500, 500)}


def test_run_checks_needs_a_card_for_cuda(monkeypatch):
    """The guard defaults to the card and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V.run_checks()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V.main([])
