"""The port's object layer (``lcp_physics_tpu_torch.physics``) vs the JAX
package's (f64, CPU): the World scenarios of tests/test_world_api.py and
tests/test_hull_scenarios.py, built from the same body lists in both
packages and stepped side by side through ``World.step`` (the host
restore-and-retry included): states 1e-8 after the first step and 1e-6
after three; jointed or stabilized scenes 1e-10 after two.  Then the
reference API around the step: accessors, collisions, the engine's step
cache, the construction checks and the exhaustion warning.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

import lcp_physics_tpu.physics as jphys
import lcp_physics_tpu_torch.physics as tphys
from test_torch_pdipm import one_torch_thread  # noqa: F401

F64 = dict(dtype=torch.float64, device="cpu")


def world(ph, bodies, constraints=(), **kw):
    """A World of ``ph`` (either package), the port's at f64 on the CPU."""
    if ph is tphys:
        kw = dict(kw, **F64)
    return ph.World(bodies, constraints, **kw)


def ground(ph, y=20.0, w=100.0):
    g = ph.Rect([0.0, 50.0, y + 1.0], [w, 2.0], mass=100.0)
    return g, ph.TotalConstraint(g)


# Each scene builds its World from ``ph`` (the JAX or the port's physics
# package); ``joint`` marks the jointed or stabilized ones.
def s_ball_ground(ph):
    ball = ph.Circle([50.0, 18.9], rad=1.0, restitution=0.6)
    g, tc = ground(ph)
    w = world(ph, [ball, g], [tc], gravity=(0.0, 10.0))
    w.set_v([0.0, 0.0, 12.0, 0.0, 0.0, 0.0])
    return w


def s_external_force(ph):
    c = ph.Circle([0.0, 0.0], rad=1.0, mass=2.0)
    c.add_force(ph.ExternalForce(ph.hor_impulse, multiplier=4.0))
    c2 = ph.Circle([5.0, 0.0], rad=1.0)
    c2.add_force(ph.ExternalForce(ph.down_force, multiplier=3.0))
    return world(ph, [c, c2])


def s_joint_chain(ph):
    b1 = ph.Circle([10.0, 0.0], rad=0.5)
    b2 = ph.Circle([20.0, 0.0], rad=0.5)
    return world(ph, [b1, b2], [ph.Joint(b1, None, [0.0, 0.0]),
                                ph.Joint(b1, b2, [15.0, 0.0])],
                 gravity=(0.0, 10.0))


def s_axis(ph):
    c = ph.Circle([5.0, 5.0], rad=1.0)
    c2 = ph.Circle([9.0, 5.0], rad=1.0)
    return world(ph, [c, c2], [ph.XConstraint(c), ph.YConstraint(c2),
                               ph.RotConstraint(c2)], gravity=(10.0, 10.0))


def s_fixed_joint(ph):
    a = ph.Rect([0.0, 0.0], [2.0, 2.0])
    b = ph.Rect([3.0, 0.0], [2.0, 2.0])
    return world(ph, [a, b], [ph.FixedJoint(a, b)], gravity=(0.0, 10.0))


def s_box_stack(ph):
    boxes = [ph.Rect([50.0, 17.0 - 2.05 * k], [4.0, 2.0], fric_coeff=0.8,
                     restitution=0.0) for k in range(3)]
    g, tc = ground(ph)
    return world(ph, boxes + [g], [tc], gravity=(0.0, 10.0), dt=1 / 60)


def s_post_stab(ph):
    ball = ph.Circle([10.0, 0.0], rad=0.5)
    return world(ph, [ball], [ph.Joint(ball, None, [0.0, 0.0])],
                 gravity=(0.0, 10.0), post_stab=True, dt=1 / 60)


def s_ode_handler(ph):
    ball = ph.Circle([50.0, 18.9], rad=1.0)
    g, tc = ground(ph)
    return world(ph, [ball, g], [tc], contact_callback="ode",
                 gravity=(0.0, 10.0))


def s_tunnel(ph):
    wall = ph.Rect([1.0, 0.0], [1.0, 4.0])
    ball = ph.Circle([-0.9, 0.0], rad=0.2)
    w = world(ph, [ball, wall], [ph.TotalConstraint(wall)], dt=0.01,
              speculative=False)
    w.set_v([0.0, 150.0, 0.0, 0.0, 0.0, 0.0])
    return w


def s_speculative(ph):
    wall = ph.Rect([1.0, 0.0], [1.0, 4.0])
    ball = ph.Circle([-0.9, 0.0], rad=0.2, restitution=0.5)
    w = world(ph, [ball, wall], [ph.TotalConstraint(wall)], dt=0.01)
    w.set_v([0.0, 150.0, 0.0, 0.0, 0.0, 0.0])
    return w


def s_rotated_box(ph):
    box = ph.Rect([0.4, 50.0, 17.5], [4.0, 2.0], restitution=0.1,
                  fric_coeff=0.8)
    g = ph.Rect([0.0, 50.0, 21.0], [100.0, 2.0], mass=100.0)
    w = world(ph, [box, g], [ph.TotalConstraint(g)], gravity=(0.0, 10.0),
              dt=1 / 60)
    w.set_v([0.0, 0.0, 6.0, 0.0, 0.0, 0.0])
    return w


def s_pentagon(ph):
    ang = np.linspace(0, 2 * np.pi, 5, endpoint=False) + np.pi / 2
    verts = np.stack([2 * np.cos(ang), 2 * np.sin(ang)], -1)
    pent = ph.Hull([50.0, 17.0], verts, fric_coeff=0.9, restitution=0.0)
    g = ph.Rect([0.0, 50.0, 21.0], [100.0, 2.0], mass=100.0)
    return world(ph, [pent, g], [ph.TotalConstraint(g)],
                 gravity=(0.0, 10.0), dt=1 / 60, strict_no_penetration=False)


def s_wedge(ph):
    left = ph.Rect([0.6, 44.0, 18.0], [12.0, 2.0], mass=50.0)
    right = ph.Rect([-0.6, 56.0, 18.0], [12.0, 2.0], mass=50.0)
    ball = ph.Circle([50.0, 12.5], 1.5, restitution=0.1, fric_coeff=0.4)
    w = world(ph, [ball, left, right], [ph.TotalConstraint(left),
                                        ph.TotalConstraint(right)],
              gravity=(0.0, 10.0), dt=1 / 60)
    w.set_v([0.0, 0.0, 8.0] + [0.0] * 6)
    return w


def s_hull_momentum(ph):
    a = ph.Rect([0.0, -1.05, 0.0], [2.0, 2.0], restitution=0.8,
                fric_coeff=0.0)
    b = ph.Rect([0.0, 1.05, 0.0], [2.0, 2.0], restitution=0.8,
                fric_coeff=0.0)
    w = world(ph, [a, b], gravity=(0.0, 0.0), dt=1 / 60)
    w.set_v([0.0, 3.0, 0.0, 0.0, -3.0, 0.0])
    return w


SCENES = {f.__name__[2:]: f for f in (
    s_ball_ground, s_external_force, s_joint_chain, s_axis, s_fixed_joint,
    s_box_stack, s_post_stab, s_ode_handler, s_tunnel, s_speculative,
    s_rotated_box, s_pentagon, s_wedge, s_hull_momentum)}
JOINTED = {"joint_chain", "axis", "fixed_joint", "post_stab"}


def state_of(w):
    return (np.asarray(w.get_p(), dtype=float),
            np.asarray(w.get_v(), dtype=float))


@pytest.mark.parametrize("name", list(SCENES))
def test_world_scene_matches_jax(name):
    """Three World.step calls of each scene in both packages."""
    jw, tw = SCENES[name](jphys), SCENES[name](tphys)
    assert tw.world_state.p.dtype == torch.float64
    for k in range(3):
        jw.step()
        tw.step()
        tol = 1e-10 if name in JOINTED and k < 2 else \
            (1e-8 if k == 0 else 1e-6)
        (jp, jv), (tp, tv) = state_of(jw), (tw.get_p().numpy(),
                                            tw.get_v().numpy())
        np.testing.assert_allclose(tp, jp, rtol=tol, atol=tol,
                                   err_msg=f"p, step {k}")
        np.testing.assert_allclose(tv, jv, rtol=tol, atol=tol,
                                   err_msg=f"v, step {k}")
        assert tw.t == pytest.approx(jw.t, abs=1e-15)
    for b_j, b_t in zip(jw.bodies, tw.bodies):
        np.testing.assert_allclose(b_t.p.numpy(), np.asarray(b_j.p),
                                   rtol=1e-6, atol=1e-6)


def test_world_invariants():
    """The invariants of tests/test_world_api.py on the port: the backtrack
    stops the tunnelling ball short of the wall with a halved step, the
    speculative world takes the full step and rebounds at e * v, and the
    pinned axes stay put."""
    w = s_tunnel(tphys)
    w.step()
    assert w.t <= 0.005 + 1e-12
    assert float(w.max_penetration()) <= w.tol
    assert float(w.bodies[0].p[1]) < 0.3
    w = s_speculative(tphys)
    w.step()
    assert w.t == pytest.approx(0.01)
    assert float(w.bodies[0].v[1]) == pytest.approx(-75.0, rel=1e-3)
    w = s_axis(tphys)
    for _ in range(5):
        w.step()
    np.testing.assert_allclose(float(w.bodies[0].p[1]), 5.0, atol=1e-8)
    np.testing.assert_allclose(float(w.bodies[1].p[2]), 5.0, atol=1e-8)
    np.testing.assert_allclose(float(w.bodies[1].p[0]), 0.0, atol=1e-8)


def test_bodies_and_accessors_match_jax():
    """Construction (inertias, the hull's centroid shift), the accessors
    (get_p, M, Je, restitutions, apply_forces) and collisions in the
    reference format, against JAX."""
    for ph in (jphys, tphys):
        c = ph.Circle([10.0, 5.0], rad=2.0, mass=3.0)
        assert c.ang_inertia == pytest.approx(6.0)
        r = ph.Rect([0.0, 0.0], [4.0, 2.0], mass=2.0)
        assert r.ang_inertia == pytest.approx(2.0 * 20 / 12)
    h_j = jphys.Hull([0.0, 0.0], [[0, 0], [2, 0], [2, 2], [0, 1.5]])
    h_t = tphys.Hull([0.0, 0.0], [[0, 0], [2, 0], [2, 2], [0, 1.5]])
    np.testing.assert_allclose(h_t.p.numpy(), np.asarray(h_j.p), atol=1e-15)
    np.testing.assert_allclose(h_t.verts, h_j.verts, atol=1e-15)
    assert h_t.ang_inertia == pytest.approx(h_j.ang_inertia, rel=1e-14)
    jw, tw = s_ball_ground(jphys), s_ball_ground(tphys)
    for f in ("get_p", "get_v", "M", "Je", "restitutions"):
        np.testing.assert_allclose(getattr(tw, f)().numpy(),
                                   np.asarray(getattr(jw, f)()), atol=1e-15,
                                   err_msg=f)
    np.testing.assert_allclose(tw.apply_forces(0.0).numpy(),
                               np.asarray(jw.apply_forces(0.0)), atol=1e-15)
    jc, tc = jw.find_collisions(), tw.find_collisions()
    assert len(tc) == len(jc) >= 1
    for ((jn, jp1, jp2, jd), ja, jb), ((tn, tp1, tp2, td), ta, tb) in zip(
            jc, tc):
        assert (ta, tb) == (ja, jb)
        for x, y in ((tn, jn), (tp1, jp1), (tp2, jp2), (td, jd)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-12)
    pairs = tw.broadphase_pairs()
    np.testing.assert_array_equal(pairs, jw.broadphase_pairs())


def test_engine_post_stabilization_matches_jax():
    """engine.post_stabilization(world) projects the accumulated joint
    drift away, as in JAX (1e-10)."""
    def scene(ph):
        ball = ph.Circle([10.0, 0.0], rad=0.5)
        return world(ph, [ball], [ph.Joint(ball, None, [0.0, 0.0])],
                     gravity=(0.0, 10.0), dt=1 / 60)
    jw, tw = scene(jphys), scene(tphys)
    for _ in range(10):
        jw.step()
        tw.step()
    drift = lambda w: abs(np.linalg.norm(np.asarray(w.get_p())[1:3]) - 10.0)
    before = drift(tw)
    jw.engine.post_stabilization(jw)
    tw.engine.post_stabilization(tw)
    np.testing.assert_allclose(tw.get_p().numpy(), np.asarray(jw.get_p()),
                               atol=1e-10)
    assert drift(tw) < before and drift(tw) < 1e-3


def test_ode_handler_gradient_matches_jax():
    """OdeContactHandler detaches the contact geometry; the gradient of a
    short rollout through the engine's config still flows through the
    dynamics, finite and equal to JAX's."""
    from lcp_physics_tpu.core import make_step as jmake_step
    from lcp_physics_tpu.core import rollout as jrollout
    from lcp_physics_tpu_torch.core import make_step, rollout

    def setup(ph):
        ball = ph.Circle([0.0, 0.0], rad=1.0)
        g = ph.Rect([0.0, 2.5], [50.0, 2.0])
        w = world(ph, [ball, g], [ph.TotalConstraint(g)],
                  contact_callback=ph.OdeContactHandler(),
                  gravity=(0.0, 10.0))
        return w, w.engine._config(w)

    jw, jcfg = setup(jphys)
    static, params, state = jw.functional()
    jstep = jmake_step(static, jcfg)

    def jloss(y0):
        s = state.__class__(p=state.p.at[0, 2].set(y0), v=state.v,
                            t=state.t)
        return jrollout(jstep, params, s, jw.dt, 8)[0].p[0, 2]

    g_jax = float(jax.jit(jax.grad(jloss))(0.0))
    tw, tcfg = setup(tphys)
    static, params, state = tw.functional()
    y0 = torch.tensor(0.0, **F64, requires_grad=True)
    pick = torch.zeros_like(state.p)
    pick[0, 2] = 1.0
    s = state.__class__(p=state.p * (1 - pick) + y0 * pick, v=state.v,
                        t=state.t)
    out = rollout(make_step(static, tcfg), params, s, tw.dt, 8)[0].p[0, 2]
    (g,) = torch.autograd.grad(out, y0)
    assert np.isfinite(float(g))
    np.testing.assert_allclose(float(g), g_jax, rtol=1e-8)


def test_dt_halving_budget_warns_like_jax():
    """max_dt_halvings = 0 with a tunnelling ball: both packages warn and
    accept the full, penetrating step."""
    def scene(ph):
        wall = ph.Rect([1.0, 0.0], [1.0, 4.0])
        ball = ph.Circle([-0.9, 0.0], rad=0.2)
        w = world(ph, [ball, wall], [ph.TotalConstraint(wall)], dt=0.01,
                  max_dt_halvings=0, speculative=False)
        w.set_v([0.0, 150.0, 0.0, 0.0, 0.0, 0.0])
        return w
    for ph in (jphys, tphys):
        w = scene(ph)
        with pytest.warns(RuntimeWarning, match="halving budget exhausted"):
            w.step()
        assert float(w.max_penetration()) > w.tol
    from lcp_physics_tpu_torch.physics import world as tworld
    w = scene(tphys)
    reads = tworld.HOST_READS["world_step"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        w.step()
    assert tworld.HOST_READS["world_step"] == reads + 1


def test_construction_checks():
    """strict_no_penetration rejects an overlapping scene unless the pair
    is excluded; a concave hull and fric_dirs != 2 raise; the 'ode'
    string selects the ODE handler."""
    a, b = tphys.Circle([0.0, 0.0], rad=1.0), tphys.Circle([0.5, 0.0],
                                                           rad=1.0)
    with pytest.raises(AssertionError):
        world(tphys, [a, b])
    a, b = tphys.Circle([0.0, 0.0], rad=1.0), tphys.Circle([0.5, 0.0],
                                                           rad=1.0)
    a.add_no_contact(b)
    assert float(world(tphys, [a, b]).max_penetration()) == 0.0
    with pytest.raises(ValueError, match="convex"):
        tphys.Hull([0.0, 0.0], [[0, 0], [4, 0], [4, 4], [2, 1], [0, 4]])
    tphys.Hull([0.0, 0.0], [[0, 0], [0, 4], [4, 4], [4, 0]])
    with pytest.raises(ValueError, match="fric_dirs"):
        world(tphys, [tphys.Circle([0.0, 0.0], rad=1.0)], fric_dirs=4)
    w = s_ode_handler(tphys)
    assert isinstance(w.contact_callback, tphys.OdeContactHandler)


def test_step_cache_reuse_and_bound():
    """invalidate_scene() on an unchanged scene keeps the engine's step
    (the force closure is reused); the cache is an LRU of CACHE_MAX."""
    ball = tphys.Circle([50.0, 10.0], rad=1.0)
    ball.add_force(tphys.ExternalForce(tphys.down_force, multiplier=10.0))
    g, tc = ground(tphys)
    w = world(tphys, [ball, g], [tc], gravity=(0.0, 10.0))
    w.step()
    assert len(w.engine._cache) == 1
    step0 = next(iter(w.engine._cache.values()))
    for _ in range(2):
        w.invalidate_scene()
        w.step()
    assert len(w.engine._cache) == 1
    assert next(iter(w.engine._cache.values())) is step0
    e = tphys.PdipmEngine()
    cap = tphys.PdipmEngine.CACHE_MAX
    for k in range(cap + 3):
        e.max_iter = k + 1         # a new SimConfig value each time
        e.compiled_step(w)
    assert len(e._cache) == cap
    assert (w.scene_static, e._config(w)) in e._cache


def test_run_world_and_fixed_dt():
    ball = tphys.Circle([50.0, 18.9], rad=1.0, restitution=0.0)
    g, tc = ground(tphys)
    w = world(tphys, [ball, g], [tc], gravity=(0.0, 10.0))
    w.step(fixed_dt=True)
    assert w.t == pytest.approx(w.dt, abs=1e-9)
    tphys.run_world(w, run_time=0.2)
    assert w.t >= 0.2
