"""The port's demos (``lcp_physics_tpu_torch/demos``) as integration tests,
as tests/test_demos.py runs the JAX package's: hello_world and chain build
and run; inference and billiards take their loss and gradient through the
port's ``make_step`` and ``rollout``, held to the JAX demos' (f64, CPU;
loss 1e-10, gradient 1e-8), and one step along the gradient lowers the
loss.  sharded_inference's epoch-0 loss and gradient over 4 CPU shards are
held to the JAX demo's at 1e-8."""
import math
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lcp_physics_tpu_torch.core import make_step
from lcp_physics_tpu_torch.demos import billiards, chain, hello_world
from lcp_physics_tpu_torch.demos import inference, sharded_inference
from lcp_physics_tpu_torch.parallel import batched_rollout, make_mesh
from lcp_physics_tpu_torch.physics import run_world
from lcp_physics_tpu_torch.utils import SimConfig
from test_torch_pdipm import one_torch_thread  # noqa: F401

F64 = dict(dtype=torch.float64, device="cpu")


def test_hello_world_runs():
    w = hello_world.make_world(**F64)
    run_world(w, run_time=0.2)
    assert w.t >= 0.2
    for b in w.bodies:          # everything stays inside the walls
        assert 0 <= float(b.p[1]) <= 800 and 0 <= float(b.p[2]) <= 600
    assert hello_world.main(["--device", "cpu", "--time", "0.05"]) == 0


def test_chain_holds_together():
    w = chain.make_world(3, **F64)
    run_world(w, run_time=0.5)
    gaps = chain.joint_gaps(w)
    assert len(gaps) == 2 and max(gaps) < 2.0


def test_inference_loss_and_gradient_match_jax():
    """d loss / d mass over a 40-step rollout (tests/test_demos.py's
    check): equal to the JAX demo's, and a step against it descends."""
    mod = runpy.run_path("demos/inference.py")
    jstatic, jtrue, jstate0 = mod["build_scene"]()
    from lcp_physics_tpu.core import make_step as jmake_step
    from lcp_physics_tpu.core import rollout as jrollout
    from lcp_physics_tpu.utils import SimConfig as JSimConfig
    jstep = jmake_step(jstatic, JSimConfig())
    n = 40

    def jtraj(params):
        return jrollout(jstep, params, jstate0, mod["DT"], n)[1].p[:, 0, :]

    target = jtraj(jtrue)

    def jloss(m):
        pr = jtrue.__class__(**{**jtrue.__dict__,
                                "mass": jtrue.mass.at[0].set(m)})
        return jnp.mean((jtraj(pr) - target) ** 2)

    l_jax, g_jax = jax.jit(jax.value_and_grad(jloss))(1.0)

    static, true_params, state0 = inference.build_scene(**F64)
    step = make_step(static, SimConfig())
    with torch.no_grad():
        tgt = inference.trajectory(step, true_params, state0, n)

    def loss(m):
        params = inference.with_guess(true_params, m, true_params
                                      .restitution[0])
        return ((inference.trajectory(step, params, state0, n) - tgt)
                ** 2).mean()

    m = torch.tensor(1.0, **F64, requires_grad=True)
    l0 = loss(m)
    (g0,) = torch.autograd.grad(l0, m)
    assert float(l0.detach()) > 0 and abs(float(g0)) > 0
    np.testing.assert_allclose(float(l0.detach()), float(l_jax), rtol=1e-10)
    np.testing.assert_allclose(float(g0), float(g_jax), rtol=1e-8)
    with torch.no_grad():
        l1 = loss(m - 0.1 * torch.sign(g0))
    assert float(l1) < float(l0.detach())


def test_billiards_loss_and_gradient_match_jax():
    """d loss / d cue_v over the demo's full 150-step rollout: equal to the
    JAX demo's, and a small step against it descends."""
    mod = runpy.run_path("demos/billiards.py")
    jstatic, jparams, jstate0 = mod["build_scene"]()
    from lcp_physics_tpu.core import WorldState as JWorldState
    from lcp_physics_tpu.core import make_step as jmake_step
    from lcp_physics_tpu.core import rollout as jrollout
    from lcp_physics_tpu.utils import SimConfig as JSimConfig
    jstep = jmake_step(jstatic, JSimConfig())

    def jloss(cue_v):
        s = JWorldState(p=jstate0.p, v=jstate0.v.at[0, 1:3].set(cue_v),
                        t=jstate0.t)
        final, _ = jrollout(jstep, jparams, s, mod["DT"], mod["STEPS"])
        return jnp.sum((final.p[1, 1:3] - mod["GOAL"]) ** 2)

    v0 = np.array([120.0, 10.0])
    l_jax, g_jax = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(v0))

    static, params, state0 = billiards.build_scene(**F64)
    step = make_step(static, SimConfig())
    cue_v = torch.tensor(v0, **F64, requires_grad=True)
    l0 = billiards.loss_fn(step, params, state0, cue_v)
    (g0,) = torch.autograd.grad(l0, cue_v)
    assert float(torch.linalg.vector_norm(g0)) > 0   # the cue reaches it
    np.testing.assert_allclose(float(l0.detach()), float(l_jax), rtol=1e-10)
    np.testing.assert_allclose(g0.numpy(), np.asarray(g_jax), rtol=1e-8)
    with torch.no_grad():
        l1 = billiards.loss_fn(step, params, state0,
                               cue_v - 1e-2 * g0 / g0.norm())
    assert float(l1) < float(l0.detach())


def test_sharded_inference_loss_and_gradient_match_jax():
    """The demo's loss and d loss / d log(mass) at epoch 0 (mass 0.6 of
    the true one), B = 8 worlds over 4 CPU shards, against the JAX demo's
    loss recomputed from its build_scene and randomized_states (1e-8);
    one Adam step at the demo's rate lowers the loss."""
    mod = runpy.run_path("demos/sharded_inference.py")
    from lcp_physics_tpu.parallel import batched_rollout as jbatched_rollout
    from lcp_physics_tpu.parallel import make_batched_step as jbatched_step
    from lcp_physics_tpu.utils import SimConfig as JSimConfig
    B, steps, dt = 8, mod["STEPS"], mod["DT"]
    jstatic, jtrue, jstate0 = mod["build_scene"]()
    jstates = mod["randomized_states"](jstate0, B)
    _, jtraj = jbatched_rollout(jstatic, JSimConfig(), jtrue, jstates, dt,
                                steps)
    jtarget = jtraj.p[:, :, 0, 1:3]
    bstep = jbatched_step(jstatic, JSimConfig())

    def jloss(log_mass):
        p = jtrue.__class__(**{**jtrue.__dict__, "mass": jtrue.mass.at[0]
                               .set(jnp.exp(log_mass))})

        def body(s, _):
            s2, _ = bstep(p, s, dt)
            return s2, s2.p[:, 0, 1:3]

        _, track = jax.lax.scan(body, jstates, None, length=steps)
        return jnp.mean((track - jtarget) ** 2)

    log_m0 = math.log(0.6 * sharded_inference.TRUE_MASS)
    l_jax, g_jax = jax.jit(jax.value_and_grad(jloss))(log_m0)

    si = sharded_inference
    static, true_params, state0 = si.build_scene(**F64)
    states = si.randomized_states(state0, B)
    mesh = make_mesh(["cpu"] * 4)
    with torch.no_grad():
        target = si.ball_track(batched_rollout(
            static, SimConfig(), true_params, states, si.DT, si.STEPS,
            mesh=mesh), "cpu")
    np.testing.assert_allclose(target.numpy(), np.asarray(jtarget),
                               rtol=1e-10, atol=1e-9)
    log_mass = torch.tensor(log_m0, **F64, requires_grad=True)
    l0, g0 = si.loss_and_grad(log_mass, static, true_params, states, target,
                              mesh)
    np.testing.assert_allclose(float(l0), float(l_jax), rtol=1e-8)
    np.testing.assert_allclose(float(g0), float(g_jax), rtol=1e-8)
    opt = torch.optim.Adam([log_mass], lr=0.1)
    log_mass.grad = g0
    opt.step()
    l1, _ = si.loss_and_grad(log_mass, static, true_params, states, target,
                             mesh)
    assert float(l1) < float(l0)


def test_sharded_inference_main_on_cpu():
    """``main`` on a 2-entry CPU mesh, 4 worlds, 2 epochs: the mass moves
    from its 0.6 start towards the true one."""
    mass = sharded_inference.main(["--device", "cpu", "--shards", "2",
                                   "--worlds", "4", "--epochs", "2"])
    assert 0.6 * sharded_inference.TRUE_MASS < mass < 2.0 * 1.3
