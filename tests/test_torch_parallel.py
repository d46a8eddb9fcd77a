"""The port's world-batch sharding (``lcp_physics_tpu_torch.parallel``) and
its entry analogs (``lcp_physics_tpu_torch.entry``) against the JAX package
(f64, CPU), case by case after tests/test_parallel.py.

The JAX side shards over conftest's 8 virtual CPU devices; the port's mesh
lists the CPU as often (``make_mesh(["cpu"] * 8)``), one worker thread per
entry.  A port shard is stepped on its own, so its gates decide per shard:
a sharded step equals the port's unsharded step at ``batch_tile = B /
shards`` exactly, and JAX's sharded step (whose ``lax.cond`` reduces over
the whole batch) at JAX's own 1e-9.
"""
import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from lcp_physics_tpu.core import WorldState as JWorldState
from lcp_physics_tpu.parallel import batched_rollout as jax_batched_rollout
from lcp_physics_tpu.parallel import make_batched_step as jax_batched_step
from lcp_physics_tpu.parallel import make_sharded_step as jax_sharded_step
from lcp_physics_tpu.parallel import replicate as jax_replicate
from lcp_physics_tpu.parallel import shard_worlds as jax_shard_worlds
from lcp_physics_tpu.parallel import tile_state as jax_tile_state
from lcp_physics_tpu.utils import SimConfig as JaxSimConfig

from lcp_physics_tpu_torch.core import (params_from_numpy, rollout,
                                        state_from_numpy)
from lcp_physics_tpu_torch.core import step as core_step
from lcp_physics_tpu_torch.entry import dryrun_multichip, entry
from lcp_physics_tpu_torch.lcp import pdipm
from lcp_physics_tpu_torch.parallel import (WORLD_AXIS, batched_rollout,
                                            gather, make_batched_step,
                                            make_mesh, make_sharded_step,
                                            replicate, shard_worlds)
from lcp_physics_tpu_torch.utils import SimConfig, bump
from test_parallel import batch_of_drops
from test_step import DT, G
from test_torch_pdipm import one_torch_thread  # noqa: F401
from test_torch_step import port_static

F64 = dict(dtype=torch.float64, device="cpu")


def cpu_mesh(k=8):
    return make_mesh([torch.device("cpu")] * k)


def jax_mesh(k=8):
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:k]), ("worlds",))


def drops(B, heights=None, vy=0.0):
    """tests/test_parallel.py::batch_of_drops (heights linspace(-4, -2.5,
    B) unless given, falling at ``vy``) in both packages: (jstatic,
    jparams, jstates) and the port's (static, params, states)."""
    jstatic, jparams, jstates = batch_of_drops(B)
    if heights is not None:
        jstates = JWorldState(p=jstates.p.at[:, 0, 2].set(heights),
                              v=jstates.v.at[:, 0, 2].set(vy), t=jstates.t)
    return (jstatic, jparams, jstates), (
        port_static(jstatic), params_from_numpy(jparams, **F64),
        state_from_numpy(jstates, **F64))


# Shards 0-3 rest on the ground (touching), shards 4-7 hang far above it
# (contact-free for the whole run): each shard's gates decide for it.
MIXED = np.repeat([-2.0, -2.0, -2.0, -2.0, -30.0, -30.0, -30.0, -30.0], 2)


def assert_states(got, ref, tol=0.0):
    for k in ("p", "v", "t"):
        g, r = getattr(got, k), getattr(ref, k)
        if isinstance(r, torch.Tensor):
            torch.testing.assert_close(g, r, rtol=0, atol=tol, msg=k)
        else:
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                       rtol=0, atol=tol, err_msg=k)


def test_mesh_needs_a_card_or_devices():
    """``make_mesh()`` takes every visible card and raises without one;
    a mesh on the CPU is asked for by name, a device may repeat."""
    if torch.cuda.is_available():
        assert make_mesh().size == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    mesh = cpu_mesh()
    assert mesh.size == 8 and mesh.axis == WORLD_AXIS
    assert set(mesh.devices) == {torch.device("cpu")}


@pytest.mark.parametrize("post_stabilization,heights", [
    (False, None), (True, MIXED)], ids=["drops", "mixed-post-stab"])
def test_sharded_step_matches_jax_and_tiles(post_stabilization, heights):
    """B = 16 over 8 shards, 10 steps: JAX's sharded step at 1e-9 and the
    port's unsharded step at batch_tile = 2 exactly (diagnostics too).
    In the mixed scene the hanging shards take the closed form while the
    touching ones solve their LCPs, as tiles do."""
    B = 16
    (jstatic, jparams, jstates), (static, params, states) = drops(B, heights)
    jcfg = JaxSimConfig(post_stabilization=post_stabilization)
    cfg = SimConfig(post_stabilization=post_stabilization)
    jm = jax_mesh()
    jstep, _, _ = jax_sharded_step(jstatic, jm, jcfg)
    js = jax_shard_worlds(jstates, jm)
    jp = jax_replicate(jparams, jm)

    mesh = cpu_mesh()
    step, place_states, place_params = make_sharded_step(static, mesh, cfg)
    shards, p_list = place_states(states), place_params(params)
    tiled = make_batched_step(static, dataclasses.replace(cfg, batch_tile=2))
    ref = states
    for _ in range(10):
        js, _ = jstep(jp, js, DT)
        outs = step(p_list, shards, DT)
        shards = [o[0] for o in outs]
        ref, ref_d = tiled(params, ref, DT)
        got = gather(shards, "cpu")
        assert_states(got, ref)
        got_d = gather([o[1] for o in outs], "cpu")
        for g, r in zip(got_d, ref_d):
            torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert_states(got, js, 1e-9)
    if heights is not None:
        assert float((got.p[:8, 0, 2] + 2.0).abs().max()) < 0.05  # resting
        torch.testing.assert_close(got.v[8:, 0, 2],            # falling
                                   torch.full((8,), 10 * DT * G, **F64))


ROLLOUT_CASES = [(False, False), (True, False), (False, True)]


@pytest.mark.parametrize("with_diagnostics,remat", ROLLOUT_CASES,
                         ids=["plain", "diagnostics", "remat"])
def test_batched_rollout_sharded(with_diagnostics, remat):
    """B = 8, 30 steps: ``batched_rollout(mesh=)`` against the unsharded
    rollout at batch_tile = 1 exactly and JAX's sharded rollout at 1e-9
    (with the reduced diagnostics, and under remat, whose gradient equals
    the plain sharded rollout's)."""
    B, n = 8, 30
    (jstatic, jparams, jstates), (static, params, states) = drops(B)
    kw = dict(with_diagnostics=with_diagnostics, remat=remat)
    jout = jax_batched_rollout(jstatic, JaxSimConfig(), jparams, jstates,
                               DT, n, mesh=jax_mesh(), **kw)
    mesh = cpu_mesh()
    outs = batched_rollout(static, SimConfig(), params, states, DT, n,
                           mesh=mesh, **kw)
    final = gather([o[0] for o in outs], "cpu")
    traj = gather([o[1] for o in outs], "cpu", dim=1)
    ref = rollout(make_batched_step(static, SimConfig(batch_tile=1)), params,
                  states, DT, n, with_diagnostics=with_diagnostics)
    assert_states(final, ref[0])
    assert_states(traj, ref[1])
    assert_states(final, jout[0], 1e-9)
    assert_states(traj, jout[1], 1e-9)
    if with_diagnostics:
        rd = gather([o[2] for o in outs], "cpu")
        for k in rd._fields:
            torch.testing.assert_close(getattr(rd, k), getattr(ref[2], k),
                                       rtol=0, atol=0)
            np.testing.assert_allclose(getattr(rd, k).numpy(),
                                       np.asarray(getattr(jout[2], k)),
                                       atol=1e-9, err_msg=k)
    if remat:
        def grad(remat_):
            pr = dataclasses.replace(params, mass=params.mass.clone()
                                     .requires_grad_(True))
            o = batched_rollout(static, SimConfig(), pr, states, DT, 10,
                                mesh=mesh, remat=remat_)
            loss = (gather([x[0] for x in o], "cpu").p ** 2).mean()
            return torch.autograd.grad(loss, pr.mass)[0]
        torch.testing.assert_close(grad(True), grad(False), rtol=1e-12,
                                   atol=0)


@pytest.mark.parametrize("params_batched", [False, True],
                         ids=["shared", "per-world"])
@pytest.mark.parametrize("bounce", [False, True], ids=["drops", "bounce"])
def test_gradient_of_sharded_batch_loss(bounce, params_batched):
    """Parameter gradients of mean(final y^2) after a 20-step rollout over
    8 shards against ``jax.grad`` of the JAX sharded loss: restitution at
    1e-9, mass at 1e-8 (tests/test_parallel.py's tolerances).  Shared
    parameters are replicated and their gradient summed over the shards;
    per-world ones are sharded with the worlds.  tests/test_parallel.py's
    drops do not reach the ground in 20 steps (no restitution gradient);
    the bounce scene throws the balls at it."""
    B = 8
    (jstatic, jparams, jstates), (static, params, states) = drops(
        B, *((np.linspace(-3.0, -2.2, B), 8.0) if bounce else ()))
    if params_batched:
        jparams = jax.tree.map(
            lambda x: jnp.broadcast_to(x[None], (B,) + x.shape), jparams)
        jparams = jparams.__class__(**{**jparams.__dict__, "restitution":
                                       jnp.stack([jnp.full((2,), 0.1 + 0.1 * k)
                                                  for k in range(B)])})
        params = params_from_numpy(jparams, **F64)
    jm = jax_mesh()

    def jloss(p, s):
        final, _ = jax_batched_rollout(jstatic, JaxSimConfig(), p, s, DT, 20,
                                       params_batched=params_batched)
        return jnp.mean(final.p[:, 0, 2] ** 2)

    jp = (jax_shard_worlds if params_batched else jax_replicate)(jparams, jm)
    jg = jax.jit(jax.grad(jloss))(jp, jax_shard_worlds(jstates, jm))

    for x in (params.mass, params.restitution):
        x.requires_grad_(True)
    outs = batched_rollout(static, SimConfig(), params, states, DT, 20,
                           params_batched=params_batched, mesh=cpu_mesh())
    final = gather([o[0] for o in outs], "cpu")
    loss = (final.p[:, 0, 2] ** 2).mean()
    # a shard with no contact leaves restitution out of its graph
    g_mass, g_rest = (torch.zeros_like(x) if g is None else g for g, x in zip(
        torch.autograd.grad(loss, (params.mass, params.restitution),
                            allow_unused=True),
        (params.mass, params.restitution)))
    np.testing.assert_allclose(g_rest.numpy(), np.asarray(jg.restitution),
                               atol=1e-9)
    np.testing.assert_allclose(g_mass.numpy(), np.asarray(jg.mass),
                               atol=1e-8)
    assert (float(g_rest.abs().max()) > 1e-3) == bounce


def test_shapes_that_do_not_divide_raise():
    (_, _, _), (static, params, states) = drops(6)
    mesh = cpu_mesh(4)
    with pytest.raises(ValueError, match="does not split"):
        shard_worlds(states, mesh)
    _, place_states, _ = make_sharded_step(static, mesh)
    with pytest.raises(ValueError, match="does not split"):
        place_states(states)
    with pytest.raises(ValueError, match="does not split"):
        batched_rollout(static, SimConfig(), params, states, DT, 2,
                        mesh=mesh)


def test_one_device_listed_twice():
    """A mesh that lists the CPU twice gives the one-entry mesh's answer
    (the shards are the tiles of batch_tile = B / 2; every world here
    takes the same branches in both), and ``replicate`` hands every entry
    the same parameter tensors."""
    B = 8
    (_, _, _), (static, params, states) = drops(B)
    one = batched_rollout(static, SimConfig(), params, states, DT, 20,
                          mesh=cpu_mesh(1))
    two = batched_rollout(static, SimConfig(), params, states, DT, 20,
                          mesh=cpu_mesh(2))
    assert len(one) == 1 and len(two) == 2
    assert_states(gather([o[0] for o in two], "cpu"), one[0][0])
    reps = replicate(params, cpu_mesh(2))
    assert all(r.mass is params.mass for r in reps)


def test_counters_under_threads():
    """Four threads step shards concurrently: the step's and the IPM
    loop's host-read counts equal the serial run's.  Then a stress test of
    the counters' lock: 16 threads bumping one key with a 1 us switch
    interval lose no count."""
    B = 8
    (_, _, _), (static, params, states) = drops(B, MIXED[::2])
    mesh = cpu_mesh(4)
    step, place_states, place_params = make_sharded_step(static, mesh)
    shards, p_list = place_states(states), place_params(params)
    bstep = make_batched_step(static)

    def reads():
        return dict(core_step.HOST_READS, **pdipm.HOST_READS)

    def run(concurrent):
        s = shards
        before = reads()
        for _ in range(5):
            if concurrent:
                s = [o[0] for o in step(p_list, s, DT)]
            else:
                s = [bstep(p, x, DT)[0] for p, x in zip(p_list, s)]
        after = reads()
        return {k: after[k] - before[k] for k in after}, s

    serial, s_serial = run(False)
    threaded, s_threaded = run(True)
    assert serial == threaded and serial["contact_gate"] == 20
    assert_states(gather(s_threaded, "cpu"), gather(s_serial, "cpu"))

    counts = {"k": 0}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [bump(counts, "k") for _ in range(2000)])
            for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert counts["k"] == 16 * 2000


def test_entry_step_matches_jax():
    """``entry()``'s batched step (B = 4 worlds of 64 circles, c_max =
    128), one f64 step, against the JAX step built from
    ``__graft_entry__._scene``: a contact-free scene, so both take the
    closed form."""
    jstatic, jparams, jstate = __graft_entry__._scene(64, 128, jnp.float64)
    jstep = jax.jit(jax_batched_step(jstatic, JaxSimConfig(
        max_iter=12, solver_eps=1e-5)))
    jout, jdiag = jstep(jparams, jax_tile_state(jstate, 4), 0.01)
    assert int(jdiag.n_contacts.max()) == 0
    fn, (params, states) = entry(device="cpu", dtype=torch.float64)
    reads = core_step.HOST_READS["contact_gate"]
    out = fn(params, states)
    assert core_step.HOST_READS["contact_gate"] == reads + 1
    assert out.p.shape == (4, 64, 3)
    assert_states(out, jout, 1e-12)


def test_dryrun_multichip_matches_jax():
    """``dryrun_multichip(4, ["cpu"] * 4)`` at f64 against JAX's sharded
    training step recomputed from ``__graft_entry__._scene`` on 4 of
    conftest's devices: the loss at 1e-12; d loss / d mass is zero in
    exact arithmetic (no contact; the closed form's mass cancels), so
    both sides' maxima are round-off under 1e-12."""
    jstatic, jparams, jstate = __graft_entry__._scene(4, 8, jnp.float64)
    jm = jax_mesh(4)
    bstep = jax_batched_step(jstatic, JaxSimConfig(max_iter=8,
                                                   solver_eps=1e-4))

    def jloss(p, s):
        def body(x, _):
            return bstep(p, x, 0.01)[0], ()
        out, _ = jax.lax.scan(body, s, None, length=3)
        return jnp.mean(out.p ** 2)

    jval, jg = jax.jit(jax.value_and_grad(jloss))(
        jax_replicate(jparams, jm),
        jax_shard_worlds(jax_tile_state(jstate, 8), jm))
    loss, g_mass = dryrun_multichip(4, ["cpu"] * 4, dtype=torch.float64)
    np.testing.assert_allclose(loss, float(jval), rtol=1e-12)
    assert g_mass <= 1e-12 and float(jnp.abs(jg.mass).max()) <= 1e-12
    assert dryrun_multichip(1, ["cpu"], dtype=torch.float64)[0] == loss
    with pytest.raises(ValueError):
        dryrun_multichip(2, ["cpu"])
