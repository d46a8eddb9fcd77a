"""The plain reference against the port at float64, in every cell of a
loop: steps of each ``step`` cell, the LCP solves of each ``lcp`` cell,
and each ``train`` cell's loss and gradients.  At float64 both run the
same algorithm, so they agree to rounding."""
import dataclasses

import numpy as np
import pytest
import torch

from benchmark.harness import check, generate, program
from benchmark.reference import lcp as ref_lcp
from benchmark.reference import train as ref_train
from benchmark.reference import world as ref_world
from benchmark.tests.helpers import cells, tiny_cell

F64 = torch.float64


def _f64(cell):
    c = tiny_cell(cell)
    c.config["dtype"] = "float64"
    return c


def _world(conf):
    return ref_world.params(conf, F64, "cpu")


def _solver(conf):
    return check.solver(conf)


@pytest.mark.parametrize("cell", cells("step"))
def test_step_agrees_with_the_port(cell):
    c = _f64(cell)
    conf = c.config
    d = generate.draw(c.traffic, conf, 31)
    p = torch.as_tensor(d["p"][0], dtype=F64)
    v = torch.as_tensor(d["v"][0], dtype=F64)
    static, params = program.scene(conf, "cpu")
    step = program.batched_step(static, conf)
    s = program.WorldState(p, v, torch.zeros(p.shape[0], dtype=F64))
    for _ in range(3):
        out, _ = step(params, s, conf["dt"])
        p_ref, v_ref = ref_world.step(_world(conf), s.p, s.v, conf["dt"],
                                      _solver(conf))
        torch.testing.assert_close(v_ref, out.v, rtol=0, atol=1e-10)
        torch.testing.assert_close(p_ref, out.p, rtol=0, atol=1e-12)
        s = out


@pytest.mark.parametrize("cell", cells("lcp"))
def test_lcp_solve_agrees_with_the_port(cell):
    c = _f64(cell)
    conf = c.config
    d = generate.draw(c.traffic, conf, 32)
    blk = ref_world.blocks(_world(conf), torch.as_tensor(d["p"][0], dtype=F64),
                           torch.as_tensor(d["v"][0], dtype=F64), conf["dt"])
    lcp = conf["lcp"]
    sol = program.lcp_solve_full(
        blk["Q"], blk["p"], blk["G"], blk["h"], None, None,
        program.ConeF(blk["mu"], blk["valid"], 2), row_mask=blk["row_mask"],
        gamma_rows=conf["c_max"], q_is_diag=True, **lcp)
    ref = ref_lcp.solve(
        blk["Q"], blk["p"], blk["G"], blk["h"], blk["F"], blk["row_mask"],
        max_iter=lcp["max_iter"], tol=lcp["tol"],
        stall_lim=lcp["not_improved_lim"], solver_dtype=F64)
    assert int(blk["n_contacts"].sum()) > 0
    torch.testing.assert_close(ref.z, sol.z, rtol=0, atol=1e-9)
    assert np.mean(ref.iters.numpy() == sol.iters.numpy()) >= 0.9


@pytest.mark.parametrize("cell", cells("train"))
def test_inference_gradients_agree_with_the_port(cell):
    c = _f64(cell)
    conf, traffic = c.config, c.traffic
    d = generate.draw(traffic, conf, 33)
    p0 = torch.as_tensor(d["p"][0], dtype=F64)
    v0 = torch.as_tensor(d["v"][0], dtype=F64)
    guess = {k: torch.as_tensor(d["guess"][k], dtype=F64)
             for k in ref_train.LEAVES}
    B, n, dt = p0.shape[0], traffic["rollout_steps"], conf["dt"]
    static, params = program.scene(conf, "cpu")
    pb = program.batch_params(params, B)
    step = program.batched_step(static, conf, params_batched=True)
    s0 = program.WorldState(p0, v0, torch.zeros(B, dtype=F64))
    with torch.no_grad():
        target = program.rollout(step, pb, s0, dt, n)[1].p
    leaves = {k: guess[k].clone().requires_grad_(True)
              for k in ref_train.LEAVES}
    traj = program.rollout(step, dataclasses.replace(pb, **leaves), s0, dt,
                           n)[1].p
    loss = ((traj - target) ** 2).mean(dim=(0, 2, 3))
    grads = torch.autograd.grad(loss.sum(), list(leaves.values()))

    world = _world(conf)
    with torch.no_grad():
        target_ref = ref_world.rollout(world, p0, v0, dt, n, _solver(conf))
    torch.testing.assert_close(target_ref, target, rtol=0, atol=1e-12)
    losses, first, _ = ref_train.adam(world, guess, p0, v0, dt, n,
                                      _solver(conf), target_ref,
                                      traffic["lr"], 1)
    torch.testing.assert_close(losses[0], loss.detach(), rtol=1e-9,
                               atol=1e-15)
    for k, g in zip(ref_train.LEAVES, grads):
        scale = float(g.abs().max())
        assert scale > 0
        torch.testing.assert_close(first[k], g, rtol=0, atol=1e-8 * scale)
