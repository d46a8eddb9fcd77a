"""The PyTorch port's batched step and rollout vs the JAX package (f64, CPU).

The scene is the headline LCP benchmark's (bench.py::bench_lcp_solves):
8 radius-1 circles per world at uniform(0, 5) positions with standard-normal
velocities, c_max = 8, dt = 0.01, SimConfig(max_iter=15, solver_eps=1e-6).
The JAX side runs with lcp_backend="fused" (the fused IPM kernel in
interpret mode); the port runs its plain torch kernels on CPU tensors.

``PYTHONPATH=. python tests/test_torch_step.py`` (from the repository root)
rewrites tests/data/torch_slice_golden.json,
the JAX record of this scene at B = 8 that chip_smoke.py holds the GPU
kernels to; ``test_golden_record_matches_jax`` keeps the file honest.
"""
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

import lcp_physics_tpu_torch as port
from lcp_physics_tpu_torch.core import (WorldState, make_scene_static,
                                        params_from_numpy, rollout,
                                        state_from_numpy)
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
    code = ("import sys, lcp_physics_tpu_torch; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'lcp_physics_tpu.')) or "
            "m == 'lcp_physics_tpu']; print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_cpu_tensors_run_the_plain_versions():
    """On CPU tensors the wrappers dispatch to their plain versions: the
    kernels' launch counters stay at zero through a contact step."""
    from lcp_physics_tpu_torch.ops import ipm, linalg
    before = dict(linalg.LAUNCHES, **ipm.LAUNCHES)
    p, v = slice_scene(2)
    _, diag, _, _ = port_run(p, v, 1)
    assert int(diag.n_contacts.sum()) > 0
    assert dict(linalg.LAUNCHES, **ipm.LAUNCHES) == before == {
        "lu": 0, "solve": 0, "solve_t": 0, "gj_inv_blocked": 0, "gj_inv": 0,
        "fused_ipm": 0, "fused_ipm_unrot": 0}


def test_unported_options_raise():
    static = make_scene_static([1] * N, c_max=C)
    for cfg in (SimConfig(post_stabilization=True),
                SimConfig(penetration_backtrack=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_batched_step(static, cfg)
    hull_static = make_scene_static([1, 4], c_max=4)
    step = make_batched_step(hull_static, SimConfig())
    params = port.core.default_params(
        hull_static, verts=np.array([[[0, 0]] * 4,
                                     [[-1, -1], [1, -1], [1, 1], [-1, 1]]],
                                    float),
        radius=np.array([1.0, 0.0]), **F64)
    state = WorldState(torch.tensor([[[0, 0, 0], [0, 1.5, 0]]], **F64),
                       torch.zeros(1, 2, 3, **F64), torch.zeros(1, **F64))
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        step(params, state, DT)


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


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    with open(GOLDEN, "w") as f:
        json.dump(golden_record(), f)
        f.write("\n")
    print("wrote", GOLDEN)
