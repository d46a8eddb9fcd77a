"""The port's training step — loss and gradients through a contact rollout
— vs ``jax.value_and_grad`` of the JAX package's, f64 on CPU.

Two scenes of bench.py's training benchmarks, cut to size:

* the touching grid of ``bench_fwd_bwd_dense`` (bench.py:331) at 4 x 4
  circles, c_max = 72 (rotated Schur system K2 = 144: two 128-panels of
  the blocked factor), B = 2, 2 steps, against ``lcp_backend="pallas"``
  (the same pivotless blocked algorithm, in interpret mode);
* the touching 8-circle line of ``bench_fwd_bwd`` (bench.py:277), B = 2,
  3 steps, against ``lcp_backend="fused"``.

The loss is mean(p^2) of the final state, the gradients are with respect
to mass, restitution, fric_coeff and the initial velocities.

``PYTHONPATH=. python tests/test_torch_train.py`` (from the repository
root) rewrites tests/data/torch_train_golden.json, the JAX record of the
grid scene that chip_smoke.py holds the card's float64 path to;
``test_train_golden_record_matches_jax`` keeps the file honest.
"""
import dataclasses
import functools
import json
import os

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

from chip_smoke import DT, grid_start, line_start, train_scene, train_step
from test_torch_pdipm import one_torch_thread  # noqa: F401
from lcp_physics_tpu_torch.ops import linalg

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_train_golden.json")
GRID = dict(side=4, c_max=72, B=2, steps=2)
LINE = dict(c_max=16, B=2, steps=3)


def jax_train(p0, v0, c_max, n_steps, backend, restitution=0.4, **cfg):
    """(loss, grads) of the JAX package, grads w.r.t. (mass, restitution,
    fric_coeff, v0)."""
    n = p0.shape[1]
    static = jax_scene_static([1] * n, c_max=c_max)
    params = jax_default_params(
        static, verts=np.zeros((n, 1, 2)), radius=np.full(n, 1.0),
        gravity=(0.0, 10.0), restitution=restitution, dtype=jnp.float64)
    step = jax_batched_step(static, JaxSimConfig(
        max_iter=12, solver_eps=1e-5, lcp_backend=backend, **cfg))

    def loss(mass, rest, fc, v):
        pr = dataclasses.replace(params, mass=mass, restitution=rest,
                                 fric_coeff=fc)
        st = JWorldState(jnp.asarray(p0), v, jnp.zeros(p0.shape[0]))
        final, _ = jax_rollout(step, pr, st, DT, n_steps)
        return jnp.mean(final.p ** 2)

    val, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3)))(
        params.mass, params.restitution, params.fric_coeff, jnp.asarray(v0))
    return float(val), [np.asarray(g) for g in grads]


def port_train(p0, v0, c_max, n_steps, remat=False, restitution=0.4,
               **cfg):
    step, params, state = train_scene(torch, "cpu", torch.float64, p0, v0,
                                      c_max, restitution=restitution, **cfg)
    loss, grads = train_step(torch, step, params, state, n_steps, remat)
    return float(loss), [g.numpy() for g in grads]


@functools.lru_cache(maxsize=None)
def grid_jax(**cfg):
    p0, v0 = grid_start(GRID["B"], GRID["side"])
    return jax_train(p0, v0, GRID["c_max"], GRID["steps"], "pallas",
                     **dict(cfg))


def check(got, want, tol):
    (l1, g1), (l2, g2) = got, want
    np.testing.assert_allclose(l1, l2, rtol=1e-10, atol=0)
    for name, a, b in zip(("mass", "restitution", "fric_coeff", "v0"),
                          g1, g2):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=tol,
                                   atol=tol * max(1.0, np.abs(b).max()),
                                   err_msg=name)


RECORD_KEYS = ("p0", "v0", "loss", "grad_mass", "grad_restitution",
               "grad_fric_coeff", "grad_v0")


def golden_record(writer="tests/test_torch_train.py", **cfg):
    """The JAX record of the grid scene; ``cfg`` adds SimConfig fields,
    which the record keeps under "config"."""
    p0, v0 = grid_start(GRID["B"], GRID["side"])
    loss, grads = grid_jax(**cfg)
    extra = "".join(f", {k}={v!r}" for k, v in cfg.items())
    rec = dict(
        about=("JAX package (lcp_backend='pallas', f64, CPU): the touching "
               "grid of bench.py::build_world_scene(dense=True) cut to 4x4 "
               "radius-1 circles, c_max=72, B=2 worlds, dt=0.01, 2 steps, "
               f"SimConfig(max_iter=12, solver_eps=1e-5{extra}), "
               "restitution 0.4, gravity (0, 10); loss mean(p^2) of the "
               f"final state and its gradients; written by {writer}"),
        c_max=GRID["c_max"], steps=GRID["steps"],
        p0=p0.tolist(), v0=v0.tolist(), loss=loss,
        **{f"grad_{k}": g.tolist() for k, g in zip(
            ("mass", "restitution", "fric_coeff", "v0"), grads)})
    if cfg:
        rec["config"] = cfg
    return rec


def check_record(path, new):
    """The stored record at ``path`` against a freshly computed one."""
    with open(path) as f:
        rec = json.load(f)
    assert rec.get("config", {}) == new.get("config", {})
    for k in RECORD_KEYS:
        np.testing.assert_allclose(np.asarray(rec[k]), np.asarray(new[k]),
                                   rtol=1e-12, atol=1e-14, err_msg=k)


def write_record(path, rec):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f)
        f.write("\n")
    print("wrote", path)


def test_grid_train_step_matches_jax():
    p0, v0 = grid_start(GRID["B"], GRID["side"])
    got = port_train(p0, v0, GRID["c_max"], GRID["steps"])
    check(got, grid_jax(), 1e-8)


def test_line_train_step_matches_jax():
    p0, v0 = line_start(LINE["B"])
    want = jax_train(p0, v0, LINE["c_max"], LINE["steps"], "fused",
                     restitution=0.5)
    got = port_train(p0, v0, LINE["c_max"], LINE["steps"], restitution=0.5)
    check(got, want, 1e-8)


def test_remat_gives_the_same_gradients():
    p0, v0 = grid_start(GRID["B"], GRID["side"])
    plain = port_train(p0, v0, GRID["c_max"], GRID["steps"])
    remat = port_train(p0, v0, GRID["c_max"], GRID["steps"], remat=True)
    assert remat[0] == plain[0]
    for a, b in zip(remat[1], plain[1]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_stop_contact_grad_matches_jax():
    """SimConfig(stop_contact_grad=True) stops gradients through the
    contact geometry as the JAX package does (the port once ignored it)."""
    p0, v0 = grid_start(GRID["B"], GRID["side"])
    got = port_train(p0, v0, GRID["c_max"], GRID["steps"],
                     stop_contact_grad=True)
    want = grid_jax(stop_contact_grad=True)
    check(got, want, 1e-8)
    # the flag moves the gradients by far more than check()'s tolerance,
    # so a port that ignored it would fail here
    assert max(np.abs(a - b).max()
               for a, b in zip(want[1], grid_jax()[1])) > 1e-7


@pytest.mark.parametrize("precision", [None, "highest"])
def test_factor_precision_routes_the_panel_kernels(monkeypatch, precision):
    """At float32, SimConfig(solver_factor_precision='highest') sends the
    blocked factor's panel inverses to the scalar kernel, forward and
    backward, as in the JAX package; the default takes the rank-16 one."""
    calls = {"gj_inv": 0, "gj_inv_blocked": 0}
    for name in calls:
        orig = getattr(linalg, name)

        def spy(K, _o=orig, _n=name):
            calls[_n] += 1
            return _o(K)
        monkeypatch.setattr(linalg, name, spy)
    p0, v0 = grid_start(1, GRID["side"])
    step, params, state = train_scene(
        torch, "cpu", torch.float32, p0, v0, GRID["c_max"],
        solver_factor_precision=precision)
    loss, grads = train_step(torch, step, params, state, 1)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    used = "gj_inv" if precision else "gj_inv_blocked"
    assert calls[used] > 0 and sum(calls.values()) == calls[used]


def test_train_golden_record_matches_jax():
    check_record(GOLDEN, golden_record())


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    write_record(GOLDEN, golden_record())
