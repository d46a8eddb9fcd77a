"""The port's bench and its measuring tools (``lcp_physics_tpu_torch.tools.
bench``, ``.iter_bench``, ``.roofline``) against the repository's
``bench.py`` and the JAX package, on the CPU.

* The scene builders give ``bench.py``'s scenes: static fields equal,
  parameter and state arrays bitwise equal at float32 (B = 2).  The scenes
  ``bench.py`` builds inline are built here with the JAX package's
  constructors from the same draws.
* Each row's timed function against the JAX package at float64: the
  headline's ``lcp_solve`` (B = 8, 1e-8), the joint chain's and the loose
  grid's steps (B = 2, 2 steps, 1e-8), the lines' value (1e-10) and mass
  gradient (1e-8) (B = 2, 3 steps).
* The joint chain's float64 JAX record ``tests/data/torch_joints_golden.json``
  (B = 2, 2 steps), held here through the plain versions at 1e-8 and by
  ``tests/test_torch_cuda_paths.py`` through the kernels.  Regenerate it
  with
  ``PYTHONPATH=. python tests/test_torch_bench.py``.
* Every row, ``iter_bench`` and ``roofline`` run on the CPU at B = 2.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from lcp_physics_tpu.core import WorldState as JWorldState
from lcp_physics_tpu.core import default_params as jax_default_params
from lcp_physics_tpu.core import make_assemble as jax_make_assemble
from lcp_physics_tpu.core import make_scene_static as jax_scene_static
from lcp_physics_tpu.lcp import lcp_solve as jax_lcp_solve
from lcp_physics_tpu.parallel import make_batched_step as jax_batched_step
from lcp_physics_tpu.parallel import tile_state as jax_tile_state
from lcp_physics_tpu.utils import SimConfig as JaxSimConfig
from test_torch_pdipm import one_torch_thread  # noqa: F401

from lcp_physics_tpu_torch.lcp import lcp_solve
from lcp_physics_tpu_torch.parallel import make_batched_step
from lcp_physics_tpu_torch.tools import asm_vjp_probe as AV
from lcp_physics_tpu_torch.tools import bench as TB
from lcp_physics_tpu_torch.tools import bwd_roofline as BR
from lcp_physics_tpu_torch.tools import iter_bench as IB
from lcp_physics_tpu_torch.tools import roofline as RL
from lcp_physics_tpu_torch.utils import SimConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_joints_golden.json")
CPU = dict(device="cpu")
F64 = dict(dtype=torch.float64, device="cpu")
JOINT_B, JOINT_STEPS = 2, 2


# --- builders against bench.py ---------------------------------------------

def same_static(jstatic, static):
    assert static.counts == tuple(jstatic.counts)
    assert static.c_max == jstatic.c_max
    assert static.allowed == tuple(tuple(r) for r in jstatic.allowed)
    assert [(j.kind, j.body1, j.body2, tuple(j.local1), tuple(j.local2),
             tuple(j.ref)) for j in static.joints] == [
        (j.kind, j.body1, j.body2, tuple(j.local1), tuple(j.local2),
         tuple(j.ref)) for j in jstatic.joints]
    assert static.n_eq == jstatic.n_eq
    jp, tp = jstatic.pair_lists(), static.pair_lists()
    assert jp.keys() == tp.keys()
    for k in jp:
        for a, b in zip(jp[k], tp[k]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def bitwise(jax_tree, torch_tree, fields):
    for f in fields:
        j = np.asarray(getattr(jax_tree, f))
        t = getattr(torch_tree, f).numpy()
        assert t.dtype == j.dtype == np.float32, f
        assert t.shape == j.shape, f
        assert np.array_equal(t, j), f


PARAM_FIELDS = ("mass", "inertia", "restitution", "fric_coeff", "radius",
                "verts", "gravity")


def same_scene(jscene, scene):
    """(static, params, states) of bench.py and of the port: static fields
    equal, params and states bitwise at float32."""
    same_static(jscene[0], scene[0])
    bitwise(jscene[1], scene[1], PARAM_FIELDS)
    bitwise(jscene[2], scene[2], ("p", "v", "t"))


@pytest.mark.parametrize("dense,hulls", [(False, False), (True, False),
                                         (True, True)],
                         ids=["loose", "dense", "hulls"])
def test_world_scene_is_bench_py(dense, hulls):
    same_scene(bench.build_world_scene(2, dense=dense, hulls=hulls),
               TB.build_world_scene(2, dense=dense, hulls=hulls, **CPU))


def test_joint_scene_is_bench_py():
    static, _, _ = scene = TB.build_joint_scene(2, **CPU)
    same_scene(bench.build_joint_scene(2), scene)
    assert static.n_eq == 33 and 2 * static.c_max + static.n_eq == 289


def jax_lcp_scene(B, dtype=jnp.float32):
    """bench_lcp_solves' scene with the JAX package (bench.py:72-88)."""
    N, C = 8, 8
    rng = np.random.default_rng(0)
    static = jax_scene_static([1] * N, c_max=C)
    params = jax_default_params(
        static, verts=np.zeros((N, 1, 2), np.float32),
        radius=np.full(N, 1.0, np.float32), gravity=(0.0, 10.0),
        restitution=0.4, dtype=dtype)
    pos = rng.uniform(0, 5.0, (B, N, 2)).astype(np.float32)
    p = np.concatenate([np.zeros((B, N, 1), np.float32), pos], -1)
    v = rng.standard_normal((B, N, 3)).astype(np.float32)
    states = JWorldState(p=jnp.asarray(p, dtype), v=jnp.asarray(v, dtype),
                         t=jnp.zeros((B,), dtype))
    return static, params, states


def jax_line_scene(B, spacing, dtype=jnp.float32):
    """bench_fwd_bwd's line with the JAX package (bench.py:289-308)."""
    N = 8
    static = jax_scene_static([1] * N, c_max=16)
    params = jax_default_params(
        static, verts=np.zeros((N, 1, 2), np.float32),
        radius=np.full(N, 1.0, np.float32), gravity=(0.0, 10.0),
        dtype=dtype)
    pos = np.stack([np.arange(N) * spacing, np.zeros(N)], -1)
    p = np.concatenate([np.zeros((N, 1)), pos], -1).astype(np.float32)
    state = JWorldState(p=jnp.asarray(p, dtype), v=jnp.zeros((N, 3), dtype),
                        t=jnp.zeros((), dtype))
    return static, params, jax_tile_state(state, B)


def jax_scale_scene(B):
    """bench_scale_up's scene with the JAX package (bench.py:413-427)."""
    N = 64
    rng = np.random.default_rng(2)
    static = jax_scene_static([1] * N, c_max=128)
    params = jax_default_params(
        static, verts=np.zeros((N, 1, 2), np.float32),
        radius=np.full(N, 1.0, np.float32), gravity=(0.0, 10.0),
        restitution=0.4, dtype=jnp.float32)
    gx, gy = np.meshgrid(np.arange(8), np.arange(8))
    pos = np.stack([gx.ravel() * 2.6, gy.ravel() * 2.6], -1)
    pos = pos + rng.uniform(-0.25, 0.25, pos.shape)
    p = np.concatenate([np.zeros((N, 1)), pos], -1).astype(np.float32)
    state = JWorldState(p=jnp.asarray(p), v=jnp.zeros((N, 3), jnp.float32),
                        t=jnp.zeros((), jnp.float32))
    return static, params, jax_tile_state(state, B)


@pytest.mark.parametrize("which", ["lcp", "line_sparse", "line_touching",
                                   "scale"])
def test_inline_scenes_are_bench_py(which):
    if which == "lcp":
        pair = jax_lcp_scene(2), TB.build_lcp_scene(2, **CPU)
    elif which == "scale":
        pair = jax_scale_scene(2), TB.build_scale_scene(2, **CPU)
    else:
        spacing = 2.2 if which == "line_sparse" else 2.0
        pair = (jax_line_scene(2, spacing),
                TB.build_line_scene(2, spacing, **CPU))
    same_scene(*pair)


# --- each row's timed function against the JAX package at f64 --------------

def jax_f64(scene, restitution=0.4):
    """A bench.py scene with its float32 arrays widened to float64 and its
    parameters built at float64 from the same inputs, as the port's
    builders do with dtype=torch.float64."""
    static, params, states = scene
    params = jax_default_params(
        static, verts=np.asarray(params.verts), radius=np.asarray(
            params.radius), gravity=(0.0, 10.0), restitution=restitution,
        dtype=jnp.float64)
    states = JWorldState(*(jnp.asarray(np.asarray(x), jnp.float64)
                           for x in (states.p, states.v, states.t)))
    return static, params, states


def test_lcp_row_matches_jax():
    """The headline's lcp_solve with bench.py:99-102's arguments, B = 8,
    f64: z within 1e-8 of the JAX package's."""
    B = 8
    static, params, states = jax_lcp_scene(B, jnp.float64)
    assemble, _ = jax_make_assemble(static, JaxSimConfig(max_iter=15,
                                                         solver_eps=1e-6))
    blocks, _ = jax.vmap(assemble, in_axes=(None, 0, None))(params, states,
                                                            0.01)
    ref = jax.jit(lambda bl: jax_lcp_solve(
        bl["Q"], bl["p"], bl["G"], bl["h"], bl["A"], bl["b"], bl["F"],
        max_iter=15, tol=1e-6, gamma_rows=8, row_mask=bl["row_mask"],
        not_improved_lim=JaxSimConfig.solver_stall_lim,
        fric_pair=True))(blocks)
    args, kw, info = TB.lcp_problem(B, **F64)
    assert info["contacts"] > 0
    z = lcp_solve(*args, **kw)
    np.testing.assert_allclose(z.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-8)


def jax_steps(scene, n_steps):
    static, params, states = scene
    step = jax.jit(jax_batched_step(static, JaxSimConfig(max_iter=12,
                                                         solver_eps=1e-5)))
    counts = []
    for _ in range(n_steps):
        states, d = step(params, states, 0.01)
        counts.append(np.asarray(d.n_contacts))
    return states, counts


def port_steps(scene, n_steps):
    static, params, states = scene
    step = make_batched_step(static, SimConfig(**TB.WORLD_CONFIG))
    counts = []
    for _ in range(n_steps):
        states, d = step(params, states, TB.DT)
        counts.append(d.n_contacts.numpy())
    return states, counts


@pytest.mark.parametrize("row", ["joints", "loose"])
def test_world_row_steps_match_jax(row):
    """The joint chain's and the loose grid's steps, B = 2, 2 steps, f64:
    p and v within 1e-8 of the JAX package's, contact counts equal."""
    if row == "joints":
        jscene = jax_f64(bench.build_joint_scene(2))
        scene = TB.build_joint_scene(2, **F64)
    else:
        jscene = jax_f64(bench.build_world_scene(2))
        scene = TB.build_world_scene(2, **F64)
    ref, jc = jax_steps(jscene, 2)
    got, tc = port_steps(scene, 2)
    for f in ("p", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=1e-8, err_msg=f)
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a, b)
    if row == "joints":
        assert sum(int(c.sum()) for c in tc) > 0   # the contact path ran


@pytest.mark.parametrize("spacing", [2.2, 2.0], ids=["sparse", "touching"])
def test_line_fwd_bwd_matches_jax(spacing):
    """bench_fwd_bwd's value mean(p^2) after 3 steps and its gradient with
    respect to params.mass, B = 2, f64: loss within 1e-10 (relative),
    gradient within 1e-8 of ``jax.value_and_grad``'s."""
    n_steps = 3
    static, params, states = jax_f64(jax_line_scene(2, spacing),
                                     restitution=0.5)
    jstep = jax_batched_step(static, JaxSimConfig(max_iter=12,
                                                  solver_eps=1e-5))

    def loss(params, states):
        def body(s, _):
            s2, _ = jstep(params, s, 0.01)
            return s2, ()
        out, _ = jax.lax.scan(body, states, None, length=n_steps)
        return jnp.mean(out.p ** 2)

    val, g = jax.jit(jax.value_and_grad(loss))(params, states)
    pstatic, pparams, pstates = TB.build_line_scene(2, spacing, **F64)
    step = make_batched_step(pstatic, SimConfig(**TB.WORLD_CONFIG))
    tval, tg = TB._fwd_bwd(step, pparams, pstates, n_steps)
    assert abs(float(tval) / float(val) - 1) <= 1e-10
    np.testing.assert_allclose(tg.numpy(), np.asarray(g.mass), rtol=0,
                               atol=1e-8)


# --- the joint chain's f64 JAX record ---------------------------------------

def joint_record():
    """bench.py::build_joint_scene at B = 2, f64, 2 steps through the JAX
    package's make_batched_step under SimConfig(max_iter=12,
    solver_eps=1e-5): final p and v, contacts of each step."""
    scene = jax_f64(bench.build_joint_scene(JOINT_B))
    final, counts = jax_steps(scene, JOINT_STEPS)
    return dict(B=JOINT_B, steps=JOINT_STEPS,
                config=dict(max_iter=12, solver_eps=1e-5),
                p0=np.asarray(scene[2].p).tolist(),
                p=np.asarray(final.p).tolist(),
                v=np.asarray(final.v).tolist(),
                n_contacts=[c.tolist() for c in counts])


def test_joint_record_plain_path():
    """The port's plain versions against the JAX record at 1e-8."""
    with open(GOLDEN) as f:
        rec = json.load(f)
    scene = TB.build_joint_scene(rec["B"], **F64)
    np.testing.assert_array_equal(scene[2].p.numpy(), np.asarray(rec["p0"]))
    got, counts = port_steps(scene, rec["steps"])
    for f in ("p", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(rec[f]), rtol=0, atol=1e-8,
                                   err_msg=f)
    assert [c.tolist() for c in counts] == rec["n_contacts"]


# --- every row, the tools, and the entry points on the CPU -------------------

ALL_ROWS = [*TB.ROWS, *TB.SCALE_ROWS]


@pytest.mark.parametrize("name", ALL_ROWS)
def test_every_row_runs_on_the_cpu(name):
    """Each row at B = 2, 1 step, 1 call in 1 window on the CPU: a finite,
    positive rate; no kernel launches (plain versions; the joint row's
    289-row system counts its padded copies) and no event time."""
    kw = dict(B=2, calls=1, windows=1)
    if name != "lcp":
        kw["n_steps"] = 1
    if name == "scale":
        kw["batch_tile"] = 1
    rec = TB.run_row(name, "cpu", **kw)
    assert rec["row"] == name
    assert np.isfinite(rec["rate"]) and rec["rate"] > 0
    assert set(rec["launches"]) <= {"pad"} and rec["event_ms"] is None
    assert rec["line"].startswith("[bench] ")


def test_stdout_line_is_bench_pys(monkeypatch, capsys):
    """main() prints bench.py's record last on stdout: its keys, its metric
    name, vs_baseline against 10,000 and the profile string bench.py
    builds from the JAX SimConfig."""
    fn, fixed = TB.ROWS["lcp"]
    monkeypatch.setitem(TB.ROWS, "lcp", (
        lambda **kw: fn(**dict(kw, B=2, calls=1, windows=1)), fixed))
    assert TB.main(["--device", "cpu", "--rows", "lcp"]) == 0
    out = capsys.readouterr()
    rec = json.loads(out.out.strip().splitlines()[-1])
    assert list(rec) == ["metric", "value", "unit", "vs_baseline", "profile"]
    assert rec["metric"] == "batched contact-LCP solves/sec/chip"
    assert rec["unit"] == "solves/sec" and rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / 10_000.0, 3)
    assert rec["profile"] == (
        f"stall_lim={JaxSimConfig.solver_stall_lim},max_iter=15,"
        f"tol=1e-6,backend=auto,fric_pair=True")
    assert TB.NORTH_STAR == bench.NORTH_STAR
    assert "[bench] device cpu" in out.err


@pytest.mark.parametrize("mod", [TB, IB, RL, BR, AV],
                         ids=["bench", "iter_bench", "roofline",
                              "bwd_roofline", "asm_vjp_probe"])
def test_tools_raise_without_a_card(mod, monkeypatch):
    """Without a card and without --device cpu each tool raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def test_unknown_row_is_refused():
    with pytest.raises(SystemExit):
        TB.main(["--device", "cpu", "--rows", "nope"])


def test_iter_bench_components_on_the_cpu():
    """iter_bench's components and its sweep at B = 2 on the CPU: every
    time positive, the marginals derived, FUSE_ITER restored."""
    from lcp_physics_tpu_torch.lcp import pdipm
    blocks, C = IB.dense_lcp(2, "cpu")
    assert 2 * C + blocks["b"].shape[-1] == 256
    comp = IB.components(blocks, C, "cpu", calls=1, windows=1)
    assert "inverse build (iter_inv_raw)" in comp
    for label, t in comp.items():
        if isinstance(t, dict):
            assert t["host_ms"] > 0 and t["event_ms"] is None, label
    swept = IB.sweep(blocks, C, "cpu", calls=1, windows=1, iters=(1, 2))
    assert pdipm.FUSE_ITER is False
    assert set(swept) == {False, True}
    for r in swept.values():
        assert np.isfinite(r["marginal"][0]) and r["marginal"][1] is None
    assert IB.lines(comp, swept)


def test_roofline_counts_are_the_jax_tools():
    """The counts at (B, n, m, K, P) = (256, 192, 512, 256, 128): the JAX
    tool's formulas (tools/roofline.py:134-153, :164-165) with its 3-pass
    factors removed, written out."""
    c = RL.counts(256, 192, 512, 256, 128)
    assert c["pplane"] == (6_442_450_944, 167_772_160)
    assert c["factor"][0] == pytest.approx(5_010_795_178.666667, rel=1e-15)
    assert c["factor"][1] == 134_217_728
    assert c["solve"] == (117_440_512, 234_881_024)
    assert c["resid"] == (101_449_728, 102_105_088)
    assert c["narrow"] == (20_643_840, 16_515_072)
    assert c["assembly"] == (26_935_296, 41_680_896)


def test_roofline_components_on_the_cpu():
    """roofline's components at B = 2 on the CPU: positive host times,
    the achieved rates "not measured" off the card."""
    shape, rows, step = RL.measure(2, "cpu", calls=1, windows=1)
    assert shape == (2, 192, 512, 256, 128)
    assert [r[0] for r in rows] == ["narrowphase", "assembly (all)",
                                    "factor (+P-plane)", "kkt solve (x1)",
                                    "residuals"]
    assert step["host_ms"] > 0 and step["iters"] > 0
    out = RL.lines(shape, rows, step)
    assert all("not measured" in line for line in out[2:])


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    rec = joint_record()
    with open(GOLDEN, "w") as f:
        json.dump(rec, f)
        f.write("\n")
    print("wrote", GOLDEN, "contacts", rec["n_contacts"])
