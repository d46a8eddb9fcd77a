"""The port's circle/hull and hull/hull narrowphase vs the JAX package
(f64, CPU): the kernels on analytic, rotated, separated and random pairs,
the pipeline on mixed worlds (speculative margin, hull pair budget,
compaction ties), ``max_penetration``, and the narrowphase gradient
against ``jax.grad`` and finite differences.  Narrowphase outputs agree
to 1e-12, validity and body indices exactly.

``PYTHONPATH=. python tests/test_torch_hull.py`` (from the repository
root) rewrites tests/data/torch_hull_golden.json: the JAX record of a
small f64 hull scene (a Rect, a pentagon, circles and a joint; B = 4,
4 steps, post-stabilization and the penetration backtrack on) that
chip_smoke.py holds the kernel path to; ``test_hull_golden_matches_jax``
keeps the file honest.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcp_physics_tpu.core import geometry as jgeo
from lcp_physics_tpu.core import JointSpec as JJointSpec
from lcp_physics_tpu.core import WorldState as JWorldState
from lcp_physics_tpu.core import default_params as jax_default_params
from lcp_physics_tpu.core import make_scene_static as jax_scene_static
from lcp_physics_tpu.core.step import rollout as jax_rollout
from lcp_physics_tpu.parallel import make_batched_step as jax_batched_step
from lcp_physics_tpu.utils import SimConfig as JaxSimConfig
from test_torch_pdipm import one_torch_thread  # noqa: F401

from lcp_physics_tpu_torch.core import geometry
from lcp_physics_tpu_torch.core import (JointSpec, make_scene_static,
                                        params_from_numpy, rollout,
                                        state_from_numpy)
from lcp_physics_tpu_torch.parallel import make_batched_step
from lcp_physics_tpu_torch.utils import SimConfig

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_hull_golden.json")
TOL = dict(rtol=1e-12, atol=1e-12)
F64 = dict(dtype=torch.float64, device="cpu")


def t64(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def square(half):
    return np.array([[-half, -half], [half, -half], [half, half],
                     [-half, half]], float)


def random_hull(rng, n_verts, scale=1.0):
    """Random convex CCW polygon with n_verts vertices, centred."""
    ang = np.sort(rng.uniform(0, 2 * np.pi, n_verts))
    rad = rng.uniform(0.5, 1.0, n_verts) * scale
    v = np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=-1)
    return v - v.mean(axis=0)


def mixed_world(rng, B, n_hull=6, n_circle=3, V=6, spread=2.2):
    """B worlds of n_hull random hulls (3..V vertices, padded by repeating
    the last) and n_circle circles, scattered so that many pairs overlap,
    touch or miss.  Returns numpy (p (B, N, 3), verts, radius, counts)."""
    N = n_hull + n_circle
    counts = np.ones(N, np.int32)
    verts = np.zeros((N, V, 2))
    radius = np.zeros(N)
    for k in range(n_hull):
        v = random_hull(rng, int(rng.integers(3, V + 1)))
        counts[k] = len(v)
        verts[k, :len(v)] = v
        verts[k, len(v):] = v[-1]
    radius[n_hull:] = rng.uniform(0.4, 0.9, n_circle)
    p = np.concatenate([rng.uniform(-np.pi, np.pi, (B, N, 1)),
                        rng.uniform(-spread, spread, (B, N, 2))], -1)
    return p, verts, radius, counts


def jax_contacts(p, verts, radius, counts, c_max, margin=None, budget=0):
    pairs = jgeo.split_pairs_by_kind(counts)
    f = lambda pp, mm: jgeo.find_contacts(
        pp, jnp.asarray(verts), jnp.asarray(radius), counts, pairs, c_max,
        margin=mm, hull_budget=budget)
    if margin is None:
        return jax.jit(jax.vmap(lambda pp: f(pp, None)))(jnp.asarray(p))
    return jax.jit(jax.vmap(f))(jnp.asarray(p), jnp.asarray(margin))


def port_contacts(p, verts, radius, counts, c_max, margin=None, budget=0):
    return geometry.find_contacts(
        t64(p), t64(verts), t64(radius), counts,
        geometry.split_pairs_by_kind(counts), c_max,
        margin=None if margin is None else t64(margin), hull_budget=budget)


def assert_contacts_equal(got, ref):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.ia.numpy(), np.asarray(ref.ia))
    np.testing.assert_array_equal(got.ib.numpy(), np.asarray(ref.ib))
    for f in ("normal", "ra", "rb", "depth"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), **TOL,
                                   err_msg=f)


@pytest.mark.parametrize("case", ["face", "corner", "inside", "random"])
def test_circle_hull_matches_jax(case):
    """The analytic cases of tests/test_geometry.py (circle over a face,
    off a corner, centre inside), and 64 random circle/hull pairs."""
    if case == "random":
        rng = np.random.default_rng(5)
        P = 64
        wv = np.stack([random_hull(rng, 5) for _ in range(P)])
        wv = wv + rng.uniform(-1, 1, (P, 1, 2))
        pc = rng.uniform(-1.5, 1.5, (P, 2))
        rc = rng.uniform(0.2, 1.0, P)
    else:
        pc, rc = {"face": ([0., 1.5], 1.0), "corner": ([2., 2.], 1.0),
                  "inside": ([0., 0.8], 0.5)}[case]
        pc, rc = np.array([pc]), np.array([rc])
        wv = square(1.0)[None]
    cnt = np.full(len(rc), 4 if case != "random" else 5)
    ref = jax.vmap(jgeo.circle_hull)(jnp.asarray(pc), jnp.asarray(rc),
                                     jnp.asarray(wv), jnp.asarray(cnt))
    got = geometry.circle_hull(t64(pc), t64(rc), t64(wv), torch.tensor(cnt))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_hull_hull_kernels_match_jax():
    """Both hull/hull forms on every hull pair of rotated random worlds
    (overlapping, touching and separated pairs, with a margin): the port's
    ``hull_hull`` against the JAX ``hull_hull`` vmapped over the pairs,
    and its ``hull_hull_pairs`` against the JAX ``hull_hull_pairs``."""
    rng = np.random.default_rng(42)
    B = 3
    p, verts, _, counts = mixed_world(rng, B, n_hull=8, n_circle=0)
    hi, hj = geometry.split_pairs_by_kind(counts)["hh"]
    m = rng.uniform(0.0, 0.3, (B, len(hi)))
    wv = np.asarray(jax.vmap(lambda pp: jgeo.world_vertices(
        jnp.asarray(verts), pp))(jnp.asarray(p)))
    cj = jnp.asarray(counts)
    ref_aos = jax.jit(jax.vmap(jax.vmap(
        lambda w, i, j, mm: jgeo.hull_hull(w[i], cj[i], jnp.zeros(2), w[j],
                                           cj[j], jnp.zeros(2), mm),
        in_axes=(None, 0, 0, 0)), in_axes=(0, None, None, 0)))(
        jnp.asarray(wv), jnp.asarray(hi), jnp.asarray(hj), jnp.asarray(m))
    twv = t64(wv)
    got_aos = geometry.hull_hull(
        twv[:, hi], torch.tensor(counts[hi]), torch.zeros(2, **F64),
        twv[:, hj], torch.tensor(counts[hj]), torch.zeros(2, **F64), t64(m))
    assert 0 < int(np.asarray(ref_aos[4]).sum()) < ref_aos[4].size
    np.testing.assert_array_equal(got_aos[4].numpy(), np.asarray(ref_aos[4]))
    for g, r in zip(got_aos[:4], ref_aos[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)

    pos = p[..., 1:3]
    ref_soa = jax.jit(jax.vmap(lambda w, ps, mm: jgeo.hull_hull_pairs(
        w, cj, ps, jnp.asarray(hi), jnp.asarray(hj), mm)))(
        jnp.asarray(wv), jnp.asarray(pos), jnp.asarray(m))
    got_soa = geometry.hull_hull_pairs(
        twv, torch.tensor(counts, dtype=torch.int64), t64(pos),
        torch.tensor(hi), torch.tensor(hj), t64(m))
    np.testing.assert_array_equal(got_soa[7].numpy(), np.asarray(ref_soa[7]))
    for g, r in zip(got_soa[:7], ref_soa[:7]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_hull_hull_sat_depths_match_jax():
    rng = np.random.default_rng(3)
    p, verts, _, counts = mixed_world(rng, 4, n_hull=8, n_circle=0)
    hi, hj = geometry.split_pairs_by_kind(counts)["hh"]
    ref = jax.jit(jax.vmap(lambda pp: jgeo.hull_hull_sat_depths(
        jgeo.world_vertices(jnp.asarray(verts), pp), jnp.asarray(counts),
        jnp.asarray(hi), jnp.asarray(hj))))(jnp.asarray(p))
    got = geometry.hull_hull_sat_depths(
        geometry.world_vertices(t64(verts), t64(p)),
        torch.tensor(counts, dtype=torch.int64), torch.tensor(hi),
        torch.tensor(hj))
    assert (np.asarray(ref) > 0).any() and (np.asarray(ref) < 0).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("c_max", [128, 24])
@pytest.mark.parametrize("with_margin", [False, True])
def test_find_contacts_mixed_world_matches_jax(c_max, with_margin):
    """Hulls and circles together (cc, ch and hh rows); c_max = 128 pads
    every candidate row, 24 compacts them."""
    rng = np.random.default_rng(c_max + with_margin)
    B = 6
    p, verts, radius, counts = mixed_world(rng, B)
    margin = rng.uniform(0.0, 0.3, (B, len(counts))) if with_margin else None
    ref = jax_contacts(p, verts, radius, counts, c_max, margin)
    got = port_contacts(p, verts, radius, counts, c_max, margin)
    assert int(np.asarray(ref.valid).sum()) > 0
    assert_contacts_equal(got, ref)


@pytest.mark.parametrize("budget", ["below", "above"])
def test_hull_budget_matches_jax(budget):
    """The hull pair budget below and above each world's count of
    overlapping hull pairs; above it, the contacts are those of the
    unbudgeted pipeline."""
    rng = np.random.default_rng(7)
    B = 4
    p, verts, radius, counts = mixed_world(rng, B, n_hull=10, n_circle=0,
                                           spread=3.0)
    pairs = geometry.split_pairs_by_kind(counts)
    boxes = geometry.aabbs(t64(p), t64(verts), t64(radius), counts)
    score = geometry.aabb_overlap_depth(boxes, torch.tensor(pairs["hh"][0]),
                                        torch.tensor(pairs["hh"][1]))
    ref_score = jax.jit(jax.vmap(lambda pp: jgeo.aabb_overlap_depth(
        jgeo.aabbs(pp, jnp.asarray(verts), jnp.asarray(radius),
                   jnp.asarray(counts)), *pairs["hh"])))(jnp.asarray(p))
    np.testing.assert_allclose(score.numpy(), np.asarray(ref_score), **TOL)
    n_over = int((score > 0).sum(-1).max())
    assert 0 < n_over < len(pairs["hh"][0])
    k = max(n_over // 2, 1) if budget == "below" else n_over
    c_max = 64
    ref = jax_contacts(p, verts, radius, counts, c_max, budget=k)
    got = port_contacts(p, verts, radius, counts, c_max, budget=k)
    assert_contacts_equal(got, ref)
    if budget == "above":
        full = port_contacts(p, verts, radius, counts, c_max)
        sets = [sorted(zip(c.ia[w][c.valid[w]].tolist(),
                           c.ib[w][c.valid[w]].tolist(),
                           np.round(c.depth[w][c.valid[w]].numpy(), 12)))
                for c in (full, got) for w in range(B)]
        assert sets[:B] == sets[B:]


@pytest.mark.parametrize("budget", [0, 3])
def test_compaction_ties_match_jax(budget):
    """Axis-aligned equal squares in a row, each overlapping the next by
    the same exact amount: every hull pair's two points tie in depth, and
    so do all the pairs; compacting 10 rows into 4 keeps the lower rows,
    as XLA's top_k does (with a budget, the tied pair scores too)."""
    N, B = 6, 2
    p = np.zeros((B, N, 3))
    p[:, :, 1] = np.arange(N) * 1.75
    verts = np.broadcast_to(square(1.0), (N, 4, 2)).copy()
    radius = np.zeros(N)
    counts = np.full(N, 4, np.int32)
    ref = jax_contacts(p, verts, radius, counts, 4, budget=budget)
    got = port_contacts(p, verts, radius, counts, 4, budget=budget)
    assert int(np.asarray(ref.valid).sum()) == 2 * 4
    assert_contacts_equal(got, ref)


@pytest.mark.parametrize("spread", [2.2, 40.0])
def test_max_penetration_matches_jax(spread):
    rng = np.random.default_rng(11)
    p, verts, radius, counts = mixed_world(rng, 6, spread=spread)
    pairs = jgeo.split_pairs_by_kind(counts)
    ref = jax.jit(jax.vmap(lambda pp: jgeo.max_penetration(
        pp, jnp.asarray(verts), jnp.asarray(radius), counts, pairs)))(
        jnp.asarray(p))
    got = geometry.max_penetration(t64(p), t64(verts), t64(radius), counts,
                                   geometry.split_pairs_by_kind(counts))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert (float(got.max()) > 0) == (spread < 10)


def test_narrowphase_gradient_matches_jax_and_fd():
    """A scalar of the contacts (depths, normals and offsets of the valid
    rows) of a mixed world compacted into c_max = 10: its gradient with
    respect to the poses against jax.grad (1e-8) and central differences
    (1e-6), and finite everywhere."""
    rng = np.random.default_rng(2)
    p, verts, radius, counts = mixed_world(rng, 2, n_hull=4, n_circle=2,
                                           spread=1.6)
    pairs = jgeo.split_pairs_by_kind(counts)

    def jloss(pp):
        c = jax.vmap(lambda q: jgeo.find_contacts(
            q, jnp.asarray(verts), jnp.asarray(radius), counts, pairs,
            10))(pp)
        w = c.valid.astype(pp.dtype)
        return (jnp.sum(w * c.depth) + jnp.sum(w[..., None] * c.normal)
                + jnp.sum(w[..., None] * (c.ra - c.rb)))

    def tloss(pp):
        c = geometry.find_contacts(pp, t64(verts), t64(radius), counts,
                                   geometry.split_pairs_by_kind(counts), 10)
        w = c.valid.to(pp.dtype)
        return ((w * c.depth).sum() + (w[..., None] * c.normal).sum()
                + (w[..., None] * (c.ra - c.rb)).sum())

    g_jax = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(p)))
    tp = t64(p).requires_grad_(True)
    tloss(tp).backward()
    g = tp.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    np.testing.assert_allclose(g, g_jax, rtol=1e-8, atol=1e-10)
    eps = 1e-6
    for k in [(0, 0, 0), (0, 1, 1), (1, 2, 2), (1, 4, 1), (0, 5, 2)]:
        dp = np.zeros_like(p)
        dp[k] = eps
        fd = (float(tloss(t64(p + dp))) - float(tloss(t64(p - dp)))) \
            / (2 * eps)
        np.testing.assert_allclose(g[k], fd, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("budget", [0, 256])
def test_hull_grid_step_matches_jax(budget):
    """bench.py's dense hull grid at full width (64 squares, 2,016 hull
    pairs, c_max = 128), two f64 worlds (the bench start and its velocities
    reversed), one step at hull_pair_budget 0 and 256 against JAX: states
    1e-8, contact counts exactly."""
    from chip_smoke import hull_grid_start
    p0, v0 = hull_grid_start(2)
    v0[1] *= -1
    counts = [4] * 64
    sq = square(1.0)
    jstatic = jax_scene_static(counts, c_max=128)
    jparams = jax_default_params(jstatic, verts=np.broadcast_to(sq,
                                                                (64, 4, 2)),
                                 radius=np.zeros(64), gravity=(0.0, 10.0),
                                 restitution=0.4, dtype=jnp.float64)
    jstate = JWorldState(jnp.asarray(p0, jnp.float64),
                         jnp.asarray(v0, jnp.float64), jnp.zeros(2))
    cfg = dict(max_iter=12, solver_eps=1e-5, hull_pair_budget=budget)
    js, jd = jax.jit(jax_batched_step(jstatic, JaxSimConfig(**cfg)))(
        jparams, jstate, 0.01)
    step = make_batched_step(make_scene_static(counts, c_max=128),
                             SimConfig(**cfg))
    s, d = step(params_from_numpy(jparams, **F64),
                state_from_numpy(jstate, **F64), 0.01)
    np.testing.assert_array_equal(d.n_contacts.numpy(),
                                  np.asarray(jd.n_contacts))
    assert int(d.n_contacts.min()) > 0
    for k in ("p", "v"):
        np.testing.assert_allclose(getattr(s, k).numpy(),
                                   np.asarray(getattr(js, k)), rtol=1e-8,
                                   atol=1e-8, err_msg=k)


# ---------------------------------------------------------------------------
# The f64 hull scene chip_smoke.py holds to a JAX record.
# ---------------------------------------------------------------------------

HULL_B, HULL_DT, HULL_STEPS = 4, 0.05, 4
HULL_CFG = dict(max_iter=20, solver_eps=1e-9, post_stabilization=True,
                penetration_backtrack=True, speculative=False)


def pentagon(r=0.9):
    ang = np.linspace(0, 2 * np.pi, 5, endpoint=False) + np.pi / 2
    return np.stack([r * np.cos(ang), r * np.sin(ang)], -1)


def hull_scene_arrays(seed=0):
    """A static floor (Rect 12 x 1, held by a 'total' joint), a falling
    box (Rect 1.6 x 1), a pentagon, two circles and a pendulum circle on a
    world joint; per world the free bodies are jittered and thrown down
    fast enough that some worlds backtrack.  Returns numpy (counts, verts,
    radius, p0 (B, N, 3), v0, joints as kwargs)."""
    rng = np.random.default_rng(seed)
    N = 6
    counts = np.array([4, 4, 5, 1, 1, 1], np.int32)
    verts = np.zeros((N, 5, 2))
    verts[0, :4] = square(1.0) * [6.0, 0.5]
    verts[1, :4] = square(1.0) * [0.8, 0.5]
    verts[2] = pentagon()
    for k in (0, 1):
        verts[k, 4] = verts[k, 3]
    radius = np.array([0.0, 0.0, 0.0, 0.5, 0.4, 0.3])
    p = np.zeros((HULL_B, N, 3))
    p[:, 0, 1:] = (0.0, 5.0)
    p[:, 1] = (0.3, -2.0, 3.2)
    p[:, 2] = (0.1, 0.2, 3.0)
    p[:, 3, 1:] = (2.5, 3.4)
    p[:, 4, 1:] = (-3.8, 2.4)
    p[:, 5, 1:] = (3.8, 1.0)
    p[:, 1:5] += rng.uniform(-0.05, 0.05, (HULL_B, 4, 3))
    v = np.zeros((HULL_B, N, 3))
    v[:, 1:5, 2] = rng.uniform(4.0, 30.0, (HULL_B, 4))
    v[:, 1:5, 1] = rng.normal(0, 1.0, (HULL_B, 4))
    joints = [dict(kind="total", body1=0, ref=(0.0, 0.0, 5.0)),
              dict(kind="joint", body1=5, local1=(0.0, -1.4),
                   ref=(0.0, 3.8, -0.4))]
    return counts, verts, radius, p, v, joints


def hull_scene_jax():
    counts, verts, radius, p, v, joints = hull_scene_arrays()
    static = jax_scene_static(counts, joints=[JJointSpec(**j)
                                              for j in joints], c_max=24)
    params = jax_default_params(static, verts=verts, radius=radius,
                                gravity=(0.0, 10.0), restitution=0.3,
                                fric_coeff=0.6, dtype=jnp.float64)
    state = JWorldState(jnp.asarray(p), jnp.asarray(v), jnp.zeros(HULL_B))
    return static, params, state


def hull_golden_record():
    static, params, state = hull_scene_jax()
    step = jax_batched_step(static, JaxSimConfig(**HULL_CFG))
    final, traj, rd = jax.jit(lambda pr, s: jax_rollout(
        step, pr, s, HULL_DT, HULL_STEPS, with_diagnostics=True))(
        params, state)
    counts, verts, radius, p, v, joints = hull_scene_arrays()
    return dict(
        about=("JAX package (f64, CPU): a Rect floor held by a 'total' "
               "joint, a Rect, a pentagon, two circles and a pendulum "
               "circle on a world joint; B=4, c_max=24, dt=0.05, "
               f"SimConfig({HULL_CFG}), gravity (0, 10), restitution 0.3, "
               "fric_coeff 0.6, 4 steps; written by tests/test_torch_hull.py"),
        counts=counts.tolist(), verts=verts.tolist(),
        radius=radius.tolist(), joints=joints, p0=p.tolist(), v0=v.tolist(),
        config=HULL_CFG, dt=HULL_DT, c_max=24,
        p=np.asarray(traj.p).tolist(), v=np.asarray(traj.v).tolist(),
        t=np.asarray(final.t).tolist(),
        max_halvings=np.asarray(rd.max_halvings).tolist())


def test_hull_golden_matches_jax():
    """The record chip_smoke.py reads is the JAX package's output, the
    port's plain path reproduces it (1e-10 over the 4 stabilized steps),
    and some world of it backtracks."""
    with open(GOLDEN) as f:
        rec = json.load(f)
    new = hull_golden_record()
    for k in ("p0", "v0", "p", "v", "t", "max_halvings"):
        np.testing.assert_allclose(np.asarray(rec[k]), np.asarray(new[k]),
                                   rtol=0, atol=1e-12, err_msg=k)
    assert max(rec["max_halvings"]) > 0
    static = make_scene_static(rec["counts"], joints=[
        JointSpec(**dict(j, ref=tuple(j["ref"]),
                         **{k: tuple(j[k]) for k in ("local1",) if k in j}))
        for j in rec["joints"]], c_max=rec["c_max"])
    from lcp_physics_tpu_torch.core import default_params
    params = default_params(static, verts=np.asarray(rec["verts"]),
                            radius=np.asarray(rec["radius"]),
                            gravity=(0.0, 10.0), restitution=0.3,
                            fric_coeff=0.6, **F64)
    state = state_from_numpy(JWorldState(np.asarray(rec["p0"]),
                                         np.asarray(rec["v0"]),
                                         np.zeros(HULL_B)), **F64)
    step = make_batched_step(static, SimConfig(**rec["config"]))
    final, traj, rd = rollout(step, params, state, rec["dt"], HULL_STEPS,
                              with_diagnostics=True)
    np.testing.assert_allclose(traj.p.numpy(), rec["p"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(traj.v.numpy(), rec["v"], rtol=0, atol=1e-10)
    np.testing.assert_array_equal(rd.max_halvings.numpy(),
                                  rec["max_halvings"])


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    with open(GOLDEN, "w") as f:
        json.dump(hull_golden_record(), f)
        f.write("\n")
    print("wrote", GOLDEN)
