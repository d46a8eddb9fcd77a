"""The port's backward tools (``lcp_physics_tpu_torch.tools.bwd_roofline``,
``.asm_vjp_probe``, ``.parity``) against the JAX package, f64 on the CPU.

The scene is the touching grid of ``tests/test_torch_train.py`` (bench.py's
dense grid cut to 4 x 4 radius-1 circles, c_max = 72, so the rotated
Schur system K2 = 144 runs the blocked factor; B = 2, 2 steps), the JAX
step at ``lcp_backend="pallas"`` (the same pivotless blocked algorithm, in
interpret mode).  Each part the tools time is held against the JAX
package's own computation of it:

* (a) both tools' ``components`` run on the CPU and return finite times;
* (b) ``lcp-bwd`` on the first step's solution against JAX's ``_lcp_bwd``
  fed the same residuals (1e-8 of each cotangent's largest entry), and
  the tool's factor, solve and outer products against ``_lcp_bwd_impl``
  (1e-12);
* (c) the one-step pullback (ones on p and v) against ``jax.vjp`` of the
  JAX batched step, every params and state cotangent (1e-8);
* (d) the assembly's stages against ``jax.vjp`` of the same stages (1e-10);
* (e) ``remat=True`` against ``remat=False`` (1e-12);
* (f) the four parity scenes of the JAX harness (``tools/parity.py``,
  loaded from this checkout with ``sys.path`` restored) per step at 1e-8,
  both profiles, and the inference gradient.

The JAX ``tools/bwd_roofline.py`` and ``tools/asm_vjp_probe.py`` define
their parts inside ``main()`` at the flagship's fixed B, N and C, so the
JAX side of (b)-(d) is written here from the same JAX package calls
(tools/bwd_roofline.py:96-107, :111-123; tools/asm_vjp_probe.py:43-116).
"""
import dataclasses
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcp_physics_tpu.core import WorldState as JWorldState
from lcp_physics_tpu.core import default_params as jax_default_params
from lcp_physics_tpu.core import make_assemble as jax_make_assemble
from lcp_physics_tpu.core import make_scene_static as jax_scene_static
from lcp_physics_tpu.core.geometry import Contacts as JContacts
from lcp_physics_tpu.core.geometry import circle_circle as jax_circle_circle
from lcp_physics_tpu.lcp.cone import ConeF as JConeF
from lcp_physics_tpu.lcp.lcp import _lcp_bwd as jax_lcp_bwd
from lcp_physics_tpu.parallel import make_batched_step as jax_batched_step
from lcp_physics_tpu.utils import SimConfig as JaxSimConfig
from test_torch_pdipm import one_torch_thread  # noqa: F401

from torch_inputs import DT, grid_start
from lcp_physics_tpu_torch.core import (WorldState, default_params,
                                        make_scene_static)
from lcp_physics_tpu_torch.lcp.lcp import _lcp_bwd_impl
from lcp_physics_tpu_torch.parallel import make_batched_step
from lcp_physics_tpu_torch.tools import asm_vjp_probe as AV
from lcp_physics_tpu_torch.tools import bwd_roofline as BR
from lcp_physics_tpu_torch.tools import parity as TP
from lcp_physics_tpu_torch.utils import SimConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDE, C, B, STEPS = 4, 72, 2, 2
N = SIDE * SIDE
CONFIG = dict(max_iter=12, solver_eps=1e-5)
F64 = dict(dtype=torch.float64, device="cpu")


def scene_args():
    return dict(verts=np.zeros((N, 1, 2)), radius=np.full(N, 1.0),
                gravity=(0.0, 10.0), restitution=0.4)


def port_grid():
    """(static, params, states, config) of the port's grid."""
    p0, v0 = grid_start(B, SIDE)
    static = make_scene_static([1] * N, c_max=C)
    params = default_params(static, **scene_args(), **F64)
    states = WorldState(torch.tensor(p0), torch.tensor(v0),
                        torch.zeros(B, dtype=torch.float64))
    return static, params, states, SimConfig(**CONFIG)


def jax_grid():
    """(static, params, states) of the JAX package's grid."""
    p0, v0 = grid_start(B, SIDE)
    static = jax_scene_static([1] * N, c_max=C)
    params = jax_default_params(static, **scene_args(), dtype=jnp.float64)
    return static, params, JWorldState(jnp.asarray(p0), jnp.asarray(v0),
                                       jnp.zeros(B))


def close(got, want, tol, what):
    """max |got - want| within ``tol`` of want's largest entry (absolute
    ``tol`` where want is all zero); None in ``got`` is a zero cotangent."""
    want = np.asarray(want)
    got = np.zeros_like(want) if got is None else got.detach().numpy()
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol * max(np.abs(want).max(initial=0.0), 1e-300) or (
        not np.abs(want).any() and err <= tol), (what, err)


# --- (a) the tools' components on the CPU ------------------------------------

def test_bwd_roofline_components_on_the_cpu():
    static, params, states, config = port_grid()
    comp = BR.components(static, config, params, states, "cpu",
                         n_steps=STEPS, calls=(1, 1), windows=1)
    assert {k for _, k in BR.TABLE} <= set(comp)
    times = [t["host_ms"] if isinstance(t, dict) else t[0]
             for t in comp.values()]
    assert np.isfinite(times).all()
    assert all(comp[k]["host_ms"] > 0 for _, k in BR.TABLE
               if isinstance(comp[k], dict))
    # plain versions only: no kernel launched (``pad`` counts the padded
    # copies of the blocked factor, which run on any device)
    assert set(comp["lcp-bwd"]["launches"]) <= {"pad"}
    assert len(BR.lines(comp, STEPS)) == 3 + len(BR.TABLE)


def test_asm_vjp_probe_components_on_the_cpu():
    static, params, states, config = port_grid()
    comp = AV.components(static, config, params, states, "cpu", calls=1,
                         windows=1)
    assert list(comp) == ["full", "eq", "contacts", "blocks", "pairs",
                          "compact", "dyn-take"]
    times = [r[k]["host_ms"] for r in comp.values() for k in ("fwd", "pull")]
    assert np.isfinite(times).all() and min(times) > 0
    assert all(r["top"] is None for r in comp.values())   # no card here
    assert len(AV.lines(comp)) == 2 * len(comp)


# --- (b) the LCP's backward --------------------------------------------------

def test_lcp_bwd_matches_jax():
    """lcp-bwd on the grid's first-step solution against JAX's _lcp_bwd fed
    the same residuals; the tool's factor + solve + outer products rebuild
    _lcp_bwd_impl's cotangents."""
    static, params, states, config = port_grid()
    blocks, sol = BR.first_step_lcp(static, config, params, states)
    assert int(blocks["row_mask"].sum()) > 0
    g = torch.ones_like(sol.z)
    kw = BR.bwd_kw(static, config)
    got = BR.lcp_bwd(blocks, sol, g, kw)

    F = blocks["F"]
    j = lambda x: jnp.asarray(x.numpy())
    residuals = (j(sol.z), j(sol.s), j(sol.lam), j(sol.nu), j(blocks["Q"]),
                 j(blocks["G"]), j(blocks["A"]),
                 JConeF(j(F.mu), j(F.valid), F.fd), j(blocks["row_mask"]))
    want = jax.jit(lambda r, g: jax_lcp_bwd(
        12, 1e-5, "auto", True, C, 0, 1, None, True, 0, None, False, 0.0,
        r, g))(residuals, j(g))
    names = ("dQ", "dp", "dG", "dh", "dA", "db", "dF.mu")
    for name, a, b in zip(names, got, want[:6] + (want[6].mu,)):
        close(a, b, 1e-8, name)

    w = BR.bwd_factor_solves(blocks, sol, g, kw, 1)
    rebuilt = BR.outers(w, sol, F)
    direct = _lcp_bwd_impl(sol.z, sol.s, sol.lam, sol.nu, blocks["Q"],
                           blocks["G"], blocks["A"], F, g, **kw)
    for name, a, b in zip(names, rebuilt, direct):
        close(a, b.numpy(), 1e-12, name)
    w2 = BR.bwd_factor_solves(blocks, sol, g, kw, 2)
    assert torch.isfinite(w2).all() and not torch.equal(w2, w)


# --- (c) one step's pullback -------------------------------------------------

def test_step_vjp_matches_jax():
    """The one-step pullback with ones cotangents on (p, v), to every float
    leaf of params and state, against jax.vjp of the JAX batched step."""
    static, params, states, config = port_grid()
    step = make_batched_step(static, config)
    got = BR.step_parts(static, config, step, params, states)["step-vjp"]()

    jstatic, jparams, jstates = jax_grid()
    jstep = jax_batched_step(jstatic, JaxSimConfig(**CONFIG,
                                                   lcp_backend="pallas"))

    def step1(pr, st):
        s2, _ = jstep(pr, st, DT)
        return s2.p, s2.v

    def pull(pr, st):
        out, vjp = jax.vjp(step1, pr, st)
        return vjp(jax.tree.map(jnp.ones_like, out))

    ct_p, ct_s = jax.jit(pull)(jparams, jstates)
    want = [getattr(ct_p, f) for f in BR.PARAM_LEAVES] + [
        getattr(ct_s, f) for f in BR.STATE_LEAVES]
    for name, a, b in zip(BR.PARAM_LEAVES + BR.STATE_LEAVES, got, want):
        close(a, b, 1e-8, name)
    assert np.abs(np.asarray(ct_p.mass)).max() > 0


# --- (d) the assembly's stages -----------------------------------------------

def jax_stages(jstatic, jparams, jstates, config):
    """The JAX tool's stages (tools/asm_vjp_probe.py:43-116) on the JAX
    grid: label -> (fn, its primal arguments)."""
    assemble, _ = jax_make_assemble(jstatic, config)
    dt_w = jnp.full((B,), DT)
    eq_b = jax.vmap(assemble.eq, in_axes=(None, 0, 0))
    con_b = jax.vmap(assemble.contacts, in_axes=(None, 0, 0))
    cb_b = jax.vmap(assemble.contact_blocks, in_axes=(None, 0, 0, 0, 0, 0))

    def asm(pr, st):
        eq = eq_b(pr, st, dt_w)
        contacts, rmask = con_b(pr, st, dt_w)
        bl = cb_b(pr, st, contacts, eq, rmask, dt_w)
        return bl["Q"], bl["p"], bl["G"], bl["h"], bl["F"].mu

    def con_f(pr, st):
        c, _ = con_b(pr, st, dt_w)
        return c.normal, c.ra, c.rb, c.depth

    contacts, rmask = con_b(jparams, jstates, dt_w)
    eq = eq_b(jparams, jstates, dt_w)

    def blocks_f(pr, st, normal, ra, rb, depth):
        c = JContacts(normal, ra, rb, depth, contacts.ia, contacts.ib,
                      contacts.valid)
        bl = cb_b(pr, st, c, eq, rmask, dt_w)
        return bl["G"], bl["h"], bl["F"].mu

    cc_i, cc_j = (jnp.asarray(i) for i in jstatic.pair_lists()["cc"])
    P = cc_i.shape[0]

    def pair_stage(pos_b, rad):
        def one(pos):
            return jax.vmap(lambda i, j: jax_circle_circle(
                pos[i], rad[i], pos[j], rad[j]))(cc_i, cc_j)
        return jax.vmap(one)(pos_b)

    rng = np.random.default_rng(0)
    keep = jnp.asarray(np.stack([rng.permutation(P)[:C] for _ in range(B)]))
    packed = jnp.asarray(rng.normal(size=(B, P, 7)))
    both = (jparams, jstates)
    return contacts, {
        "full": (asm, both),
        # vmap hands the dict back with sorted keys: the port's order here
        "eq": (lambda pr, st: tuple(eq_b(pr, st, dt_w)[k]
                                    for k in ("Q", "p", "A", "b")), both),
        "contacts": (con_f, both),
        "blocks": (blocks_f, both + (contacts.normal, contacts.ra,
                                     contacts.rb, contacts.depth)),
        "pairs": (pair_stage, (jstates.p[:, :, 1:3], jparams.radius)),
        "compact": (lambda pk: jnp.take_along_axis(pk, keep[..., None],
                                                   axis=1), (packed,)),
        "dyn-take": (lambda r: jax.vmap(lambda i: r[i])(contacts.ia),
                     (jparams.restitution,))}


def jax_pullback(f, args):
    out, vjp = jax.vjp(f, *args)
    return vjp(jax.tree.map(jnp.ones_like, out))


def flat_cotangents(cts):
    """The JAX cotangents in the order of the port's leaves: a params and
    state pair becomes their ``PARAM_LEAVES`` and ``STATE_LEAVES``."""
    out = []
    for ct in cts:
        if isinstance(ct, JWorldState):
            out += [getattr(ct, f) for f in BR.STATE_LEAVES]
        elif dataclasses.is_dataclass(ct):
            out += [getattr(ct, f) for f in BR.PARAM_LEAVES]
        else:
            out.append(ct)
    return out


@pytest.fixture(scope="module")
def assembly_stages():
    static, params, states, config = port_grid()
    jstatic, jparams, jstates = jax_grid()
    jcontacts, jst = jax_stages(jstatic, jparams, jstates,
                                JaxSimConfig(**CONFIG))
    return AV.stages(static, config, params, states), jcontacts, jst


@pytest.mark.parametrize("label", ["full", "eq", "contacts", "blocks",
                                   "pairs", "compact", "dyn-take"])
def test_assembly_stage_pullback_matches_jax(assembly_stages, label):
    """Each assembly stage's outputs and pullback (ones cotangents) against
    jax.vjp of the JAX stage, at 1e-10."""
    stages, jcontacts, jst = assembly_stages
    f, leaves = stages[label]
    jf, jargs = jst[label]
    outs = f()
    jouts = jf(*jargs)
    jouts = jouts if isinstance(jouts, tuple) else (jouts,)
    for k, (a, b) in enumerate(zip(outs, jouts)):
        close(a, b, 1e-10, f"{label} output {k}")
    got = AV.pullback(outs, leaves)()
    want = flat_cotangents(jax.jit(jax_pullback, static_argnums=0)(jf,
                                                                   jargs))
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        close(a, b, 1e-10, f"{label} cotangent {k}")
    if label == "dyn-take":
        assert np.abs(np.asarray(want[0])).sum() == int(
            np.asarray(jcontacts.ia).size)


# --- (e) remat ---------------------------------------------------------------

def test_remat_gradient_equals_no_remat():
    static, params, states, config = port_grid()
    step = make_batched_step(static, config)
    parts = BR.rollout_parts(step, params, states, STEPS)
    (l0, g0), (l1, g1) = parts["rollout"](), parts["remat"]()
    assert float(g0.abs().max()) > 0
    close(l1, l0.numpy(), 1e-12, "loss")
    close(g1, g0.numpy(), 1e-12, "mass gradient")
    lf, gf = parts["fwd+bwd"]()
    close(parts["fwd"](), l0.numpy(), 1e-12, "fwd loss")
    close(gf, g0.numpy(), 1e-12, "bench._fwd_bwd's mass gradient")


# --- (f) the parity scenes ---------------------------------------------------

@pytest.fixture(scope="module")
def jax_parity():
    """The JAX package's tools/parity.py, loaded from this checkout's file;
    the module puts directories at the front of ``sys.path``, which is
    restored after the load."""
    import lcp_physics_tpu
    import lcp_physics_tpu.physics  # noqa: F401
    saved = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_parity_tool", os.path.join(ROOT, "tools", "parity.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    assert os.path.abspath(lcp_physics_tpu.__file__).startswith(ROOT + os.sep)
    return mod


@pytest.mark.parametrize("name", [s[0] for s in TP.SCENARIOS])
def test_parity_scene_matches_the_jax_harness(jax_parity, name):
    """Each BASELINE scene through the port's object layer, at both
    profiles, against the JAX harness's run_trajectory with its ours_api:
    every step's tracked poses within 1e-8, over the harness's horizon."""
    (_, build, steps), = [s for s in TP.SCENARIOS if s[0] == name]
    (_, jbuild, jsteps), = [s for s in jax_parity.SCENARIOS if s[0] == name]
    assert steps == jsteps
    for profile in ("reference", "default"):
        want = np.asarray(jax_parity.run_trajectory(
            jax_parity.ours_api(profile), jbuild, steps))
        got = np.asarray(TP.run_trajectory(
            TP.ours_api(profile, device="cpu"), build, steps))
        assert got.shape == want.shape == (steps, len(want[0]), 3)
        err = np.abs(got - want).max(axis=(1, 2))
        assert err.max() <= 1e-8, (profile, int(err.argmax()), err.max())


def test_parity_inference_gradient_matches_jax(jax_parity):
    want = jax_parity.gradient_ours_inference()
    got = TP.gradient_ours_inference(device="cpu")
    assert np.isfinite(got) and abs(want) > 0
    assert abs(got - want) <= 1e-8 * abs(want)


def test_parity_skips_without_the_reference(capsys):
    assert not TP.reference_available()
    assert TP.main([]) == 0
    assert capsys.readouterr().out.startswith("PARITY SKIP")
