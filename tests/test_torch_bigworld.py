"""Big single systems in the port vs the JAX package, f64 on CPU: the
blocked factor at many panels, and the size rule of ``resolve_backend``.

Past ``linalg.MAX_BLOCKED_N`` = 1536 rows the JAX package's
``resolve_backend`` turns ``"auto"``, ``"pallas"`` and ``"fused"`` into its
pivoted ``"xla"`` LU at every factor site; the port's
``lcp.pdipm.resolve_backend`` does the same, so such systems solve under
``"auto"`` (through ``torch.linalg.lu_factor``, counted in
``pdipm.ROUTES["library_lu"]``) instead of raising in ``plu_factor``.  Every
solve here is capped at a fixed number of iterations (``tol=0``,
``not_improved_lim=0``), so both packages take the same iterations.  The
JAX side runs ``backend="auto"``, which on the CPU is its pivoted LU."""
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

from lcp_physics_tpu import lcp as J
from test_fused_ipm import engine_instance
from test_pdipm import random_qp
from test_torch_pdipm import one_torch_thread  # noqa: F401

from lcp_physics_tpu_torch import lcp as T
from lcp_physics_tpu_torch.lcp import pdipm
from lcp_physics_tpu_torch.ops import linalg
from lcp_physics_tpu_torch.tools import bigworld as BW
from lcp_physics_tpu_torch.utils import SimConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-8
CAP = dict(max_iter=3, tol=0.0, not_improved_lim=0)


def t(x):
    return None if x is None else torch.tensor(np.asarray(x),
                                               dtype=torch.float64)


def close(got, ref, tol=TOL):
    for f in ("z", "s", "lam", "nu"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=tol,
                                   atol=tol, err_msg=f)


def equal(a, b):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def engine_case(seed, B, n, C, q):
    """An engine-layout LCP with the +- friction pair (rotated K2 = 2C + q)
    in both packages' forms: (JAX args, port args, keywords)."""
    rng = np.random.default_rng(seed)
    qd, p, G, h, A, b, F, rmask = engine_instance(rng, B, n, C, q=q,
                                                  pair=True)
    kw = dict(q_is_diag=True, gamma_rows=C, fric_pair=True, **CAP)
    jargs = (qd, p, G, h, A, b, F)
    targs = tuple(map(t, (qd, p, G, h, A, b))) + (
        T.ConeF(t(F.mu), t(F.valid), 2),)
    return jargs, targs, dict(kw, row_mask=rmask), dict(kw, row_mask=t(rmask))


def test_resolve_backend_size_rule():
    """The JAX package's size rule without its platform rule: 'auto',
    'pallas' and 'fused' become 'xla' past MAX_BLOCKED_N rows, each such
    routing counted; at or below the cap, and for 'xla', nothing moves."""
    cap = linalg.MAX_BLOCKED_N
    before = pdipm.ROUTES["library_lu"]
    for be in ("auto", "pallas", "fused", "xla"):
        assert pdipm.resolve_backend(be, cap) == be
    assert pdipm.ROUTES["library_lu"] == before
    for be in ("auto", "pallas", "fused"):
        assert pdipm.resolve_backend(be, cap + 1) == "xla"
    assert pdipm.resolve_backend("xla", cap + 1) == "xla"
    assert pdipm.resolve_backend("xla", 8) == "xla"
    assert pdipm.ROUTES["library_lu"] == before + 3


def test_dense_qp_past_the_cap_matches_jax():
    """A dense-Q QP with n + m + q = 1600 KKT rows, B = 1: the port's
    "auto" routes the dense KKT factor to the library LU and equals its
    "xla" bit for bit, and JAX's "auto" to 1e-8."""
    rng = np.random.default_rng(3)
    inst = random_qp(rng, 700, 800, 100)
    ref = jax.jit(lambda *a: J.pdipm_solve(*a, backend="auto", **CAP))(
        *inst)
    before = pdipm.ROUTES["library_lu"]
    got = T.pdipm_solve(*map(t, inst), backend="auto", **CAP)
    routed = pdipm.ROUTES["library_lu"] - before
    assert routed == CAP["max_iter"] + 1     # the start and each iteration
    equal(got, T.pdipm_solve(*map(t, inst), backend="xla", **CAP))
    close(got, ref)


def test_engine_layout_past_the_cap_matches_jax():
    """A rotated engine-layout LCP with K2 = 1600 > MAX_BLOCKED_N (C = 800,
    B = 1): under "auto" the port's rotated factor routes to the library
    LU (one routing per factory: the solve's and the backward's), equals
    "xla" bit for bit forward and backward, and matches JAX's "auto" at
    1e-8.  Under "auto" the pivotless factor would raise."""
    jargs, targs, jkw, tkw = engine_case(11, 1, 64, 800, 0)
    assert 2 * 800 > linalg.MAX_BLOCKED_N
    ref = jax.jit(lambda *a: J.lcp_solve_full(*a, backend="auto", **jkw))(
        *jargs)
    before = pdipm.ROUTES["library_lu"]
    got = T.lcp_solve_full(*targs, backend="auto", **tkw)
    assert pdipm.ROUTES["library_lu"] == before + 1
    equal(got, T.lcp_solve_full(*targs, backend="xla", **tkw))
    close(got, ref)

    def grad_p(backend):
        p = targs[1].clone().requires_grad_(True)
        z = T.lcp_solve(targs[0], p, *targs[2:], backend=backend, **tkw)
        return torch.autograd.grad(z.square().sum(), p)[0]

    before = pdipm.ROUTES["library_lu"]
    g = grad_p("auto")
    assert pdipm.ROUTES["library_lu"] == before + 2   # forward, backward
    assert torch.equal(g, grad_p("xla"))


@pytest.mark.parametrize("C,q,panels", [(284, 8, 5), (764, 8, 12)])
def test_engine_layout_blocked_panels_match_jax(C, q, panels):
    """Rotated engine-layout LCPs at K2 = 576 and 1536 (5 and 12 panels of
    the blocked factor, the latter at the cap), B = 2: the port's "auto"
    runs its pivotless blocked factor (no routing) and matches JAX's
    "auto" at 1e-8."""
    K2 = 2 * C + q
    assert -(-K2 // linalg.PANEL) == panels and K2 <= linalg.MAX_BLOCKED_N
    jargs, targs, jkw, tkw = engine_case(C, 2, 48, C, q)
    ref = jax.jit(lambda *a: J.lcp_solve_full(*a, backend="auto", **jkw))(
        *jargs)
    before = pdipm.ROUTES["library_lu"]
    got = T.lcp_solve_full(*targs, backend="auto", **tkw)
    assert pdipm.ROUTES["library_lu"] == before
    close(got, ref)


# --- the big-world tool (lcp_physics_tpu_torch.tools.bigworld) -------------

@pytest.fixture
def jax_bigworld_tool(monkeypatch):
    """The JAX package's tools/bigworld.py, loaded from this checkout's
    file.  The tool puts a fixed directory at the front of ``sys.path`` and
    imports ``bench`` from it: ``bench`` is a stub here, ``sys.path`` is
    restored after the test, and the JAX package is imported from this
    checkout before the tool runs."""
    import importlib.util
    import lcp_physics_tpu
    import lcp_physics_tpu.parallel  # noqa: F401
    import lcp_physics_tpu.utils  # noqa: F401
    bench = types.ModuleType("bench")
    bench.log = bench.time_chained = None
    monkeypatch.setitem(sys.modules, "bench", bench)
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        "jax_bigworld_tool", os.path.join(ROOT, "tools", "bigworld.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert os.path.abspath(lcp_physics_tpu.__file__).startswith(ROOT + os.sep)
    return mod


@pytest.mark.parametrize("hulls,c_max", [(False, None), (True, 48)])
def test_grid_scene_is_the_jax_tools(jax_bigworld_tool, hulls, c_max):
    """build_grid_scene builds the JAX tool's grid from the same draws:
    c_max, positions, velocities and parameters equal at float32."""
    jstatic, jparams, jstates = jax_bigworld_tool.build_grid_scene(
        16, 3, hulls=hulls, c_max=c_max)
    static, params, states = BW.build_grid_scene(
        16, 3, hulls=hulls, c_max=c_max, device="cpu")
    assert static.c_max == jstatic.c_max == (c_max or 32)
    assert static.counts == tuple(jstatic.counts)
    for f in ("p", "v", "t"):
        np.testing.assert_array_equal(getattr(states, f).numpy(),
                                      np.asarray(getattr(jstates, f)))
    for f in ("mass", "inertia", "restitution", "fric_coeff", "radius",
              "verts", "gravity"):
        np.testing.assert_array_equal(getattr(params, f).numpy(),
                                      np.asarray(getattr(jparams, f)))


def test_batched_step_past_the_cap_matches_jax(jax_bigworld_tool):
    """The 4 x 4 grid at c_max = 800 (rotated K2 = 1600 > MAX_BLOCKED_N),
    B = 1, f64: the batched step under "auto" routes each step's factor to
    the library LU, equals "xla" bit for bit, and matches the JAX
    package's step at 1e-8 (JAX's "auto" is its pivoted LU there)."""
    from lcp_physics_tpu.core import WorldState as JWorldState
    from lcp_physics_tpu.core import default_params as jax_default_params
    from lcp_physics_tpu.parallel import make_batched_step as jax_step
    from lcp_physics_tpu.utils import SimConfig as JaxSimConfig
    f64 = dict(dtype=torch.float64, device="cpu")
    rec = BW.probe(16, 1, 1, c_max=800, **f64)
    assert rec["K2"] == 1600 and rec["panels"] is None
    assert rec["path"].startswith("library LU")
    assert rec["library_lu_per_step"] == 1 and rec["k4_per_step"] == 0
    xla = BW.probe(16, 1, 1, c_max=800, config=SimConfig(
        max_iter=12, solver_eps=1e-5, lcp_backend="xla"), **f64)
    for f in ("p", "v"):
        assert torch.equal(getattr(rec["final"], f),
                           getattr(xla["final"], f)), f

    static, params, states = BW.build_grid_scene(16, 1, c_max=800, **f64)
    jstatic = jax_bigworld_tool.build_grid_scene(16, 1, c_max=800)[0]
    jparams = jax_default_params(
        jstatic, verts=params.verts.numpy(), radius=params.radius.numpy(),
        gravity=(0.0, 10.0), restitution=0.4, dtype=jax.numpy.float64)
    jstates = JWorldState(*(jax.numpy.asarray(getattr(states, f).numpy())
                            for f in ("p", "v", "t")))
    step = jax_step(jstatic, JaxSimConfig(max_iter=12, solver_eps=1e-5))
    s1, _ = jax.jit(step)(jparams, jstates, BW.DT)
    # probe's final state is one counted step from the start
    for f in ("p", "v"):
        np.testing.assert_allclose(getattr(rec["final"], f).numpy(),
                                   np.asarray(getattr(s1, f)), rtol=TOL,
                                   atol=TOL, err_msg=f)


def test_bigworld_main_needs_a_card(monkeypatch):
    """The tool defaults to the card and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BW.main([])
