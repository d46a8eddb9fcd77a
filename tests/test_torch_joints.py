"""The port's batched step on a jointed scene vs the JAX package (f64, CPU).

The scene: 12 circles per world, B = 4 worlds -- a 5-link chain hung from
the world by revolute joints, one body welded to the world ('fixed'), one
pinned in y ('y') and five free bodies dropped onto the chain.  Built with
no contact capacity (c_max = 0, where both packages solve the
equality-only KKT through ``lcp_solve``) and with contacts (c_max = 24),
under the step options no other port test turns: the XLA and auto
backends, per-world parameters in tiles, speculative contacts off, the
contact-free fast path off and the IPM's stall options
(``solver_stall_lim=3, solver_stall_rtol=0.05``).  Two steps each,
agreement to 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcp_physics_tpu.core import JointSpec as JJointSpec
from lcp_physics_tpu.core import WorldState as JWorldState
from lcp_physics_tpu.core import default_params as jax_default_params
from lcp_physics_tpu.core import make_scene_static as jax_scene_static
from lcp_physics_tpu.parallel import make_batched_step as jax_batched_step
from lcp_physics_tpu.utils import SimConfig as JaxSimConfig
from test_torch_pdipm import one_torch_thread  # noqa: F401

from lcp_physics_tpu_torch.core import (JointSpec, make_scene_static,
                                        params_from_numpy, state_from_numpy)
from lcp_physics_tpu_torch.lcp import lcp as port_lcp
from lcp_physics_tpu_torch.parallel import make_batched_step
from lcp_physics_tpu_torch.utils import SimConfig

N, B, DT, STEPS = 12, 4, 0.01, 2
LINK, R = 1.0, 0.5
F64 = dict(dtype=torch.float64, device="cpu")


def joints(spec):
    """The chain, the welded body 5 and the y-pinned body 6."""
    js = [spec(kind="joint", body1=0, local1=(-LINK / 2, 0.0),
               ref=(0.0, 0.0, 3.0))]
    js += [spec(kind="joint", body1=k, body2=k - 1, local1=(-LINK / 2, 0.0),
                local2=(LINK / 2, 0.0)) for k in range(1, 5)]
    js += [spec(kind="fixed", body1=5, ref=(0.0, 1.0, 5.0)),
           spec(kind="y", body1=6, ref=(0.0, 0.0, 5.0))]
    return tuple(js)


def start(seed=0):
    """numpy (p0, v0) of B worlds: the jointed bodies at their joints'
    poses, the free bodies jittered just above the chain."""
    rng = np.random.default_rng(seed)
    p = np.zeros((B, N, 3))
    p[:, :5, 1] = LINK / 2 + LINK * np.arange(5)
    p[:, :5, 2] = 3.0
    p[:, 5, 1:] = (1.0, 5.0)
    p[:, 6, 1:] = (2.1, 5.0)
    p[:, 7:, 1] = 0.6 + 0.95 * np.arange(5) + rng.uniform(-0.1, 0.1, (B, 5))
    p[:, 7:, 2] = 2.05 + rng.uniform(-0.05, 0.05, (B, 5))
    v = 4.0 * rng.standard_normal((B, N, 3))
    v[:, :7] = 0.0
    return p, v


def run_jax(c_max, cfg, params_batched):
    static = jax_scene_static([1] * N, joints=joints(JJointSpec), c_max=c_max)
    params = jax_default_params(static, verts=np.zeros((N, 1, 2)),
                                radius=np.full(N, R), dtype=jnp.float64)
    if params_batched:
        params = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (B,) + x.shape), params)
        params = params.__class__(**{
            **vars(params),
            "mass": params.mass * jnp.linspace(0.8, 1.2, B)[:, None]})
    p, v = start()
    s = JWorldState(p=jnp.asarray(p), v=jnp.asarray(v), t=jnp.zeros(B))
    step = jax.jit(jax_batched_step(static, JaxSimConfig(**cfg),
                                    params_batched=params_batched))
    for _ in range(STEPS):
        s, d = step(params, s, DT)
    return params, s, d


def run_port(c_max, cfg, params_batched, jax_params):
    static = make_scene_static([1] * N, joints=joints(JointSpec), c_max=c_max)
    params = params_from_numpy(jax_params, **F64)
    p, v = start()
    s = state_from_numpy(JWorldState(p=p, v=v, t=np.zeros(B)), **F64)
    step = make_batched_step(static, SimConfig(**cfg),
                             params_batched=params_batched)
    for _ in range(STEPS):
        s, d = step(params, s, DT)
    return s, d


def check(c_max, cfg, params_batched=False):
    params, js, jd = run_jax(c_max, cfg, params_batched)
    ts, td = run_port(c_max, cfg, params_batched, params)
    np.testing.assert_allclose(ts.p.numpy(), np.asarray(js.p), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(td.n_contacts.numpy(),
                                  np.asarray(jd.n_contacts))
    return td


@pytest.mark.parametrize("fast_free", [True, False])
def test_no_contact_capacity_matches_jax(fast_free, monkeypatch):
    """c_max = 0: the step solves the equality-only KKT through lcp_solve
    (with the solver's regularization on Q), as the JAX step does."""
    calls = []
    apply = port_lcp._LcpSolve.apply
    monkeypatch.setattr(port_lcp._LcpSolve, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    check(0, dict(contact_free_fast_path=fast_free))
    assert len(calls) == STEPS


@pytest.mark.parametrize("cfg,params_batched", [
    (dict(lcp_backend="xla"), False),
    (dict(lcp_backend="auto"), False),
    (dict(batch_tile=2), True),
    (dict(speculative=False), False),
    (dict(contact_free_fast_path=False), False),
    (dict(solver_stall_lim=3, solver_stall_rtol=0.05), False),
], ids=["xla", "auto", "params_batched_tile2", "not_speculative",
        "no_fast_path", "stall_rtol"])
def test_jointed_contacts_match_jax(cfg, params_batched):
    diag = check(24, cfg, params_batched)
    assert int(diag.n_contacts.sum()) > 0     # the contact branch ran
