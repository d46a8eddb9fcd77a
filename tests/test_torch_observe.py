"""The port's ``utils.observe`` vs the JAX package's, f64 on CPU:
``solver_stats`` on the forward slice's circle scene (B = 4 worlds of 8
circles, c_max = 8: the unrotated engine-layout LCP, K = 24, through the
plain unrotated fused loop; the JAX package with lcp_backend="fused", its
kernel in interpret mode), and the guards and the trace."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from lcp_physics_tpu.utils import SimConfig as JaxSimConfig
from lcp_physics_tpu.utils.observe import solver_stats as jax_solver_stats
from test_torch_pdipm import one_torch_thread  # noqa: F401
from test_torch_step import C, N, jax_scene, slice_scene

from lcp_physics_tpu_torch.core import (WorldState, make_scene_static,
                                        params_from_numpy, state_from_numpy)
from lcp_physics_tpu_torch.ops import ipm
from lcp_physics_tpu_torch.utils import SimConfig
from lcp_physics_tpu_torch.utils import observe

F64 = dict(dtype=torch.float64, device="cpu")


def test_solver_stats_matches_jax(monkeypatch):
    p, v = slice_scene(4)
    static, params, state = jax_scene(p, v)
    cfg = dict(max_iter=15, solver_eps=1e-6)
    jcfg = JaxSimConfig(lcp_backend="fused", **cfg)
    ref = jax.jit(lambda pr, st: jax_solver_stats(static, jcfg, pr, st))(
        params, state)
    calls = []
    orig = ipm.fused_ipm
    monkeypatch.setattr(ipm, "fused_ipm", lambda *a, **k: calls.append(
        k["fric_pair"]) or orig(*a, **k))
    got = observe.solver_stats(make_scene_static([1] * N, c_max=C),
                               SimConfig(**cfg),
                               params_from_numpy(params, **F64),
                               state_from_numpy(state, **F64))
    assert calls == [False]          # the unrotated loop, as in JAX
    for f in got._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-8,
                                   atol=1e-8, err_msg=f)
    assert int(got.iters.min()) > 0 and got.z.shape == (4, 3 * N)
    # a single world is solved as a batch of one and squeezed back
    one = observe.solver_stats(
        make_scene_static([1] * N, c_max=C), SimConfig(**cfg),
        params_from_numpy(params, **F64),
        WorldState(*(torch.tensor(np.asarray(x)[0])
                     for x in (state.p, state.v, state.t))))
    np.testing.assert_allclose(one.z.numpy(), got.z[0].numpy(), rtol=1e-12,
                               atol=1e-12)


def test_finite_guards_and_timer():
    p = torch.zeros(3, N, 3, **F64)
    state = WorldState(p, p.clone(), torch.zeros(3, **F64))
    assert observe.finite_mask(state).tolist() == [True] * 3
    assert observe.finite_or_raise(state) is state
    state.v[1, 2, 0] = float("nan")
    assert observe.finite_mask(state).tolist() == [True, False, True]
    with pytest.raises(FloatingPointError, match="after step 7"):
        observe.finite_or_raise(state, "after step 7")
    one = WorldState(p[0], p[0], torch.zeros((), **F64))
    assert bool(observe.finite_mask(one))


def test_trace_writes_a_trace(tmp_path):
    logdir = os.path.join(tmp_path, "trace")
    with observe.trace(logdir):
        torch.ones(4, 4) @ torch.ones(4, 4)
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "")
               for e in events)
