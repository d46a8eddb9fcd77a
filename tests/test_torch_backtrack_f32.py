"""The penetration backtrack on the f32 hull grid: the port halves its step
where the JAX package does (CPU).

The grid is the big-world tool's hull grid (``build_grid_scene(N, 1,
hulls=True)``: squares of side 2 at spacing 2.01, numpy seed 1) at its
smallest sizes, 2 x 2 and 3 x 3, whose first steps halve the step (the
3 x 3 grid exhausts its 6 halvings, reported as 7), under
``SimConfig(max_iter=12, solver_eps=1e-5, penetration_backtrack=True)``.
Halvings per step over three steps equal the JAX package's at float32
(run in a process of its own, without x64) and at float64: the halvings
are the scene's, not float32 noise of either solver."""
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
from lcp_physics_tpu.parallel import make_batched_step as jax_batched_step
from lcp_physics_tpu.utils import SimConfig as JaxSimConfig
from test_torch_pdipm import one_torch_thread  # noqa: F401

from lcp_physics_tpu_torch.parallel import make_batched_step
from lcp_physics_tpu_torch.tools.bigworld import DT, build_grid_scene
from lcp_physics_tpu_torch.utils import SimConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(max_iter=12, solver_eps=1e-5, penetration_backtrack=True)
SIDES, STEPS = (2, 3), 3
# halvings per step of the grids above, in both packages at f32 and f64
WANT = {2: [1, 0, 0], 3: [7, 1, 0]}

# the JAX package at float32: the JAX tool's own grid (float32 arrays).
# The tool puts a fixed directory at the front of sys.path and imports
# `bench` from it: the JAX package is imported from this checkout first,
# `bench` is a stub, and sys.path is restored after the tool loads.
JAX_F32 = f"""
import importlib.util, json, os, sys, types
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {ROOT!r})
import lcp_physics_tpu
from lcp_physics_tpu.parallel import make_batched_step
from lcp_physics_tpu.utils import SimConfig
bench = types.ModuleType("bench")
bench.log = bench.time_chained = None
sys.modules["bench"] = bench
path = list(sys.path)
spec = importlib.util.spec_from_file_location(
    "bw", {os.path.join(ROOT, "tools", "bigworld.py")!r})
bw = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bw)
sys.path[:] = path
assert os.path.abspath(lcp_physics_tpu.__file__).startswith(
    {ROOT + os.sep!r})
out = {{}}
for side in {SIDES!r}:
    static, params, s = bw.build_grid_scene(side * side, 1, hulls=True)
    assert s.p.dtype == "float32"
    step = jax.jit(make_batched_step(static, SimConfig(**{CFG!r})))
    out[side] = []
    for _ in range({STEPS}):
        s, d = step(params, s, {DT})
        out[side].append(int(d.halvings[0]))
print(json.dumps(out))
"""


def port_halvings(side, dtype):
    static, params, s = build_grid_scene(side * side, 1, hulls=True,
                                         dtype=dtype, device="cpu")
    step = make_batched_step(static, SimConfig(**CFG))
    out = []
    with torch.no_grad():
        for _ in range(STEPS):
            s, d = step(params, s, DT)
            out.append(int(d.halvings[0]))
    return out


def test_f32_halvings_match_jax_f32():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_ENABLE_X64", None)
    res = subprocess.run([sys.executable, "-c", JAX_F32], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    jax_f32 = {int(k): v for k, v in json.loads(
        res.stdout.strip().splitlines()[-1]).items()}
    port_f32 = {side: port_halvings(side, torch.float32) for side in SIDES}
    assert jax_f32 == port_f32 == WANT


@pytest.mark.parametrize("side", SIDES)
def test_f64_halvings_match_jax(side):
    static, params, s = build_grid_scene(side * side, 1, hulls=True,
                                         dtype=torch.float64, device="cpu")
    jstatic = jax_scene_static(static.counts, c_max=static.c_max)
    jparams = jax_default_params(
        jstatic, verts=params.verts.numpy(), radius=params.radius.numpy(),
        gravity=(0.0, 10.0), restitution=0.4, dtype=jnp.float64)
    js = JWorldState(*(jnp.asarray(getattr(s, f).numpy())
                       for f in ("p", "v", "t")))
    step = jax.jit(jax_batched_step(jstatic, JaxSimConfig(**CFG)))
    got = []
    for _ in range(STEPS):
        js, d = step(jparams, js, DT)
        got.append(int(d.halvings[0]))
    assert got == port_halvings(side, torch.float64) == WANT[side]
    assert np.isfinite(np.asarray(js.p)).all()
