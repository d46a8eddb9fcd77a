"""The port's f32 physics-quality guard (counterpart of the JAX package's
``tools/validate_f32.py``).

Long float32 rollouts must keep four physical invariants, each at two
numerics profiles:

1. dense resting grid: an 8 x 8 grid of touching circles with its bottom
   row pinned settles under gravity; the deepest penetration over 500
   steps stays at most 0.06 (radius-1 bodies);
2. gravity-free cluster: 16 colliding circles conserve linear momentum
   (contacts and friction are internal forces) to 1e-2 relative over 200
   steps, and stay finite and within |p| < 100;
3. box stack: four unit boxes on a pinned slab stay standing for 300
   steps: the top box moves less than 0.2 sideways, turns less than 0.2
   and the deepest penetration stays under 0.1;
4. bounce-height law: a ball dropped onto a pinned slab with restitution
   e = 0.7 rebounds to within 15% of e^2 h0.

Scenes, rollout lengths and thresholds are the JAX tool's, unchanged; the
scenes are built from numpy as it builds them (``*_spec``, whose arrays the
tests also feed to the JAX package).  Rollouts run through
``make_step_batched`` at B = 1 and ``rollout(..., with_diagnostics=True)``.

Profiles: ``production`` is ``SimConfig(max_iter=12, solver_eps=1e-5)``,
``refine2`` the same with ``solver_refine=2``.  On the TPU the JAX
package's production profile also stores the forward factor in bfloat16;
the port has no such storage (its float32 factors stay float32), so its
production profile is that configuration alone.

Which kernels each scene reaches on the card (``record["launches"]``):
the bounce (rotated K2 = 2 * 8 + 3 = 19) the fused IPM kernel K3 at the
production profile; the stack (K2 = 67) the lane LU K1 and its
substitution K2; the free cluster (K2 = 128) one 128-panel through the
rank-16 Gauss-Jordan kernel K4 (the explicit inverse at refine 2); the
dense grid (K2 = 2 * 128 + 24 = 280) the blocked LU over three panels,
K4 on each diagonal panel.

Usage: ``python -m lcp_physics_tpu_torch.tools.validate_f32 [--device
cuda|cpu] [--quick]``.  The default is the card, and it raises without
one.  ``--quick`` shortens the rollouts (the thresholds stay).  Prints one
PASS or FAIL line per check with its value and exits 1 on any failure.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from lcp_physics_tpu_torch.core import (JointSpec, WorldState, default_params,
                                        make_scene_static, make_step_batched,
                                        rollout)
from lcp_physics_tpu_torch.lcp import pdipm
from lcp_physics_tpu_torch.ops import ipm, ipm_iter, linalg
from lcp_physics_tpu_torch.utils import SimConfig

PROFILES = {
    "production": SimConfig(max_iter=12, solver_eps=1e-5),
    "refine2": SimConfig(max_iter=12, solver_eps=1e-5, solver_refine=2),
}
E_BOUNCE = 0.7
# drop height above resting contact: ground top at y = 1.5, ball radius 1,
# so the ball rests at y = 0.5; it starts at y = -4.0
H0_BOUNCE = 0.5 + 4.0
# (dt, steps, steps with --quick) of each scene, the JAX tool's
LENGTHS = {"dense": (0.01, 500, 100), "free": (0.01, 200, 50),
           "stack": (0.01, 300, 80), "bounce": (0.005, 500, 500)}


class SceneSpec(NamedTuple):
    """A scene as numpy arrays and host values, before any tensor."""

    counts: list
    joints: tuple            # JointSpec
    c_max: int
    verts: np.ndarray        # (N, V, 2) float32
    radius: np.ndarray       # (N,) float32
    gravity: tuple
    restitution: float
    fric_coeff: float
    p: np.ndarray            # (N, 3) float32
    v: np.ndarray            # (N, 3) float32


def dense_grid_spec():
    """8 x 8 radius-1 circles at spacing 2.01, jittered by uniform(-0.005,
    0.005) (numpy seed 7), gravity toward +y, restitution 0.3, c_max = 128,
    the bottom row (y > 13.9) pinned by ``total`` joints."""
    N = 64
    rng = np.random.default_rng(7)
    gx, gy = np.meshgrid(np.arange(8), np.arange(8))
    pos = np.stack([gx.ravel() * 2.01, gy.ravel() * 2.01], -1)
    pos = pos + rng.uniform(-0.005, 0.005, pos.shape)
    p = np.concatenate([np.zeros((N, 1)), pos], -1).astype(np.float32)
    joints = tuple(JointSpec(kind="total", body1=i,
                             ref=tuple(map(float, p[i])))
                   for i in range(N) if p[i, 2] > 13.9)
    return SceneSpec([1] * N, joints, 128, np.zeros((N, 1, 2), np.float32),
                     np.full(N, 1.0, np.float32), (0.0, 10.0), 0.3, 0.9, p,
                     np.zeros((N, 3), np.float32))


def free_cluster_spec():
    """16 radius-1 circles at uniform(0, 7) positions with normal(0, 2)
    velocities (numpy seed 8), no gravity, restitution 0.6, c_max = 64."""
    N = 16
    rng = np.random.default_rng(8)
    pos = rng.uniform(0.0, 7.0, (N, 2))
    p = np.concatenate([np.zeros((N, 1)), pos], -1).astype(np.float32)
    v = rng.normal(0, 2.0, (N, 3)).astype(np.float32)
    return SceneSpec([1] * N, (), 64, np.zeros((N, 1, 2), np.float32),
                     np.full(N, 1.0, np.float32), (0.0, 0.0), 0.6, 0.9, p, v)


def stack_spec():
    """Four 2 x 1 boxes stacked upward (box k at y = 1 - k) on a 16 x 1
    slab pinned at y = 2, perturbed by uniform x (+-0.03) and rotation
    (+-0.01) (numpy seed 9), restitution 0, friction 0.9, c_max = 32."""
    boxes = 4
    sq = np.array([[-1.0, -0.5], [1.0, -0.5], [1.0, 0.5], [-1.0, 0.5]],
                  np.float32)
    ground = np.array([[-8.0, -0.5], [8.0, -0.5], [8.0, 0.5], [-8.0, 0.5]],
                      np.float32)
    N = boxes + 1
    verts = np.zeros((N, 4, 2), np.float32)
    verts[:boxes] = sq
    verts[boxes] = ground
    joints = (JointSpec(kind="total", body1=boxes, ref=(0.0, 0.0, 2.0)),)
    rng = np.random.default_rng(9)
    p = np.zeros((N, 3), np.float32)
    p[:boxes, 2] = 1.0 - np.arange(boxes)
    p[:boxes, 1] = rng.uniform(-0.03, 0.03, boxes)
    p[:boxes, 0] = rng.uniform(-0.01, 0.01, boxes)
    p[boxes, 2] = 2.0
    return SceneSpec([4] * N, joints, 32, verts, np.zeros(N, np.float32),
                     (0.0, 10.0), 0.0, 0.9, p, np.zeros((N, 3), np.float32))


def bounce_spec(e=E_BOUNCE):
    """A radius-1 ball at y = -4 above a 16 x 1 slab pinned at y = 2,
    restitution ``e``, no friction, c_max = 8."""
    ground = np.array([[-8.0, -0.5], [8.0, -0.5], [8.0, 0.5], [-8.0, 0.5]],
                      np.float32)
    verts = np.zeros((2, 4, 2), np.float32)
    verts[1] = ground
    joints = (JointSpec(kind="total", body1=1, ref=(0.0, 0.0, 2.0)),)
    p = np.array([[0.0, 0.0, -4.0], [0.0, 0.0, 2.0]], np.float32)
    return SceneSpec([1, 4], joints, 8, verts,
                     np.array([1.0, 0.0], np.float32), (0.0, 10.0), e, 0.0,
                     p, np.zeros((2, 3), np.float32))


SPECS = {"dense": dense_grid_spec, "free": free_cluster_spec,
         "stack": stack_spec, "bounce": bounce_spec}


def build(spec: SceneSpec, dtype, device):
    """The port's (SceneStatic, SceneParams, WorldState) of ``spec``: one
    world, p and v (N, 3), t ().  ``build(SPECS[name](), dtype, device)``
    builds each scene."""
    static = make_scene_static(spec.counts, joints=spec.joints,
                               c_max=spec.c_max)
    params = default_params(static, verts=spec.verts, radius=spec.radius,
                            gravity=spec.gravity,
                            restitution=spec.restitution,
                            fric_coeff=spec.fric_coeff, dtype=dtype,
                            device=device)
    opts = dict(dtype=dtype, device=device)
    state = WorldState(torch.tensor(spec.p, **opts),
                       torch.tensor(spec.v, **opts), torch.zeros((), **opts))
    return static, params, state


def run_scene(static, config, params, state, dt, n_steps):
    """``n_steps`` of one world through ``make_step_batched`` (B = 1) and
    ``rollout(..., with_diagnostics=True)``, without autograd.  Returns
    numpy (final p, final v, trajectory p (n_steps, N, 3), max
    penetration over the run)."""
    step = make_step_batched(static, config)
    states = WorldState(state.p[None], state.v[None], state.t[None])
    with torch.no_grad():
        final, traj, rd = rollout(step, params, states, dt, n_steps,
                                  with_diagnostics=True)
    np_ = lambda x: x.double().cpu().numpy()
    return (np_(final.p[0]), np_(final.v[0]), np_(traj.p[:, 0]),
            float(rd.max_penetration[0]))


# The checks: the JAX tool's formulas on numpy arrays.  Each returns
# (ok, value, detail); value is the number its threshold reads first.

def penetration_check(traj_p, max_pen, steps):
    ok = bool(np.isfinite(traj_p).all() and max_pen <= 0.06)
    return ok, max_pen, (f"max penetration over {steps} steps = "
                         f"{max_pen:.4f} (threshold 0.06)")


def momentum_check(mass, v0, final_v, final_p, traj_p, steps):
    m = np.asarray(mass)[:, None]
    p0 = (m * np.asarray(v0)[:, 1:3]).sum(0)
    p1 = (m * final_v[:, 1:3]).sum(0)
    scale = max(float(np.linalg.norm(p0)), 1.0)
    drift = float(np.linalg.norm(p1 - p0)) / scale
    ok = bool(np.isfinite(traj_p).all() and drift <= 1e-2
              and float(np.abs(final_p).max()) < 100.0)
    return ok, drift, (f"relative drift over {steps} steps = {drift:.2e} "
                       f"(threshold 1e-2)")


def stack_check(p0, final_p, traj_p, max_pen, steps):
    p0 = np.asarray(p0)
    top = int(np.argmin(p0[:, 2]))
    drift_x = float(abs(final_p[top, 1] - p0[top, 1]))
    tilt = float(abs(final_p[top, 0]))
    ok = bool(np.isfinite(traj_p).all() and drift_x < 0.2 and tilt < 0.2
              and max_pen < 0.1)
    return ok, (drift_x, tilt, max_pen), (
        f"top-box |dx| = {drift_x:.3f}, |rot| = {tilt:.3f}, max pen = "
        f"{max_pen:.3f} over {steps} steps (thresholds 0.2 / 0.2 / 0.1)")


def bounce_check(y, e=E_BOUNCE, h0=H0_BOUNCE):
    """The first rebound's apex: the least y (up is -y) within 260 steps of
    the first step near the resting height (y > 0.45)."""
    hit = np.argmax(y > 0.45)
    apex = float(y[hit:hit + 260].min())
    h1 = 0.5 - apex
    rel = abs(h1 - e * e * h0) / (e * e * h0)
    ok = bool(np.isfinite(y).all() and rel < 0.15)
    return ok, rel, (f"rebound h1 = {h1:.3f} vs e^2 h0 = {e * e * h0:.3f} "
                     f"(rel err {rel:.1%}, threshold 15%)")


NAMES = {"dense": "dense-grid penetration", "free": "momentum conservation",
         "stack": "box-stack stability", "bounce": "bounce-height law"}


def _counts():
    return dict(linalg.LAUNCHES, **ipm.LAUNCHES, **ipm_iter.LAUNCHES,
                library_lu=pdipm.ROUTES["library_lu"])


def run_check(scene, profile, device, quick=False, dtype=torch.float32):
    """One check: the scene's rollout at the profile, then the JAX tool's
    formula.  Returns a record: name, scene, profile, ok, value, detail,
    steps, seconds (host clock, synchronised), launches (kernel launches
    and library-LU routings during the rollout, those that moved)."""
    dt, n_full, n_quick = LENGTHS[scene]
    steps = n_quick if quick else n_full
    spec = SPECS[scene]()
    static, params, state = build(spec, dtype, device)
    dev = torch.device(device)
    before = _counts()
    t0 = time.perf_counter()
    final_p, final_v, traj_p, max_pen = run_scene(
        static, PROFILES[profile], params, state, dt, steps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    sec = time.perf_counter() - t0
    moved = {k: n - before[k] for k, n in _counts().items() if n > before[k]}
    if scene == "dense":
        ok, value, detail = penetration_check(traj_p, max_pen, steps)
    elif scene == "free":
        ok, value, detail = momentum_check(params.mass.cpu().numpy(), spec.v,
                                           final_v, final_p, traj_p, steps)
    elif scene == "stack":
        ok, value, detail = stack_check(spec.p, final_p, traj_p, max_pen,
                                        steps)
    else:
        ok, value, detail = bounce_check(traj_p[:, 0, 2])
    return dict(name=f"{NAMES[scene]} [{profile}]", scene=scene,
                profile=profile, ok=ok, value=value, detail=detail,
                steps=steps, seconds=sec, launches=moved)


def run_checks(device="cuda", quick=False):
    """The 8 checks (4 scenes x 2 profiles) at float32 on ``device``, in
    the JAX tool's order.  Returns their records (:func:`run_check`).
    Raises on a CUDA device when none is present."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("validate_f32: no CUDA device (pass --device cpu "
                           "for the CPU)")
    return [run_check(scene, profile, device, quick)
            for scene in SPECS for profile in PROFILES]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--quick", action="store_true",
                    help="shorter rollouts (the thresholds stay)")
    args = ap.parse_args(argv)
    name = (torch.cuda.get_device_name(0) if args.device == "cuda"
            and torch.cuda.is_available() else args.device)
    print(f"[validate_f32] device: {name}", flush=True)
    records = run_checks(args.device, args.quick)
    for r in records:
        print(f"[validate_f32] {'PASS' if r['ok'] else 'FAIL'} {r['name']}: "
              f"{r['detail']}; {r['seconds']:.1f} s, launches "
              f"{r['launches']}", flush=True)
    failures = [r["name"] for r in records if not r["ok"]]
    if failures:
        print(f"[validate_f32] FAILED: {failures}", flush=True)
        return 1
    print("[validate_f32] ALL PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
