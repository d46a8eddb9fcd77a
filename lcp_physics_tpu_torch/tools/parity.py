"""Trajectory and gradient parity of the port's object layer against the
reference engine (counterpart of the repository's ``tools/parity.py``).

The four BASELINE scenes (bounce, chain, inference, billiards) are built
from one scene description through an API namespace: the reference
``lcp_physics`` package's (``reference_api``) or the port's
``lcp_physics_tpu_torch.physics`` (``ours_api``) under one of the JAX
harness's two profiles:

* ``"default"``: the engine's own defaults (speculative contacts on,
  ``solver_stall_lim=1``);
* ``"reference"``: the reference's semantics pinned (``speculative=False``,
  ``PdipmEngine(stall_lim=3, stall_rtol=0.0)``).

Each scene is stepped through ``World.step`` in float64 and the largest
per-step position deviation from the reference is reported per scene and
profile (the ``"reference"`` profile is the gate, at 1e-4), then the
inference gradient d(final x)/d(mass) through ``torch.autograd`` (1e-3
relative).  Unlike the JAX harness, an error in a scene is not caught: it
ends the run with its traceback.  Without an importable ``lcp_physics``
the tool prints ``PARITY SKIP`` and returns 0; the port is held to the JAX
package's harness on the same scenes by ``tests/test_torch_bwd_tools.py``.

Usage: ``python -m lcp_physics_tpu_torch.tools.parity [--device
cuda|cpu]``.  The default is the card; with the reference present and no
card it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import sys

import numpy as np
import torch

from lcp_physics_tpu_torch.tools import bench

TOL = 1e-4
GRAD_RTOL = 1e-3
INFERENCE_STEPS = 90


def reference_available():
    return importlib.util.find_spec("lcp_physics") is not None


# ---------------------------------------------------------------------------
# Scene builders, over an API namespace (the reference's or the port's):
# the JAX harness's scenes, constructor for constructor.
# ---------------------------------------------------------------------------

def scene_bounce(api):
    ball = api.Circle([400, 100], 20, restitution=0.6)
    ball.add_force(api.ExternalForce(api.down_force, multiplier=100.0))
    floor = api.Rect([400, 300], [700, 40])
    return api.World([ball, floor], [api.TotalConstraint(floor)],
                     dt=1 / 60), [0]


def scene_chain(api):
    """Linked bodies with joints and an anchored head (BASELINE
    configs[1])."""
    bodies, joints = [], []
    prev = None
    for k in range(4):
        c = api.Circle([300 + 50 * k, 100], 10)
        c.add_force(api.ExternalForce(api.down_force, multiplier=100.0))
        bodies.append(c)
        if prev is None:
            joints.append(api.XConstraint(c))
            joints.append(api.YConstraint(c))
        else:
            joints.append(api.Joint(prev, c, [275 + 50 * k, 100]))
        prev = c
    floor = api.Rect([400, 400], [700, 40])
    bodies.append(floor)
    joints.append(api.TotalConstraint(floor))
    return api.World(bodies, joints, dt=1 / 60), list(range(4))


def scene_inference(api, mass=2.0):
    """The parameter-inference scene (BASELINE configs[2]): a ball of
    unknown mass pushed by a fixed impulse across a frictional floor."""
    ball = api.Circle([300, 280], 20, mass=mass, fric_coeff=0.4)
    ball.add_force(api.ExternalForce(api.hor_impulse, multiplier=300.0))
    floor = api.Rect([400, 320], [700, 40], fric_coeff=0.4)
    return api.World([ball, floor], [api.TotalConstraint(floor)],
                     dt=1 / 60), [0]


def scene_billiards(api, cue_v=(300.0, -20.0)):
    """Cue ball shot at a target ball (BASELINE configs[3])."""
    cue = api.Circle([200, 200], 15)
    target = api.Circle([400, 190], 15)
    w = api.World([cue, target], [], dt=1 / 60)
    v0 = [0.0, cue_v[0], cue_v[1], 0.0, 0.0, 0.0]
    if getattr(api, "__name__", "") == "ref":  # reference wants a tensor
        v0 = torch.tensor(v0, dtype=torch.float64)
    w.set_v(v0)
    return w, [0, 1]


SCENARIOS = [
    ("bounce", scene_bounce, 120),
    ("chain", scene_chain, 120),
    ("inference", scene_inference, INFERENCE_STEPS),
    ("billiards", scene_billiards, 60),
]
SYMBOLS = ("Circle", "Rect", "Hull", "Joint", "TotalConstraint",
           "XConstraint", "YConstraint", "ExternalForce", "down_force",
           "hor_impulse")


class _Namespace:
    """API namespace adapter over a package's physics modules."""

    def __init__(self, name, **symbols):
        self.__name__ = name
        for k, v in symbols.items():
            setattr(self, k, v)


def reference_api():
    from lcp_physics.physics import bodies, constraints, forces, world
    return _Namespace(
        "ref",
        Circle=bodies.Circle, Rect=bodies.Rect, Hull=bodies.Hull,
        Joint=constraints.Joint, TotalConstraint=constraints.TotalConstraint,
        XConstraint=constraints.XConstraint,
        YConstraint=constraints.YConstraint,
        ExternalForce=forces.ExternalForce, down_force=forces.down_force,
        hor_impulse=forces.hor_impulse, World=world.World)


def ours_api(profile="default", dtype=torch.float64, device="cuda"):
    """The port's API namespace under a named profile (module docstring),
    its worlds in ``dtype`` on ``device``."""
    import lcp_physics_tpu_torch.physics as phys
    extra = {} if profile == "default" else dict(
        speculative=False, engine=phys.PdipmEngine(stall_lim=3,
                                                   stall_rtol=0.0))

    class ProfileWorld(phys.World):
        def __init__(self, bodies, constraints=(), **kw):
            for k, v in dict(extra, dtype=dtype, device=device).items():
                kw.setdefault(k, v)
            super().__init__(bodies, constraints, **kw)

    name = "ours" if profile == "default" else "ours-refprofile"
    ns = _Namespace(name, **{k: getattr(phys, k) for k in SYMBOLS})
    ns.World = ProfileWorld
    return ns


def run_trajectory(api, build, steps):
    """The tracked bodies' poses after each of ``steps`` ``World.step``
    calls: a nested list (steps, tracked bodies, 3)."""
    world, track = build(api)
    traj = []
    for _ in range(steps):
        world.step()
        traj.append([[float(x) for x in world.bodies[i].p] for i in track])
    return traj


def gradient_ours_inference(dtype=torch.float64, device="cuda",
                            steps=INFERENCE_STEPS):
    """d(final x)/d(mass) through the port's rollout under the
    ``"reference"`` profile, by ``torch.autograd`` (the JAX harness's
    ``jax.grad``): the scene built at mass 1, the ball's mass set to 2."""
    from lcp_physics_tpu_torch.core import make_step, rollout
    w, _ = scene_inference(ours_api("reference", dtype, device), mass=1.0)
    static, params, state = w.functional()
    mass = torch.tensor(2.0, dtype=dtype, device=device, requires_grad=True)
    params = dataclasses.replace(
        params, mass=torch.cat([mass[None], params.mass[1:]]))
    step = make_step(static, w.engine._config(w))
    final, _ = rollout(step, params, state, w.dt, steps)
    (g,) = torch.autograd.grad(final.p[0, 1], mass)
    return float(g)


def gradient_reference_inference():
    """The same quantity through the reference engine's autograd."""
    api = reference_api()
    mass = torch.tensor(2.0, dtype=torch.float64, requires_grad=True)
    ball = api.Circle([300, 280], 20, mass=mass, fric_coeff=0.4)
    ball.add_force(api.ExternalForce(api.hor_impulse, multiplier=300.0))
    floor = api.Rect([400, 320], [700, 40], fric_coeff=0.4)
    w = api.World([ball, floor], [api.TotalConstraint(floor)], dt=1 / 60)
    for _ in range(INFERENCE_STEPS):
        w.step()
    w.bodies[0].p[1].backward()
    return float(mass.grad)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the port's worlds live; the default is the "
                         "card")
    args = ap.parse_args(argv)
    if not reference_available():
        print("PARITY SKIP: the reference lcp_physics is not importable; "
              "tests/test_torch_bwd_tools.py holds the port to the JAX "
              "package's harness on the same scenes.")
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("parity: no CUDA device")
    print(f"[parity] {bench.device_line(args.device)}")

    ref = reference_api()
    profiles = [(p, ours_api(p, device=args.device))
                for p in ("reference", "default")]
    failures = 0
    print(f"{'scenario':<12} {'profile':<10} {'steps':>5} "
          f"{'max |dp|':>12}  verdict")
    for name, build, steps in SCENARIOS:
        t_ref = np.asarray(run_trajectory(ref, build, steps))
        for pname, ours in profiles:
            dev = np.abs(t_ref - np.asarray(run_trajectory(ours, build,
                                                           steps))).max()
            # only the pinned reference profile is the gate; the default
            # one is reported (speculative contacts move impact timing)
            ok = dev <= TOL
            failures += pname == "reference" and not ok
            print(f"{name:<12} {pname:<10} {steps:>5} {dev:>12.3e}  "
                  f"{'PASS' if ok else 'FAIL'} @ {TOL:g}")

    g_ref = gradient_reference_inference()
    g_our = gradient_ours_inference(device=args.device)
    rel = abs(g_ref - g_our) / max(abs(g_ref), 1e-12)
    ok = rel <= GRAD_RTOL
    failures += not ok
    print(f"{'grad(mass)':<12} {INFERENCE_STEPS:>5} {rel:>12.3e}  "
          f"{'PASS' if ok else 'FAIL'} @ {GRAD_RTOL:g} rel (ref {g_ref:.6g}, "
          f"ours {g_our:.6g})")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
