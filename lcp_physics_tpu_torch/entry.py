"""Entry points of the port, the analogs of the repository's
``__graft_entry__.py``.

``entry()`` gives the batched forward step of the flagship scene (B = 4
worlds of 64 circles, c_max = 128) and example arguments.
``dryrun_multichip(n)`` runs one sharded training step: the gradient of
mean(p^2) after a 3-step rollout of 2 worlds per entry of an n-entry mesh,
the parameters replicated and their gradient summed over the shards.

Both scenes place radius-1 circles on a grid of spacing 2.5 under uniform
gravity, so they never touch: every step takes the contact-free closed
form and launches no solver kernel.
"""
import numpy as np
import torch

from lcp_physics_tpu_torch.core import (WorldState, default_params,
                                        make_scene_static)
from lcp_physics_tpu_torch.parallel import (batched_rollout, gather,
                                            make_batched_step, make_mesh,
                                            tile_state)
from lcp_physics_tpu_torch.utils import SimConfig


def _scene(N, c_max, dtype=torch.float32, device="cuda"):
    """(static, params, state): N radius-1 circles on a square grid of
    spacing 2.5, gravity (0, 10), restitution 0.4."""
    static = make_scene_static([1] * N, c_max=c_max)
    params = default_params(
        static, verts=np.zeros((N, 1, 2), np.float32),
        radius=np.full(N, 1.0, np.float32), gravity=(0.0, 10.0),
        restitution=0.4, dtype=dtype, device=device)
    side = int(np.ceil(np.sqrt(N)))
    gx, gy = np.meshgrid(np.arange(side), np.arange(side))
    pos = np.stack([gx.ravel(), gy.ravel()], -1)[:N] * 2.5
    p = np.concatenate([np.zeros((N, 1)), pos], -1)
    opts = dict(dtype=dtype, device=device)
    state = WorldState(p=torch.as_tensor(p, **opts),
                       v=torch.zeros((N, 3), **opts),
                       t=torch.zeros((), **opts))
    return static, params, state


def entry(device="cuda", dtype=torch.float32):
    """(fn, example_args): ``fn(params, states)`` is one batched forward
    world step of B = 4 worlds of 64 circles."""
    B, N = 4, 64
    static, params, state = _scene(N, 128, dtype, device)
    states = tile_state(state, B)
    bstep = make_batched_step(static, SimConfig(max_iter=12,
                                                solver_eps=1e-5))

    def fn(params, states):
        new_states, _ = bstep(params, states, 0.01)
        return new_states

    return fn, (params, states)


def dryrun_multichip(n_devices, devices=None, dtype=torch.float32):
    """One sharded training step on an ``n_devices``-entry mesh: 2 worlds
    of 4 circles per entry, a 3-step rollout, the gradient of mean(p^2)
    with respect to the shared parameters.  ``devices`` lists the mesh's
    entries (default: the first ``n_devices`` CUDA devices, raising when
    fewer exist).  Prints and returns (loss, max |d loss / d mass|)."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}): {have} CUDA "
                               f"device(s); pass devices= for another mesh")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    if len(devices) != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}): {len(devices)} "
                         f"devices given")
    mesh = make_mesh(devices)
    dev = mesh.devices[0]

    B, N = 2 * n_devices, 4           # tiny shapes: 2 worlds per entry
    static, params, state = _scene(N, 8, dtype, dev)
    params.mass.requires_grad_(True)
    outs = batched_rollout(static, SimConfig(max_iter=8, solver_eps=1e-4),
                           params, tile_state(state, B), 0.01, 3, mesh=mesh)
    final = gather([o[0] for o in outs], dev)
    loss = (final.p ** 2).mean()       # the mean over all shards' worlds
    (g_mass,) = torch.autograd.grad(loss, params.mass)
    value, g = float(loss.detach()), float(g_mass.abs().max())
    if not (np.isfinite(value) and bool(torch.isfinite(g_mass).all())):
        raise RuntimeError(f"dryrun_multichip({n_devices}): loss {value}, "
                           f"d loss / d mass {g_mass.tolist()}")
    print(f"dryrun_multichip({n_devices}): loss={value:.6f} "
          f"grad|mass|={g:.3e} ok", flush=True)
    return value, g
