r"""The batched world step: contact LCP assembly + semi-implicit Euler.

Counterpart of ``lcp_physics_tpu/core/step.py`` for the batch-native step
(``make_step_batched``) and its rollout.  Velocity-level contact model
(Stewart-Trinkle / Anitescu-Potra), mapped onto the solver's blocks as in
the JAX package:

    G = [-Jc; -Jf; 0],  F = [[0,0,0],[0,0,-E],[-diag(mu),E^T,0]],
    h = [e (Jc v); 0; 0]; padded slots get zero rows and h = 1.

The contact-free fast path is a Python ``if`` on the batch-level AABB
predicate (the JAX package's ``lax.cond``): one host synchronisation per
step, and one more for the post-step penetration gate.

The step is differentiable end to end: gradients pass through the
narrowphase, the contact compaction (a gather) and the assembly as plain
autograd, and through the LCP by ``lcp_solve``'s implicit backward.

Not ported yet (each raises): post-stabilization and the penetration
backtrack (ROADMAP A6), the single-world ``make_step`` (A6).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint

from lcp_physics_tpu_torch.core.geometry import (any_aabb_overlap,
                                                 find_contacts,
                                                 max_penetration)
from lcp_physics_tpu_torch.core.jacobians import (assemble_contact_jacobians,
                                                  assemble_Je)
from lcp_physics_tpu_torch.core.state import (SceneParams, SceneStatic,
                                              WorldState)
from lcp_physics_tpu_torch.lcp import lcp_solve
from lcp_physics_tpu_torch.lcp.cone import ConeF
from lcp_physics_tpu_torch.lcp.pdipm import _dtype_consts
from lcp_physics_tpu_torch.utils import SimConfig


class StepDiagnostics(NamedTuple):
    n_contacts: torch.Tensor       # (B,) int32 active contacts at the input
    max_penetration: torch.Tensor  # (B,) deepest penetration after the step
    pre_penetration: torch.Tensor  # (B,) deepest penetration at the input
    halvings: torch.Tensor         # (B,) int32 dt halvings (0: no backtrack)


class RolloutDiagnostics(NamedTuple):
    """Per-step :class:`StepDiagnostics` reduced over a rollout."""

    max_penetration: torch.Tensor
    max_pre_penetration: torch.Tensor
    max_halvings: torch.Tensor
    total_contacts: torch.Tensor


def generalized_mass(params: SceneParams):
    """Diagonal mass matrix entries (..., 3N): [I_k, m_k, m_k] per body."""
    M = torch.stack([params.inertia, params.mass, params.mass], dim=-1)
    return M.reshape(M.shape[:-2] + (-1,))


def motion_margins(params: SceneParams, states: WorldState, dt_w, counts,
                   tol=1e-6):
    """(B, N) speculative-contact activation band: how far each body can
    travel this step, plus a slop that keeps resting contacts active."""
    vn = torch.linalg.vector_norm(params.verts, dim=-1)       # (..., N, V)
    vmask = torch.as_tensor(
        np.arange(vn.shape[-1])[None, :] < np.asarray(counts)[:, None],
        device=vn.device)
    reach = params.radius + torch.amax(torch.where(vmask, vn, 0.0), dim=-1)
    speed = (torch.linalg.vector_norm(states.v[..., 1:3], dim=-1)
             + states.v[..., 0].abs() * reach)
    gmag = torch.linalg.vector_norm(params.gravity, dim=-1)[..., None]
    dt = dt_w[:, None]
    return (dt * (speed + dt * gmag) + 10.0 * tol).detach()


def total_force(static: SceneStatic, params: SceneParams, states: WorldState):
    """Generalized forces (B, N, 3): gravity plus the optional force hook."""
    f = torch.zeros_like(states.p)
    f[..., 1:3] += params.mass[..., None] * params.gravity[..., None, :]
    if static.force_fn is not None:
        f = f + static.force_fn(params.force_params, states, states.t)
    return f


def _take(x, idx):
    """Per-body parameter x ((N,) shared or (B, N) per world) at body
    indices idx (B, C)."""
    return x[idx] if x.dim() == 1 else x.gather(-1, idx)


def make_assemble(static: SceneStatic, config: SimConfig):
    """Batched LCP block assembly.  Returns ``assemble(params, states,
    dt_w) -> (blocks, contacts)`` carrying the staged split the contact-free
    fast path uses as attributes: ``eq``, ``any_overlap``, ``contacts``,
    ``contact_blocks`` and ``empty_blocks`` (same stages as the JAX
    package; ``dt_w`` is the (B,) per-world step)."""
    pairs = static.pair_lists()
    counts = static.counts_np()
    N = static.n_bodies
    C = static.c_max
    fd = config.fric_dirs

    def assemble_eq(params, states, dt_w):
        """Mass, force and equality blocks — no narrowphase."""
        B = states.p.shape[0]
        Mdiag = generalized_mass(params).expand(B, 3 * N)
        v = states.v.reshape(B, -1)
        f = total_force(static, params, states).reshape(B, -1)
        u = Mdiag * v + dt_w[:, None] * f
        Je = assemble_Je(static, states.p)
        b_eq = torch.zeros(Je.shape[:2], dtype=u.dtype, device=u.device)
        return dict(Q=Mdiag, p=-u, A=Je, b=b_eq)

    def _margin(params, states, dt_w):
        return (motion_margins(params, states, dt_w, counts, config.tol)
                if config.speculative else None)

    def assemble_contacts(params, states, dt_w):
        """Narrowphase: (contacts, row_mask); row_mask is None when the
        scene has no contact capacity."""
        contacts = find_contacts(states.p, params.verts, params.radius,
                                 counts, pairs, C,
                                 margin=_margin(params, states, dt_w))
        if config.stop_contact_grad:
            contacts = type(contacts)(*(x.detach() for x in contacts))
        if C == 0:
            return contacts, None
        mask = contacts.valid.to(states.p.dtype)
        return contacts, torch.cat([mask, mask.repeat(1, fd), mask], dim=-1)

    def any_overlap(params, states, dt_w):
        """(B,) conservative contact predicate at AABB cost."""
        return any_aabb_overlap(states.p, params.verts, params.radius,
                                counts, pairs,
                                margin=_margin(params, states, dt_w))

    def assemble_contact_blocks(params, states, contacts, eq, rmask, dt_w):
        """The G/h/F contact tensors."""
        B = states.p.shape[0]
        dtype = states.p.dtype
        v = states.v.reshape(B, -1)
        Jc, Jf, _ = assemble_contact_jacobians(contacts, N, fd)
        valid = contacts.valid
        mask = valid.to(dtype)
        e_rest = 0.5 * (_take(params.restitution, contacts.ia)
                        + _take(params.restitution, contacts.ib))
        mu = torch.sqrt(torch.clamp(_take(params.fric_coeff, contacts.ia)
                                    * _take(params.fric_coeff, contacts.ib),
                                    min=0.0)) * mask
        G = torch.cat([-Jc, -Jf, torch.zeros_like(Jc)], dim=1)
        F = ConeF(mu=mu, valid=mask, fd=fd)
        # Normal-row targets: the restitution law for touching contacts
        # and for speculative ones that would cross their gap this step;
        # otherwise cap the approach speed at gap/dt.
        dt = dt_w[:, None]
        jcv = torch.einsum("bcn,bn->bc", Jc, v)
        gap = torch.clamp(-contacts.depth, min=0.0)
        will_hit = ((-jcv) * dt >= gap) | (gap <= 0)
        h_n = torch.where(valid, torch.where(will_hit, e_rest * jcv,
                                             gap / dt), 1.0)
        h_f = torch.where(valid.repeat(1, fd), 0.0, 1.0).to(dtype)
        h_g = torch.where(valid, 0.0, 1.0).to(dtype)
        h = torch.cat([h_n, h_f, h_g], dim=-1)
        return dict(**eq, G=G, h=h, F=F, row_mask=rmask)

    def empty_blocks(eq):
        """Contact blocks for a scene with NO contact capacity (C == 0)."""
        Q = eq["Q"]
        B = Q.shape[0]
        opts = dict(dtype=Q.dtype, device=Q.device)
        return dict(**eq, G=torch.zeros((B, 0, 3 * N), **opts),
                    h=torch.zeros((B, 0), **opts),
                    F=torch.zeros((B, 0, 0), **opts))

    def assemble(params, states, dt_w):
        eq = assemble_eq(params, states, dt_w)
        contacts, rmask = assemble_contacts(params, states, dt_w)
        if rmask is None:
            return empty_blocks(eq), contacts
        return (assemble_contact_blocks(params, states, contacts, eq, rmask,
                                        dt_w), contacts)

    assemble.eq = assemble_eq
    assemble.contacts = assemble_contacts
    assemble.any_overlap = any_overlap
    assemble.contact_blocks = assemble_contact_blocks
    assemble.empty_blocks = empty_blocks
    return assemble


def _equality_solve(Qd, pvec, A, b):
    """Closed-form KKT solution with NO active inequality rows:
    ``min 1/2 v' diag(Qd) v + p' v  s.t.  A v = b`` with the solver's
    equality-block regularization (same formula as the JAX package)."""
    vin = -pvec / Qd
    q = A.shape[-2]
    if q == 0:
        return vin
    reg = _dtype_consts(Qd.dtype)["reg"]
    AQ = A / Qd[..., None, :]
    S = AQ @ A.transpose(-1, -2) + reg * torch.eye(q, dtype=Qd.dtype,
                                                   device=Qd.device)
    rhs = torch.einsum("...qn,...n->...q", A, vin) - b
    nu = torch.linalg.solve(S, rhs[..., None])[..., 0]
    return vin - torch.einsum("...qn,...q->...n", A, nu) / Qd


def _max_depth(contacts):
    return torch.clamp(torch.amax(torch.where(contacts.valid, contacts.depth,
                                              0.0), dim=-1), min=0.0)


def make_step_batched(static: SceneStatic, config: SimConfig = SimConfig(),
                      params_batched=False):
    """Batch-native step: ``step_b(params, states, dt) -> (states',
    StepDiagnostics)`` with ONE batched LCP solve per step.  Parameters are
    shared by all worlds, or per world with a leading batch axis when
    ``params_batched``."""
    if config.post_stabilization or config.penetration_backtrack:
        raise NotImplementedError(
            "ROADMAP A6: post_stabilization and penetration_backtrack are "
            "not ported yet")
    assemble = make_assemble(static, config)
    N = static.n_bodies
    C = static.c_max
    pairs = static.pair_lists()
    counts = static.counts_np()
    fast_free = config.contact_free_fast_path
    dyn_kw = dict(max_iter=config.max_iter, tol=config.solver_eps,
                  backend=config.lcp_backend, q_is_diag=True,
                  refine=config.solver_refine,
                  not_improved_lim=config.solver_stall_lim,
                  gondzio=config.solver_gondzio,
                  stall_rtol=config.solver_stall_rtol, gamma_rows=C,
                  fric_pair=(config.fric_dirs == 2),
                  factor_precision=config.solver_factor_precision)

    def solve_with_contacts(params, states, eq, dt_w):
        contacts, rmask = assemble.contacts(params, states, dt_w)
        blocks = assemble.contact_blocks(params, states, contacts, eq,
                                         rmask, dt_w)
        v = lcp_solve(**blocks, **dyn_kw)
        ncon = (contacts.valid & (contacts.depth > 0)).sum(-1).to(torch.int32)
        return v, ncon, _max_depth(contacts)

    def step_tile(params, states, dt):
        B = states.p.shape[0]
        dtype, dev = states.p.dtype, states.p.device
        dt_w = torch.as_tensor(dt, dtype=dtype, device=dev).expand(B)
        zeros_i = torch.zeros(B, dtype=torch.int32, device=dev)
        zeros_f = torch.zeros(B, dtype=dtype, device=dev)
        eq = assemble.eq(params, states, dt_w)
        ncon, prepen = zeros_i, zeros_f
        if not C:
            # no contact capacity: the solver's equality-only KKT, with
            # its regularization and its implicit backward, as in JAX
            v_flat = lcp_solve(**assemble.empty_blocks(eq), **dyn_kw)
        # Contact-free fast path: the AABB predicate False proves the
        # whole batch contact-free (host sync, see module docstring).
        elif fast_free and not bool(
                assemble.any_overlap(params, states, dt_w).any()):
            v_flat = _equality_solve(eq["Q"], eq["p"], eq["A"], eq["b"])
        else:
            v_flat, ncon, prepen = solve_with_contacts(params, states, eq,
                                                       dt_w)
        v_new = v_flat.reshape(B, N, 3)
        p_new = states.p + dt_w[:, None, None] * v_new
        new_states = WorldState(p=p_new, v=v_new, t=states.t + dt_w)
        sg_pnew = p_new.detach()
        if C and (not fast_free or bool(any_aabb_overlap(
                sg_pnew, params.verts, params.radius, counts, pairs).any())):
            post = max_penetration(sg_pnew, params.verts, params.radius,
                                   counts, pairs)
        else:
            post = zeros_f
        return new_states, StepDiagnostics(ncon, post.detach(), prepen,
                                           zeros_i)

    tile = config.batch_tile

    def step_b(params, states, dt):
        B = states.p.shape[0]
        if tile <= 0 or B <= tile:
            return step_tile(params, states, dt)
        if B % tile:
            raise ValueError(
                f"world batch {B} is not divisible by batch_tile {tile}")
        outs = []
        for t0 in range(0, B, tile):
            sl = slice(t0, t0 + tile)
            s_t = WorldState(states.p[sl], states.v[sl], states.t[sl])
            p_t = (SceneParams(**{
                f: (getattr(params, f)[sl] if f != "force_params"
                    else params.force_params)
                for f in SceneParams.__dataclass_fields__})
                if params_batched else params)
            outs.append(step_tile(p_t, s_t, dt))
        cat = lambda xs: torch.cat(xs, dim=0)
        new_states = WorldState(*(cat([getattr(o[0], f) for o in outs])
                                  for f in ("p", "v", "t")))
        diags = StepDiagnostics(*(cat([o[1][i] for o in outs])
                                  for i in range(4)))
        return new_states, diags

    return step_b


def rollout(step, params, state, dt, n_steps, remat=False,
            with_diagnostics=False):
    """Roll the world forward ``n_steps`` (a Python loop in place of
    ``lax.scan``).  Returns (final_state, trajectory) with every
    intermediate :class:`WorldState` stacked on a leading time axis, plus
    the :class:`RolloutDiagnostics` with ``with_diagnostics=True``.

    ``remat=True`` runs each step under ``torch.utils.checkpoint`` (the
    JAX package's ``jax.checkpoint`` per step): the backward recomputes a
    step's forward instead of keeping its activations."""
    if remat:
        plain = step
        step = lambda pr, s, dt_: torch.utils.checkpoint.checkpoint(
            plain, pr, s, dt_, use_reentrant=False)
    zf = torch.zeros_like(state.t)
    zi = torch.zeros(state.t.shape, dtype=torch.int32, device=state.t.device)
    rd = RolloutDiagnostics(zf, zf, zi, zi)
    traj = []
    s = state
    for _ in range(n_steps):
        s, d = step(params, s, dt)
        traj.append(s)
        rd = RolloutDiagnostics(
            torch.maximum(rd.max_penetration, d.max_penetration),
            torch.maximum(rd.max_pre_penetration, d.pre_penetration),
            torch.maximum(rd.max_halvings, d.halvings),
            rd.total_contacts + d.n_contacts)
    stack = lambda f: torch.stack([getattr(x, f) for x in traj])
    trajectory = WorldState(stack("p"), stack("v"), stack("t"))
    if with_diagnostics:
        return s, trajectory, rd
    return s, trajectory
