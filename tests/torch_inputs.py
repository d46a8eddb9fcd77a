"""Inputs and comparisons of the port's tests: the scenes, LCP batches and
KKT matrices they are made from (numpy draws from fixed seeds, so a batch
is the same on the CPU and on the card), per-world errors, one-ulp moves
of an input, the plain-versions switch (``plain_kernels``) and the
``one_torch_thread`` fixture.

Imports numpy, torch and pytest, never jax: the card's tests import it
under ``python -m pytest --noconftest -m cuda``, where no jax is present,
and ``tools/time_kernels.py`` loads it by path for its inputs.  Every
function imports the port where it runs, so the package is whichever tree
is first on ``sys.path``.
"""
import contextlib

import numpy as np
import pytest
import torch

B = 4096
N, C, DT, STEPS = 8, 8, 0.01, 20
CAP_ITERS = 3   # the fused kernel's per-world check: iterations, no stopping
TRAIN_B, TRAIN_SIDE, TRAIN_C, TRAIN_STEPS = 256, 8, 128, 8
TRAIN_B64 = 32
GJ_RES_RATIO = 4   # a panel kernel's ||K X - I|| against its plain version's
LINE_B, LINE_STEPS = 64, 20
ITER_B64 = 32   # K6 at float64: worlds of the dense scene
HULL_B, HULL_STEPS, HULL_C = 256, 8, 128   # bench.py's dense hull grid
STAB_B, STAB_STEPS = 64, 4
WORLD_STEPS, INFER_EPOCHS = 60, 3
LCP_KW = dict(max_iter=15, tol=1e-6, gamma_rows=C, not_improved_lim=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain torch versions on one CPU thread.  The suite runs several
    test processes side by side, and torch's per-process thread pools then
    oversubscribe the cores and spin-wait on each other (on 8 cores, six
    copies of a 3 s test took 455 s together that way, 17 s on one thread
    each).  The modules that import this fixture use it too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def kkt_batch(rng, B, n):
    """Quasi-definite KKT matrices [[Q, G^T], [G, -D]], the class the
    interior-point solver factors (numpy, float64)."""
    nq = (n + 1) // 2
    m = n - nq
    L = rng.standard_normal((B, nq, nq))
    K = np.zeros((B, n, n))
    K[:, :nq, :nq] = L @ L.transpose(0, 2, 1) + nq * np.eye(nq)
    G = rng.standard_normal((B, m, nq))
    K[:, nq:, :nq] = G
    K[:, :nq, nq:] = G.transpose(0, 2, 1)
    K[:, nq:, nq:] = -np.eye(m) * rng.uniform(0.1, 10.0, (B, m, 1))
    return K


def engine_instance(rng, B, n, C, q, valid_frac=0.7, pair=True, fd=2):
    """Engine-layout contact LCPs (the generator of tests/test_fused_ipm.py,
    numpy only): with ``pair`` the +-friction pair structure (fd = 2),
    without it ``fd`` independent friction rows per contact."""
    qd = rng.uniform(0.5, 2.0, (B, n))
    p = rng.standard_normal((B, n))
    valid = (rng.random((B, C)) < valid_frac).astype(float)
    mu = rng.uniform(0.3, 1.0, (B, C)) * valid
    Jc = rng.standard_normal((B, C, n)) * valid[..., None]
    if pair:
        fd = 2
        Jf1 = rng.standard_normal((B, C, n)) * valid[..., None]
        Jf = np.concatenate([Jf1, -Jf1], 1)
    else:
        Jf = rng.standard_normal((B, fd * C, n)) \
            * np.tile(valid, (1, fd))[..., None]
    G = np.concatenate([-Jc, -Jf, np.zeros((B, C, n))], 1)
    jcv = np.einsum("bcn,bn->bc", Jc, p)
    h = np.concatenate([np.where(valid > 0, 0.3 * jcv, 1.0),
                        np.where(np.tile(valid, (1, fd)) > 0, 0.0, 1.0),
                        np.where(valid > 0, 0.0, 1.0)], -1)
    rmask = np.concatenate([valid, np.tile(valid, (1, fd)), valid], -1)
    A = rng.standard_normal((B, q, n))
    b = np.einsum("bqn,bn->bq", A, rng.standard_normal((B, n))) * 0.1
    return qd, p, G, h, A, b, mu, valid, rmask


def world_rel(a, r):
    """Per-world ||a - r||_inf / ||r||_inf (leading axis = worlds)."""
    a = a.double().reshape(a.shape[0], -1)
    r = r.double().reshape(r.shape[0], -1)
    return (a - r).abs().amax(-1) / r.abs().amax(-1).clamp_min(1e-300)


def share(e, lim):
    """Share of worlds whose error e is at most lim."""
    return float((e <= lim).double().mean())


def rel_err(a, r):
    """Largest per-world ||a - r||_inf / ||r||_inf."""
    return float(world_rel(a, r).max())


def inv_residual(torch, K, X):
    """Per-matrix ||K X - I||_inf (largest entry), in float64."""
    eye = torch.eye(K.shape[-1], dtype=torch.float64, device=K.device)
    return (K.double() @ X.double() - eye).abs().amax((1, 2))


def ulp_tensor(torch, x):
    """x moved by about one ulp of float32 (torch generator, seed 1)."""
    return x * (1 + 2.0 ** -23 * torch.randn(
        x.shape, generator=torch.Generator(x.device).manual_seed(1),
        device=x.device, dtype=x.dtype))


def ulp(p0, seed=1):
    """p0 moved by about one float32 ulp (numpy, ``seed``)."""
    return p0 * (1 + 2.0 ** -23
                 * np.random.default_rng(seed).standard_normal(p0.shape))


def hold_full_f32(torch, tag, got, ref, pert):
    """A float32 full solve (z, s, lam, nu, mu, resid, iters) against its
    plain version ``ref``: f32 stops on a merit near its f32 floor, where
    one ulp of input moves the stopping iteration and z, so the plain
    version at p + 1 ulp (``pert``) is the yardstick for the shares."""
    same = got[6] == ref[6]
    ez = world_rel(got[0], ref[0])[same]
    el = world_rel(got[2], ref[2])[same]
    frac = float(same.double().mean())
    frac_ulp = float((pert[6] == ref[6]).double().mean())
    assert frac >= 0.9 * frac_ulp, (tag, frac, frac_ulp)
    assert share(ez, 1e-4) >= 0.999, (tag, share(ez, 1e-4))
    assert float(ez.median()) <= 1e-6, (tag, float(ez.median()))
    assert float(el.median()) <= 1e-4, (tag, float(el.median()))
    merit_ref = ref[4] + ref[5]
    worse = float((got[4] + got[5] - merit_ref).max())
    worse_ulp = float((pert[4] + pert[5] - merit_ref).max())

    def agree(x, y):
        e = (x[0] - y[0]).abs().amax(-1) / \
            y[0].abs().amax(-1).clamp_min(1.0)
        return share(e, 1e-3)
    frac, frac_ulp = agree(got, ref), agree(pert, ref)
    assert worse <= 1e-3, (tag, worse, worse_ulp)
    assert frac >= frac_ulp - 0.01, (tag, frac, frac_ulp)


def launch_counts():
    from lcp_physics_tpu_torch.ops import ipm, ipm_iter, linalg
    return dict(linalg.LAUNCHES, **ipm.LAUNCHES, **ipm_iter.LAUNCHES)


def kernel_counts():
    """``launch_counts()`` less ``pad``, the padded copies of the blocked
    factor, which run on any device: the hand-written kernels' launches,
    which CPU tensors leave at zero."""
    return {k: n for k, n in launch_counts().items() if k != "pad"}


@contextlib.contextmanager
def plain_kernels(what):
    """Route the solver through the plain torch versions (the comparison
    path): the solver looks its kernels up on these modules, and its
    unfused loop runs eagerly (a captured CUDA graph of a pass replays the
    kernels it captured).  Checks that no kernel launched inside, so the
    comparison path was plain (``kernel_counts``: a padded copy is no
    kernel)."""
    from lcp_physics_tpu_torch.lcp import pdipm
    from lcp_physics_tpu_torch.ops import ipm, ipm_iter, linalg
    swaps = [(pdipm, "loop_route", lambda *a: "eager"),
             (linalg, "lu_factor", linalg.plu_factor_ref),
             (linalg, "lu_solve", linalg.plu_solve_ref),
             (linalg, "gj_inv_blocked", linalg.gj_inv_blocked_ref),
             (linalg, "gj_inv", linalg.gj_inv_ref),
             (ipm, "fused_ipm", ipm.fused_ipm_ref),
             (ipm_iter, "fused_iter_ipm", ipm_iter.fused_iter_ipm_ref)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, ref in swaps:
        setattr(mod, name, ref)
    before = kernel_counts()
    try:
        yield
    finally:
        for (mod, name, _), f in zip(swaps, saved):
            setattr(mod, name, f)
    assert kernel_counts() == before, \
        f"{what} launched a kernel (plain versions only)"


def slice_start(B):
    """The benchmark scene's start (numpy, seed 0): per world 8 circles at
    positions uniform(0, 5) with angle 0, velocities standard normal."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 5.0, (B, N, 2))
    p0 = np.concatenate([np.zeros((B, N, 1)), pos], -1)
    return p0, rng.standard_normal((B, N, 3))


def slice_scene(torch, dev, dt, p0, v0):
    from lcp_physics_tpu_torch.core import (WorldState, default_params,
                                            make_scene_static)
    from lcp_physics_tpu_torch.parallel import make_batched_step
    from lcp_physics_tpu_torch.utils import SimConfig
    static = make_scene_static([1] * N, c_max=C)
    params = default_params(static, verts=np.zeros((N, 1, 2)),
                            radius=np.full(N, 1.0), gravity=(0.0, 10.0),
                            restitution=0.4, dtype=dt, device=dev)
    state = WorldState(torch.tensor(p0, dtype=dt, device=dev),
                       torch.tensor(v0, dtype=dt, device=dev),
                       torch.zeros(p0.shape[0], dtype=dt, device=dev))
    step = make_batched_step(static, SimConfig(max_iter=15, solver_eps=1e-6))
    return step, params, state


def grid_start(B, side, seed=1):
    """The touching grid of bench.py::build_world_scene(dense=True):
    side x side radius-1 circles at spacing 2.01, positions jittered by
    uniform(-0.01, 0.01), velocities normal(0, 0.5), drawn per world
    (numpy, ``seed``)."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(side), np.arange(side))
    pos = np.stack([gx.ravel() * 2.01, gy.ravel() * 2.01], -1)
    pos = pos + rng.uniform(-0.01, 0.01, (B, side * side, 2))
    v0 = rng.normal(0, 0.5, (B, side * side, 3))
    return np.concatenate([np.zeros((B, side * side, 1)), pos], -1), v0


def line_start(B):
    """bench.py::bench_fwd_bwd's touching line: 8 radius-1 circles at
    spacing 2.0 on the x axis, at rest, in every world."""
    pos = np.stack([np.arange(8) * 2.0, np.zeros(8)], -1)
    p0 = np.concatenate([np.zeros((8, 1)), pos], -1)
    return np.broadcast_to(p0, (B, 8, 3)).copy(), np.zeros((B, 8, 3))


def train_scene(torch, dev, dt, p0, v0, c_max, restitution=0.4, **cfg):
    """(step, params, state) of a circle scene under the benchmark's
    training configuration, SimConfig(max_iter=12, solver_eps=1e-5)
    (``cfg`` adds or replaces fields), gravity (0, 10); params.mass,
    .restitution,
    .fric_coeff and state.v require gradients."""
    from lcp_physics_tpu_torch.core import (WorldState, default_params,
                                            make_scene_static)
    from lcp_physics_tpu_torch.parallel import make_batched_step
    from lcp_physics_tpu_torch.utils import SimConfig
    n = p0.shape[1]
    static = make_scene_static([1] * n, c_max=c_max)
    params = default_params(static, verts=np.zeros((n, 1, 2)),
                            radius=np.full(n, 1.0), gravity=(0.0, 10.0),
                            restitution=restitution, dtype=dt, device=dev)
    state = WorldState(torch.tensor(p0, dtype=dt, device=dev),
                       torch.tensor(v0, dtype=dt, device=dev),
                       torch.zeros(p0.shape[0], dtype=dt, device=dev))
    for x in (params.mass, params.restitution, params.fric_coeff, state.v):
        x.requires_grad_(True)
    step = make_batched_step(static, SimConfig(
        **dict(dict(max_iter=12, solver_eps=1e-5), **cfg)))
    return step, params, state


def train_step(torch, step, params, state, n_steps, remat=False):
    """Loss mean(p^2) after an ``n_steps`` rollout and its gradients with
    respect to (mass, restitution, fric_coeff, v0)."""
    from lcp_physics_tpu_torch.core import rollout
    final, _ = rollout(step, params, state, DT, n_steps, remat=remat)
    loss = (final.p ** 2).mean()
    leaves = (params.mass, params.restitution, params.fric_coeff, state.v)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def first_step_lcp(torch, dev, dt, B, seed=1):
    """The LCP of the dense scene's first step (the touching 8 x 8 grid of
    ``grid_start(B, 8, seed)``, c_max = 128): the keyword arguments
    make_batched_step gives lcp_solve."""
    import lcp_physics_tpu_torch.core.step as step_mod
    step, params, state = train_scene(torch, dev, dt,
                                      *grid_start(B, TRAIN_SIDE, seed),
                                      TRAIN_C)
    seen = {}
    orig = step_mod.lcp_solve

    def capture(**kw):
        seen.update(kw)
        return orig(**kw)
    step_mod.lcp_solve = capture
    try:
        with torch.no_grad():
            step(params, state, DT)
    finally:
        step_mod.lcp_solve = orig
    return seen


def iter_operands(torch, lcp):
    """K6's operands for ``lcp`` (first_step_lcp's): Ghat and Q^-1, the
    initial iterate X0, the rotated factor (its ``iter_inv_raw`` builds the
    inverse) and the dtype's constants."""
    from lcp_physics_tpu_torch.lcp import pdipm
    from lcp_physics_tpu_torch.ops import ipm
    Q, p, G, h, A, b, F = (lcp[k] for k in "Q p G h A b F".split())
    rmask = lcp["row_mask"].to(p.dtype)
    consts = pdipm._dtype_consts(p.dtype)
    ops = ipm.rot_operands(Q, G, A, F.C)
    fac = pdipm._rot_factor_factory(ops, F, consts["reg"])
    X0 = torch.cat(pdipm._start(fac, p, h, b, rmask, consts), -1)
    vecs = (ops[1], ops[2], p, h, b, F.mu, F.valid, rmask)
    return vecs, X0, fac, consts


def engine_iter_case(torch, dev, Bn, n, C, q, dt, seed):
    """K6's operands on ``engine_instance`` LCPs (numpy, ``seed``): the
    vectors, X0, the inverse at X0's scaling, the dtype's constants."""
    from lcp_physics_tpu_torch.lcp.cone import ConeF
    from lcp_physics_tpu_torch.lcp.pdipm import (_dtype_consts,
                                                 _rot_factor_factory, _start)
    from lcp_physics_tpu_torch.ops import ipm
    qd, p, G, h, A, b, mu, valid, rmask = (
        torch.tensor(x, dtype=dt, device=dev)
        for x in engine_instance(np.random.default_rng(seed), Bn, n, C, q))
    consts = _dtype_consts(dt)
    ops = ipm.rot_operands(qd, G, A, C)
    fac = _rot_factor_factory(ops, ConeF(mu, valid), consts["reg"])
    X0 = torch.cat(_start(fac, p, h, b, rmask, consts), -1)
    m = 4 * C
    d_inv = torch.clamp(X0[:, n:n + m] / X0[:, n + m:n + 2 * m],
                        consts["dinv_min"], consts["dinv_max"])
    vecs = (ops[1], ops[2], p, h, b, mu, valid, rmask)
    return vecs, X0, fac, fac.iter_inv_raw(d_inv), consts


def slice_lcp(torch, dev, dt, Bn=None):
    """The LCPs of bench.py::bench_lcp_solves: the first step of the
    forward slice's scene (the first ``Bn`` worlds of slice_start(B)),
    assembled by make_assemble: lcp_solve's keyword arguments Q, p, G, h,
    A, b, F and row_mask."""
    from lcp_physics_tpu_torch.core import (WorldState, default_params,
                                            make_assemble, make_scene_static)
    from lcp_physics_tpu_torch.utils import SimConfig
    Bn = Bn or B
    p0, v0 = (x[:Bn] for x in slice_start(B))
    static = make_scene_static([1] * N, c_max=C)
    params = default_params(static, verts=np.zeros((N, 1, 2)),
                            radius=np.full(N, 1.0), gravity=(0.0, 10.0),
                            restitution=0.4, dtype=dt, device=dev)
    state = WorldState(torch.tensor(p0, dtype=dt, device=dev),
                       torch.tensor(v0, dtype=dt, device=dev),
                       torch.zeros(Bn, dtype=dt, device=dev))
    assemble, _ = make_assemble(static,
                                SimConfig(max_iter=15, solver_eps=1e-6))
    with torch.no_grad():
        blocks, _ = assemble(params, state,
                             torch.full((Bn,), DT, dtype=dt, device=dev))
    return blocks


def lcp_fwd_bwd(torch, blocks, backward=True, **kw):
    """z of lcp_solve on ``blocks`` and, with ``backward``, the gradients of
    sum(z^2) with respect to h and F.mu."""
    from lcp_physics_tpu_torch.lcp import ConeF, lcp_solve
    F = blocks["F"]
    h = blocks["h"].clone().requires_grad_(backward)
    mu = F.mu.clone().requires_grad_(backward)
    args = dict(blocks, h=h, F=ConeF(mu, F.valid, F.fd))
    if not backward:
        with torch.no_grad():
            return lcp_solve(**args, **kw), None, None
    z = lcp_solve(**args, **kw)
    gh, gmu = torch.autograd.grad((z ** 2).sum(), (h, mu))
    return z.detach(), gh, gmu


def hull_grid_start(B):
    """bench.py::build_world_scene(dense=True, hulls=True), in numpy from
    its seed and in its order: 64 squares of side 2 in a touching 8 x 8
    grid at spacing 2.01, positions jittered by uniform(-0.01, 0.01),
    velocities normal(0, 0.5) (numpy seed 1), float32, one world tiled B
    times.  Returns (p0, v0) (B, 64, 3)."""
    rng = np.random.default_rng(1)
    gx, gy = np.meshgrid(np.arange(8), np.arange(8))
    pos = np.stack([gx.ravel() * 2.01, gy.ravel() * 2.01], -1)
    pos = pos + rng.uniform(-0.01, 0.01, pos.shape)
    v0 = rng.normal(0, 0.5, (64, 3)).astype(np.float32)
    p = np.concatenate([np.zeros((64, 1)), pos], -1).astype(np.float32)
    tile = lambda x: np.broadcast_to(x, (B,) + x.shape).copy()
    return tile(p), tile(v0)


def hull_scene(torch, dev, dt, p0, v0, **cfg):
    """(step, params, state) of the hull grid: c_max = 128, gravity (0, 10),
    restitution 0.4, SimConfig(max_iter=12, solver_eps=1e-5) plus ``cfg``
    (bench.py::bench_world_steps)."""
    from lcp_physics_tpu_torch.core import (WorldState, default_params,
                                            make_scene_static)
    from lcp_physics_tpu_torch.parallel import make_batched_step
    from lcp_physics_tpu_torch.utils import SimConfig
    static = make_scene_static([4] * 64, c_max=HULL_C)
    sq = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])
    params = default_params(static,
                            verts=np.broadcast_to(sq, (64, 4, 2)).copy(),
                            radius=np.zeros(64), gravity=(0.0, 10.0),
                            restitution=0.4, dtype=dt, device=dev)
    state = WorldState(torch.tensor(p0, dtype=dt, device=dev),
                       torch.tensor(v0, dtype=dt, device=dev),
                       torch.zeros(p0.shape[0], dtype=dt, device=dev))
    step = make_batched_step(static, SimConfig(
        **dict(dict(max_iter=12, solver_eps=1e-5), **cfg)))
    return step, params, state


def first_contacts(torch, step_cfg, params, state):
    """The contacts the step's assembly finds at ``state`` under
    ``step_cfg`` (its speculative margin and hull pair budget)."""
    from lcp_physics_tpu_torch.core import make_scene_static
    from lcp_physics_tpu_torch.core.step import make_assemble
    from lcp_physics_tpu_torch.utils import SimConfig
    static = make_scene_static([4] * 64, c_max=HULL_C)
    assemble, _ = make_assemble(static, SimConfig(**step_cfg))
    dt_w = torch.full((state.p.shape[0],), DT, dtype=state.p.dtype,
                      device=state.p.device)
    with torch.no_grad():
        c = assemble.contacts(params, state, dt_w)[0]
    return type(c)(*(x.cpu() for x in c))


def contact_set(c, w):
    """World w's valid contacts as a sorted list of exact tuples."""
    v = c.valid[w]
    cols = [c.ia[w][v], c.ib[w][v], c.depth[w][v], c.normal[w][v][:, 0],
            c.normal[w][v][:, 1], c.ra[w][v][:, 0], c.ra[w][v][:, 1]]
    return sorted(zip(*(x.tolist() for x in cols)))


@contextlib.contextmanager
def counted_factors(panels):
    """Append the panel count of every blocked factorization to ``panels``
    (the solver reaches ``plu_factor_blocks`` through the module)."""
    from lcp_physics_tpu_torch.ops import linalg
    orig = linalg.plu_factor_blocks

    def counted(K, *args, **kw):
        panels.append(-(-K.shape[-1] // linalg.PANEL))
        return orig(K, *args, **kw)
    linalg.plu_factor_blocks = counted
    try:
        yield
    finally:
        linalg.plu_factor_blocks = orig


def per_block_factor(K, exact=False):
    """The blocked factor a 128 x 128 block at a time, as the port first
    computed it: K padded to T panels, then per panel step the panel
    inverse, one product per Uhat block and one product and one
    subtraction per trailing block.  Returns (blocks, binv, n): the T x T
    grid of blocks (Lhat below the diagonal, Uhat above, the Schur
    complement's diagonal panels on it) and the (B, T, P, P) inverses."""
    from lcp_physics_tpu_torch.ops import linalg
    P = linalg.PANEL
    B, n = K.shape[0], K.shape[-1]
    T = -(-n // P)
    Kp = K
    if T * P > n:
        Kp = K.new_zeros((B, T * P, T * P))
        Kp[:, :n, :n] = K
        Kp.diagonal(dim1=1, dim2=2)[:, n:] = 1.0
    blk = [[Kp[:, t * P:(t + 1) * P, s * P:(s + 1) * P] for s in range(T)]
           for t in range(T)]
    binvs = []
    for t in range(T):
        binv_t = linalg._gj_inverse(blk[t][t], exact)
        binvs.append(binv_t)
        for s in range(t + 1, T):          # Uhat row: binv_t @ K[t, s]
            blk[t][s] = binv_t @ blk[t][s]
        for i in range(t + 1, T):          # trailing update
            for s in range(t + 1, T):
                blk[i][s] = blk[i][s] - blk[i][t] @ blk[t][s]
    return blk, torch.stack(binvs, dim=1), n


def per_block_solve(fac, r, trans=0):
    """Block substitution on :func:`per_block_factor`'s result, one
    batched matvec and one subtraction per block."""
    from lcp_physics_tpu_torch.ops import linalg
    blocks, binv, n = fac
    T, P = len(blocks), linalg.PANEL
    rp = r.new_zeros((r.shape[0], T * P))
    rp[:, :n] = r
    part = lambda t: rp[:, t * P:(t + 1) * P]
    mv = lambda M, v: torch.einsum("bij,bj->bi", M, v)
    mtv = lambda M, v: torch.einsum("bij,bi->bj", M, v)
    xs = [None] * T
    if trans == 0:
        ys = []
        for t in range(T):                 # Lhat y = r
            acc = part(t)
            for s in range(t):
                acc = acc - mv(blocks[t][s], ys[s])
            ys.append(mv(binv[:, t], acc))
        for t in reversed(range(T)):       # Uhat x = y
            acc = ys[t]
            for s in range(t + 1, T):
                acc = acc - mv(blocks[t][s], xs[s])
            xs[t] = acc
    else:
        zs = []
        for t in range(T):                 # Uhat^T z = r
            acc = part(t)
            for s in range(t):
                acc = acc - mtv(blocks[s][t], zs[s])
            zs.append(acc)
        for t in reversed(range(T)):       # Lhat^T x = z
            acc = zs[t]
            for s in range(t + 1, T):
                acc = acc - mtv(blocks[s][t], xs[s])
            xs[t] = mtv(binv[:, t], acc)
    return torch.cat(xs, dim=-1)[:, :n]


def _point_velocity_row(r):
    """Row blocks (..., 3) [d/d omega, d/d vx, d/d vy] of the world velocity
    of a point at offset r from the com: v_pt = v + omega * perp(r)."""
    one, zero = torch.ones_like(r[..., 0]), torch.zeros_like(r[..., 0])
    row_x = torch.stack([-r[..., 1], one, zero], dim=-1)
    row_y = torch.stack([r[..., 0], zero, one], dim=-1)
    return row_x, row_y


def every_joint_kind():
    """(static, p0 (numpy, 1 world)) of 10 circles under every joint kind:
    a ``joint`` to the world and one between bodies 1 and 2, a ``fixed``
    to the world and one between bodies 4 and 5, ``x`` and ``y`` on body
    6, ``rot`` on 7, ``total`` on 8 and a ``joint`` of body 9 with itself
    (its second term overwrites its first's entries of Je).  No
    coordinate of p carries more than two terms of the rows or of the
    error: past two, p's gradient sums the same terms in the loop's order
    and in the tables' (:func:`chain16_joints`)."""
    from lcp_physics_tpu_torch.core import JointSpec, make_scene_static
    js = [JointSpec("joint", 0, local1=(-0.5, 0.1), ref=(0.0, 0.3, -0.7)),
          JointSpec("joint", 1, 2, local1=(0.5, 0.2), local2=(-0.4, 0.3)),
          JointSpec("fixed", 3, local1=(0.2, -0.3), ref=(0.3, 1.1, -2.0)),
          JointSpec("fixed", 4, 5, local1=(0.1, 0.7), local2=(-0.6, 0.25),
                    ref=(0.4, 0.0, 0.0)),
          JointSpec("x", 6, ref=(0.0, 0.9, 0.0)),
          JointSpec("y", 6, ref=(0.0, 0.0, 1.3)),
          JointSpec("rot", 7, ref=(0.8, 0.0, 0.0)),
          JointSpec("total", 8, ref=(0.1, 0.2, 0.3)),
          JointSpec("joint", 9, 9, local1=(0.3, 0.1), local2=(-0.2, 0.5))]
    static = make_scene_static([1] * 10, joints=js)
    p0 = np.random.default_rng(11).uniform(-4.0, 4.0, (1, 10, 3))
    return static, p0


def chain16_joints():
    """(static, p0 (numpy, 1 world)) of the benchmark's ``chain16`` joint
    list (``benchmark/configs/chain16.json``: 64 bodies, 17 specs, q = 33)
    at random poses.  One coordinate carries three terms of the position
    error, the first link's angle (the anchor joint, the ``rot`` row and
    the first link joint), so p's gradient through the error sums them in
    the loop's order and in the tables' and may round apart there."""
    import json
    import pathlib
    from benchmark.harness import program
    from lcp_physics_tpu_torch.core import make_scene_static
    root = pathlib.Path(__file__).resolve().parents[1]
    conf = json.loads((root / "benchmark/configs/chain16.json").read_text())
    static = make_scene_static([1] * conf["bodies"],
                               joints=program.joints(conf))
    p0 = np.random.default_rng(13).uniform(-4.0, 4.0, (1, conf["bodies"], 3))
    return static, p0


def sum_order_close(got, want):
    """got equals want up to the order of a short sum: within 4 ulps of
    want's largest entry."""
    eps = torch.finfo(want.dtype).eps
    scale = float(want.abs().max())
    return float((got - want).abs().max()) <= 4 * eps * scale


def loop_joint_rows(static, p):
    """The equality Jacobian (B, n_eq, 3N) a joint spec at a time, as the
    port first computed it: per spec its rows written into (B, 3N) zero
    tensors, each offset made on p's device, then stacked."""
    from lcp_physics_tpu_torch.utils import rotate
    B, N = p.shape[0], static.n_bodies
    opts = dict(dtype=p.dtype, device=p.device)
    rows = []

    def unit(col):
        r = torch.zeros((B, 3 * N), **opts)
        r[:, col] = 1.0
        return r

    for js in static.joints:
        b1 = js.body1
        if js.kind in ("joint", "fixed"):
            r1 = rotate(torch.tensor(js.local1, **opts), p[:, b1, 0])
            row1x, row1y = _point_velocity_row(r1)
            rx = torch.zeros((B, 3 * N), **opts)
            ry = torch.zeros((B, 3 * N), **opts)
            rx[:, 3 * b1:3 * b1 + 3] = row1x
            ry[:, 3 * b1:3 * b1 + 3] = row1y
            if js.body2 >= 0:
                b2 = js.body2
                r2 = rotate(torch.tensor(js.local2, **opts), p[:, b2, 0])
                row2x, row2y = _point_velocity_row(r2)
                rx[:, 3 * b2:3 * b2 + 3] = -row2x
                ry[:, 3 * b2:3 * b2 + 3] = -row2y
            rows += [rx, ry]
            if js.kind == "fixed":
                rr = unit(3 * b1)
                if js.body2 >= 0:
                    rr[:, 3 * js.body2] = -1.0
                rows.append(rr)
        elif js.kind in ("x", "y", "rot"):
            rows.append(unit(3 * b1 + {"rot": 0, "x": 1, "y": 2}[js.kind]))
        elif js.kind == "total":
            rows += [unit(3 * b1 + col) for col in (0, 1, 2)]
        else:
            raise ValueError(f"unknown joint kind {js.kind}")
    if not rows:
        return torch.zeros((B, 0, 3 * N), **opts)
    return torch.stack(rows, dim=1)


def loop_position_error(static, p):
    """The position error (B, n_eq) a joint spec at a time, as the port
    first computed it."""
    from lcp_physics_tpu_torch.utils import rotate
    B = p.shape[0]
    opts = dict(dtype=p.dtype, device=p.device)
    errs = []
    for js in static.joints:
        b1 = js.body1
        if js.kind in ("joint", "fixed"):
            a1 = p[:, b1, 1:3] + rotate(torch.tensor(js.local1, **opts),
                                        p[:, b1, 0])
            if js.body2 >= 0:
                b2 = js.body2
                a2 = p[:, b2, 1:3] + rotate(torch.tensor(js.local2, **opts),
                                            p[:, b2, 0])
            else:
                a2 = torch.tensor(js.ref[1:3], **opts).expand(B, 2)
            err = a1 - a2
            errs += [err[:, 0], err[:, 1]]
            if js.kind == "fixed":
                rot2 = p[:, js.body2, 0] if js.body2 >= 0 else 0.0
                errs.append(p[:, b1, 0] - rot2 - js.ref[0])
        elif js.kind in ("x", "y", "rot"):
            col = {"rot": 0, "x": 1, "y": 2}[js.kind]
            errs.append(p[:, b1, col] - js.ref[col])
        elif js.kind == "total":
            errs += [p[:, b1, col] - js.ref[col] for col in (0, 1, 2)]
    if not errs:
        return torch.zeros((B, 0), **opts)
    return torch.stack(errs, dim=1)


def joint_rows_against_loop(static, p0, seed=5):
    """[(name, tables', loop's)] for the equality rows, the position error
    and p's gradient of each weighted by a fixed draw (in p0's dtype and
    on its device), from ``core.jacobians`` and from the per-spec loop."""
    from lcp_physics_tpu_torch.core import jacobians
    rng = np.random.default_rng(seed)
    B, q, N = p0.shape[0], static.n_eq, static.n_bodies
    draw = lambda *shape: torch.as_tensor(rng.normal(size=shape),
                                          dtype=p0.dtype, device=p0.device)
    out = []
    for name, tables, loop, w in (
            ("rows", jacobians.assemble_Je, loop_joint_rows,
             draw(B, q, 3 * N)),
            ("error", jacobians.constraint_position_error,
             loop_position_error, draw(B, q))):
        got, want = [], []
        for fn, res in ((tables, got), (loop, want)):
            p = p0.clone().requires_grad_(True)
            x = fn(static, p)
            res += [x.detach(), torch.autograd.grad((x * w).sum(), p)[0]]
        out += [(name, got[0], want[0]), (f"{name} grad", got[1], want[1])]
    return out


def sharded_rollout(static, cfg, params, state, steps, mesh, dev):
    """``parallel.batched_rollout`` over ``mesh``, gathered on ``dev``:
    (final, trajectory)."""
    from lcp_physics_tpu_torch.parallel import batched_rollout, gather
    outs = batched_rollout(static, cfg, params, state, DT, steps, mesh=mesh)
    return (gather([o[0] for o in outs], dev),
            gather([o[1] for o in outs], dev, dim=1))


def bwd_inputs(torch, blocks, sol, seed):
    """``_lcp_bwd_impl``'s inputs (z, s, lam, nu, Q, G, A, F) at the first
    step's solution, every entry moved by about one float32 ulp (torch
    generator, ``seed``), so that the worlds of the tiled scene differ."""
    from lcp_physics_tpu_torch.lcp.cone import ConeF
    gen = torch.Generator(sol.z.device).manual_seed(seed)

    def mv(x):
        return x * (1 + 2.0 ** -23 * torch.randn(
            x.shape, generator=gen, device=x.device, dtype=x.dtype))
    F = blocks["F"]
    return (mv(sol.z), mv(sol.s), mv(sol.lam), mv(sol.nu), mv(blocks["Q"]),
            mv(blocks["G"]), blocks["A"], ConeF(mv(F.mu), F.valid, F.fd))


def bwd_world_rel(torch, got, ref):
    """Per world, the largest ``world_rel`` over the backward's non-empty
    cotangents (dQ, dp, dG, dh, dA, db, dF.mu)."""
    return torch.stack([world_rel(a, r) for a, r in zip(got, ref)
                        if r.numel()]).amax(0)
