"""The port's general LCP library API vs the JAX package, f64 on CPU: the
cases of tests/test_pdipm.py and tests/test_lcp_grad.py replayed in both
packages on the same inputs — dense Q, dense F (or none), the Schur path
for a diagonal Q, ``m == 0`` (``solve_eq_kkt``), a ``ConeF`` against its
dense matrix, Gondzio correctors, ``verbose``, ``max_iter=0`` and
``backend="xla"`` — plus ``LCPFunction`` and ``lcp.util``.

``PYTHONPATH=. python tests/test_torch_lcp_general.py`` (from the
repository root) rewrites tests/data/torch_lcp_golden.json, the JAX record
of ``lcp_solve(fric_pair=False)`` that chip_smoke.py holds the kernels to;
``test_golden_record_matches_jax`` keeps the file honest.

The JAX side runs as its own tests run it: its default backend, which on
the CPU is the pivoted 'xla' LU, where the port's default runs its
pivotless factor; both reach the same iterates to rounding at f64."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcp_physics_tpu import lcp as J
from test_fused_ipm import engine_instance
from test_pdipm import _engine_layout_instance, check_kkt, random_qp
from test_torch_pdipm import one_torch_thread  # noqa: F401

from lcp_physics_tpu_torch import lcp as T
from lcp_physics_tpu_torch.lcp import pdipm

TOL = 1e-8


def t(x):
    return None if x is None else torch.tensor(np.asarray(x),
                                               dtype=torch.float64)


def close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def same_solution(got, ref, tol=TOL):
    for f in ("z", "s", "lam", "nu"):
        close(getattr(got, f).numpy(), getattr(ref, f), tol, f)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))


def replay_trials(seed, n, m, q, with_F, max_iter):
    """test_pdipm's five single-instance trials: the port on each alone,
    the JAX package on the five as one batch; KKT optimality of the port's
    solution as there, and the same solution as JAX's."""
    rng = np.random.default_rng(seed)
    trials = [random_qp(rng, n, m, q, with_F=with_F) for _ in range(5)]
    kw = dict(max_iter=max_iter, tol=1e-10)
    stacked = [jnp.stack(xs) for xs in zip(*trials)]
    ref = jax.jit(lambda *a: J.pdipm_solve(*a, **kw))(*stacked)
    for i, inst in enumerate(trials):
        got = T.pdipm_solve(*map(t, inst), **kw)
        check_kkt(*inst, type(got)(*(jnp.asarray(x.numpy()) for x in got)))
        same_solution(got, type(ref)(*(x[i] for x in ref)))


@pytest.mark.parametrize("n,m,q", [(5, 3, 0), (8, 6, 2), (12, 20, 4)])
def test_qp_kkt_optimality(n, m, q):
    replay_trials(0, n, m, q, False, 25)


@pytest.mark.parametrize("n,m,q", [(6, 4, 0), (10, 8, 3)])
def test_lcp_with_F_kkt(n, m, q):
    replay_trials(1, n, m, q, True, 30)


def test_equality_only_path():
    rng = np.random.default_rng(3)
    n, q = 6, 2
    L = rng.standard_normal((n, n))
    Q = L @ L.T + n * np.eye(n)
    p, A, b = (rng.standard_normal(s) for s in (n, (q, n), q))
    z, nu = T.solve_eq_kkt(t(Q), t(p), t(A), t(b))
    zj, nuj = J.solve_eq_kkt(jnp.asarray(Q), jnp.asarray(p), jnp.asarray(A),
                             jnp.asarray(b))
    close(z, zj)
    close(nu, nuj)
    close(Q @ z.numpy() + p + A.T @ nu.numpy(), 0.0)
    # m == 0 route through pdipm_solve agrees, single and batched
    sol = T.pdipm_solve(t(Q), t(p), torch.zeros(0, n, dtype=torch.float64),
                        torch.zeros(0, dtype=torch.float64), t(A), t(b),
                        torch.zeros(0, 0, dtype=torch.float64), max_iter=10,
                        tol=1e-10)
    close(sol.z, zj)
    assert sol.lam.shape == (0,) and int(sol.iters) == 0
    solb = T.pdipm_solve(t(Q)[None], t(p)[None],
                         torch.zeros(1, 0, n, dtype=torch.float64),
                         torch.zeros(1, 0, dtype=torch.float64), t(A)[None],
                         t(b)[None], torch.zeros(1, 0, 0, dtype=torch.float64))
    close(solb.z[0], zj)


def test_diag_q_schur_path_matches_dense():
    """Q as a diagonal (the Schur path) and as the dense matrix: the same z
    and gradients in the port, equal to the JAX package's."""
    rng = np.random.default_rng(21)
    n, m, q = 6, 5, 2
    qd = rng.uniform(0.5, 3.0, n)
    p = rng.standard_normal(n)
    G = rng.standard_normal((m, n))
    z0 = rng.standard_normal(n)
    h = G @ z0 + rng.uniform(0.5, 1.5, m)
    A = rng.standard_normal((q, n))
    b = A @ z0
    S = rng.standard_normal((m, m))
    F = S - S.T
    kw = dict(max_iter=30, tol=1e-11)
    solve_j = jax.jit(lambda p_: J.lcp_solve(
        jnp.asarray(qd), p_, *map(jnp.asarray, (G, h, A, b, F)), **kw))
    zj = solve_j(jnp.asarray(p))
    gj = jax.jit(jax.grad(lambda p_: solve_j(p_).sum()))(jnp.asarray(p))
    for Qx in (qd, np.diag(qd)):
        pt = t(p).requires_grad_(True)
        z = T.lcp_solve(t(Qx), pt, *map(t, (G, h, A, b, F)), **kw)
        z.sum().backward()
        close(z.detach(), zj, 1e-7)
        close(pt.grad, gj, 1e-7)
    # batched diagonal Q: each world as solved alone
    B = 3
    qd_b = np.stack([qd * (1 + 0.1 * k) for k in range(B)])
    rep = lambda x: t(np.stack([x] * B))
    zb = T.lcp_solve(t(qd_b), *map(rep, (p, G, h, A, b, F)), **kw)
    close(zb[0], T.lcp_solve(t(qd_b[0]), *map(t, (p, G, h, A, b, F)), **kw),
          1e-9)


def test_cone_f_matches_dense():
    """A ConeF and its dense matrix: matvec, solutions and the gradient
    with respect to mu, in the port and against the JAX package."""
    rng = np.random.default_rng(3)
    B, n, C = 5, 9, 4
    qd, p, G, h, F, rmask = _engine_layout_instance(rng, B, n, C)
    Fc = T.ConeF(t(F.mu), t(F.valid), 2)
    close(Fc.dense(), F.dense(), 1e-15)
    lam_t = rng.standard_normal((B, 16))
    close(Fc.matvec(t(lam_t)),
          np.einsum("bij,bj->bi", np.asarray(F.dense()), lam_t), 1e-13)
    kw = dict(max_iter=25, tol=1e-11, q_is_diag=True, gamma_rows=C)
    args = tuple(map(t, (qd, p, G, h)))
    sc = T.lcp_solve_full(*args, None, None, Fc, row_mask=t(rmask), **kw)
    sd = T.lcp_solve_full(*args, None, None, Fc.dense(), row_mask=t(rmask),
                          **kw)
    close(sc.z, sd.z, 1e-10)

    def loss_j(mu_):
        z = J.lcp_solve(qd, p, G, h, None, None, J.ConeF(mu_, F.valid, 2),
                        row_mask=rmask, **kw)
        return jnp.sum(z ** 2)

    g_j = jax.jit(jax.grad(loss_j))(F.mu)
    for dense in (False, True):
        mu = t(F.mu).requires_grad_(True)
        Fx = T.ConeF(mu, t(F.valid), 2)
        z = T.lcp_solve(*args, None, None, Fx.dense() if dense else Fx,
                        row_mask=t(rmask), **kw)
        (z ** 2).sum().backward()
        close(mu.grad, g_j, 1e-8, f"dense={dense}")


def test_gondzio_correctors_same_solution_fewer_iters():
    """Gondzio correctors on the Schur path (diagonal Q, dense G and A):
    the same solution as plain Mehrotra, no more iterations on average,
    and the JAX package's solutions and iteration counts."""
    rng = np.random.default_rng(31)
    B, n, m, q = 32, 12, 10, 3
    qd = np.abs(rng.standard_normal((B, n))) + 0.5
    p = rng.standard_normal((B, n))
    G = rng.standard_normal((B, m, n))
    h = rng.standard_normal((B, m)) + 2.0
    A = rng.standard_normal((B, q, n))
    b = rng.standard_normal((B, q))
    kw = dict(max_iter=40, tol=1e-10, q_is_diag=True, not_improved_lim=0)
    sols = {}
    for gz in (0, 2):
        got = T.lcp_solve_full(*map(t, (qd, p, G, h, A, b)), None,
                               gondzio=gz, **kw)
        ref = jax.jit(lambda *a: J.lcp_solve_full(*a, None, gondzio=gz,
                                                  **kw))(qd, p, G, h, A, b)
        same_solution(got, ref)
        assert float(got.resid.max()) < 1e-9
        sols[gz] = got
    close(sols[2].z, sols[0].z, 1e-7)
    assert float(sols[2].iters.double().mean()) <= float(
        sols[0].iters.double().mean())


@pytest.mark.parametrize("fric_pair", [True, False],
                         ids=["rotated", "unrotated"])
def test_gondzio_engine_layout_and_gradients(fric_pair):
    """Gondzio on the engine layout (diagonal Q, ConeF, gamma rows,
    row_mask), through the rotated and the unrotated factor: the same z as
    gondzio=0, the gradient with respect to p unchanged, and both equal to
    the JAX package's with backend="pallas", the same pivotless factor as
    the port's.  (Its test runs backend="xla": the pivoted LU's transposed
    solve at the solution's scaling, d = s / lam over 1e-12..1e12, moves
    the rotated layout's gradient by ~1e-7.)"""
    rng = np.random.default_rng(32)
    B, n, C = 4, 12, 6
    qd, p, G, h, F, rmask = _engine_layout_instance(rng, B, n, C)
    kw = dict(max_iter=30, tol=1e-10, q_is_diag=True, gamma_rows=C,
              fric_pair=fric_pair)
    tF = T.ConeF(t(F.mu), t(F.valid), 2)
    zs, gs = {}, {}
    for gz in (0, 2):
        solve_j = lambda p_: J.lcp_solve(qd, p_, G, h, None, None, F,
                                         gondzio=gz, row_mask=rmask,
                                         backend="pallas", **kw)
        zj = jax.jit(solve_j)(p)
        gj = jax.jit(jax.grad(lambda p_: jnp.sum(solve_j(p_) ** 2)))(p)
        pt = t(p).requires_grad_(True)
        z = T.lcp_solve(t(qd), pt, t(G), t(h), None, None, tF, gondzio=gz,
                        row_mask=t(rmask), **kw)
        (z ** 2).sum().backward()
        close(z.detach(), zj)
        close(pt.grad, gj)
        zs[gz], gs[gz] = z.detach(), pt.grad
    close(zs[2], zs[0], 1e-7)
    close(gs[2], gs[0], 1e-5)


def test_verbose_plumbs_through_and_is_solution_neutral(capfd):
    """``verbose`` prints the JAX package's per-iteration line (one host
    read per iteration, only when asked), keeps the solve out of the fused
    kernel and leaves the solution as it is; ``LCPFunction(verbose=1)``
    reaches it too."""
    rng = np.random.default_rng(33)
    B, n, C = 4, 12, 6
    qd, p, G, h, F, rmask = _engine_layout_instance(rng, B, n, C)
    kw = dict(max_iter=15, tol=1e-10, q_is_diag=True, gamma_rows=C,
              row_mask=t(rmask), fric_pair=True)
    args = tuple(map(t, (qd, p, G, h))) + (None, None,
                                          T.ConeF(t(F.mu), t(F.valid), 2))
    reads = pdipm.HOST_READS["verbose"]
    z_quiet = T.lcp_solve(*args, **kw)
    assert pdipm.HOST_READS["verbose"] == reads
    capfd.readouterr()
    sol = T.lcp_solve_full(*args, verbose=True, **kw)
    z_loud = T.lcp_solve(*args, verbose=True, backend="fused", **kw)
    close(z_loud, z_quiet, 1e-9)
    out = capfd.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("pdipm iter")]
    ran = int(sol.iters.max()) + 1
    assert len(lines) == 2 * ran
    assert lines[0].startswith("pdipm iter 0: mu=") and "done=0/4" in lines[0]
    assert f"done=4/4" in lines[ran - 1]
    assert pdipm.HOST_READS["verbose"] == reads + 2 * ran

    rngq = np.random.default_rng(34)
    inst = tuple(map(t, random_qp(rngq, 6, 4, 2)))
    z1 = T.LCPFunction(verbose=1, maxIter=10)(*inst)
    assert "pdipm iter" in capfd.readouterr().out
    fn = T.LCPFunction(maxIter=10)
    z0 = fn(*inst)
    assert fn.zhats is z0
    close(z1, z0, 1e-9)
    close(z0, J.LCPFunction(maxIter=10)(*random_qp(
        np.random.default_rng(34), 6, 4, 2)))


def test_max_iter_zero_returns_the_start_point():
    """max_iter=0: no iteration, the start point through the best-iterate
    tail, as in the JAX package (dense Q and the unrotated engine
    layout)."""
    rng = np.random.default_rng(9)
    Q, p, G, h, A, b, F = random_qp(rng, 6, 4, 2, with_F=True)
    got = T.pdipm_solve(*map(t, (Q, p, G, h, A, b, F)), max_iter=0)
    same_solution(got, jax.jit(lambda *a: J.pdipm_solve(*a, max_iter=0))(
        Q, p, G, h, A, b, F))
    qd, p, G, h, F, rmask = _engine_layout_instance(rng, 3, 9, 4)
    kw = dict(max_iter=0, q_is_diag=True, gamma_rows=4)
    got = T.lcp_solve_full(*map(t, (qd, p, G, h)), None, None,
                           T.ConeF(t(F.mu), t(F.valid), 2),
                           row_mask=t(rmask), **kw)
    ref = jax.jit(lambda *a: J.lcp_solve_full(*a, None, None, F,
                                              row_mask=rmask, **kw))(
        qd, p, G, h)
    same_solution(got, ref)
    np.testing.assert_array_equal(got.iters.numpy(), 0)


@pytest.mark.parametrize("layout", ["dense", "rotated"])
def test_xla_backend_matches_jax_xla(layout):
    """backend="xla" (the pivoted library LU and the unfused loop) against
    the JAX package's backend="xla": a dense QP with F, and the rotated
    engine layout, whose dispatch then skips the fused kernel."""
    rng = np.random.default_rng(40)
    if layout == "dense":
        inst = random_qp(rng, 10, 8, 3, with_F=True)
        kw = dict(max_iter=30, tol=1e-10)
        got = T.pdipm_solve(*map(t, inst), backend="xla", **kw)
        ref = J.pdipm_solve(*inst, backend="xla", **kw)
    else:
        qd, p, G, h, F, rmask = _engine_layout_instance(rng, 3, 9, 4)
        kw = dict(max_iter=25, tol=1e-10, q_is_diag=True, gamma_rows=4,
                  fric_pair=True)
        from lcp_physics_tpu_torch.ops import ipm
        calls = []
        orig = ipm.fused_ipm
        ipm.fused_ipm = lambda *a, **k: calls.append(1) or orig(*a, **k)
        try:
            got = T.lcp_solve_full(*map(t, (qd, p, G, h)), None, None,
                                   T.ConeF(t(F.mu), t(F.valid), 2),
                                   row_mask=t(rmask), backend="xla", **kw)
        finally:
            ipm.fused_ipm = orig
        assert not calls
        ref = J.lcp_solve_full(qd, p, G, h, None, None, F, row_mask=rmask,
                               backend="xla", **kw)
    same_solution(got, ref)


SOLVE_KW = dict(max_iter=30, tol=1e-11)


def grads_both(fn_j, fn_t, xs):
    """jax.grad of fn_j and the port's autograd of fn_t on the inputs xs
    (numpy), within 1e-8."""
    want = jax.jit(jax.grad(fn_j, argnums=tuple(range(len(xs)))))(
        *map(jnp.asarray, xs))
    ts = [t(x).requires_grad_(True) for x in xs]
    fn_t(*ts).backward()
    for i, (x, g) in enumerate(zip(ts, want)):
        scale = max(1.0, float(np.abs(np.asarray(g)).max()))
        close(x.grad, g, TOL * scale, f"input {i}")


def test_grads_qp_all_inputs():
    rng = np.random.default_rng(10)
    xs = random_qp(rng, 6, 4, 2)
    grads_both(lambda *a: J.lcp_solve(*a, **SOLVE_KW).sum(),
               lambda *a: T.lcp_solve(*a, **SOLVE_KW).sum(), xs)


def test_grads_lcp_with_F():
    rng = np.random.default_rng(11)
    xs = random_qp(rng, 6, 5, 2, with_F=True)
    grads_both(lambda *a: (J.lcp_solve(*a, **SOLVE_KW) ** 2).sum(),
               lambda *a: (T.lcp_solve(*a, **SOLVE_KW) ** 2).sum(), xs)


def test_grads_no_equality():
    rng = np.random.default_rng(12)
    xs = random_qp(rng, 5, 3, 0)[:4]
    grads_both(lambda *a: J.lcp_solve(*a, **SOLVE_KW).sum(),
               lambda *a: T.lcp_solve(*a, **SOLVE_KW).sum(), xs)


def test_grads_equality_only():
    """m == 0: the backward is the equality-only KKT solve."""
    rng = np.random.default_rng(13)
    n, q = 5, 2
    L = rng.standard_normal((n, n))
    xs = (L @ L.T + n * np.eye(n), rng.standard_normal(n),
          rng.standard_normal((q, n)), rng.standard_normal(q))
    G0, h0 = np.zeros((0, n)), np.zeros((0,))
    grads_both(lambda Q, p, A, b: J.lcp_solve(
        Q, p, jnp.asarray(G0), jnp.asarray(h0), A, b, **SOLVE_KW).sum(),
        lambda Q, p, A, b: T.lcp_solve(Q, p, t(G0), t(h0), A, b,
                                       **SOLVE_KW).sum(), xs)


def test_lcp_batch_util():
    """tests/test_aux.py::test_lcp_batch_util replayed: lcp.util.batch
    expands the shared parameters and solves the batch once; the util
    helpers as in the JAX package."""
    rng = np.random.default_rng(30)
    n, m, B = 5, 3, 4
    L = rng.standard_normal((n, n))
    Q = L @ L.T + n * np.eye(n)                     # shared across batch
    p = rng.standard_normal((B, n))                 # per-instance
    G = rng.standard_normal((m, n))
    h = G @ rng.standard_normal(n) + 1.0
    A, b, F = np.zeros((0, n)), np.zeros((0,)), np.zeros((m, m))
    solver = T.batch(lambda *xs, **kw: T.pdipm_solve(*xs, **kw).z)
    z = solver(*map(t, (Q, p, G, h, A, b, F)), max_iter=25, tol=1e-10)
    assert z.shape == (B, n)
    z0 = T.pdipm_solve(*map(t, (Q, p[0], G, h, A, b, F)), max_iter=25,
                       tol=1e-10).z
    close(z[0], z0)
    zj = jax.jit(lambda *a: J.batch(lambda *xs, **kw: J.pdipm_solve(
        *xs, **kw).z)(*a, max_iter=25, tol=1e-10))(
        *map(jnp.asarray, (Q, p, G, h, A, b, F)))
    close(z, zj)
    x, y = rng.standard_normal((2, 3)), rng.standard_normal((2, 4))
    close(T.bger(t(x), t(y)), J.bger(x, y), 0)
    assert T.get_sizes(t(G), t(A)) == J.get_sizes(G, A) == (m, n, 0)
    assert T.extract_nBatch(t(Q), t(p), t(G), t(h)) == B
    assert T.extract_batch_size(t(Q), t(p[0]), t(G), t(h)) is None
    assert T.expandParam(t(G), B, 2).shape == (B, m, n)
    with pytest.raises(ValueError):
        T.expand_param(t(p)[None], B, 1)


GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_lcp_golden.json")
GOLDEN_KW = dict(max_iter=25, tol=1e-10, not_improved_lim=3)


def golden_inputs():
    """The record's inputs (numpy): B = 4 engine-layout instances without
    the +- pair (C = 8 contacts, n = 24: the unrotated system of K = 24
    rows, within the fused kernel) and one dense-Q, dense-F QP (n = 6,
    m = 4, q = 2: a 12-row dense KKT)."""
    rng = np.random.default_rng(404)
    qd, p, G, h, A, b, F, rmask = engine_instance(rng, 4, 24, 8)
    eng = dict(qd=qd, p=p, G=G, h=h, mu=F.mu, valid=F.valid, rmask=rmask)
    Q, p, G, h, A, b, F = random_qp(rng, 6, 4, 2, with_F=True)
    qp = dict(Q=Q, p=p, G=G, h=h, A=A, b=b, F=F)
    return ({k: np.asarray(x) for k, x in eng.items()},
            {k: np.asarray(x) for k, x in qp.items()})


def golden_record():
    """JAX's z, lam and the gradients of sum(z^2) of
    lcp_solve(fric_pair=False) on golden_inputs(): the engine instances
    with backend="fused" (the unrotated whole-IPM kernel), the QP with
    backend="pallas" (the dense KKT's lane LU)."""
    eng, qp = golden_inputs()
    ekw = dict(GOLDEN_KW, q_is_diag=True, gamma_rows=8,
               row_mask=eng["rmask"], backend="fused")

    def eng_loss(p, h, mu):
        z = J.lcp_solve(eng["qd"], p, eng["G"], h, None, None,
                        J.ConeF(mu, eng["valid"], 2), **ekw)
        return jnp.sum(z ** 2)

    def qp_loss(p, h):
        z = J.lcp_solve(qp["Q"], p, qp["G"], h, qp["A"], qp["b"], qp["F"],
                        backend="pallas", **GOLDEN_KW)
        return jnp.sum(z ** 2)

    e_args = tuple(jnp.asarray(eng[k]) for k in ("p", "h", "mu"))
    e_sol = jax.jit(lambda *a: J.lcp_solve_full(
        eng["qd"], a[0], eng["G"], a[1], None, None,
        J.ConeF(a[2], eng["valid"], 2), **ekw))(*e_args)
    e_grads = jax.jit(jax.grad(eng_loss, argnums=(0, 1, 2)))(*e_args)
    q_args = tuple(jnp.asarray(qp[k]) for k in ("p", "h"))
    q_sol = jax.jit(lambda *a: J.lcp_solve_full(
        qp["Q"], a[0], qp["G"], a[1], qp["A"], qp["b"], qp["F"],
        backend="pallas", **GOLDEN_KW))(*q_args)
    q_grads = jax.jit(jax.grad(qp_loss, argnums=(0, 1)))(*q_args)
    lst = lambda x: np.asarray(x).tolist()
    return dict(
        about=("JAX package (f64, CPU) lcp_solve(fric_pair=False), "
               f"{GOLDEN_KW}: 'engine' B=4 engine-layout LCPs without the "
               "+- friction pair (C=8, n=24, gamma_rows=8, backend='fused')"
               " and 'qp' one dense-Q dense-F QP (n=6, m=4, q=2, "
               "backend='pallas'); z, lam and the gradients of sum(z^2); "
               "written by tests/test_torch_lcp_general.py"),
        kw=GOLDEN_KW,
        engine=dict({k: lst(x) for k, x in eng.items()}, z=lst(e_sol.z),
                    lam=lst(e_sol.lam), iters=lst(e_sol.iters),
                    grad_p=lst(e_grads[0]), grad_h=lst(e_grads[1]),
                    grad_mu=lst(e_grads[2])),
        qp=dict({k: lst(x) for k, x in qp.items()}, z=lst(q_sol.z),
                lam=lst(q_sol.lam), iters=lst(q_sol.iters),
                grad_p=lst(q_grads[0]), grad_h=lst(q_grads[1])))


def port_record(rec, device="cpu"):
    """The port's z, lam and gradients on the record's inputs (the kernels
    on a CUDA device), keyed as in the record."""
    out = {}
    for part in ("engine", "qp"):
        r = rec[part]
        g = lambda k: torch.tensor(r[k], dtype=torch.float64, device=device)
        leaves = [g("p").requires_grad_(True), g("h").requires_grad_(True)]
        if part == "engine":
            leaves.append(g("mu").requires_grad_(True))
            args = (g("qd"), leaves[0], g("G"), leaves[1], None, None,
                    T.ConeF(leaves[2], g("valid"), 2))
            kw = dict(rec["kw"], q_is_diag=True, gamma_rows=8,
                      row_mask=g("rmask"))
        else:
            args = (g("Q"), leaves[0], g("G"), leaves[1], g("A"), g("b"),
                    g("F"))
            kw = dict(rec["kw"])
        sol = T.lcp_solve_full(*args, **kw)
        z = T.lcp_solve(*args, **kw)
        grads = torch.autograd.grad((z ** 2).sum(), leaves)
        names = ("grad_p", "grad_h", "grad_mu")
        out[part] = dict(z=sol.z, lam=sol.lam, iters=sol.iters,
                         **dict(zip(names, grads)))
    return out


def test_golden_record_matches_jax():
    with open(GOLDEN) as f:
        rec = json.load(f)
    new = golden_record()
    for part in ("engine", "qp"):
        for k, x in new[part].items():
            np.testing.assert_allclose(np.asarray(rec[part][k]),
                                       np.asarray(x), rtol=0, atol=1e-12,
                                       err_msg=f"{part} {k}")


def test_port_matches_golden_record():
    """The port's plain versions against the record, as chip_smoke.py holds
    the kernels to it on the card: z, lam and gradients within 1e-8, the
    same iterations."""
    with open(GOLDEN) as f:
        rec = json.load(f)
    got = port_record(rec)
    for part, res in got.items():
        for k, x in res.items():
            tol = 0 if k == "iters" else 1e-8
            np.testing.assert_allclose(x.numpy(), np.asarray(rec[part][k]),
                                       rtol=tol, atol=tol,
                                       err_msg=f"{part} {k}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    with open(GOLDEN, "w") as f:
        json.dump(golden_record(), f)
        f.write("\n")
    print("wrote", GOLDEN)
