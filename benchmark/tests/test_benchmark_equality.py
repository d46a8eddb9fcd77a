"""The reference's equality rows: the mixed LCP with A z = b against the
port's ``lcp_solve(..., A, b)`` at float64, the call without rows equal to
the call before them, the joints' rows against the port's, and the
generator's draws for the cells' mixes equal to the bytes they drew before
scenes could set velocities or read their configuration."""
import hashlib

import numpy as np
import pytest
import torch

from benchmark.harness import generate, program, spec
from benchmark.reference import joints
from benchmark.reference import lcp as ref_lcp
from benchmark.tests.helpers import bench
from lcp_physics_tpu_torch.core import assemble_Je

F64 = torch.float64
KW = dict(max_iter=30, tol=1e-12)
STALL = 3
LEAVES = ("Q", "p", "G", "h", "A", "b")


def _batch(seed, B, n, m, q, padded=0, far=0.0):
    """A feasible batch: z0 meets every row, half the inequality rows
    tight at z0; the last ``padded`` rows are padding (zero rows, h 1,
    mask 0, as the engine pads); ``far`` moves h away so that no
    inequality row binds."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda *s: torch.rand(*s, generator=g, dtype=F64)
    randn = lambda *s: torch.randn(*s, generator=g, dtype=F64)
    Q = 0.5 + rand(B, n)
    p = randn(B, n)
    G = randn(B, m, n)
    z0 = randn(B, n)
    h = (G @ z0[..., None])[..., 0] + rand(B, m) * (rand(B, m) > 0.5) + far
    A = randn(B, q, n)
    b = (A @ z0[..., None])[..., 0]
    mask = torch.ones(B, m, dtype=F64)
    if padded:
        G[:, m - padded:] = 0.0
        h[:, m - padded:] = 1.0
        mask[:, m - padded:] = 0.0
    return dict(Q=Q, p=p, G=G, h=h, A=A, b=b,
                F=torch.zeros(B, m, m, dtype=F64), row_mask=mask)


CASES = {
    "two equality rows": dict(seed=1, B=8, n=9, m=6, q=2),
    "padded rows": dict(seed=2, B=8, n=9, m=8, q=3, padded=2),
    "the equality rows alone set z": dict(seed=3, B=8, n=6, m=4, q=6,
                                          far=20.0),
}


def _reference(d, cot, rows):
    x = {k: d[k].clone().requires_grad_(True) for k in LEAVES}
    z = ref_lcp.lcp_solve(x["Q"], x["p"], x["G"], x["h"], d["F"],
                          d["row_mask"], stall_lim=STALL, solver_dtype=F64,
                          **rows(x), **KW)
    return z.detach(), dict(zip(LEAVES, torch.autograd.grad(
        (z * cot).sum(), list(x.values()), allow_unused=True)))


@pytest.mark.parametrize("case", list(CASES))
def test_lcp_with_equality_rows_agrees_with_the_port(case):
    d = _batch(**CASES[case])
    cot = torch.randn(d["p"].shape, generator=torch.Generator()
                      .manual_seed(9), dtype=F64)
    z, grads = _reference(d, cot, rows=lambda x: dict(A=x["A"], b=x["b"]))
    x = {k: d[k].clone().requires_grad_(True) for k in LEAVES}
    zp = program.lcp_solve(x["Q"], x["p"], x["G"], x["h"], x["A"], x["b"],
                           d["F"], q_is_diag=True, row_mask=d["row_mask"],
                           not_improved_lim=STALL, **KW)
    port = dict(zip(LEAVES, torch.autograd.grad((zp * cot).sum(),
                                                list(x.values()))))
    # Both run the same Mehrotra iterates at float64 to tol 1e-12 (the
    # pivoted library LU against the port's own factor): z agrees to a
    # few ulps (4e-15 measured).
    torch.testing.assert_close(z, zp.detach(), rtol=0, atol=1e-12)
    assert float((torch.linalg.vector_norm(
        (d["A"] @ z[..., None])[..., 0] - d["b"], dim=-1)).max()) < 1e-12
    if case == "the equality rows alone set z":
        torch.testing.assert_close(z, torch.linalg.solve(d["A"], d["b"]),
                                   rtol=0, atol=1e-12)
    # The gradients come from one transposed solve at the last iterate,
    # whose d = s / lam spans the clamps (1e-12 to 1e12): rounding there
    # is amplified to 4e-11 of gradients of size ~3 (measured), so each
    # is held to 1e-9 of the largest gradient (at least 1).
    scale = max(1.0, max(float(g.abs().max()) for g in port.values()))
    for k in LEAVES:
        torch.testing.assert_close(grads[k], port[k], rtol=0,
                                   atol=1e-9 * scale, msg=f"d{k}")


def test_no_equality_rows_is_the_call_without_them():
    """A (B, 0, n) and b (B, 0) run what a call without A and b runs,
    forward and backward, bit for bit."""
    d = _batch(**CASES["two equality rows"])
    cot = torch.randn(d["p"].shape, generator=torch.Generator()
                      .manual_seed(9), dtype=F64)
    B, n = d["p"].shape
    empty = dict(A=torch.zeros(B, 0, n, dtype=F64),
                 b=torch.zeros(B, 0, dtype=F64))
    z0, g0 = _reference(d, cot, rows=lambda x: {})
    z1, g1 = _reference(d, cot, rows=lambda x: empty)
    assert torch.equal(z0, z1)
    for k in ("Q", "p", "G", "h"):
        assert torch.equal(g0[k], g1[k]), k
    kw = dict(stall_lim=STALL, solver_dtype=F64, **KW)
    args = [d[k] for k in ("Q", "p", "G", "h", "F", "row_mask")]
    s0, s1 = ref_lcp.solve(*args, **kw), ref_lcp.solve(*args, **empty, **kw)
    for a, c in zip(s0, s1):
        assert torch.equal(a, c)


ENTRIES = [
    {"kind": "joint", "body1": 0, "local1": [-0.5, 0.2],
     "ref": [0.0, 1.0, -2.0]},
    {"kind": "joint", "body1": 1, "body2": 2, "local1": [0.5, 0.0],
     "local2": [-0.3, 0.4]},
    {"kind": "fixed", "body1": 3, "body2": 0, "local1": [0.1, -0.2],
     "local2": [0.7, 0.0]},
    {"kind": "fixed", "body1": 2, "local1": [0.25, 0.5]},
    {"kind": "x", "body1": 1}, {"kind": "y", "body1": 3},
    {"kind": "rot", "body1": 0}, {"kind": "total", "body1": 4},
]


def test_joint_rows_and_pairs_equal_the_port():
    """Every kind of joint, one body and two: the reference's rows are
    the port's ``assemble_Je`` at random angles, and the pairs left to
    the narrowphase are the port's circle pairs."""
    N = 5
    p = torch.randn(3, N, 3, generator=torch.Generator().manual_seed(4),
                    dtype=F64)
    static = program.make_scene_static([1] * N, joints=program.joints(
        {"joints": ENTRIES}))
    A, b = joints.rows(ENTRIES, p)
    torch.testing.assert_close(A, assemble_Je(static, p), rtol=0,
                               atol=1e-15)
    assert tuple(b.shape) == (3, static.n_eq) and not b.any()
    ia, ib = joints.contact_pairs(N, ENTRIES)
    pia, pib = static.pair_lists()["cc"]
    assert np.array_equal(ia, pia) and np.array_equal(ib, pib)


# sha256 (first 16 hex digits) of p, v and the guesses each mix drew for
# its first cell's configuration at 8 worlds, before the scene hooks
# (velocities, the configuration, the test size) were added
DRAWN = {
    "lcp": ("3a5b5aecfbfae3f4", "aedf8fff13de50b0", "bc5215a7602c1e0e"),
    "loose-fwd": ("d7639a56737d0754", "4c6775f801f59b3f",
                  "17f84987a5216a7d"),
    "pile-fwd": ("9bb54e039ff61a09", "86497b7ea8f73065",
                 "89546437b1f6a8f7"),
    "pile-train": ("926b70057c28318f", "b2704a63c60b42fc",
                   "1f8efe0c31bf3d18"),
}
SEEDS = (0, 2 ** 31 + 12345, 2 ** 40 + 3)


@pytest.mark.parametrize("mix", list(DRAWN))
def test_grid_and_scatter_draw_the_bytes_they_drew(mix):
    first = next(w["name"] for w in bench()["workloads"]
                 if w["traffic"] == mix)
    c = spec.cell(first, bench())
    assert c.traffic["scene"]["kind"] in ("grid", "scatter")
    conf = dict(c.config, worlds=8)
    got = []
    for seed in SEEDS:
        d = generate.draw(c.traffic, conf, seed)
        h = hashlib.sha256()
        for k in ("p", "v"):
            h.update(d[k].tobytes())
        for k in sorted(d.get("guess", {})):
            h.update(d["guess"][k].tobytes())
        got.append(h.hexdigest()[:16])
    assert tuple(got) == DRAWN[mix]
