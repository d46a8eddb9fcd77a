"""The port's CUDA kernels against their plain torch versions, on a GPU.

Marked ``cuda``: skipped where no CUDA device is present.  These tests
import no jax, so on a machine without it they run from the repository
root with ``python -m pytest --noconftest tests/test_torch_cuda.py``.
The input generators are chip_smoke.py's.
"""
import numpy as np
import pytest
import torch

from chip_smoke import (DT, GJ_RES_RATIO, engine_instance, engine_iter_case,
                        hull_grid_start, hull_scene, inv_residual, kkt_batch,
                        plain_kernels, share, ulp, ulp_tensor, world_rel)
from lcp_physics_tpu_torch.lcp.cone import ConeF
from lcp_physics_tpu_torch.lcp.pdipm import _dtype_consts, initial_point
from lcp_physics_tpu_torch.ops import ipm, linalg

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# every bucket edge of csrc/lu.cu (NB and NB + 1) and the paths' 16, 24, 56
LU_SIZES = [1, 8, 9, 15, 16, 17, 24, 25, 32, 33, 48, 49, 56, 64, 65, 88]


def lu_case(dev, B, n, dtype, seed):
    rng = np.random.default_rng(seed)
    K = torch.tensor(kkt_batch(rng, B, n), dtype=dtype, device=dev)
    r = torch.tensor(rng.standard_normal((B, n)), dtype=dtype, device=dev)
    return K, r


@pytest.mark.parametrize("B", [1, 3, 4097])
@pytest.mark.parametrize("n", LU_SIZES)
def test_lu_kernels_match_plain_f64(dev, B, n):
    """K1 and K2 (trans 0 and 1) against the plain versions at f64; the
    column-form substitution sums in another order than plain's dot
    products, within 1e-10."""
    K, r = lu_case(dev, B, n, torch.float64, n)
    before = dict(linalg.LAUNCHES)
    lu = linalg.plu_factor(K)
    lu_ref = linalg.plu_factor_ref(K)
    torch.testing.assert_close(lu, lu_ref, rtol=1e-10, atol=1e-12)
    for trans in (0, 1):
        x = linalg.plu_solve(lu, r, trans)
        torch.testing.assert_close(x, linalg.plu_solve_ref(lu_ref, r, trans),
                                   rtol=1e-10, atol=1e-12)
    assert linalg.LAUNCHES["lu"] == before["lu"] + 1
    assert linalg.LAUNCHES["solve"] == before["solve"] + 1
    assert linalg.LAUNCHES["solve_t"] == before["solve_t"] + 1


@pytest.mark.parametrize("B", [1, 3, 4097])
@pytest.mark.parametrize("n", LU_SIZES)
def test_lu_kernels_f32_residual(dev, B, n):
    K, r = lu_case(dev, B, n, torch.float32, 7)
    lu = linalg.plu_factor(K)
    for trans, Kop in ((0, K), (1, K.transpose(1, 2))):
        x = linalg.plu_solve(lu, r, trans)
        res = torch.einsum("bij,bj->bi", Kop.double(), x.double()) - r
        assert float(res.abs().max() / r.abs().max()) < 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", LU_SIZES)
def test_lu_factor_is_plain_bit_for_bit(dev, n, dtype):
    """K1 rounds each update as the plain version does (the product, then
    the difference; no FMA), in its order: the same factor bit for bit."""
    K, _ = lu_case(dev, 4097, n, dtype, n + 1)
    assert torch.equal(linalg.plu_factor(K), linalg.plu_factor_ref(K))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [8, 16, 17, 24, 56, 88])
def test_lu_kernels_batch_slice_bitwise(dev, n, dtype):
    """Worlds factored and solved in a batch of 4,097 give, bit for bit,
    what the same worlds give alone, at the batch's start and inside it
    (other lanes of a warp, another CTA), unaligned rows included."""
    K, r = lu_case(dev, 4097, n, dtype, 3)
    lu = linalg.plu_factor(K)
    xs = [linalg.plu_solve(lu, r, trans) for trans in (0, 1)]
    for sl in (slice(0, 1), slice(0, 3), slice(5, 4097), slice(1, 2)):
        part = linalg.plu_factor(K[sl])
        assert torch.equal(part, lu[sl])
        for trans, x in enumerate(xs):
            assert torch.equal(linalg.plu_solve(lu[sl], r[sl], trans), x[sl])


@pytest.mark.parametrize("C,q", [(4, 0), (4, 3), (24, 0)])
def test_fused_ipm_kernel_matches_plain_f64(dev, C, q):
    rng = np.random.default_rng(31 + C + q)
    qd, p, G, h, A, b, mu, valid, rmask = (
        torch.tensor(x, device=dev)
        for x in engine_instance(rng, 130, 24, C, q))
    consts = _dtype_consts(torch.float64)
    ops = ipm.rot_operands(qd, G, A, C)
    x0 = initial_point(ops, p, h, b, ConeF(mu, valid), rmask, consts)
    kw = dict(C=C, fd=2, max_iter=25, tol=1e-8, consts=consts,
              not_improved_lim=3, fric_pair=True)
    before = ipm.LAUNCHES["fused_ipm"]
    got = ipm.fused_ipm(ops, p, h, b, mu, valid, rmask, *x0, **kw)
    ref = ipm.fused_ipm_ref(ops, p, h, b, mu, valid, rmask, *x0, **kw)
    assert ipm.LAUNCHES["fused_ipm"] == before + 1
    for g, r in zip(got[:4], ref[:4]):
        if g.shape[-1]:   # per-world ||g - r||_inf / ||r||_inf
            err = (g - r).abs().amax(-1) / r.abs().amax(-1).clamp_min(1e-300)
            assert float(err.max()) <= 1e-8
    assert float((got[4] + got[5]).max()) < 1e-8      # every world converged
    assert got[6].dtype == torch.int32
    assert torch.equal(got[6], ref[6])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C,q,fd", [(4, 0, 2), (4, 3, 2), (16, 0, 2),
                                    (16, 0, 1), (12, 3, 1)])
def test_fused_ipm_unrot_kernel_matches_plain(dev, C, q, fd, dtype):
    """The unrotated kernel (K = (1 + fd)C + q, up to 48) against its plain
    loop on instances without the +- pair, 130 worlds: runs capped at 3
    iterations per world (f64 1e-8, f32 1e-3), and at f64 a full run with
    the same iterations and z, lam within 1e-8."""
    rng = np.random.default_rng(7 + C + q + fd)
    qd, p, G, h, A, b, mu, valid, rmask = (
        torch.tensor(x, dtype=dtype, device=dev)
        for x in engine_instance(rng, 130, 24, C, q, pair=False, fd=fd))
    consts = _dtype_consts(dtype)
    ops = ipm.unrot_operands(qd, G, A, C)
    x0 = initial_point(ops, p, h, b, ConeF(mu, valid, fd), rmask, consts,
                       fric_pair=False)
    args = (ops, p, h, b, mu, valid, rmask, *x0)
    base = dict(C=C, fd=fd, consts=consts, fric_pair=False)
    runs = [(dict(max_iter=3, tol=0.0, not_improved_lim=0),
             1e-8 if dtype == torch.float64 else 1e-3)]
    if dtype == torch.float64:
        runs.append((dict(max_iter=25, tol=1e-8, not_improved_lim=3), 1e-8))
    for kw, lim in runs:
        before = dict(ipm.LAUNCHES)
        got = ipm.fused_ipm(*args, **base, **kw)
        ref = ipm.fused_ipm_ref(*args, **base, **kw)
        assert ipm.LAUNCHES == dict(before, fused_ipm_unrot=before[
            "fused_ipm_unrot"] + 1)
        assert torch.equal(got[6], ref[6])
        for g, r in zip(got[:4], ref[:4]):
            if g.shape[-1]:   # per-world ||g - r||_inf / ||r||_inf
                err = (g - r).abs().amax(-1) / r.abs().amax(-1).clamp_min(
                    1e-300)
                assert float(err.max()) <= lim


def fused_case(dev, rot, C, q, fd, B, dtype, seed):
    """(args, base keywords) of fused_ipm on B engine instances: with the
    +- friction pair when ``rot``, else fd independent friction rows."""
    rng = np.random.default_rng(seed)
    qd, p, G, h, A, b, mu, valid, rmask = (
        torch.tensor(x, dtype=dtype, device=dev)
        for x in engine_instance(rng, B, 24, C, q, pair=rot, fd=fd))
    consts = _dtype_consts(dtype)
    ops = (ipm.rot_operands if rot else ipm.unrot_operands)(qd, G, A, C)
    x0 = initial_point(ops, p, h, b, ConeF(mu, valid, fd), rmask, consts,
                       fric_pair=rot)
    return ((ops, p, h, b, mu, valid, rmask, *x0),
            dict(C=C, fd=fd, consts=consts, fric_pair=rot))


def world_err(g, r):
    """Largest per-world ||g - r||_inf / ||r||_inf."""
    return float(((g - r).abs().amax(-1)
                  / r.abs().amax(-1).clamp_min(1e-300)).max())


# (rot, C, q, fd): K = 2C + q rotated, (1 + fd)C + q unrotated, at and just
# past every bucket edge of the kernel (16, 24, 32, 48)
BUCKET_EDGES = [(True, 8, 0, 2), (True, 8, 1, 2), (True, 12, 0, 2),
                (True, 12, 1, 2), (True, 16, 0, 2), (True, 16, 1, 2),
                (True, 20, 3, 2), (True, 24, 0, 2),
                (False, 5, 1, 2), (False, 5, 2, 2), (False, 8, 0, 2),
                (False, 8, 1, 2), (False, 11, 0, 2), (False, 16, 0, 2),
                (False, 8, 0, 1), (False, 8, 1, 1), (False, 16, 0, 1),
                (False, 16, 1, 1), (False, 24, 0, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rot,C,q,fd", BUCKET_EDGES)
def test_fused_ipm_kernel_bucket_edges(dev, rot, C, q, fd, dtype):
    """Both variants at every bucket edge against the plain loop, 130
    worlds: capped at 3 iterations per world (f64 1e-8, f32 1e-3), and at
    f64 a full run with the same iterations and z, lam within 1e-8."""
    args, base = fused_case(dev, rot, C, q, fd, 130, dtype, 3 * C + q + fd)
    f64 = dtype == torch.float64
    runs = [(dict(max_iter=3, tol=0.0, not_improved_lim=0),
             1e-8 if f64 else 1e-3)]
    if f64:
        runs.append((dict(max_iter=25, tol=1e-8, not_improved_lim=3), 1e-8))
    name = "fused_ipm" if rot else "fused_ipm_unrot"
    for kw, lim in runs:
        before = ipm.LAUNCHES[name]
        got = ipm.fused_ipm(*args, **base, **kw)
        ref = ipm.fused_ipm_ref(*args, **base, **kw)
        assert ipm.LAUNCHES[name] == before + 1
        # a full run's world whose merit lands on the stopping boundary may
        # stop one iteration apart (chip_smoke.py allows 0.1% at B = 4096)
        same = got[6] == ref[6]
        assert int((~same).sum()) <= (1 if kw["tol"] > 0 else 0)
        assert int((got[6] - ref[6]).abs().max()) <= 1
        for g, r in zip(got[:4], ref[:4]):
            if g.shape[-1]:
                assert world_err(g[same], r[same]) <= lim


@pytest.mark.parametrize("rot,C,q", [(True, 8, 0), (False, 8, 0),
                                     (True, 24, 0)])
@pytest.mark.parametrize("B", [1, 3, 130])
def test_fused_ipm_ragged_batches(dev, rot, C, q, B):
    """A batch that is no multiple of the worlds per CTA (8 at K = 16,
    4 at K = 24 and 48): its worlds' results equal, bit for bit, those of
    the same worlds inside a batch of 136."""
    args, base = fused_case(dev, rot, C, q, 2, 136, torch.float64, 11)
    kw = dict(base, max_iter=25, tol=1e-8, not_improved_lim=3)
    full = ipm.fused_ipm(*args, **kw)
    part = ipm.fused_ipm(*take_worlds(args, slice(0, B)), **kw)
    for g, r in zip(part, full):
        assert torch.equal(g, r[:B])


def take_worlds(args, idx):
    return [tuple(x[idx] for x in a) if isinstance(a, tuple) else a[idx]
            for a in args]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rot", [True, False])
def test_fused_ipm_worlds_stopping_apart(dev, rot, dtype):
    """Worlds of one CTA that stop at different iterations (easy ones on
    tol, hard ones capped at max_iter) give, bit for bit, their solo runs'
    results: a world that is done leaves without disturbing its CTA."""
    args, base = fused_case(dev, rot, 8, 0, 2, 32, dtype, 5)
    f64 = dtype == torch.float64
    kw = dict(base, tol=1e-8 if f64 else 1e-5, not_improved_lim=0)
    its = ipm.fused_ipm_ref(*args, **kw, max_iter=30)[6].cpu()
    cap = int(its.double().median())
    W = 8 if rot else 4   # worlds per CTA at K = 16 and K = 24
    easy = (its < cap).nonzero().flatten()
    hard = (its >= cap).nonzero().flatten()
    assert len(easy) >= W // 2 and len(hard) >= W // 2
    idx = torch.cat([easy[:W // 2], hard[:W // 2], easy[W // 2:],
                     hard[W // 2:]]).to(dev)
    args = take_worlds(args, idx)     # the first CTA mixes both kinds
    kw["max_iter"] = cap
    got = ipm.fused_ipm(*args, **kw)
    stops = got[6][:W]
    assert int(stops.min()) < cap and int(stops.max()) == cap
    for w in range(W):
        solo = ipm.fused_ipm(*take_worlds(args, slice(w, w + 1)), **kw)
        for g, r in zip(solo, got):
            assert torch.equal(g, r[w:w + 1])


def check_residual(K, X, Xr):
    """||K X - I||_inf of the kernel's inverses at most GJ_RES_RATIO times
    the plain version's, in the largest and the median matrix."""
    res, res_r = inv_residual(torch, K, X), inv_residual(torch, K, Xr)
    assert float(res.max()) <= GJ_RES_RATIO * float(res_r.max())
    assert float(res.median()) <= GJ_RES_RATIO * float(res_r.median())


@pytest.mark.parametrize("B", [1, 130, 257])
@pytest.mark.parametrize("P", [16, 48, 64, 128])
def test_gj_inv_blocked_kernel_matches_plain(dev, P, B):
    rng = np.random.default_rng(P)
    K = torch.tensor(kkt_batch(rng, B, P), dtype=torch.float32, device=dev)
    before = linalg.LAUNCHES["gj_inv_blocked"]
    X = linalg.gj_inv_blocked(K)
    assert linalg.LAUNCHES["gj_inv_blocked"] == before + 1
    Xr = linalg.gj_inv_blocked_ref(K)
    err = (X - Xr).abs().amax((1, 2)) / Xr.abs().amax((1, 2))
    assert float(err.max()) <= 1e-4
    assert float(inv_residual(torch, K, X).max()) <= 1e-4
    check_residual(K, X, Xr)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("P", [40, 128])
def test_gj_inv_kernel_matches_plain(dev, P, dtype, tol):
    rng = np.random.default_rng(P + 1)
    K = torch.tensor(kkt_batch(rng, 130, P), dtype=dtype, device=dev)
    before = linalg.LAUNCHES["gj_inv"]
    X = linalg.gj_inv(K)
    assert linalg.LAUNCHES["gj_inv"] == before + 1
    Xr = linalg.gj_inv_ref(K)
    err = (X - Xr).abs().amax((1, 2)) / Xr.abs().amax((1, 2))
    assert float(err.max()) <= tol
    check_residual(K, X, Xr)


def test_blocked_factor_on_the_card_matches_plain_f64(dev):
    """Two-panel blocked LU (n = 200) through the scalar kernel at f64,
    both solves, against the plain versions."""
    rng = np.random.default_rng(5)
    K = torch.tensor(kkt_batch(rng, 64, 200), device=dev)
    r = torch.tensor(rng.standard_normal((64, 200)), device=dev)
    fac = linalg.plu_factor(K)
    assert isinstance(fac, linalg.BlockedFactor)
    for trans, Kop in ((0, K), (1, K.transpose(1, 2))):
        x = linalg.plu_solve(fac, r, trans)
        res = torch.einsum("bij,bj->bi", Kop, x) - r
        assert float(res.abs().max()) <= 1e-9


@pytest.mark.parametrize("dtype,lims", [
    # f32: the direction is a matvec against an explicit inverse with
    # cancellation, summed in another order than plain's
    (torch.float32, (1e-3, 1e-3)),
    (torch.float64, (1e-10, 1e-8))])
@pytest.mark.parametrize("C,q", [(48, 8), (70, 2)])
def test_ipm_iter_kernel_matches_plain(dev, C, q, dtype, lims):
    """K6 against its plain iteration, per world: one iteration from the
    same inputs (X, bestX, state), then runs capped at 3 iterations (z and
    lam).  K2 = 104 (one panel, equality rows) and 144 (two panels); 130
    worlds, no multiple of a lane width."""
    from lcp_physics_tpu_torch.lcp.pdipm import _rot_factor_factory, _start
    from lcp_physics_tpu_torch.ops import ipm_iter
    rng = np.random.default_rng(C + q)
    qd, p, G, h, A, b, mu, valid, rmask = (
        torch.tensor(x, dtype=dtype, device=dev)
        for x in engine_instance(rng, 130, 64, C, q))
    consts = _dtype_consts(dtype)
    ops = ipm.rot_operands(qd, G, A, C)
    fac = _rot_factor_factory(ops, ConeF(mu, valid), consts["reg"])
    X0 = torch.cat(_start(fac, p, h, b, rmask, consts), -1)
    n, m = p.shape[1], 4 * C
    d_inv = torch.clamp(X0[:, n:n + m] / X0[:, n + m:n + 2 * m],
                        consts["dinv_min"], consts["dinv_max"])
    vecs = (ops[1], ops[2], p, h, b, mu, valid, rmask)
    state = ipm_iter.initial_state(130, 10, dtype, dev)
    kw = dict(C=C, consts=consts, tol=1e-8, not_improved_lim=3,
              stall_rtol=0.0)
    a = (fac.iter_inv_raw(d_inv), *vecs, X0, X0, state, 0)
    before = ipm_iter.LAUNCHES["ipm_iter"]
    got = ipm_iter.iteration(*a, **kw)
    assert ipm_iter.LAUNCHES["ipm_iter"] == before + 1
    for g, r in zip(got, ipm_iter._iter_ref(*a, **kw)):
        err = (g - r).abs().amax(-1) / r.abs().amax(-1).clamp_min(1e-300)
        assert float(err.max()) <= lims[0]
    cap = dict(C=C, consts=consts, max_iter=3, tol=0.0, not_improved_lim=0,
               inv_raw=fac.iter_inv_raw)
    g3 = ipm_iter.fused_iter_ipm(*vecs, X0, **cap)
    r3 = ipm_iter.fused_iter_ipm_ref(*vecs, X0, **cap)
    for sl in (slice(0, n), slice(n + m, n + 2 * m)):
        g_, r_ = g3[0][:, sl], r3[0][:, sl]
        err = (g_ - r_).abs().amax(-1) / r_.abs().amax(-1).clamp_min(1e-300)
        assert float(err.max()) <= lims[1]
    assert torch.equal(g3[3], r3[3])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("n", [100, 200])
def test_inv_factor_on_the_card_matches_plain(dev, n, dtype, tol):
    """The explicit-inverse factor through the panel kernels (K4 at f32,
    K5 at f64) against the plain versions on the CPU, and its solves."""
    rng = np.random.default_rng(n)
    K = torch.tensor(kkt_batch(rng, 64, n), dtype=dtype)
    r = torch.tensor(rng.standard_normal((64, n)), dtype=dtype)
    fac = linalg.inv_factor_blocks(K.to(dev))
    ref = linalg.inv_factor_blocks(K)
    err = (fac.inv.cpu() - ref.inv).abs().amax((1, 2)) \
        / ref.inv.abs().amax((1, 2))
    assert float(err.max()) <= tol
    check_residual(K.to(dev)[:, :n, :n], fac.inv[:, :n, :n],
                   ref.inv[:, :n, :n].to(dev))
    for trans, Kop in ((0, K), (1, K.transpose(1, 2))):
        x = linalg.plu_solve(fac, r.to(dev), trans).cpu()
        res = torch.einsum("bij,bj->bi", Kop.double(), x.double()) - r
        assert float(res.abs().max() / r.abs().max()) <= 10 * tol


# every bucket edge of csrc/gj_inv.cu's scalar kernel (K5) and the tests' 40
GJ_EDGES = [1, 15, 16, 17, 31, 32, 33, 40, 63, 64, 65, 96, 97, 127, 128]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("P", GJ_EDGES)
def test_gj_inv_kernel_bucket_edges(dev, P, dtype, tol):
    """K5 at every bucket edge (clusters of 1 to 4 CTAs a world) and
    batches around a cluster-count multiple, per matrix against plain and
    by ||K X - I|| within GJ_RES_RATIO of plain's."""
    for B in (1, 31, 32, 33, 257):
        rng = np.random.default_rng(1000 * P + B)
        K = torch.tensor(kkt_batch(rng, B, P), dtype=dtype, device=dev)
        X, Xr = linalg.gj_inv(K), linalg.gj_inv_ref(K)
        err = (X - Xr).abs().amax((1, 2)) / Xr.abs().amax((1, 2))
        assert float(err.max()) <= tol, (B, float(err.max()))
        check_residual(K, X, Xr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gj_inv_kernel_non_finite_panel(dev, dtype):
    """A NaN in one panel: K5's output is non-finite where plain's is, and
    the other panels of the batch are untouched by it."""
    rng = np.random.default_rng(3)
    K = torch.tensor(kkt_batch(rng, 5, 100), dtype=dtype, device=dev)
    K[2, 70, 3] = float("nan")
    X, Xr = linalg.gj_inv(K), linalg.gj_inv_ref(K)
    assert torch.equal(torch.isfinite(X), torch.isfinite(Xr))
    keep = [0, 1, 3, 4]
    assert torch.equal(X[keep], linalg.gj_inv(K[keep].contiguous()))


def test_gj_shape_matches_the_kernel(dev):
    """linalg.gj_shape's shared bytes equal the C entry's for every
    bucket, and a bucket or cluster other than gj_shape's is refused."""
    import ctypes
    lib = linalg._gj_lib()
    out = (ctypes.c_int * 3)()
    for f64 in (0, 1):
        for pb in linalg.GJ_BUCKETS:
            assert lib.lcp_gj_inv_attrs(f64, pb, out) == 0
            assert out[2] == linalg.gj_shape(pb, 8 if f64 else 4).smem
    K = torch.eye(40, device=dev).expand(2, 40, 40).contiguous()
    o = torch.empty_like(K)
    s = linalg._build.stream_ptr(lib, K.device)
    for pb, cs in ((32, 1), (64, 1), (96, 3), (64, 2)):
        rc = lib.lcp_gj_inv_f32(linalg._build.ptr(K), linalg._build.ptr(o),
                                2, 40, pb, cs, s)
        assert (rc == 0) == ((pb, cs) == (64, 2))


def test_iter_smem_matches_the_kernel(dev):
    """ops.ipm_iter.smem_bytes equals the C entry's count on every admitted
    shape of a grid, and the wrapper refuses an inverse narrower than K2."""
    import ctypes
    from lcp_physics_tpu_torch.ops import ipm_iter
    lib = ipm_iter._lib()
    for n in (1, 63, 65, 191, 301, 701, 1201, 2001, 2800):
        for C, q in ((44, 1), (52, 0), (48, 8), (71, 2), (128, 0), (124, 8)):
            for item in (4, 8):
                if ipm_iter.fused_iter_supported(C, q, n, item):
                    assert ipm_iter.smem_bytes(n, C, q, item) == \
                        lib.lcp_ipm_iter_smem_bytes(n, 4 * C, q, C,
                                                    int(item == 8))
    out = (ctypes.c_int * 2)()
    for f64 in (0, 1):
        assert lib.lcp_ipm_iter_attrs(f64, out) == 0
        assert out[0] > 0
    vecs, X0, fac, inv, consts = engine_iter_case(torch, dev, 2, 65, 44, 1,
                                                  torch.float32, 7)
    state = ipm_iter.initial_state(2, 10, torch.float32, dev)
    narrow = inv[:, :88, :88].contiguous()
    with pytest.raises(ValueError):
        ipm_iter.iteration(narrow, *vecs, X0, X0, state, 0, C=44,
                           consts=consts, tol=1e-8, not_improved_lim=3,
                           stall_rtol=0.0)


# (C, q, n): K2 = 89, 104, 144, 256 with q = 0, 1, 2, 8; odd n leaves
# Ghat2's rows off 16-byte boundaries (the scalar loads), n = 1201 takes
# the transposed product over many column tiles.  (124, 8, 64) is a Schur
# system of rank 64 in 256 rows: there the plain f32 run itself moves by
# ~4e-3 under one ulp of p (test_torch_ipm_iter.py::
# test_plain_f32_one_ulp_spread), so f32 capped runs are held to
# max(1e-3, 10x plain's own one-ulp spread), as chip_smoke.py holds the
# touching line's gradients.
ITER_CASES = [(44, 1, 63), (52, 0, 64), (48, 8, 65), (71, 2, 129),
              (128, 0, 191), (124, 8, 64), (124, 8, 193), (128, 0, 1201)]


@pytest.mark.parametrize("dtype,lims", [
    (torch.float32, (1e-3, 1e-3)),
    (torch.float64, (1e-10, 1e-8))])
@pytest.mark.parametrize("C,q,n", ITER_CASES)
def test_ipm_iter_kernel_shapes_match_plain(dev, C, q, n, dtype, lims):
    """K6 against its plain iteration: one iteration from the same inputs
    per world, on a batch of 13 worlds with done and live ones mixed (the
    done ones copied through bit for bit), then runs capped at 3
    iterations (z and lam per world)."""
    from lcp_physics_tpu_torch.ops import ipm_iter
    vecs, X0, fac, inv, consts = engine_iter_case(torch, dev, 13, n, C, q,
                                                  dtype, C + q + n)
    Bn, m = X0.shape[0], 4 * C
    state = ipm_iter.initial_state(Bn, 10, dtype, dev)
    state[::3, 1] = 1.0                      # every third world done
    bestX = X0 + 1.0
    kw = dict(C=C, consts=consts, tol=1e-8, not_improved_lim=3,
              stall_rtol=0.0)
    a = (inv, *vecs, X0, bestX, state, 2)
    before = ipm_iter.LAUNCHES["ipm_iter"]
    got = ipm_iter.iteration(*a, **kw)
    assert ipm_iter.LAUNCHES["ipm_iter"] == before + 1
    ref = ipm_iter._iter_ref(*a, **kw)
    for g, r, x0 in zip(got, ref, (X0, bestX, state)):
        assert torch.equal(g[::3], x0[::3])
        err = (g - r).abs().amax(-1) / r.abs().amax(-1).clamp_min(1e-300)
        assert float(err.max()) <= lims[0]
    cap = dict(C=C, consts=consts, max_iter=3, tol=0.0, not_improved_lim=0,
               inv_raw=fac.iter_inv_raw)
    g3 = ipm_iter.fused_iter_ipm(*vecs, X0, **cap)
    r3 = ipm_iter.fused_iter_ipm_ref(*vecs, X0, **cap)
    lim = lims[1]
    if dtype == torch.float32:
        u3 = ipm_iter.fused_iter_ipm_ref(vecs[0], vecs[1],
                                         ulp_tensor(torch, vecs[2]),
                                         *vecs[3:], X0, **cap)
    for sl in (slice(0, n), slice(n + m, n + 2 * m)):
        r_ = r3[0][:, sl]
        if dtype == torch.float32:
            lim = max(lims[1], 10 * float(world_rel(u3[0][:, sl], r_).max()))
        err = world_rel(g3[0][:, sl], r_)
        assert float(err.max()) <= lim, (float(err.max()), lim)
    assert torch.equal(g3[3], r3[3])


def test_hull_grid_first_step_matches_plain(dev):
    """bench.py's dense hull grid (B = 64, f32): the first step through the
    kernels (K4 under the K2 = 256 factor) against the plain versions,
    held to plain's own spread under one ulp of the positions."""
    p0, v0 = hull_grid_start(64)
    step, params, state = hull_scene(torch, dev, torch.float32, p0, v0)
    before = linalg.LAUNCHES["gj_inv_blocked"]
    with torch.no_grad():
        s1, _ = step(params, state, DT)
        assert linalg.LAUNCHES["gj_inv_blocked"] > before
        with plain_kernels("the hull grid's comparison steps"):
            s1_r, _ = step(params, state, DT)
            step_u, params_u, state_u = hull_scene(
                torch, dev, torch.float32, ulp(p0), v0)
            s1_u, _ = step_u(params_u, state_u, DT)
    e, e_u = (world_rel(s.v, s1_r.v) for s in (s1, s1_u))
    assert float(e.median()) <= max(1e-5, 4 * float(e_u.median()))
    assert share(e, 1e-3) >= share(e_u, 1e-3) - 0.05


def test_backtrack_halvings_match_plain(dev):
    """A unit box thrown at a held floor fast enough to tunnel (speculative
    contacts off, tests/test_step.py's scene) and a far one: with the
    penetration backtrack, the kernel path's halvings and states equal the
    plain path's (f64)."""
    from lcp_physics_tpu_torch.core import (JointSpec, WorldState,
                                            default_params,
                                            make_scene_static)
    from lcp_physics_tpu_torch.parallel import make_batched_step
    from lcp_physics_tpu_torch.utils import SimConfig
    f64 = dict(dtype=torch.float64, device=dev)
    verts = np.zeros((2, 4, 2))
    verts[0] = [[-1, -1], [1, -1], [1, 1], [-1, 1]]
    verts[1] = [[-50, -1], [50, -1], [50, 1], [-50, 1]]
    static = make_scene_static([4, 4], joints=(JointSpec(
        kind="total", body1=1, ref=(0.0, 0.0, 0.0)),))
    params = default_params(static, verts=verts, radius=[0.0, 0.0],
                            gravity=(0.0, 10.0), restitution=0.0, **f64)
    p0 = torch.tensor([[[0., 0., -2.4], [0., 0., 0.]],
                       [[0., 0., -30.], [0., 0., 0.]]], **f64)
    v0 = torch.zeros(2, 2, 3, **f64)
    v0[0, 0, 2] = 12.0
    state = WorldState(p0, v0, torch.zeros(2, **f64))
    step = make_batched_step(static, SimConfig(
        speculative=False, tol=1e-6, penetration_backtrack=True,
        max_dt_halvings=8))
    out, d = step(params, state, 0.05)
    with plain_kernels("the backtrack's comparison step"):
        out_r, d_r = step(params, state, 0.05)
    assert d.halvings.tolist() == d_r.halvings.tolist()
    assert d.halvings[0] >= 1 and d.halvings[1] == 0
    torch.testing.assert_close(out.p, out_r.p, rtol=1e-10, atol=1e-10)


def test_world_defaults_to_the_card(dev):
    """World() without device= puts its state and parameters on the card."""
    from lcp_physics_tpu_torch.physics import (Circle, Rect, TotalConstraint,
                                               World)
    ball = Circle([0.0, 0.0], rad=1.0)
    floor = Rect([0.0, 3.0], [20.0, 2.0])
    w = World([ball, floor], [TotalConstraint(floor)], gravity=(0.0, 10.0))
    assert w.world_state.p.device.type == "cuda"
    assert w.scene_params.mass.device.type == "cuda"
    w.step()
    assert ball.p.device.type == "cuda"


def test_two_shards_on_one_card(dev):
    """Forward and backward through the mesh [cuda:0, cuda:0] (two worker
    threads, a stream each) on the 8-circle slice scene (B = 64, f64, 5
    steps): the states equal the unsharded step's at batch_tile = 32 bit
    for bit, the gradients of mean(p^2) within 1e-10 (the shared
    parameters' gradients sum both shards in the autograd engine's
    order), and K1, K2 and K3 launched, the backward's trans=1
    substitution too."""
    import dataclasses

    from chip_smoke import C, N, slice_start
    from lcp_physics_tpu_torch.core import (WorldState, default_params,
                                            make_scene_static, rollout)
    from lcp_physics_tpu_torch.parallel import (batched_rollout, gather,
                                                make_batched_step, make_mesh)
    from lcp_physics_tpu_torch.utils import SimConfig
    f64 = dict(dtype=torch.float64, device=dev)
    static = make_scene_static([1] * N, c_max=C)
    cfg = SimConfig(max_iter=15, solver_eps=1e-6)
    p0, v0 = slice_start(64)

    def scene():
        params = default_params(static, verts=np.zeros((N, 1, 2)),
                                radius=np.full(N, 1.0), gravity=(0.0, 10.0),
                                restitution=0.4, **f64)
        state = WorldState(torch.tensor(p0, **f64), torch.tensor(v0, **f64),
                           torch.zeros(64, **f64))
        for x in (params.mass, params.restitution, state.v):
            x.requires_grad_(True)
        return params, state, (params.mass, params.restitution, state.v)

    params, state, leaves = scene()
    before = dict(linalg.LAUNCHES, **ipm.LAUNCHES)
    outs = batched_rollout(static, cfg, params, state, DT, 5,
                           mesh=make_mesh([dev, dev]))
    final = gather([o[0] for o in outs], dev)
    grads = torch.autograd.grad((final.p ** 2).mean(), leaves)
    after = dict(linalg.LAUNCHES, **ipm.LAUNCHES)
    for k in ("lu", "solve", "solve_t", "fused_ipm"):
        assert after[k] > before[k], k

    params_r, state_r, leaves_r = scene()
    tiled = make_batched_step(static, dataclasses.replace(cfg, batch_tile=32))
    final_r, _ = rollout(tiled, params_r, state_r, DT, 5)
    grads_r = torch.autograd.grad((final_r.p ** 2).mean(), leaves_r)
    assert torch.equal(final.p, final_r.p) and torch.equal(final.v,
                                                           final_r.v)
    for g, r in zip(grads, grads_r):
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-12)


def test_guard_quick_on_the_card(dev):
    """The f32 physics-quality guard's 8 checks with --quick's rollouts
    (lcp_physics_tpu_torch.tools.validate_f32) on the card: every check
    passes at the JAX tool's thresholds."""
    from lcp_physics_tpu_torch.tools import validate_f32
    records = validate_f32.run_checks(str(dev), quick=True)
    assert len(records) == 8
    assert not [f"{r['name']}: {r['detail']}" for r in records if not r["ok"]]
