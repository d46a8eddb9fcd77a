"""The unfused IPM loop's two routes (``lcp.pdipm.loop_route``): eager,
op by op, and one pass captured as a CUDA graph and replayed
(``graph_loop``).

On the CPU: the routing rule, a CPU solve that never touches
``torch.cuda.graphs``, and the graphed route's static buffers on a
stand-in graph that replays the captured pass in Python (every factor
form, two inputs through one capture; the padded copies of a system that
is not whole panels counted on replay as on the eager pass).  On the card (marked ``cuda``,
skipped elsewhere): the graphed loop against the eager loop bit for bit
at two and four K4 panels, f32 and f64, a gradient through
``lcp_solve`` on both routes and two shards of one card.  No jax is
imported, so on a machine without it the file runs from the repository
root with ``python -m pytest --noconftest tests/test_torch_loop_graph.py``.
"""
import contextlib

import numpy as np
import pytest
import torch

from torch_inputs import engine_instance, one_torch_thread  # noqa: F401
from lcp_physics_tpu_torch.lcp import ConeF, lcp_solve, pdipm
from lcp_physics_tpu_torch.lcp.pdipm import make_kkt_factor, pdipm_solve
from lcp_physics_tpu_torch.ops import linalg
from lcp_physics_tpu_torch.utils import bump, tally


def instance(seed, B, n, C, q, dtype=torch.float64, device="cpu"):
    """An engine-layout batch (torch_inputs.engine_instance) as the
    positional arguments of ``pdipm_solve`` and its row mask."""
    t = lambda x: torch.tensor(x, dtype=dtype, device=device)
    qd, p, G, h, A, b, mu, valid, rmask = (
        t(x) for x in engine_instance(np.random.default_rng(seed), B, n, C,
                                      q))
    return (qd, p, G, h, A, b, ConeF(mu, valid)), rmask


FACTORS = {"factor": 0}   # the stand-in graph's counted factors


def counts():
    return dict(**{f"route.{k}": v for k, v in pdipm.LOOP_ROUTES.items()},
                **{f"read.{k}": v for k, v in pdipm.HOST_READS.items()},
                **{f"launch.{k}": v for k, v in linalg.LAUNCHES.items()},
                **pdipm.LOOP_CAPTURES, **FACTORS)


def delta(before):
    return {k: v - before[k] for k, v in counts().items()}


@contextlib.contextmanager
def route(name, monkeypatch):
    """Every unfused loop on ``name``'s route."""
    with monkeypatch.context() as mp:
        mp.setattr(pdipm, "loop_route", lambda *a: name)
        yield


def assert_same(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f


# ---------------------------------------------------------------------------
# On the CPU.
# ---------------------------------------------------------------------------

def _rot_factor(C, backend="auto"):
    """A rotated engine-layout factor (K2 = 2C) of one small world."""
    (qd, p, G, h, A, b, F), _ = instance(0, 1, 4, C, 0)
    reg = pdipm._dtype_consts(torch.float64)["reg"]
    return make_kkt_factor(qd, qd, G, A, F, reg, backend, gamma_rows=C,
                           fric_pair=True)


@pytest.mark.parametrize("case,want", [
    ("cpu", "eager"), ("verbose", "eager"), ("xla", "eager"),
    ("library_lu", "eager"), ("capturing", "eager"), ("autograd", "eager"),
    ("plain_cuda", "graph")])
def test_loop_route_rule(case, want):
    """The rule from what the solver observes: CPU tensors, ``verbose``,
    ``backend='xla'``, a system past ``MAX_BLOCKED_N`` that
    ``resolve_backend`` sends to the library LU, a caller's stream already
    capturing and autograd recording the loop give the eager loop; a
    plain CUDA solve (the port's pivotless factor) the graph."""
    pivoted = False
    if case in ("xla", "library_lu", "plain_cuda"):
        routed = pdipm.ROUTES["library_lu"]
        C = (linalg.MAX_BLOCKED_N // 2 + 1) if case == "library_lu" else 48
        pivoted = _rot_factor(C, "xla" if case == "xla" else "auto").pivoted
        assert pdipm.ROUTES["library_lu"] - routed == (case == "library_lu")
    flags = dict(cuda=case != "cpu", verbose=case == "verbose",
                 pivoted=pivoted, capturing=case == "capturing",
                 recording=case == "autograd")
    assert pdipm.loop_route(**flags) == want


def test_cpu_solve_never_touches_cuda_graphs(monkeypatch):
    """A CPU solve past the fused kernel (K2 = 64) runs the eager loop:
    nothing of ``torch.cuda.graphs`` or the capture is called, and
    ``LOOP_ROUTES['eager']`` counts one a pass (every world stops before
    ``max_iter``, so the passes are the last world's iterations plus
    one)."""
    def refuse(*a, **k):
        raise AssertionError("a CPU solve reached torch.cuda.graphs")

    for name in ("graph", "CUDAGraph", "Stream", "Event"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(pdipm, "_capture", refuse)
    monkeypatch.setattr(pdipm, "_record", refuse)
    (qd, p, G, h, A, b, F), rmask = instance(3, 3, 12, 32, 1)
    before = counts()
    sol = pdipm_solve(qd, p, G, h, A, b, F, row_mask=rmask, max_iter=40,
                      tol=1e-9, q_is_diag=True, gamma_rows=32,
                      fric_pair=True, not_improved_lim=3)
    passes = int(sol.iters.max()) + 1
    assert passes < 40
    d = delta(before)
    assert d["route.eager"] == passes and d["route.graph"] == 0
    assert d["capture"] == 0 and d["read.ipm_loop"] == passes


def _quietly(body):
    """``body()`` with its counter bumps undone."""
    with tally() as log:
        body()
    for c, k, n in log:
        bump(c, k, -n)


class _StandInGraph:
    """A stand-in for a captured pass: its replay runs the pass's Python on
    the static buffers, as the card's replay runs its kernels there, and
    bumps nothing (the route repeats the capture's bumps)."""

    def __init__(self, body, stream):
        # a capture runs the pass's Python (and its bumps), not its kernels:
        # the static state is put back as it was
        state = body.__self__.state
        before = [t.clone() for t in state]
        body()
        for t, b in zip(state, before):
            t.copy_(b)
        self.replay = lambda: _quietly(body)


class _NoOp:
    def __getattr__(self, name):
        return lambda *a, **k: None


def stand_in_card(monkeypatch):
    """The graphed route's CUDA calls replaced: streams and events that do
    nothing and :class:`_StandInGraph` for the capture, so that
    ``pdipm._capture`` (the warm-up, the capture's bumps undone) and the
    rest of the route run on CPU tensors."""
    monkeypatch.setattr(pdipm, "_record", _StandInGraph)
    for name in ("Stream", "Event", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: _NoOp())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(pdipm, "_GRAPHS", type(pdipm._GRAPHS)())


FORMS = {
    # (C, q, solve options): the rotated lane (K2 = 66) and blocked
    # (K2 = 98) factors, the unrotated gamma factor over the cone bands and
    # over a dense F (K = 49, 37), the plain Schur factor and the dense KKT,
    # and the rotated lane factor with a Gondzio corrector and the stall
    # tolerance
    "rot_lane": (32, 2, dict(q_is_diag=True, gamma_rows=32, fric_pair=True)),
    "rot_blocked": (48, 2, dict(q_is_diag=True, gamma_rows=48,
                                fric_pair=True)),
    "gamma_cone": (16, 1, dict(q_is_diag=True, gamma_rows=16)),
    "gamma_dense_F": (12, 1, dict(q_is_diag=True, gamma_rows=12, dense=1)),
    "schur": (6, 1, dict(q_is_diag=True, dense=1)),
    "dense_kkt": (6, 1, dict(q_is_diag=False, dense=1)),
    "rot_gondzio": (32, 2, dict(q_is_diag=True, gamma_rows=32,
                                fric_pair=True, gondzio=1,
                                stall_rtol=1e-3)),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_graphed_route_on_a_stand_in_graph(form, monkeypatch):
    """The graphed route's bookkeeping without a card: each factor form's
    ``state`` and the helpers' tensors copied into the static twin, the
    state reset, the pass index filled in before each replay.  Two inputs
    through one capture (the second would read the first's operands if a
    buffer were left stale) each equal their eager solve bit for bit, with
    the same host reads and launch counts, and one capture in all."""
    C, q, opts = FORMS[form]
    opts = dict(opts)
    dense = opts.pop("dense", 0)
    stand_in_card(monkeypatch)
    # a counted factor: the capture's bumps are undone, each replay's made
    factor = pdipm._factor
    monkeypatch.setattr(pdipm, "_factor", lambda *a: (
        bump(FACTORS, "factor"), factor(*a))[1])
    captures = pdipm.LOOP_CAPTURES["capture"]
    for seed in (11, 12):
        (qd, p, G, h, A, b, F), rmask = instance(seed, 3, 14, C, q)
        if dense:
            F = F.dense()
        Q = qd if opts["q_is_diag"] else torch.diag_embed(qd)
        kw = dict(row_mask=rmask, max_iter=14, tol=1e-9, not_improved_lim=3,
                  **opts)
        got = {}
        for name in ("eager", "graph"):
            before = counts()
            with route(name, monkeypatch):
                got[name] = pdipm_solve(Q, p, G, h, A, b, F, **kw)
            got[name + ".counts"] = delta(before)
        assert_same(got["eager"], got["graph"])
        ce, cg = got["eager.counts"], got["graph.counts"]
        # the first solve's first pass is the capture's warm-up
        first = seed == 11
        assert cg["route.eager"] == first and cg["capture"] == first
        assert cg["route.graph"] + first == ce["route.eager"] > 0
        assert ce["factor"] > ce["route.eager"]
        for k in ce:
            if not k.startswith(("route.", "capture")):
                assert ce[k] == cg[k], k
    assert pdipm.LOOP_CAPTURES["capture"] - captures == 1


@pytest.mark.parametrize("C,q,pads", [(128, 33, True), (128, 0, False)],
                         ids=["padded_289", "whole_256"])
def test_pad_count_replayed_as_the_eager_pass_counts_it(C, q, pads,
                                                        monkeypatch):
    """K2 = 2C + q = 289 rows (the chain cell's rotated system: three
    panels, 95 rows padded): ``LAUNCHES['pad']`` counts one padded copy a
    factor on the eager route and on the stand-in graph's route alike,
    where the capture's bumps are repeated by each replay; at K2 = 256
    none on either."""
    stand_in_card(monkeypatch)
    factor = pdipm._factor
    monkeypatch.setattr(pdipm, "_factor", lambda *a: (
        bump(FACTORS, "factor"), factor(*a))[1])
    (qd, p, G, h, A, b, F), rmask = instance(21, 2, 48, C, q)
    kw = dict(row_mask=rmask, max_iter=6, tol=1e-9, not_improved_lim=3,
              q_is_diag=True, gamma_rows=C, fric_pair=True)
    got = {}
    for name in ("eager", "graph"):
        before = counts()
        with route(name, monkeypatch):
            pdipm_solve(qd, p, G, h, A, b, F, **kw)
        got[name] = delta(before)
    ce, cg = got["eager"], got["graph"]
    assert cg["route.graph"] > 0 and ce["factor"] == cg["factor"] > 0
    assert cg["launch.pad"] == ce["launch.pad"] == pads * ce["factor"]


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("max_iter", [12, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C,B", [(128, 64), (256, 16)],
                         ids=["two_panels", "four_panels"])
def test_graph_loop_matches_eager_on_the_card(dev, C, B, dtype, max_iter,
                                              monkeypatch):
    """K2 = 256 (two K4 panels) and 512 (four), n = 192: the graphed loop
    equals the eager loop bit for bit in z, s, lam, nu, iters, mu and
    resid, for two inputs in turn through one cached graph, with equal
    host reads and launch counts.  At ``max_iter`` 12 the worlds run to
    the cap or stop apart; at 40 every world stops before it, on the
    stall rule or the tolerance, and the exit read ends the loop."""
    kw = dict(max_iter=max_iter, tol=1e-6, q_is_diag=True, gamma_rows=C,
              fric_pair=True, not_improved_lim=3)
    for seed in (1, 2):
        args, rmask = instance(seed, B, 192, C, 0, dtype, dev)
        got = {}
        for name in ("eager", "graph"):
            before = counts()
            with route(name, monkeypatch):
                got[name] = pdipm_solve(*args, row_mask=rmask, **kw)
            torch.cuda.synchronize()
            got[name + ".counts"] = delta(before)
        assert_same(got["eager"], got["graph"])
        ce, cg = got["eager.counts"], got["graph.counts"]
        passes = ce["route.eager"]
        # a key's first solve runs its first pass eagerly, the warm-up
        assert cg["route.graph"] + cg["route.eager"] == passes
        assert cg["route.eager"] == cg["capture"] <= 1
        for k in ce:
            if k.startswith(("read.", "launch.")):
                assert ce[k] == cg[k], k
        iters = got["eager"].iters
        if max_iter == 40:
            assert int(iters.max()) < max_iter - 1
            assert passes == int(iters.max()) + 1
            assert int(iters.min()) < int(iters.max())
        else:
            assert passes == max_iter


@pytest.mark.cuda
def test_graph_loop_takes_the_real_route_on_the_card(dev):
    """A plain CUDA solve takes the graph unprompted; ``verbose`` and
    ``backend='xla'`` keep it eager."""
    args, rmask = instance(3, 8, 192, 128, 0, torch.float32, dev)
    kw = dict(row_mask=rmask, max_iter=3, tol=1e-6, q_is_diag=True,
              gamma_rows=128, fric_pair=True)
    for opts, want in ((dict(), "graph"), (dict(verbose=True), "eager"),
                       (dict(backend="xla"), "eager")):
        before = counts()
        pdipm_solve(*args, **kw, **opts)
        d = delta(before)
        assert d["route.graph"] + d["route.eager"] == 3
        assert d["route.graph"] >= 2 if want == "graph" else d[
            "route.graph"] == 0, opts


@pytest.mark.cuda
def test_lcp_solve_gradient_on_both_routes(dev, monkeypatch):
    """The gradient of a loss through ``lcp_solve`` (the implicit
    backward) on both routes, f32, K2 = 256: equal bit for bit, after a
    second solve with other inputs has run through the same cached graph
    before the first's backward, so nothing the backward saved aliases a
    static buffer."""
    C = 128
    kw = dict(max_iter=12, tol=1e-6, q_is_diag=True, gamma_rows=C,
              fric_pair=True, not_improved_lim=3)
    grads = {}
    for name in ("eager", "graph"):
        (qd, p, G, h, A, b, F), rmask = instance(4, 32, 192, C, 0,
                                                 torch.float32, dev)
        leaves = [x.requires_grad_(True) for x in (p, h, F.mu)]
        with route(name, monkeypatch):
            z = lcp_solve(qd, p, G, h, A, b, F, row_mask=rmask, **kw)
            args2, rmask2 = instance(5, 32, 192, C, 0, torch.float32, dev)
            pdipm_solve(*args2, row_mask=rmask2, **kw)
        grads[name] = torch.autograd.grad((z * z).sum(), leaves)
    for ge, gg in zip(grads["eager"], grads["graph"]):
        assert torch.equal(ge, gg)


def _pile(dev, B, seed=5):
    """B worlds of a 4 x 4 pile of radius-1 circles (jittered, moving),
    c_max 32: the rotated system has K2 = 64 rows, past the fused kernel,
    so every contact step runs the unfused loop (lane factor, f64)."""
    from lcp_physics_tpu_torch.core import (WorldState, default_params,
                                            make_scene_static)
    side, N = 4, 16
    f64 = dict(dtype=torch.float64, device=dev)
    rng = np.random.default_rng(seed)
    static = make_scene_static([1] * N, c_max=32)
    params = default_params(static, verts=np.zeros((N, 1, 2)),
                            radius=np.ones(N), restitution=0.4, **f64)
    gx, gy = np.meshgrid(np.arange(side), np.arange(side))
    pos = (np.stack([gx.ravel(), gy.ravel()], -1) * 2.01
           + rng.uniform(-0.01, 0.01, (B, N, 2)))
    state = WorldState(
        torch.tensor(np.concatenate([np.zeros((B, N, 1)), pos], -1), **f64),
        torch.tensor(rng.normal(0.0, 0.5, (B, N, 3)), **f64),
        torch.zeros(B, **f64))
    for x in (params.mass, state.v):
        x.requires_grad_(True)
    return static, params, state, (params.mass, state.v)


@pytest.mark.cuda
def test_two_shards_through_the_graphed_loop(dev, monkeypatch):
    """Two shards on one card (``parallel.batch``'s worker threads, a
    stream each) through the graphed loop, 3 steps forward and backward
    of the 4 x 4 pile (B = 8, f64): each shard captures or takes a cached
    pass of its own, and the states equal the eager unsharded step at
    ``batch_tile`` 4 bit for bit, the gradients within 1e-10 (the shards'
    sum in the autograd engine's order)."""
    import dataclasses

    from lcp_physics_tpu_torch.core import rollout
    from lcp_physics_tpu_torch.parallel import (batched_rollout, gather,
                                                make_batched_step, make_mesh)
    from lcp_physics_tpu_torch.utils import SimConfig
    cfg = SimConfig(max_iter=12, solver_eps=1e-9)
    static, params, state, leaves = _pile(dev, 8)
    before = counts()
    outs = batched_rollout(static, cfg, params, state, 0.01, 3,
                           mesh=make_mesh([dev, dev]))
    final = gather([o[0] for o in outs], dev)
    grads = torch.autograd.grad((final.p ** 2).mean(), leaves)
    d = delta(before)
    assert d["route.graph"] > 0 and d["route.eager"] == d["capture"] <= 2

    static, params_r, state_r, leaves_r = _pile(dev, 8)
    with route("eager", monkeypatch):
        tiled = make_batched_step(static,
                                  dataclasses.replace(cfg, batch_tile=4))
        final_r, _ = rollout(tiled, params_r, state_r, 0.01, 3)
        grads_r = torch.autograd.grad((final_r.p ** 2).mean(), leaves_r)
    assert torch.equal(final.p, final_r.p) and torch.equal(final.v,
                                                           final_r.v)
    for g, r in zip(grads, grads_r):
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-12)
