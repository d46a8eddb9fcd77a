"""World-batch parallelism: a batch axis on one device, worlds sharded over
several (counterpart of ``lcp_physics_tpu/parallel/batch.py``).

Worlds are independent, so a batch is a leading axis on the state, and
sharding is pure data parallelism: the batch axis is split over the mesh,
shared parameters are replicated, and the only reduction is the sum of the
shards' shared-parameter gradients.

The JAX package is single-controller (one program sees the whole batch,
XLA places it), and so is this one: one process, one worker thread per
mesh entry, plain tensors -- the idiom of ``torch.nn.parallel``'s
scatter / replicate / parallel_apply / gather.  ``replicate`` copies with
``Tensor.to`` (or a view on the same device), which is differentiable, so
the gradient of a loss over all shards reaches the one parameter leaf as
the sum over shards, the counterpart of XLA's psum; no all-reduce is
written.

A shard is stepped on its own, so the step's host-read gates (the
contact-free fast path, the penetration gate, post-stabilization's closed
form, the backtrack's loop) decide per shard, where the JAX package's
``lax.cond`` reduces over the whole batch.  That is the tile semantics of
``SimConfig.batch_tile``: a sharded step equals the unsharded step at
``batch_tile = B / mesh.size``.

Each CUDA mesh entry runs on a stream of its own (two entries may name the
same card), which first waits for the caller's current stream; the
caller's stream waits for every worker's before the results are handed
back.  The step and rollout run in worker threads, so they overlap only
where torch releases the interpreter lock (kernel launches, host reads).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses

import torch

from lcp_physics_tpu_torch.core.state import SceneParams, WorldState
from lcp_physics_tpu_torch.core.step import make_step_batched, rollout
from lcp_physics_tpu_torch.utils import SimConfig

WORLD_AXIS = "worlds"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the world-batch axis: the devices in shard order
    (one device may appear more than once)."""

    devices: tuple
    axis: str = WORLD_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def _device(d):
    """``torch.device(d)``, with a CUDA device's index made explicit."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices=None, axis=WORLD_AXIS) -> Mesh:
    """Mesh over ``devices`` (anything ``torch.device`` takes), by default
    every visible CUDA device.  Without a card the default raises: pass
    the devices for another, e.g. ``[torch.device("cpu")] * 8``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "to build a mesh on another device")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(_device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh: no devices")
    return Mesh(devices, axis)


def _map(f, tree, rep=None):
    """``f`` over every tensor leaf of ``tree`` (a tensor, a dataclass such
    as WorldState or SceneParams, a tuple, NamedTuple, list or dict); other
    leaves pass unchanged.  With ``rep``, a SceneParams' ``force_params``
    go through ``rep`` instead."""
    if isinstance(tree, torch.Tensor):
        return f(tree)
    if isinstance(tree, SceneParams) and rep is not None:
        return dataclasses.replace(
            _map(f, dataclasses.replace(tree, force_params=())),
            force_params=_map(rep, tree.force_params))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{k.name: _map(f, getattr(tree, k.name), rep)
                             for k in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(f, x, rep) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(f, x, rep) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(f, v, rep) for k, v in tree.items()}
    return tree


def _leaves(tree):
    out = []
    _map(out.append, tree)
    return out


def _to(x, device):
    """``x`` on ``device``: a copy by ``Tensor.to``, or, where ``x``
    already lies there and requires grad, a view of it.  Either way the
    entry's tensor hangs off a node made on the caller's stream, so the
    caller's leaf meets the shards' gradients on its own stream (with the
    leaf itself, autograd would find its node on a worker's stream)."""
    if x.device == device and x.requires_grad:
        return x.view_as(x)
    return x.to(device)


def shard_worlds(tree, mesh: Mesh):
    """Split every leaf's leading batch axis into ``mesh.size`` contiguous
    equal chunks, in mesh order, each on its device: one tree per mesh
    entry.  A SceneParams' ``force_params`` are replicated, as the tiled
    step passes them whole.  Raises if a batch does not divide, as a JAX
    ``NamedSharding`` does."""
    k = mesh.size

    def check(x):
        if x.dim() == 0 or x.shape[0] % k:
            raise ValueError(f"shard_worlds: a leaf of shape "
                             f"{tuple(x.shape)} does not split into {k} "
                             f"equal shards on its leading axis")
        return x

    _map(check, tree, rep=lambda x: x)

    def shard(i, dev):
        def chunk(x):
            n = x.shape[0] // k
            return x.narrow(0, i * n, n).to(dev)
        return _map(chunk, tree, rep=lambda x: _to(x, dev))

    return [shard(i, d) for i, d in enumerate(mesh.devices)]


def replicate(tree, mesh: Mesh):
    """One copy of ``tree`` per mesh entry, made by ``Tensor.to`` (the same
    tensor, or a view of it if it requires grad, where it already lies on
    the entry's device).  Differentiable: gradients of all copies sum into
    the original leaves."""
    return [_map(lambda x: _to(x, d), tree) for d in mesh.devices]


def gather(trees, device, dim=0):
    """The inverse of :func:`shard_worlds`: the per-entry trees' leaves
    concatenated on ``device`` along ``dim`` (the batch axis; 1 for a
    rollout's trajectory, whose leading axis is time)."""
    cols = zip(*(_leaves(t) for t in trees))
    cats = iter([torch.cat([x.to(device) for x in col], dim) for col in cols])
    return _map(lambda _: next(cats), trees[0])


def _streams(mesh: Mesh):
    """A stream of its own for each CUDA mesh entry (None elsewhere)."""
    return [torch.cuda.Stream(d) if d.type == "cuda" else None
            for d in mesh.devices]


@contextlib.contextmanager
def _on(device, stream):
    if stream is None:
        yield
        return
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


def _run_on_mesh(mesh: Mesh, streams, fn, args):
    """``fn(*args[i])`` for every mesh entry i, each in a worker thread of
    its own, on the entry's device and stream, under the caller's grad
    mode.  Returns the results in mesh order; the first worker's error is
    raised (with the count of the others) after every worker has ended."""
    grad = torch.is_grad_enabled()
    for d, s, a in zip(mesh.devices, streams, args):
        if s is not None:
            s.wait_stream(torch.cuda.current_stream(d))
            for x in _leaves(a):
                if x.is_cuda:
                    x.record_stream(s)

    def work(i):
        with torch.set_grad_enabled(grad), _on(mesh.devices[i], streams[i]):
            return fn(*args[i])

    with concurrent.futures.ThreadPoolExecutor(
            mesh.size, thread_name_prefix="shard") as ex:
        futures = [ex.submit(work, i) for i in range(mesh.size)]
        errors = [e for e in (f.exception() for f in futures)
                  if e is not None]
    for d, s in zip(mesh.devices, streams):
        if s is not None:
            torch.cuda.current_stream(d).wait_stream(s)
    if errors:
        if len(errors) > 1:
            errors[0].add_note(f"{len(errors) - 1} more shard(s) failed")
        raise errors[0]
    outs = [f.result() for f in futures]
    for d, s, o in zip(mesh.devices, streams, outs):
        if s is not None:
            for x in _leaves(o):
                if x.is_cuda:
                    x.record_stream(torch.cuda.current_stream(d))
    return outs


def stack_states(states) -> WorldState:
    """Stack single-world states into a batched WorldState."""
    return WorldState(*(torch.stack([getattr(s, f) for s in states])
                        for f in ("p", "v", "t")))


def tile_state(state: WorldState, batch: int) -> WorldState:
    """Repeat one world state into a batch of identical worlds."""
    rep = lambda x: x[None].expand((batch,) + tuple(x.shape)).clone()
    return WorldState(rep(state.p), rep(state.v), rep(state.t))


def make_batched_step(static, config: SimConfig = SimConfig(),
                      params_batched=False):
    """Batched step ``(params, states, dt) -> (states', diags)``: one
    parameter set shared by all worlds, or per-world parameters with
    ``params_batched=True``.  The KKT solves run once over all worlds."""
    return make_step_batched(static, config, params_batched)


def make_sharded_step(static, mesh: Mesh, config: SimConfig = SimConfig(),
                      params_batched=False):
    """The batched step over a mesh: ``(step, place_states,
    place_params)``.  ``place_states`` shards a batch of states,
    ``place_params`` replicates shared parameters (shards per-world ones
    with ``params_batched``); ``step(params_list, states_list, dt)`` steps
    each shard on its device in a worker thread and returns the per-shard
    ``(states', diags)`` list that :func:`gather` assembles.  ``dt`` is a
    number or a () tensor.  Unlike the JAX step it does not donate the
    input buffers."""
    bstep = make_batched_step(static, config, params_batched)
    streams = _streams(mesh)

    def place_states(states):
        return shard_worlds(states, mesh)

    def place_params(params):
        return (shard_worlds if params_batched else replicate)(params, mesh)

    def step(params_list, states_list, dt):
        return _run_on_mesh(mesh, streams, bstep,
                            [(p, s, dt) for p, s in zip(params_list,
                                                        states_list)])

    return step, place_states, place_params


def batched_rollout(static, config, params, states, dt, n_steps,
                    params_batched=False, remat=False, mesh: Mesh = None,
                    with_diagnostics=False):
    """Roll a batch of worlds ``n_steps`` forward: (final, traj), or
    (final, traj, :class:`core.step.RolloutDiagnostics`) with
    ``with_diagnostics=True``; ``remat=True`` recomputes each step's
    forward in the backward (``core.step.rollout``).

    With ``mesh``, the inputs are placed first (states sharded, parameters
    replicated or, with ``params_batched``, sharded) and each shard rolls
    out on its device; the result is the per-shard list of those tuples,
    which :func:`gather` assembles (``dim=1`` for a trajectory)."""
    bstep = make_batched_step(static, config, params_batched)

    def run(p, s):
        return rollout(bstep, p, s, dt, n_steps, remat=remat,
                       with_diagnostics=with_diagnostics)

    if mesh is None:
        return run(params, states)
    placed = (shard_worlds if params_batched else replicate)(params, mesh)
    return _run_on_mesh(mesh, _streams(mesh), run,
                        list(zip(placed, shard_worlds(states, mesh))))
