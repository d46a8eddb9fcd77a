"""Batching utilities for the LCP layer.

Counterpart of ``lcp_physics_tpu/lcp/util.py`` (the reference's ``bger``,
``expandParam``, ``extract_nBatch``, ``get_sizes``).  The solver is
batch-native, so these helpers only normalize user-provided parameter
stacks (shared vs per-instance) into one batch.
"""
from __future__ import annotations


def bger(x, y):
    """Batched outer product: (..., n) x (..., m) -> (..., n, m)."""
    return x[..., :, None] * y[..., None, :]


def get_sizes(G, A=None):
    """(m, n[, q]) from constraint matrices, ignoring leading batch dims."""
    m, n = G.shape[-2], G.shape[-1]
    if A is None:
        return m, n
    return m, n, A.shape[-2]


def extract_batch_size(Q, p, G, h, A=None, b=None, F=None):
    """The batch size carried by whichever argument has a leading batch
    axis, or None.  Base (unbatched) ranks: Q 2, p 1, G 2, h 1, A 2, b 1,
    F 2."""
    base = {"Q": 2, "p": 1, "G": 2, "h": 1, "A": 2, "b": 1, "F": 2}
    for name, x in [("Q", Q), ("p", p), ("G", G), ("h", h),
                    ("A", A), ("b", b), ("F", F)]:
        if x is not None and x.dim() == base[name] + 1:
            return x.shape[0]
    return None


def expand_param(x, n_batch, base_ndim):
    """Broadcast a possibly-shared parameter to a full batch axis: rank
    ``base_ndim`` is shared across the batch, rank ``base_ndim + 1``
    already per instance (the reference's ``expandParam``)."""
    if x is None:
        return None
    if x.dim() == base_ndim:
        return x.expand((n_batch,) + tuple(x.shape))
    if x.dim() == base_ndim + 1:
        return x
    raise ValueError(f"parameter rank {x.dim()} incompatible with base rank "
                     f"{base_ndim}")


def batch(fn):
    """Wrap an LCP function ``fn(Q, p, G, h, A, b, F, **kw)`` with the
    reference's nBatch semantics: when any argument carries a batch axis,
    every shared argument is expanded to it and ``fn`` is called ONCE on
    the whole batch.

    Unlike the JAX package's ``batch``, this does not vmap a
    single-instance function: the port's solver is batch-native and its
    loop reads the host each iteration, which ``torch.func.vmap`` cannot
    trace, so ``fn`` must take batched inputs (``pdipm_solve``,
    ``lcp_solve`` and ``lcp_solve_full`` do)."""

    def wrapped(Q, p, G, h, A=None, b=None, F=None, **kw):
        nb = extract_batch_size(Q, p, G, h, A, b, F)
        if nb is None:
            return fn(Q, p, G, h, A, b, F, **kw)
        return fn(expand_param(Q, nb, 2), expand_param(p, nb, 1),
                  expand_param(G, nb, 2), expand_param(h, nb, 1),
                  expand_param(A, nb, 2), expand_param(b, nb, 1),
                  expand_param(F, nb, 2), **kw)

    return wrapped


# Reference-spelling aliases (lcp_physics/lcp/util.py).
expandParam = expand_param
extract_nBatch = extract_batch_size
