"""Checkpoint / resume for world state and scene parameters.

Counterpart of ``lcp_physics_tpu/utils/checkpoint.py``.  A tree here is any
nesting of the port's dataclasses (``WorldState``, ``SceneParams``),
NamedTuples, tuples, lists, dicts, ``None`` and leaves (tensors, arrays,
numbers).  ``save_pytree`` writes one ``.npz`` with the leaves and a
description of the tree's structure; ``load_pytree`` checks that
description against the target structure (a mismatch raises instead of
scattering leaves into the wrong fields) and restores each leaf with the
dtype and device of the target's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_SUFFIX = "__leaf"


def _flatten(tree, leaves):
    """Append the leaves of ``tree`` to ``leaves``; return its structure
    as a string."""
    if tree is None:
        return "None"
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        kids = [_flatten(getattr(tree, n), leaves) for n in names]
        return (f"{type(tree).__name__}("
                + ", ".join(f"{n}={k}" for n, k in zip(names, kids)) + ")")
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        kids = [_flatten(getattr(tree, n), leaves) for n in tree._fields]
        return (f"{type(tree).__name__}("
                + ", ".join(f"{n}={k}" for n, k in zip(tree._fields, kids))
                + ")")
    if isinstance(tree, (tuple, list)):
        kids = [_flatten(x, leaves) for x in tree]
        o, c = ("(", ")") if isinstance(tree, tuple) else ("[", "]")
        return o + ", ".join(kids) + (",)" if len(kids) == 1 and o == "("
                                      else c)
    if isinstance(tree, dict):
        keys = sorted(tree)
        kids = [_flatten(tree[k], leaves) for k in keys]
        return "{" + ", ".join(f"{k!r}: {v}" for k, v in zip(keys, kids)) \
            + "}"
    leaves.append(tree)
    return "*"


def _unflatten(like, leaves):
    """A tree of ``like``'s structure whose leaves are taken, in order,
    from the iterator ``leaves``."""
    if like is None:
        return None
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return type(like)(**{f.name: _unflatten(getattr(like, f.name),
                                                leaves)
                             for f in dataclasses.fields(like)})
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, n), leaves)
                            for n in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(x, leaves) for x in like)
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    return next(leaves)


def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_pytree(path, tree):
    """Save a tree of tensors, arrays and numbers to ``path`` (.npz)."""
    leaves = []
    structure = _flatten(tree, leaves)
    arrays = {f"{i}{_SUFFIX}": _as_numpy(x) for i, x in enumerate(leaves)}
    np.savez(path, __treedef__=np.frombuffer(structure.encode(),
                                             dtype=np.uint8), **arrays)


def load_pytree(path, like):
    """Load a tree saved by :func:`save_pytree` into the structure of
    ``like``; each leaf takes the dtype (and, for tensors, the device) of
    the matching leaf of ``like``.  Raises ``ValueError`` when the stored
    structure differs from ``like``'s."""
    like_leaves = []
    structure = _flatten(like, like_leaves)
    with np.load(path) as data:
        if "__treedef__" in data:
            stored = bytes(data["__treedef__"]).decode()
            if stored != structure:
                raise ValueError(
                    "checkpoint treedef mismatch:\n"
                    f"  stored: {stored}\n  target: {structure}")
        n_stored = sum(1 for k in data.files if k.endswith(_SUFFIX))
        if n_stored != len(like_leaves):
            raise ValueError(
                f"checkpoint has {n_stored} leaves, target structure has "
                f"{len(like_leaves)}")
        out = []
        for i, ref in enumerate(like_leaves):
            arr = data[f"{i}{_SUFFIX}"]
            if isinstance(ref, torch.Tensor):
                out.append(torch.as_tensor(arr, dtype=ref.dtype,
                                           device=ref.device))
            else:
                out.append(np.asarray(arr, dtype=np.asarray(ref).dtype))
    return _unflatten(like, iter(out))


def save_world(path, state, params=None):
    """Checkpoint a WorldState (and optionally SceneParams)."""
    save_pytree(path, (state, params))


def load_world(path, like_state, like_params=None):
    state, params = load_pytree(path, (like_state, like_params))
    return (state, params) if like_params is not None else (state, None)
