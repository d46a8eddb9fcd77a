"""Constraint and contact Jacobians over the flattened (3N,) generalized
velocity [omega_0, vx_0, vy_0, omega_1, ...].

Counterpart of ``lcp_physics_tpu/core/jacobians.py``, batch-native: ``p``
is (B, N, 3) and every Jacobian carries the leading world axis.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from lcp_physics_tpu_torch.core.geometry import Contacts
from lcp_physics_tpu_torch.core.state import SceneStatic
from lcp_physics_tpu_torch.utils import bump, cross_2d, orthogonal_tangents


JOINT_TABLES = {"made": 0, "used": 0}
_TABLES_LOCK = threading.Lock()
_COL = {"rot": 0, "x": 1, "y": 2}


def _host_tables(joints, N):
    """numpy tables of the equality rows of ``joints`` over N bodies.

    Je is a constant part of 0/+-1 entries and, for every point term of a
    ``joint``/``fixed`` (body1 with sign +1, body2 with sign -1), the two
    entries (row_x, 3b) = -ry * sign and (row_y, 3b) = rx * sign, r the
    term's offset rotated by the body's angle.  The writes are replayed in
    the joints' order, so where two terms write one entry (body2 == body1)
    the later wins and the indexed copy never sees a duplicate index.  The
    position error reads every term: ``pair`` holds each point pair's
    bodies and offsets (body2 -1: the world anchor ``ref[1:3]``), ``ang``
    each ``fixed``'s angle row, ``unit`` each x/y/rot/total row, and
    ``order`` puts [pair x, pair y, ang, unit] back in the joints' rows."""
    q = sum(js.rows for js in joints)
    const = np.zeros((q, 3 * N))
    src = {}                      # (row, col) -> (term, 0 for x / 1 for y)
    terms, pair, ang, unit = [], [], [], []
    row_of = {"pair_x": [], "pair_y": [], "ang": [], "unit": []}

    def point(rx, ry, b, local, sign):
        t = len(terms)
        terms.append((b, local[0], local[1], sign))
        for row, comp in ((rx, 0), (ry, 1)):
            const[row, 3 * b + 1:3 * b + 3] = (sign * (1.0 - comp),
                                               sign * float(comp))
            src[(row, 3 * b)] = (t, comp)

    row = 0
    for js in joints:
        b1, b2 = js.body1, js.body2
        if js.kind in ("joint", "fixed"):
            point(row, row + 1, b1, js.local1, 1.0)
            if b2 >= 0:
                point(row, row + 1, b2, js.local2, -1.0)
            pair.append((b1, *js.local1, max(b2, 0), *js.local2, b2 >= 0,
                         *js.ref[1:3]))
            row_of["pair_x"].append(row)
            row_of["pair_y"].append(row + 1)
            row += 2
            if js.kind == "fixed":
                const[row, 3 * b1] = 1.0
                if b2 >= 0:
                    const[row, 3 * b2] = -1.0
                ang.append((b1, max(b2, 0), b2 >= 0, js.ref[0]))
                row_of["ang"].append(row)
                row += 1
        elif js.kind in _COL:
            const[row, 3 * b1 + _COL[js.kind]] = 1.0
            unit.append((3 * b1 + _COL[js.kind], js.ref[_COL[js.kind]]))
            row_of["unit"].append(row)
            row += 1
        elif js.kind == "total":
            for col in (0, 1, 2):
                const[row, 3 * b1 + col] = 1.0
                unit.append((3 * b1 + col, js.ref[col]))
                row_of["unit"].append(row)
                row += 1
        else:
            raise ValueError(f"unknown joint kind {js.kind}")
    kept = sorted({t for t, _ in src.values()})
    at = {tc: row * 3 * N + col for (row, col), tc in src.items()}
    order = np.argsort(np.concatenate([row_of[k] for k in
                                       ("pair_x", "pair_y", "ang", "unit")]))
    return dict(
        const=const.reshape(-1),
        term=np.array([terms[t] for t in kept]).reshape(-1, 4),
        at=np.array([at[(t, comp)] for comp in (0, 1) for t in kept]),
        pair=np.array(pair, float).reshape(-1, 9),
        ang=np.array(ang, float).reshape(-1, 4),
        unit=np.array(unit, float).reshape(-1, 2),
        order=order)


def _tables(static: SceneStatic, device, dtype):
    """The scene's joint tables on ``device`` in ``dtype``, copied there
    once and kept on the scene (``SceneStatic.on_device``); counted in
    ``JOINT_TABLES``: ``made`` a copy, ``used`` a call served."""
    key = ("joints", device, dtype)
    with _TABLES_LOCK:
        tabs = static.on_device.get(key)
        if tabs is None:
            host = _host_tables(static.joints, static.n_bodies)
            idx = lambda a: torch.as_tensor(a, dtype=torch.long,
                                            device=device)
            val = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
            term, pair, ang, unit = (host[k] for k in
                                     ("term", "pair", "ang", "unit"))
            tabs = dict(
                const=val(host["const"]), at=idx(host["at"]),
                rot=idx(3 * term[:, 0]), lx=val(term[:, 1]),
                ly=val(term[:, 2]), sign=val(term[:, 3]),
                b1=idx(pair[:, 0]), l1x=val(pair[:, 1]), l1y=val(pair[:, 2]),
                b2=idx(pair[:, 3]), l2x=val(pair[:, 4]), l2y=val(pair[:, 5]),
                has2=idx(pair[:, 6]).bool(), anchor=val(pair[:, 7:9]),
                a1=idx(ang[:, 0]), a2=idx(ang[:, 1]),
                ahas2=idx(ang[:, 2]).bool(), aref=val(ang[:, 3]),
                ucol=idx(unit[:, 0]), uref=val(unit[:, 1]),
                order=idx(host["order"]))
            static.on_device[key] = tabs
            bump(JOINT_TABLES, "made")
    bump(JOINT_TABLES, "used")
    return tabs


def _rotated(th, lx, ly):
    """(rx, ry): offsets (lx, ly) rotated by th, in ``utils.rotate``'s
    product order."""
    c, s = torch.cos(th), torch.sin(th)
    return c * lx - s * ly, s * lx + c * ly


def assemble_Je(static: SceneStatic, p):
    """Equality (joint) Jacobian (B, n_eq, 3N) at configuration p (B, N, 3):
    the scene's constant part with each point term's two angle-dependent
    entries copied in (one gather of the angles, one indexed copy)."""
    B, N = p.shape[0], static.n_bodies
    if not static.joints:
        return torch.zeros((B, 0, 3 * N), dtype=p.dtype, device=p.device)
    tabs = _tables(static, p.device, p.dtype)
    th = p.reshape(B, 3 * N).index_select(1, tabs["rot"])
    rx, ry = _rotated(th, tabs["lx"], tabs["ly"])
    vals = torch.cat([-ry * tabs["sign"], rx * tabs["sign"]], dim=1)
    Je = tabs["const"].expand(B, -1).index_copy(1, tabs["at"], vals)
    return Je.reshape(B, static.n_eq, 3 * N)


def constraint_position_error(static: SceneStatic, p):
    """Position-level constraint violation (B, n_eq) for post-stabilization."""
    B = p.shape[0]
    if not static.joints:
        return torch.zeros((B, 0), dtype=p.dtype, device=p.device)
    t = _tables(static, p.device, p.dtype)

    def point(b, lx, ly):
        pb = p.index_select(1, b)
        rx, ry = _rotated(pb[..., 0], lx, ly)
        return pb[..., 1] + rx, pb[..., 2] + ry

    a1x, a1y = point(t["b1"], t["l1x"], t["l1y"])
    a2x, a2y = point(t["b2"], t["l2x"], t["l2y"])
    a2x = torch.where(t["has2"], a2x, t["anchor"][:, 0])
    a2y = torch.where(t["has2"], a2y, t["anchor"][:, 1])
    rot = p[:, :, 0]
    rot2 = torch.where(t["ahas2"], rot.index_select(1, t["a2"]), 0.0)
    errs = [a1x - a2x, a1y - a2y,
            rot.index_select(1, t["a1"]) - rot2 - t["aref"],
            p.reshape(B, -1).index_select(1, t["ucol"]) - t["uref"]]
    return torch.cat(errs, dim=1).index_select(1, t["order"])


def assemble_contact_jacobians(contacts: Contacts, n_bodies, fric_dirs=2):
    """Normal and friction Jacobians from a padded contact buffer.

    Returns (Jc (B, C, 3N), Jf (B, fric_dirs*C, 3N), E (fric_dirs*C, C)).
    Invalid contact rows are zeroed.
    """
    B, C = contacts.normal.shape[:2]
    N = n_bodies
    dtype = contacts.normal.dtype
    mask = contacts.valid.to(dtype)
    oh_a = torch.nn.functional.one_hot(contacts.ia, N).to(dtype)
    oh_b = torch.nn.functional.one_hot(contacts.ib, N).to(dtype)

    def pair_rows(direction):
        # separation rate along `direction`: d . (v_a(pt) - v_b(pt))
        blk_a = torch.stack([cross_2d(contacts.ra, direction),
                             direction[..., 0], direction[..., 1]], dim=-1)
        blk_b = -torch.stack([cross_2d(contacts.rb, direction),
                              direction[..., 0], direction[..., 1]], dim=-1)
        J = (oh_a[..., :, None] * blk_a[..., None, :]
             + oh_b[..., :, None] * blk_b[..., None, :])
        return (mask[..., None, None] * J).reshape(B, C, 3 * N)

    Jc = pair_rows(contacts.normal)
    tangents = orthogonal_tangents(contacts.normal, fric_dirs)  # (B, C, fd, 2)
    Jf = torch.cat([pair_rows(tangents[..., d, :])
                    for d in range(fric_dirs)], dim=1)
    eye = torch.eye(C, dtype=dtype, device=Jc.device)
    E = torch.cat([eye] * fric_dirs, dim=0)
    return Jc, Jf, E
