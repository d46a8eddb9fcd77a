"""Joints: the equality rows of a configuration's ``joints`` entries.

An entry is the engine's description of one constraint, as a JSON object:
``kind``, ``body1``, and where the kind needs them ``body2`` (absent or
-1: the world), ``local1`` and ``local2`` (anchor offsets in each body's
frame) and ``ref`` ([rot, x, y] targets, which only a position-level
correction reads).  At the velocity level every row asks a velocity of
the constrained quantity to be zero (b = 0):

* ``joint``: the world velocity of body1's anchor less body2's (or the
  world's, zero), in x and in y (2 rows); the velocity of a point at
  offset r (world frame) from a body's centre is v + omega perp(r),
  perp(r) = (-r_y, r_x), r = R(angle) local;
* ``fixed``: the joint's two rows and omega1 - omega2 (3 rows);
* ``x``, ``y``, ``rot``: vx, vy or omega of body1 (1 row);
* ``total``: omega, vx and vy of body1 (3 rows).

A pair of bodies that a joint links never makes a contact: the pairs a
jointed world checks are the others (``contact_pairs``).
"""
from __future__ import annotations

import numpy as np
import torch

COL = {"rot": 0, "x": 1, "y": 2}


def _body2(entry):
    return entry.get("body2", -1)


def contact_pairs(N, joints):
    """(ia, ib): the pairs i < j of N bodies that no joint links, in
    row-major order."""
    iu, ju = np.triu_indices(N, 1)
    linked = {frozenset((j["body1"], _body2(j))) for j in joints
              if _body2(j) >= 0}
    keep = np.array([frozenset((a, b)) not in linked
                     for a, b in zip(iu.tolist(), ju.tolist())], bool)
    return iu[keep], ju[keep]


def _anchor_rows(local, angle):
    """The x and y rows' blocks (B, 3) [d/d omega, d/d vx, d/d vy] of the
    world velocity of the anchor at ``local`` of bodies at ``angle``."""
    lx, ly = float(local[0]), float(local[1])
    c, s = torch.cos(angle), torch.sin(angle)
    rx, ry = c * lx - s * ly, s * lx + c * ly
    one, zero = torch.ones_like(rx), torch.zeros_like(rx)
    return (torch.stack([-ry, one, zero], -1),
            torch.stack([rx, zero, one], -1))


def rows(joints, p):
    """A (B, q, 3N) and b (B, q) of the ``joints`` entries for worlds at
    positions p (B, N, 3); A is differentiable in p's angles."""
    B, N = p.shape[:2]
    out = []

    def row(*blocks):
        """One row from (body, sign, (B, 3) block) parts."""
        r = p.new_zeros((B, N, 3))
        for body, sign, blk in blocks:
            r[:, body] = r[:, body] + sign * blk
        out.append(r.reshape(B, 3 * N))

    unit = lambda col: p.new_tensor(
        [float(k == col) for k in range(3)]).expand(B, 3)
    for j in joints:
        kind, b1, b2 = j["kind"], j["body1"], _body2(j)
        if kind in ("joint", "fixed"):
            x1, y1 = _anchor_rows(j.get("local1", (0.0, 0.0)), p[:, b1, 0])
            if b2 >= 0:
                x2, y2 = _anchor_rows(j.get("local2", (0.0, 0.0)),
                                      p[:, b2, 0])
                row((b1, 1.0, x1), (b2, -1.0, x2))
                row((b1, 1.0, y1), (b2, -1.0, y2))
            else:
                row((b1, 1.0, x1))
                row((b1, 1.0, y1))
            if kind == "fixed":
                if b2 >= 0:
                    row((b1, 1.0, unit(0)), (b2, -1.0, unit(0)))
                else:
                    row((b1, 1.0, unit(0)))
        elif kind in COL:
            row((b1, 1.0, unit(COL[kind])))
        elif kind == "total":
            for col in (0, 1, 2):
                row((b1, 1.0, unit(col)))
        else:
            raise ValueError(f"unknown joint kind {kind!r}")
    if not out:
        return p.new_zeros((B, 0, 3 * N)), p.new_zeros((B, 0))
    A = torch.stack(out, 1)
    return A, p.new_zeros(A.shape[:2])
