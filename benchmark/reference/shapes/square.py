"""Squares (``width`` x ``height`` boxes, radius 0): the separating-axis
test and a two-point manifold for every pair of squares.

For each pair (a, b), taken i < j in lexicographic order:

* the separating-axis test over both squares' face normals: for each face
  of one square, the smallest signed distance of the other's corners to
  the face's line; the largest over a square's faces is its separation,
  and its face (the first of equals) its candidate reference face;
* the reference face is a's unless b's separation is larger by the
  relative tolerance (b wins where sep_b > 0.98 sep_a + 1e-6), the
  incident square is the other one, and its incident edge is the face
  whose normal is most anti-parallel to the reference normal (the first
  of equals);
* the incident edge is clipped to the reference face's two side planes,
  giving up to two points that share the normal; a point's depth is its
  penetration along the reference normal, and it is kept while its
  depth is above -(m_a + m_b) and the pair's separation at most
  m_a + m_b, m the speculative margin of each body,
  dt (|v| + |omega| reach + dt |g|) + 10 tol with reach its largest
  corner norm (the radius is 0);
* the pair is a candidate only where its corner boxes, each inflated by
  its body's margin, overlap;
* the points are rows in pair-major order (pair p's two points in rows
  2p and 2p + 1); past ``c_max`` rows the deepest ``c_max`` valid rows
  are kept by a stable descending sort, so equal depths keep row order.

``normal`` points from b toward a; the point on the incident square is
the clipped point, the point on the reference square its projection onto
the reference face, and ``ra``, ``rb`` are each body's point less its
centre.  Every pair is tested (no pair budget).

Departures from the published description (Box2D's
``b2CollidePolygons``, Ericson's "Real-Time Collision Detection" 5.x),
each the engine's own formulation:

* the relative tolerance's absolute term is 1e-6, not Box2D's half of a
  linear slop;
* the clip is parametric on the incident edge, [t0, t1] = [0, 1] cut by
  each side plane (a plane that the edge runs parallel to, within 1e-12,
  keeps all of it or none); its end points are the points that
  Sutherland-Hodgman clipping gives;
* Box2D reports the clipped point for both bodies; here the reference
  body's point is its projection onto the reference face;
* points are kept down to -(m_a + m_b) (speculative contacts), where
  Box2D keeps only points within a fixed slop;
* a unit vector is v / sqrt(|v|^2 + 1e-12).

The arithmetic of each quantity follows the engine's expressions term by
term, so that at float64 the depths, and so the compaction's order, come
out equal to the last bit.
"""
from __future__ import annotations

import numpy as np
import torch

TOL = 1e-6      # the engine's contact tolerance (speculative slop)
_TINY = 1e-12


def params(config, dtype, device):
    """The configuration's per-body parameters (N,), its local corners
    (N, 4, 2), gravity and ``c_max``: the ``world`` dict of
    ``benchmark.reference.world``."""
    N = config["bodies"]
    full = lambda x: torch.full((N,), float(x), dtype=dtype, device=device)
    w, h = config["width"], config["height"]
    m = config["mass"]
    corners = torch.tensor([[-w / 2, -h / 2], [w / 2, -h / 2],
                            [w / 2, h / 2], [-w / 2, h / 2]], dtype=dtype,
                           device=device)
    return dict(shape="square", mass=full(m),
                inertia=full(m * (w * w + h * h) / 12.0),
                restitution=full(config["restitution"]),
                fric_coeff=full(config["fric_coeff"]),
                verts=corners.expand(N, 4, 2).clone(),
                gravity=torch.tensor(config["gravity"], dtype=dtype,
                                     device=device),
                c_max=config["c_max"])


def corners_in_world(verts, p):
    """World corners (B, N, 4, 2) of local corners (N, 4, 2) at poses p
    (B, N, 3) = [angle, x, y]."""
    c = torch.cos(p[..., 0])[..., None]
    s = torch.sin(p[..., 0])[..., None]
    x = c * verts[..., 0] - s * verts[..., 1]
    y = s * verts[..., 0] + c * verts[..., 1]
    return torch.stack([x + p[..., 1:2], y + p[..., 2:3]], -1)


def margins(v, reach, gravity, dt):
    """(B, N) speculative band of each square (module docstring)."""
    speed = (torch.linalg.vector_norm(v[..., 1:3], dim=-1)
             + v[..., 0].abs() * reach)
    g = torch.linalg.vector_norm(gravity, dim=-1)
    return (dt * (speed + dt * g) + 10.0 * TOL).detach()


def faces(wc):
    """Each square's faces from its world corners wc (..., 4, 2): a list
    over faces k of (start, end, unit outward normal), each (..., 2);
    face k runs from corner k to corner k + 1, counter-clockwise."""
    out = []
    for k in range(4):
        a, b = wc[..., k, :], wc[..., (k + 1) % 4, :]
        ex, ey = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
        inv = 1.0 / torch.sqrt(ex * ex + ey * ey + _TINY)
        out.append((a, b, torch.stack([ey * inv, -ex * inv], -1)))
    return out


def separation(ref_faces, other):
    """For each face of one square, the smallest signed distance of the
    other's corners ``other`` (..., 4, 2) to the face's line; returns the
    largest of those over the faces and the first face that has it."""
    best = idx = None
    for k, (a, _, n) in enumerate(ref_faces):
        d = None
        for j in range(4):
            o = other[..., j, :]
            dj = (n[..., 0] * (o[..., 0] - a[..., 0])
                  + n[..., 1] * (o[..., 1] - a[..., 1]))
            d = dj if d is None else torch.minimum(d, dj)
        if best is None:
            best, idx = d, torch.zeros_like(d, dtype=torch.int64)
        else:
            idx = torch.where(d > best, k, idx)
            best = torch.maximum(best, d)
    return best, idx


def pick(items, k):
    """items[k] per element: ``items`` a list over faces of (..., D)
    tensors, ``k`` (...) face indices."""
    out = items[0]
    for j in range(1, len(items)):
        out = torch.where((k == j)[..., None], items[j], out)
    return out


def side_interval(g0, gd):
    """The t of the incident edge with g0 + t gd >= 0: (lo, hi)."""
    eps = 1e-12
    inf = torch.full_like(g0, float("inf"))
    t = -g0 / torch.where(gd.abs() > eps, gd, torch.ones_like(gd))
    lo = torch.where(gd > eps, t, -inf)
    hi = torch.where(gd < -eps, t, inf)
    parallel_out = (gd.abs() <= eps) & (g0 < 0)
    return torch.where(parallel_out, inf, lo), hi


def manifold(ca, cb, pos_a, pos_b, band):
    """The two points of pairs of squares with world corners ca, cb
    (B, P, 4, 2), centres pos_a, pos_b (B, P, 2) and speculative band
    (B, P): (normal (B, P, 2), ra, rb (B, P, 2, 2), depth, kept
    (B, P, 2))."""
    fa, fb = faces(ca), faces(cb)
    sep_a, ka = separation(fa, cb)
    sep_b, kb = separation(fb, ca)
    use_b = sep_b > 0.98 * sep_a + 1e-6
    sep = torch.where(use_b, sep_b, sep_a)
    ub = use_b[..., None]
    ref_v1 = torch.where(ub, pick([f[0] for f in fb], kb),
                         pick([f[0] for f in fa], ka))
    ref_v2 = torch.where(ub, pick([f[1] for f in fb], kb),
                         pick([f[1] for f in fa], ka))
    ref_n = torch.where(ub, pick([f[2] for f in fb], kb),
                        pick([f[2] for f in fa], ka))

    # incident edge: the other square's face most anti-parallel to ref_n
    inc = [tuple(torch.where(ub, x, y) for x, y in zip(f_a, f_b))
           for f_a, f_b in zip(fa, fb)]
    best = ki = None
    for k, (_, _, n) in enumerate(inc):
        al = n[..., 0] * ref_n[..., 0] + n[..., 1] * ref_n[..., 1]
        if best is None:
            best, ki = al, torch.zeros_like(al, dtype=torch.int64)
        else:
            ki = torch.where(al < best, k, ki)
            best = torch.minimum(best, al)
    i1, i2 = pick([f[0] for f in inc], ki), pick([f[1] for f in inc], ki)

    # clip the incident edge i1 + t (i2 - i1) to the reference face's
    # side planes, through its two ends
    D = i2 - i1
    rt = ref_v2 - ref_v1
    rinv = 1.0 / torch.sqrt(rt[..., 0] * rt[..., 0] + rt[..., 1] * rt[..., 1]
                            + _TINY)
    tx, ty = rt[..., 0] * rinv, rt[..., 1] * rinv
    lo1, hi1 = side_interval(tx * (i1[..., 0] - ref_v1[..., 0])
                             + ty * (i1[..., 1] - ref_v1[..., 1]),
                             tx * D[..., 0] + ty * D[..., 1])
    lo2, hi2 = side_interval(-tx * (i1[..., 0] - ref_v2[..., 0])
                             - ty * (i1[..., 1] - ref_v2[..., 1]),
                             -tx * D[..., 0] - ty * D[..., 1])
    zero = torch.zeros_like(lo1)
    t0 = torch.maximum(zero, torch.maximum(lo1, lo2))
    t1 = torch.minimum(zero + 1.0, torch.minimum(hi1, hi2))
    ts = torch.stack([t0, t1], -1)                           # (B, P, 2)
    px = i1[..., None, 0] + ts * D[..., None, 0]
    py = i1[..., None, 1] + ts * D[..., None, 1]
    nx, ny = ref_n[..., None, 0], ref_n[..., None, 1]
    depth = -((px - ref_v1[..., None, 0]) * nx
              + (py - ref_v1[..., None, 1]) * ny)
    kept = ((t0 <= t1)[..., None] & (depth > -band[..., None])
            & (sep <= band)[..., None])
    on_inc = torch.stack([px, py], -1)
    on_ref = torch.stack([px + depth * nx, py + depth * ny], -1)
    ub2 = use_b[..., None, None]
    pa = torch.where(ub2, on_inc, on_ref)
    pb = torch.where(ub2, on_ref, on_inc)
    normal = torch.where(ub, ref_n, -ref_n)
    return (normal, pa - pos_a[..., None, :], pb - pos_b[..., None, :],
            depth, kept)


def contacts(world, p, v, dt):
    """The padded contact buffer (normal, ra, rb, depth, ia, ib, valid) of
    the square worlds, each (B, c_max, ...) (module docstring)."""
    B, N = p.shape[:2]
    verts = world["verts"]
    wc = corners_in_world(verts, p)                          # (B, N, 4, 2)
    reach = torch.linalg.vector_norm(verts, dim=-1).amax(-1)
    margin = margins(v, reach, world["gravity"], dt)
    iu, ju = np.triu_indices(N, 1)
    ia = torch.as_tensor(iu, device=p.device)
    ib = torch.as_tensor(ju, device=p.device)
    lo = wc.amin(-2) - margin[..., None]
    hi = wc.amax(-2) + margin[..., None]
    boxes = ((lo[:, ia] <= hi[:, ib]) & (lo[:, ib] <= hi[:, ia])).all(-1)
    band = margin[:, ia] + margin[:, ib]
    pos = p[..., 1:3]
    normal, ra, rb, depth, kept = manifold(wc[:, ia], wc[:, ib], pos[:, ia],
                                           pos[:, ib], band)
    P = ia.shape[0]
    rows = lambda x: x.reshape((B, 2 * P) + x.shape[3:])
    out = [rows(normal[:, :, None].expand(B, P, 2, 2)), rows(ra), rows(rb),
           rows(depth), ia.repeat_interleave(2).expand(B, -1),
           ib.repeat_interleave(2).expand(B, -1),
           rows(kept & boxes[..., None])]
    c_max = world["c_max"]
    if 2 * P <= c_max:
        pad = c_max - 2 * P
        return [torch.nn.functional.pad(x, (0, 0, 0, pad) if x.dim() == 3
                                        else (0, pad)) for x in out]
    score = torch.where(out[6], out[3], float("-inf"))
    keep = torch.sort(score, dim=-1, descending=True,
                      stable=True).indices[:, :c_max]
    return [x.gather(1, keep[..., None].expand(-1, -1, 2)) if x.dim() == 3
            else x.gather(1, keep) for x in out]
