"""Batched broadphase and narrowphase over padded shape arrays.

Counterpart of ``lcp_physics_tpu/core/geometry.py``, written batch-native:
``p`` is (B, N, 3) and every result carries the leading world axis.  Shapes
are "rounded convex hulls" as in the JAX package (``verts`` (N, V, 2) local
vertices, static ``counts``, ``radius``); a circle is a 1-vertex hull.

Three narrowphase kernels, each over a static pair list split by kind:
circle/circle, circle/hull (closest edge point, or the nearest face when
the centre is inside) and hull/hull (separating axes, a reference face
with the JAX package's hysteresis, and the incident face clipped to at
most two points sharing one normal).  The hull/hull kernel keeps the JAX
package's two forms: ``hull_hull`` over (..., V, 2) vertex arrays, and
``hull_hull_pairs``, the form the pipeline runs, with the pair axis last
and x/y apart ((..., V, P) arrays).  Where the JAX package unrolls the
vertex loops and picks faces by one-hot sums, this module broadcasts over
the vertex axis and picks faces with ``gather``: the same values, and
fewer launches.  ``argmax``/``argmin`` keep the first index on ties, and
the compaction and the hull pair budget use a stable descending sort, so
ties go to the lower index as with XLA's ``top_k``.

Invariant kept from the JAX package: a contact is valid only if the two
bodies' AABBs, inflated by the same speculative margin, overlap — so
``any_aabb_overlap`` returning False proves a world contact-free.

Contact normal convention: ``normal`` points FROM body ``b`` TOWARD body
``a``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lcp_physics_tpu_torch.utils import left_orthogonal, rotate
from lcp_physics_tpu_torch.utils.observe import span

_TINY = 1e-12


class Contacts(NamedTuple):
    """Fixed-capacity padded contact buffer, (B, C, ...) per field."""

    normal: torch.Tensor  # (B, C, 2) from body b toward body a
    ra: torch.Tensor      # (B, C, 2) contact point - com(a)
    rb: torch.Tensor      # (B, C, 2) contact point - com(b)
    depth: torch.Tensor   # (B, C) penetration depth (> 0: overlapping)
    ia: torch.Tensor      # (B, C) int64 body index a
    ib: torch.Tensor      # (B, C) int64 body index b
    valid: torch.Tensor   # (B, C) bool


def world_vertices(verts, p):
    """Local padded vertices (N, V, 2) -> world frame given p (..., N, 3)."""
    return rotate(verts, p[..., None, 0]) + p[..., None, 1:3]


def _clip01(x):
    """clip(x, 0, 1) as ``jnp.clip`` computes it (ties split the gradient)."""
    return torch.minimum(torch.maximum(x, torch.zeros_like(x)),
                         torch.ones_like(x))


def _pick(x, idx):
    """Rows of a per-world tensor x (B, N, ...) at body indices idx: (P,)
    for every world or (B, P) per world.  Returns (B, P, ...)."""
    if idx.dim() == 1:
        return x[:, idx]
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _gather_last2(a, sel):
    """a (..., V, P) at row sel (..., P) of its vertex axis -> (..., P)."""
    return torch.gather(a, -2, sel.unsqueeze(-2)).squeeze(-2)


# ---------------------------------------------------------------------------
# Narrowphase kernels, elementwise over leading dims.
# ---------------------------------------------------------------------------

def circle_circle(pa, ra_, pb, rb_):
    """Circle/circle pairs, elementwise over leading dims: centers (..., 2),
    radii (...).  Returns (normal, ra, rb, depth)."""
    d = pa - pb
    dist = torch.sqrt(torch.sum(d * d, dim=-1) + _TINY)
    n = d / dist[..., None]
    depth = ra_ + rb_ - dist
    return n, -n * ra_[..., None], n * rb_[..., None], depth


def _edge_data(wv, count):
    """Edges and outward normals of CCW padded polygons wv (..., V, 2) with
    true vertex counts ``count`` (...): (v2, e, elen, n_out, edge_valid)."""
    V = wv.shape[-2]
    idx = torch.arange(V, device=wv.device)
    count = torch.as_tensor(count, device=wv.device)[..., None]
    nxt = torch.where(idx + 1 < count, idx + 1, 0)
    nxt = nxt.expand(wv.shape[:-1])
    v2 = torch.gather(wv, -2, nxt[..., None].expand(wv.shape))
    e = v2 - wv
    elen = torch.sqrt(torch.sum(e * e, dim=-1) + _TINY)
    n_out = left_orthogonal(e) / elen[..., None]
    edge_valid = (idx < count).expand(wv.shape[:-1])
    return v2, e, elen, n_out, edge_valid


def _take_v(a, k):
    """a (..., V, D) at vertex k (...) -> (..., D)."""
    return torch.gather(a, -2, k[..., None, None].expand(
        a.shape[:-2] + (1, a.shape[-1]))).squeeze(-2)


def circle_hull(pc, rc, wv, count):
    """Circle (center pc (..., 2), radius rc (...)) against a hull (world
    vertices wv (..., V, 2), true vertex count ``count`` (...)).  Returns
    (normal from hull toward circle, r_circle, contact point on the hull,
    depth)."""
    _, e, elen, n_out, edge_valid = _edge_data(wv, count)
    inf = torch.tensor(float("inf"), dtype=wv.dtype, device=wv.device)

    # Closest point on each (valid) edge segment to the circle center.
    to_c = pc[..., None, :] - wv
    t = _clip01(torch.sum(to_c * e, dim=-1) / (elen ** 2))
    cp = wv + t[..., None] * e
    dvec = pc[..., None, :] - cp
    d = torch.sqrt(torch.sum(dvec * dvec, dim=-1) + _TINY)

    sd = torch.sum(n_out * to_c, dim=-1)   # signed distance to edge lines
    inside = torch.all(torch.where(edge_valid, sd, -inf) <= 0, dim=-1)

    k_out = torch.argmin(torch.where(edge_valid, d, inf), dim=-1)
    d_out = torch.gather(d, -1, k_out[..., None]).squeeze(-1)
    n_from_hull = _take_v(dvec, k_out) / d_out[..., None]
    cp_out = _take_v(cp, k_out)

    k_in = torch.argmax(torch.where(edge_valid, sd, -inf), dim=-1)
    s_in = torch.gather(sd, -1, k_in[..., None]).squeeze(-1)  # <= 0 inside
    n_in = _take_v(n_out, k_in)
    cp_in = pc - n_in * s_in[..., None]    # projection onto nearest face

    ins = inside[..., None]
    n = torch.where(ins, n_in, n_from_hull)
    s = torch.where(inside, s_in, d_out)   # signed distance center->boundary
    depth = rc - s
    cp_hull = torch.where(ins, cp_in, cp_out)
    return n, -n * rc[..., None], cp_hull, depth


def _face_separation(n_out, face_v, edge_valid, other_wv, other_count):
    """For each face of the reference hull, the minimum signed distance of
    the other hull's valid vertices to that face plane: (..., V)."""
    Vo = other_wv.shape[-2]
    vert_valid = torch.arange(Vo, device=other_wv.device) < torch.as_tensor(
        other_count, device=other_wv.device)[..., None]
    diff = other_wv[..., None, :, :] - face_v[..., :, None, :]
    d = torch.sum(n_out[..., :, None, :] * diff, dim=-1)   # (..., Vf, Vo)
    inf = torch.tensor(float("inf"), dtype=d.dtype, device=d.device)
    d = torch.where(vert_valid[..., None, :], d, inf)
    return torch.where(edge_valid, torch.amin(d, dim=-1), -inf)


def _halfplane_interval(g0, gd):
    """Interval of t with g0 + t*gd >= 0 (branch-free, elementwise): the
    one copy of the eps and empty-interval logic both hull/hull kernels
    use."""
    eps = 1e-12
    pos = gd > eps
    neg = gd < -eps
    t_cross = -g0 / torch.where(torch.abs(gd) > eps, gd, torch.ones_like(gd))
    inf = torch.tensor(float("inf"), dtype=g0.dtype, device=g0.device)
    lo = torch.where(pos, t_cross, -inf)
    hi = torch.where(neg, t_cross, inf)
    empty = (~pos) & (~neg) & (g0 < 0)
    lo = torch.where(empty, inf, lo)
    return lo, hi


def _clip_params(lo1, hi1, lo2, hi2):
    """[t0, t1] = [0, 1] cut by the two side-plane intervals."""
    t0 = torch.maximum(torch.zeros_like(lo1), torch.maximum(lo1, lo2))
    t1 = torch.minimum(torch.ones_like(hi1), torch.minimum(hi1, hi2))
    return t0, t1


def hull_hull(wva, ca, pos_a, wvb, cb, pos_b, margin=0.0):
    """Hull/hull pairs, elementwise over leading dims, by SAT and
    reference/incident face clipping: world vertices (..., V, 2), counts
    (...), coms (..., 2).

    Returns (normal (..., 2), ra (..., 2, 2), rb (..., 2, 2), depth
    (..., 2), point_valid (..., 2)): up to two contact points sharing one
    normal.  ``margin`` > 0 also emits near-contact points with negative
    depth down to ``-margin``."""
    _, _, _, na, eva = _edge_data(wva, ca)
    _, _, _, nb, evb = _edge_data(wvb, cb)
    dev = wva.device
    ca = torch.as_tensor(ca, device=dev).expand(wva.shape[:-2])
    cb = torch.as_tensor(cb, device=dev).expand(wvb.shape[:-2])
    margin = torch.as_tensor(margin, dtype=wva.dtype, device=dev)

    sep_a_k = _face_separation(na, wva, eva, wvb, cb)
    sep_b_k = _face_separation(nb, wvb, evb, wva, ca)
    sep_a = torch.amax(sep_a_k, dim=-1)
    sep_b = torch.amax(sep_b_k, dim=-1)
    ka = torch.argmax(sep_a_k, dim=-1)
    kb = torch.argmax(sep_b_k, dim=-1)

    # Box2D-style preference for hull A (coherence under near-ties).
    use_b = sep_b > 0.98 * sep_a + 1e-6
    sep = torch.where(use_b, sep_b, sep_a)
    ub = use_b[..., None]

    def gather_face(wv, count, k):
        nxt = torch.where(k + 1 < count, k + 1, 0)
        return _take_v(wv, k), _take_v(wv, nxt)

    ra1, ra2 = gather_face(wva, ca, ka)
    rb1, rb2 = gather_face(wvb, cb, kb)
    ref_v1 = torch.where(ub, rb1, ra1)
    ref_v2 = torch.where(ub, rb2, ra2)
    ref_n = torch.where(ub, _take_v(nb, kb), _take_v(na, ka))

    uv = use_b[..., None, None]
    inc_wv = torch.where(uv, wva, wvb)
    inc_normals = torch.where(uv, na, nb)
    inc_valid = torch.where(ub, eva, evb)
    inc_count = torch.where(use_b, ca, cb)

    # Incident face: most anti-parallel to the reference normal.
    align = torch.sum(inc_normals * ref_n[..., None, :], dim=-1)
    inf = torch.tensor(float("inf"), dtype=align.dtype, device=dev)
    ki = torch.argmin(torch.where(inc_valid, align, inf), dim=-1)
    inc_v1, inc_v2 = gather_face(inc_wv, inc_count, ki)

    # Clip the incident segment parametrically against the two side planes.
    D = inc_v2 - inc_v1
    ref_t = ref_v2 - ref_v1
    ref_t = ref_t / torch.sqrt(torch.sum(ref_t * ref_t, dim=-1)
                               + _TINY)[..., None]
    dot = lambda x, y: torch.sum(x * y, dim=-1)
    lo1, hi1 = _halfplane_interval(dot(ref_t, inc_v1 - ref_v1), dot(ref_t, D))
    lo2, hi2 = _halfplane_interval(dot(-ref_t, inc_v1 - ref_v2),
                                   dot(-ref_t, D))
    t0, t1 = _clip_params(lo1, hi1, lo2, hi2)
    seg_ok = t0 <= t1

    pts = inc_v1[..., None, :] + torch.stack([t0, t1], dim=-1)[..., None] \
        * D[..., None, :]
    pen = -torch.sum((pts - ref_v1[..., None, :]) * ref_n[..., None, :],
                     dim=-1)
    pt_valid = seg_ok[..., None] & (pen > -margin[..., None])

    # Surface points: the clipped point lies on the incident hull; its
    # projection onto the reference face on the reference hull.
    pts_ref = pts + pen[..., None] * ref_n[..., None, :]
    pts_a = torch.where(uv, pts, pts_ref)
    pts_b = torch.where(uv, pts_ref, pts)
    normal = torch.where(ub, ref_n, -ref_n)      # from b toward a
    ra = pts_a - pos_a[..., None, :]
    rb = pts_b - pos_b[..., None, :]
    # A pair separated beyond the margin produces no points even if
    # clipping found interval overlap.
    pt_valid = pt_valid & (sep <= margin)[..., None]
    return normal, ra, rb, pen, pt_valid


# ---------------------------------------------------------------------------
# The pipeline's hull/hull narrowphase: pair axis last, x and y apart.
# ---------------------------------------------------------------------------

def _soa_edges(x, y, c):
    """Edge data of padded CCW polygons: x, y (..., V, P) vertex
    coordinates, c (..., P) true counts.  Returns (x2, y2, nx, ny, ev):
    next-vertex coordinates, unit outward normals and edge validity, all
    (..., V, P)."""
    V = x.shape[-2]
    k = torch.arange(V, device=x.device)[:, None]
    c = c[..., None, :]
    has_next = k + 1 < c
    x2 = torch.where(has_next, torch.roll(x, -1, dims=-2), x[..., :1, :])
    y2 = torch.where(has_next, torch.roll(y, -1, dims=-2), y[..., :1, :])
    ex, ey = x2 - x, y2 - y
    inv = 1.0 / torch.sqrt(ex * ex + ey * ey + _TINY)
    # left_orthogonal(e) = (ey, -ex); CCW -> outward
    return x2, y2, ey * inv, -ex * inv, (k < c).expand(x.shape)


def _soa_face_separation(nx, ny, fx, fy, ev, ox, oy, oc):
    """Min signed distance of the other hull's valid vertices to each face.

    nx, ny, fx, fy, ev: (..., V, P) face normals, face base vertices and
    validity of the reference hull; ox, oy: (..., V, P) other-hull
    vertices; oc: (..., P) other-hull counts.  Returns (..., V, P)
    separations (-inf on invalid faces)."""
    V = ox.shape[-2]
    d = (nx[..., :, None, :] * (ox[..., None, :, :] - fx[..., :, None, :])
         + ny[..., :, None, :] * (oy[..., None, :, :] - fy[..., :, None, :]))
    j_ok = torch.arange(V, device=ox.device)[:, None] < oc[..., None, :]
    inf = torch.tensor(float("inf"), dtype=d.dtype, device=d.device)
    sep = torch.amin(torch.where(j_ok[..., None, :, :], d, inf), dim=-2)
    return torch.where(ev, sep, -inf)


def _soa_hulls(wv, counts_t, ia, ib):
    """(ax, ay, bx, by) (B, V, P) world vertices and (ca, cb) counts of the
    pairs' two hulls."""
    wva, wvb = _pick(wv, ia), _pick(wv, ib)        # (B, P, V, 2)
    T = lambda a: a.transpose(-1, -2)
    return (T(wva[..., 0]), T(wva[..., 1]), T(wvb[..., 0]), T(wvb[..., 1]),
            counts_t[ia], counts_t[ib])


def hull_hull_pairs(wv, counts_t, pos, ia, ib, margin_p):
    """Hull/hull narrowphase over a pair axis.

    wv (B, N, V, 2) world vertices, counts_t (N,) int64 tensor, pos (B, N, 2)
    body coms; ia, ib body indices, (P,) for every world or (B, P) per
    world; margin_p (B, P) speculative activation band.  Returns, pair axis
    last: normal (nx, ny) (B, P), contact offsets (rax, ray, rbx, rby),
    depth and validity, each (B, 2, P) — the same <=2-point shared-normal
    manifolds as :func:`hull_hull`."""
    ax, ay, bx, by, ca, cb = _soa_hulls(wv, counts_t, ia, ib)
    pos_a, pos_b = _pick(pos, ia), _pick(pos, ib)  # (B, P, 2)

    ax2, ay2, nax, nay, eva = _soa_edges(ax, ay, ca)
    bx2, by2, nbx, nby, evb = _soa_edges(bx, by, cb)

    sep_a_k = _soa_face_separation(nax, nay, ax, ay, eva, bx, by, cb)
    sep_b_k = _soa_face_separation(nbx, nby, bx, by, evb, ax, ay, ca)
    sep_a = torch.amax(sep_a_k, dim=-2)
    sep_b = torch.amax(sep_b_k, dim=-2)
    ka = torch.argmax(sep_a_k, dim=-2)
    kb = torch.argmax(sep_b_k, dim=-2)

    # Box2D-style preference for hull A (coherence under near-ties).
    use_b = sep_b > 0.98 * sep_a + 1e-6
    sep = torch.where(use_b, sep_b, sep_a)

    # Reference face, then the a/b select.
    ra1x, ra1y, ra2x, ra2y, ranx, rany = (
        _gather_last2(a, ka) for a in (ax, ay, ax2, ay2, nax, nay))
    rb1x, rb1y, rb2x, rb2y, rbnx, rbny = (
        _gather_last2(a, kb) for a in (bx, by, bx2, by2, nbx, nby))
    ref_v1x = torch.where(use_b, rb1x, ra1x)
    ref_v1y = torch.where(use_b, rb1y, ra1y)
    ref_v2x = torch.where(use_b, rb2x, ra2x)
    ref_v2y = torch.where(use_b, rb2y, ra2y)
    ref_nx = torch.where(use_b, rbnx, ranx)
    ref_ny = torch.where(use_b, rbny, rany)

    # Incident hull = the other one; its face most anti-parallel to ref_n.
    ub = use_b[..., None, :]
    inc_x = torch.where(ub, ax, bx)
    inc_y = torch.where(ub, ay, by)
    inc_x2 = torch.where(ub, ax2, bx2)
    inc_y2 = torch.where(ub, ay2, by2)
    align = (torch.where(ub, nax, nbx) * ref_nx[..., None, :]
             + torch.where(ub, nay, nby) * ref_ny[..., None, :])
    inc_valid = torch.where(ub, eva, evb)
    inf = torch.tensor(float("inf"), dtype=align.dtype, device=align.device)
    ki = torch.argmin(torch.where(inc_valid, align, inf), dim=-2)
    inc_v1x, inc_v1y, inc_v2x, inc_v2y = (
        _gather_last2(a, ki) for a in (inc_x, inc_y, inc_x2, inc_y2))

    # Clip the incident segment parametrically against the two side planes.
    Dx, Dy = inc_v2x - inc_v1x, inc_v2y - inc_v1y
    rtx, rty = ref_v2x - ref_v1x, ref_v2y - ref_v1y
    rinv = 1.0 / torch.sqrt(rtx * rtx + rty * rty + _TINY)
    rtx, rty = rtx * rinv, rty * rinv
    lo1, hi1 = _halfplane_interval(rtx * (inc_v1x - ref_v1x)
                                   + rty * (inc_v1y - ref_v1y),
                                   rtx * Dx + rty * Dy)
    lo2, hi2 = _halfplane_interval(-rtx * (inc_v1x - ref_v2x)
                                   - rty * (inc_v1y - ref_v2y),
                                   -rtx * Dx - rty * Dy)
    t0, t1 = _clip_params(lo1, hi1, lo2, hi2)
    seg_ok = t0 <= t1

    ts = torch.stack([t0, t1], dim=-2)                       # (B, 2, P)
    row = lambda a: a[..., None, :]
    ptx = row(inc_v1x) + ts * row(Dx)
    pty = row(inc_v1y) + ts * row(Dy)
    pen = -((ptx - row(ref_v1x)) * row(ref_nx)
            + (pty - row(ref_v1y)) * row(ref_ny))            # (B, 2, P)
    pt_valid = row(seg_ok) & (pen > -row(margin_p))

    # Surface points: clipped point on the incident hull; its projection
    # onto the reference face for the reference hull.
    prx = ptx + pen * row(ref_nx)
    pry = pty + pen * row(ref_ny)
    pax = torch.where(ub, ptx, prx)
    pay = torch.where(ub, pty, pry)
    pbx = torch.where(ub, prx, ptx)
    pby = torch.where(ub, pry, pty)
    nrm_x = torch.where(use_b, ref_nx, -ref_nx)              # from b toward a
    nrm_y = torch.where(use_b, ref_ny, -ref_ny)

    pt_valid = pt_valid & row(sep <= margin_p)
    rax = pax - row(pos_a[..., 0])
    ray = pay - row(pos_a[..., 1])
    rbx = pbx - row(pos_b[..., 0])
    rby = pby - row(pos_b[..., 1])
    return (nrm_x, nrm_y, rax, ray, rbx, rby, pen, pt_valid)


def hull_hull_sat_depths(wv, counts_t, ia, ib):
    """SAT penetration depths (B, P) of hull pairs (positive = overlap):
    the depth-only path ``max_penetration`` takes."""
    ax, ay, bx, by, ca, cb = _soa_hulls(wv, counts_t, ia, ib)
    _, _, nax, nay, eva = _soa_edges(ax, ay, ca)
    _, _, nbx, nby, evb = _soa_edges(bx, by, cb)
    sep_a = torch.amax(_soa_face_separation(nax, nay, ax, ay, eva, bx, by,
                                            cb), dim=-2)
    sep_b = torch.amax(_soa_face_separation(nbx, nby, bx, by, evb, ax, ay,
                                            ca), dim=-2)
    return -torch.maximum(sep_a, sep_b)


# ---------------------------------------------------------------------------
# Broadphase and the full pipeline.
# ---------------------------------------------------------------------------

def aabbs(p, verts, radius, counts):
    """Axis-aligned bounding boxes (..., N, 2, 2): [[minx, miny], [maxx, maxy]]."""
    wv = world_vertices(verts, p)
    vert_valid = torch.as_tensor(
        np.arange(verts.shape[-2])[None, :] < np.asarray(counts)[:, None],
        device=p.device)[..., None]
    inf = torch.tensor(float("inf"), dtype=p.dtype, device=p.device)
    vmax = torch.amax(torch.where(vert_valid, wv, -inf), dim=-2) \
        + radius[..., None]
    vmin = torch.amin(torch.where(vert_valid, wv, inf), dim=-2) \
        - radius[..., None]
    return torch.stack([vmin, vmax], dim=-2)


def _box_pairs(boxes, ia, ib):
    if ia.dim() == 1:
        return boxes[..., ia, :, :], boxes[..., ib, :, :]
    return _pick(boxes, ia), _pick(boxes, ib)


def aabb_overlap(boxes, ia, ib):
    """Pairwise AABB overlap (..., P) for index lists ia, ib: (P,) static
    or (B, P) per world."""
    a, b = _box_pairs(boxes, ia, ib)
    return torch.all((a[..., 0, :] <= b[..., 1, :])
                     & (b[..., 0, :] <= a[..., 1, :]), dim=-1)


def aabb_overlap_depth(boxes, ia, ib):
    """Smallest per-axis AABB overlap extent (..., P): > 0 iff the boxes
    overlap, and the score of the hull pair budget."""
    a, b = _box_pairs(boxes, ia, ib)
    ext = torch.minimum(a[..., 1, :], b[..., 1, :]) \
        - torch.maximum(a[..., 0, :], b[..., 0, :])
    return torch.amin(ext, dim=-1)


def split_pairs_by_kind(counts, allowed=None):
    """Static pair enumeration split by narrowphase kernel (NumPy; same
    result as the JAX package's function of the same name).  Returns a
    dict of (ia, ib) index arrays for 'cc', 'ch', 'hh' ('ch' lists the
    circle first)."""
    counts = np.asarray(counts)
    N = counts.shape[0]
    iu, ju = np.triu_indices(N, k=1)
    if allowed is not None:
        keep = np.asarray(allowed)[iu, ju]
        iu, ju = iu[keep], ju[keep]
    is_c = counts == 1
    cc = is_c[iu] & is_c[ju]
    hh = (~is_c[iu]) & (~is_c[ju])
    ch = is_c[iu] & (~is_c[ju])
    hc = (~is_c[iu]) & is_c[ju]
    return {
        "cc": (iu[cc], ju[cc]),
        "ch": (np.concatenate([iu[ch], ju[hc]]),
               np.concatenate([ju[ch], iu[hc]])),
        "hh": (iu[hh], ju[hh]),
    }


def _on(pair, device):
    """A static (ia, ib) pair list as index tensors on ``device``."""
    return tuple(torch.as_tensor(x, dtype=torch.int64, device=device)
                 for x in pair)


def _inflate(boxes, margin):
    if margin is None:
        return boxes
    return boxes + torch.stack([-margin, margin], dim=-1)[..., None]


def any_aabb_overlap(p, verts, radius, counts, pairs, margin=None):
    """(B,) bool: does ANY allowed pair's (margin-inflated) AABB overlap?
    False proves the world contact-free, speculative activations included."""
    boxes = _inflate(aabbs(p, verts, radius, counts), margin)
    hit = torch.zeros(p.shape[:-2], dtype=torch.bool, device=p.device)
    for key in ("cc", "ch", "hh"):
        ia, ib = _on(pairs[key], p.device)
        if len(ia):
            hit = hit | torch.any(aabb_overlap(boxes, ia, ib), dim=-1)
    return hit


def _hull_rows(wv, counts_t, pos, boxes, margin, ii, jj, hull_budget):
    """The hull/hull pairs' contact rows (normal, ra, rb, depth, ia, ib,
    valid), each (B, 2P, ...): the pair AABB gate, :func:`hull_hull_pairs`
    and its 2-point manifolds as single-contact rows sharing the normal,
    pair-major.  ``hull_budget`` as in :func:`find_contacts`."""
    B = wv.shape[0]
    if 0 < hull_budget < len(ii):
        # Rank every static pair by AABB-overlap extent and run the
        # hull/hull kernel on each world's hull_budget best.
        score = aabb_overlap_depth(boxes, ii, jj)
        sel = torch.sort(score, dim=-1, descending=True,
                         stable=True).indices[:, :hull_budget]
        ii, jj = ii[sel], jj[sel]
    P = ii.shape[-1]
    ok = aabb_overlap(boxes, ii, jj)
    hh_m = (_pick(margin, ii) + _pick(margin, jj) if margin is not None
            else torch.zeros((B, P), dtype=wv.dtype, device=wv.device))
    nrm_x, nrm_y, rax, ray, rbx, rby, d2, v2 = hull_hull_pairs(
        wv, counts_t, pos, ii, jj, hh_m)
    # (B, 2, P) -> (B, 2P), pair-major
    rows = lambda a: a.transpose(-1, -2).reshape(B, 2 * P)
    xy = lambda x, y: torch.stack([rows(x), rows(y)], dim=-1)
    n2 = lambda a: a[:, None, :].expand(B, 2, P)
    return (xy(n2(nrm_x), n2(nrm_y)), xy(rax, ray), xy(rbx, rby), rows(d2),
            torch.repeat_interleave(ii, 2, dim=-1).expand(B, -1),
            torch.repeat_interleave(jj, 2, dim=-1).expand(B, -1),
            rows(v2 & ok[:, None, :]))


def _compact(c, c_max):
    """The ``c_max`` deepest valid rows of a contact buffer ``c`` of more
    rows.  A stable sort keeps equal depths in index order, as XLA's
    top_k does."""
    inf = torch.tensor(float("inf"), dtype=c.depth.dtype,
                       device=c.depth.device)
    score = torch.where(c.valid, c.depth, -inf)
    keep = torch.sort(score, dim=-1, descending=True,
                      stable=True).indices[:, :c_max]
    keep2 = keep[..., None].expand(-1, -1, 2)
    return Contacts(*(x.gather(1, keep2 if x.dim() == 3 else keep)
                      for x in c))


def find_contacts(p, verts, radius, counts, pairs, c_max, margin=None,
                  hull_budget=0):
    """Collision pipeline for a batch of worlds.

    p (B, N, 3); verts (N, V, 2) or (B, N, V, 2); radius (N,) or (B, N);
    counts and pairs static (host NumPy); margin optional (B, N)
    speculative-activation band: a pair is emitted while separated by up
    to ``margin[a] + margin[b]``.  ``hull_budget`` > 0, when the static
    hull/hull pair list is longer, sends only each world's
    ``hull_budget`` pairs of largest AABB-overlap extent to the hull/hull
    kernel (ties to the lower pair index); it is exact whenever it covers
    the overlapping pairs.  Returns a :class:`Contacts` buffer of exactly
    ``c_max`` slots; under overflow the ``c_max`` deepest valid contacts
    are kept, ties going to the lower row (XLA ``top_k`` order).
    """
    B = p.shape[0]
    dt, dev = p.dtype, p.device
    pos = p[..., 1:3]
    radius = radius.expand(B, p.shape[1])
    boxes = _inflate(aabbs(p, verts, radius, counts), margin)
    outs = []   # (normal, ra, rb, depth, ia, ib, valid), (B, rows, ...)

    def gate(ok, d, ia, ib):
        if margin is None:
            return ok & (d > 0.0)
        return ok & (d > -(_pick(margin, ia) + _pick(margin, ib)))

    cc_i, cc_j = _on(pairs["cc"], dev)
    if len(cc_i):
        n, ra, rb, d = circle_circle(pos[:, cc_i], radius[:, cc_i],
                                     pos[:, cc_j], radius[:, cc_j])
        ok = gate(aabb_overlap(boxes, cc_i, cc_j), d, cc_i, cc_j)
        outs.append((n, ra, rb, d, cc_i.expand(B, -1), cc_j.expand(B, -1),
                     ok))

    ch_i, ch_j = _on(pairs["ch"], dev)            # circle first, hull second
    if len(ch_i) or len(pairs["hh"][0]):
        wv = world_vertices(verts, p)             # (B, N, V, 2)
        counts_t = torch.as_tensor(np.asarray(counts), dtype=torch.int64,
                                   device=dev)
    if len(ch_i):
        n, r_c, cp_hull, d = circle_hull(pos[:, ch_i], radius[:, ch_i],
                                         wv[:, ch_j], counts_t[ch_j])
        ok = gate(aabb_overlap(boxes, ch_i, ch_j), d, ch_i, ch_j)
        # normal from hull toward circle == from b toward a, a the circle
        outs.append((n, r_c, cp_hull - pos[:, ch_j], d, ch_i.expand(B, -1),
                     ch_j.expand(B, -1), ok))

    ii, jj = _on(pairs["hh"], dev)
    if len(ii):
        with span("step.narrowphase.hull"):
            outs.append(_hull_rows(wv, counts_t, pos, boxes, margin, ii, jj,
                                   hull_budget))

    if not outs:
        z2 = torch.zeros((B, c_max, 2), dtype=dt, device=dev)
        zi = torch.zeros((B, c_max), dtype=torch.int64, device=dev)
        return Contacts(z2, z2, z2, torch.zeros((B, c_max), dtype=dt,
                                                device=dev),
                        zi, zi, torch.zeros((B, c_max), dtype=torch.bool,
                                            device=dev))
    normal, ra, rb, depth, ia, ib, valid = (
        torch.cat([o[k] for o in outs], dim=1) for k in range(7))

    total = normal.shape[1]
    if total <= c_max:
        pad = c_max - total
        pad2 = lambda x: torch.nn.functional.pad(x, (0, 0, 0, pad))
        pad1 = lambda x: torch.nn.functional.pad(x, (0, pad))
        return Contacts(pad2(normal), pad2(ra), pad2(rb), pad1(depth),
                        pad1(ia), pad1(ib), pad1(valid))

    with span("step.narrowphase.compact"):
        return _compact(Contacts(normal, ra, rb, depth, ia, ib, valid), c_max)


def max_penetration(p, verts, radius, counts, pairs):
    """(B,) deepest penetration of each world (0 when nothing overlaps):
    per-pair signed depths, SAT separations for hull pairs, reduced with a
    max; no contact buffer."""
    B = p.shape[0]
    dev = p.device
    radius = radius.expand(B, p.shape[1])
    best = torch.zeros(p.shape[:-2], dtype=p.dtype, device=dev)
    pos = p[..., 1:3]
    cc_i, cc_j = _on(pairs["cc"], dev)
    if len(cc_i):
        d = circle_circle(pos[:, cc_i], radius[:, cc_i],
                          pos[:, cc_j], radius[:, cc_j])[3]
        best = torch.maximum(best, torch.amax(d, dim=-1))
    ch_i, ch_j = _on(pairs["ch"], dev)
    hh_i, hh_j = _on(pairs["hh"], dev)
    if len(ch_i) or len(hh_i):
        wv = world_vertices(verts, p)
        counts_t = torch.as_tensor(np.asarray(counts), dtype=torch.int64,
                                   device=dev)
    if len(ch_i):
        d = circle_hull(pos[:, ch_i], radius[:, ch_i], wv[:, ch_j],
                        counts_t[ch_j])[3]
        best = torch.maximum(best, torch.amax(d, dim=-1))
    if len(hh_i):
        d = hull_hull_sat_depths(wv, counts_t, hh_i, hh_j)
        best = torch.maximum(best, torch.amax(d, dim=-1))
    return best
