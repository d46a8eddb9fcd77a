"""Contact handlers (counterpart of ``lcp_physics_tpu/physics/contacts.py``).

One narrowphase serves both: ``DiffContactHandler`` exposes
``core.geometry.find_contacts`` as it is (differentiable contact
geometry); ``OdeContactHandler`` keeps the reference's semantics of contact
geometry from a C library by detaching it, so gradients still flow through
the dynamics but not through normals, offsets and depths.  ``find`` takes
a batch of worlds (p (B, N, 3)).
"""
from __future__ import annotations

from lcp_physics_tpu_torch.core.geometry import find_contacts


class ContactHandler:
    diff = True

    def find(self, p, verts, radius, counts, pairs, c_max, margin=None):
        raise NotImplementedError


class DiffContactHandler(ContactHandler):
    """Differentiable contact generation (the default)."""

    diff = True

    def find(self, p, verts, radius, counts, pairs, c_max, margin=None):
        return find_contacts(p, verts, radius, counts, pairs, c_max,
                             margin=margin)


class OdeContactHandler(ContactHandler):
    """Contact geometry treated as data (no gradients)."""

    diff = False

    def find(self, p, verts, radius, counts, pairs, c_max, margin=None):
        cts = find_contacts(p, verts, radius, counts, pairs, c_max,
                            margin=margin)
        return type(cts)(*(x.detach() for x in cts))
