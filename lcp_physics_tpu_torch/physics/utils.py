"""The reference keeps its helpers in ``lcp_physics/physics/utils.py``; the
port's live in ``lcp_physics_tpu_torch.utils`` (shared with the functional
core without import cycles) and are re-exported here, as in the JAX
package."""

from lcp_physics_tpu_torch.utils import (Defaults, Indices, Recorder,
                                         SimConfig, cart_to_polar, cross_2d,
                                         get_tensor, left_orthogonal,
                                         orthogonal_tangents, perp_2d, plot,
                                         polar_to_cart, polygon_centroid,
                                         polygon_inertia, rotate,
                                         rotation_matrix)

__all__ = [
    "Defaults", "Indices", "Recorder", "SimConfig", "cart_to_polar",
    "cross_2d", "get_tensor", "left_orthogonal", "orthogonal_tangents",
    "perp_2d", "plot", "polar_to_cart", "polygon_centroid",
    "polygon_inertia", "rotate", "rotation_matrix",
]
