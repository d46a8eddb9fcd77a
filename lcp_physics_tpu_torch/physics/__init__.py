"""The user-facing scene API (counterpart of ``lcp_physics_tpu/physics``):
bodies, constraints, forces, contact handlers, the engine and ``World``.

``Defaults.ENGINE`` / ``Defaults.CONTACT`` are lazy class properties on
``Defaults`` (``utils._DefaultsMeta``) resolving to ``PdipmEngine`` /
``DiffContactHandler``."""

from lcp_physics_tpu_torch.physics.bodies import Body, Circle, Hull, Rect
from lcp_physics_tpu_torch.physics.constraints import (Constraint,
                                                       FixedJoint, Joint,
                                                       RotConstraint,
                                                       TotalConstraint,
                                                       XConstraint,
                                                       YConstraint)
from lcp_physics_tpu_torch.physics.contacts import (ContactHandler,
                                                    DiffContactHandler,
                                                    OdeContactHandler)
from lcp_physics_tpu_torch.physics.engines import Engine, PdipmEngine
from lcp_physics_tpu_torch.physics.forces import (ExternalForce, down_force,
                                                  gravity, hor_impulse,
                                                  rot_impulse, vert_impulse)
from lcp_physics_tpu_torch.physics.utils import (Defaults, Indices, Recorder,
                                                 SimConfig, cart_to_polar,
                                                 cross_2d, get_tensor,
                                                 left_orthogonal, plot,
                                                 polar_to_cart,
                                                 rotation_matrix)
from lcp_physics_tpu_torch.physics.world import World, run_world

__all__ = [
    "Body", "Circle", "Hull", "Rect", "Constraint", "FixedJoint", "Joint",
    "RotConstraint", "TotalConstraint", "XConstraint", "YConstraint",
    "ContactHandler", "DiffContactHandler", "OdeContactHandler", "Engine",
    "PdipmEngine", "ExternalForce", "down_force", "gravity", "hor_impulse",
    "rot_impulse", "vert_impulse", "Defaults", "Indices", "Recorder",
    "SimConfig", "cart_to_polar", "cross_2d", "get_tensor",
    "left_orthogonal", "plot", "polar_to_cart", "rotation_matrix", "World",
    "run_world",
]
