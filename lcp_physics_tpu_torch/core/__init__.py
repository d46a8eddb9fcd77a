"""State, narrowphase, Jacobians and the batched step (counterpart of
``lcp_physics_tpu/core``)."""

from lcp_physics_tpu_torch.core.geometry import (Contacts, find_contacts,
                                                 max_penetration,
                                                 split_pairs_by_kind,
                                                 world_vertices)
from lcp_physics_tpu_torch.core.jacobians import (assemble_contact_jacobians,
                                                  assemble_Je,
                                                  constraint_position_error)
from lcp_physics_tpu_torch.core.state import (JointSpec, SceneParams,
                                              SceneStatic, WorldState,
                                              default_params,
                                              make_scene_static,
                                              params_from_numpy,
                                              state_from_numpy)
from lcp_physics_tpu_torch.core.step import (RolloutDiagnostics,
                                             StepDiagnostics,
                                             generalized_mass, make_assemble,
                                             make_step, make_step_batched,
                                             rollout, total_force)

__all__ = [
    "Contacts", "find_contacts", "max_penetration", "split_pairs_by_kind",
    "world_vertices", "assemble_contact_jacobians", "assemble_Je",
    "constraint_position_error", "JointSpec", "SceneParams", "SceneStatic",
    "WorldState", "default_params", "make_scene_static", "params_from_numpy",
    "state_from_numpy", "StepDiagnostics", "RolloutDiagnostics",
    "generalized_mass", "make_assemble", "make_step", "make_step_batched",
    "rollout", "total_force",
]
