"""World-batch parallelism: the batched step on one device and worlds
sharded over a mesh of devices (counterpart of
``lcp_physics_tpu/parallel``)."""

from lcp_physics_tpu_torch.parallel.batch import (WORLD_AXIS, Mesh,
                                                  batched_rollout, gather,
                                                  make_batched_step,
                                                  make_mesh,
                                                  make_sharded_step,
                                                  replicate, shard_worlds,
                                                  stack_states, tile_state)

__all__ = [
    "WORLD_AXIS", "Mesh", "batched_rollout", "gather", "make_batched_step",
    "make_mesh", "make_sharded_step", "replicate", "shard_worlds",
    "stack_states", "tile_state",
]
