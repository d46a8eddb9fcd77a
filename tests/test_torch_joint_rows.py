"""The joints' equality rows from per-scene tables
(``core/jacobians.py::assemble_Je`` and ``constraint_position_error``)
against the per-spec loop the port first ran
(``torch_inputs.loop_joint_rows``, ``loop_position_error``): the rows,
the position error and p's gradient through each, bit for bit, at float64
and float32, on a joint list with every kind and on the benchmark's
``chain16`` list (whose first link's angle takes three terms of the
error: p's gradient through the error there sums them in another order)."""
import numpy as np
import pytest
import torch

from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import (chain16_joints, every_joint_kind,
                          joint_rows_against_loop, sum_order_close)

SCENES = {"every_kind": every_joint_kind, "chain16": chain16_joints}


@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_joint_rows_equal_the_per_spec_loop(dtype, B, scene):
    static, p0 = SCENES[scene]()
    more = np.random.default_rng(B).uniform(-4.0, 4.0,
                                            (B - 1, *p0.shape[1:]))
    p0 = torch.as_tensor(np.concatenate([p0, more]), dtype=dtype)
    for name, got, want in joint_rows_against_loop(static, p0):
        assert got.dtype == dtype, name
        if scene == "chain16" and name == "error grad":
            assert sum_order_close(got, want), name
        else:
            assert torch.equal(got, want), name
