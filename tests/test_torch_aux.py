"""The port's host-side pieces of the object layer, as tests/test_aux.py and
tests/test_native.py hold the JAX package's: checkpoints of the port's
dataclasses (round trip, resume, a mismatched structure raising), the lazy
``Defaults.ENGINE``/``CONTACT``, the force profiles (working dtype, batched
times), a constraint's ``J`` against the assembled rows, the 2D helpers
against the JAX package's, and the sweep-and-prune broadphase (its C++
path) against the NumPy all-pairs version."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcp_physics_tpu import utils as jutils
from lcp_physics_tpu_torch import native, utils
from lcp_physics_tpu_torch.core import (WorldState, default_params,
                                        make_scene_static, make_step,
                                        rollout)
from lcp_physics_tpu_torch.utils.checkpoint import (load_pytree, load_world,
                                                    save_pytree, save_world)

F64 = dict(dtype=torch.float64, device="cpu")


def box_ground():
    """tests/test_step.py::box_ground_world's scene: a unit-radius ball
    over a held ground slab."""
    from lcp_physics_tpu_torch.core import JointSpec
    verts = np.zeros((2, 4, 2))
    verts[1] = [[-50, -1], [50, -1], [50, 1], [-50, 1]]
    static = make_scene_static([1, 4], joints=(JointSpec(
        kind="total", body1=1, ref=(0.0, 0.0, 0.0)),))
    params = default_params(static, verts=verts, radius=[1.0, 0.0],
                            gravity=(0.0, 10.0), restitution=0.5, **F64)
    return static, params


def test_checkpoint_roundtrip_and_resume(tmp_path):
    static, params = box_ground()
    s0 = WorldState(torch.tensor([[0., 0., -3.], [0., 0., 0.]], **F64),
                    torch.zeros(2, 3, **F64), torch.zeros((), **F64))
    step = make_step(static)
    mid, _ = rollout(step, params, s0, 0.01, 30)
    path = os.path.join(tmp_path, "ckpt.npz")
    save_world(path, mid, params)
    mid2, params2 = load_world(path, mid, params)
    assert torch.equal(mid.p, mid2.p) and torch.equal(params.mass,
                                                      params2.mass)
    assert mid2.p.dtype == torch.float64
    a, _ = rollout(step, params, mid, 0.01, 10)
    b, _ = rollout(step, params2, mid2, 0.01, 10)
    assert torch.equal(a.p, b.p)


def test_checkpoint_generic_tree_and_mismatch(tmp_path):
    tree = {"a": torch.arange(5.0), "b": (np.ones((2, 2)), 3), "c": None}
    path = os.path.join(tmp_path, "tree.npz")
    save_pytree(path, tree)
    out = load_pytree(path, tree)
    assert torch.equal(out["a"], torch.arange(5.0))
    assert int(out["b"][1]) == 3 and out["c"] is None
    other = {"a": torch.ones(2), "d": torch.zeros(3)}
    with pytest.raises(ValueError, match="treedef mismatch"):
        load_pytree(path, other)
    s = WorldState(torch.zeros(2, 3), torch.zeros(2, 3), torch.zeros(()))
    save_world(path, s)
    with pytest.raises(ValueError, match="treedef mismatch"):
        load_world(path, s, box_ground()[1])


def test_defaults_engine_contact_populated():
    from lcp_physics_tpu_torch.physics import Defaults
    from lcp_physics_tpu_torch.physics.contacts import DiffContactHandler
    from lcp_physics_tpu_torch.physics.engines import PdipmEngine

    assert Defaults.ENGINE is PdipmEngine
    assert Defaults.CONTACT is DiffContactHandler


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_force_profiles_keep_dtype_and_batch(dtype):
    """No hardcoded dtype in the profiles; a (B,) time gives (B, 3)."""
    from lcp_physics_tpu_torch.physics import (gravity, hor_impulse,
                                               rot_impulse, vert_impulse)
    t = torch.tensor([0.05, 0.2], dtype=dtype)
    for f, axis in ((hor_impulse, 1), (vert_impulse, 2), (rot_impulse, 0)):
        out = f(t)
        assert out.dtype == dtype and out.shape == (2, 3)
        assert out[0, axis] == 1.0 and float(out[1].abs().sum()) == 0.0
        assert f(torch.tensor(0.05, dtype=dtype)).shape == (3,)
    assert gravity(t).shape == (2, 3) and gravity(0.3).dtype == torch.float64


def test_constraint_J_matches_assembled_rows_and_jax():
    """constraint.J() blocks equal the world's assembled Je rows, and the
    JAX package's J() of the same constraints."""
    import lcp_physics_tpu.physics as jphys
    import lcp_physics_tpu_torch.physics as tphys
    Js = []
    for ph in (jphys, tphys):
        b1 = ph.Circle([10.0, 0.0], rad=0.5)
        b2 = ph.Circle([20.0, 0.0], rad=0.5)
        b1.set_p([0.3, 10.0, 0.0])
        j = ph.Joint(b1, b2, [15.0, 0.0])
        xc = ph.XConstraint(b1)
        kw = F64 if ph is tphys else {}
        w = ph.World([b1, b2], [j, xc], **kw)
        Je = np.asarray(w.Je())
        J1, J2 = j.J()
        np.testing.assert_allclose(np.asarray(J1), Je[0:2, 0:3], atol=1e-12)
        np.testing.assert_allclose(np.asarray(J2), Je[0:2, 3:6], atol=1e-12)
        Jx, Jx2 = xc.J()
        assert Jx2 is None
        np.testing.assert_allclose(np.asarray(Jx), Je[2:3, 0:3], atol=1e-12)
        Js.append(Je)
    np.testing.assert_allclose(Js[1], Js[0], atol=1e-12)


def test_2d_helpers_match_jax():
    rng = np.random.default_rng(0)
    th = rng.uniform(-4, 4, (3, 2))
    v = rng.normal(size=(3, 2, 2))
    np.testing.assert_allclose(utils.rotation_matrix(torch.tensor(th))
                               .numpy(),
                               np.asarray(jutils.rotation_matrix(
                                   jnp.asarray(th))), atol=1e-15)
    for pos in (True, False):
        for a, b in zip(utils.cart_to_polar(torch.tensor(v), pos),
                        jutils.cart_to_polar(jnp.asarray(v), pos)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-15)
    r, t = rng.uniform(0, 2, 4), rng.uniform(-4, 4, 4)
    np.testing.assert_allclose(
        utils.polar_to_cart(torch.tensor(r), torch.tensor(t)).numpy(),
        np.asarray(jutils.polar_to_cart(jnp.asarray(r), jnp.asarray(t))),
        atol=1e-15)
    poly = np.array([[0, 0], [2, 0], [2.5, 1.5], [0.5, 2]], float)
    np.testing.assert_allclose(
        utils.polygon_centroid(torch.tensor(poly)).numpy(),
        np.asarray(jutils.polygon_centroid(jnp.asarray(poly))), atol=1e-15)
    x = utils.get_tensor([1.0, 2.0])
    assert x.dtype == torch.float64 and x.device.type == "cpu"
    assert utils.get_tensor(torch.ones(2, dtype=torch.float32)).dtype == \
        torch.float32


def random_aabbs(n, rng, extent=100.0, size=3.0):
    lo = rng.uniform(0, extent, (n, 2)).astype(np.float32)
    hi = lo + rng.uniform(0.1, size, (n, 2)).astype(np.float32)
    return np.concatenate([lo, hi], axis=-1)


def test_sap_pairs_matches_numpy_and_runs_cpp():
    """tests/test_native.py's cases on the port's copy: random boxes, a
    mask, the capacity retry, no overlaps; the C++ path ran (g++ is
    present)."""
    rng = np.random.default_rng(0)
    for n in (2, 17, 200, 1000):
        aabbs = random_aabbs(n, rng)
        np.testing.assert_array_equal(native.sap_pairs(aabbs),
                                      native._sap_pairs_numpy(aabbs))
    assert native.LAST_PATH == "cpp", native.BUILD_ERROR
    aabbs = random_aabbs(100, rng)
    mask = rng.uniform(size=100) < 0.5
    np.testing.assert_array_equal(native.sap_pairs(aabbs, mask=mask),
                                  native._sap_pairs_numpy(aabbs, mask=mask))
    n = 64
    full = np.tile(np.array([[0, 0, 1, 1]], np.float32), (n, 1))
    assert native.sap_pairs(full, cap=8).shape == (n * (n - 1) // 2, 2)
    far = np.array([[0, 0, 1, 1], [5, 5, 6, 6]], np.float32)
    assert native.sap_pairs(far).shape == (0, 2)
