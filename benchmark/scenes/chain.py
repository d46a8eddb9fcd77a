"""A chain and rain on it (``bench.py::build_joint_scene``, drawn per
world): the configuration's first ``links`` bodies laid out at rest along
its joints from the world anchor, the other bodies in a grid of
``rain_cols`` columns at ``spacing``, its first rank's centres ``drop``
above the links' centres (gravity is +y), each rain centre jittered by
uniform(-``jitter``, ``jitter``) per world and body, falling at ``fall``
on top of the generator's normal(0, ``vel_std``) draw."""
import numpy as np


def links(config):
    """The links' centres (links, 2) at angle 0: the world joint's body
    with its anchor at the joint's ``ref``, each next body where the
    joint from the one before puts it (joints listed along the chain)."""
    centres = np.zeros((config["links"], 2))
    for j in config["joints"]:
        if j["kind"] != "joint":
            continue
        l1 = np.asarray(j.get("local1", (0.0, 0.0)))
        l2 = np.asarray(j.get("local2", (0.0, 0.0)))
        if j.get("body2", -1) < 0:
            centres[j["body1"]] = np.asarray(j.get("ref", (0, 0, 0))[1:]) - l1
        else:
            centres[j["body2"]] = centres[j["body1"]] + l1 - l2
    return centres


def positions(scene, shape, rng, config):
    """Centres (shape + (2,)) of ``shape`` = (batches, B, N) bodies: the
    chain, then the rain (one uniform draw, the rain's jitter)."""
    L = config["links"]
    k = np.arange(shape[-1] - L)
    cols, gap = scene["rain_cols"], scene["spacing"]
    rain = np.stack([(k % cols) * gap, -scene["drop"] - (k // cols) * gap],
                    -1)
    j = scene["jitter"]
    rain = rain + rng.uniform(-j, j, tuple(shape[:2]) + rain.shape)
    chain = np.broadcast_to(links(config), tuple(shape[:2]) + (L, 2))
    return np.concatenate([chain, rain], -2)


def velocities(scene, v, config):
    """The links at rest; the rain falls at ``fall`` more in +y."""
    L = config["links"]
    v = v.copy()
    v[..., :L, :] = 0.0
    v[..., L:, 2] += scene["fall"]
    return v


def tiny(scene):
    """The tests' CPU size: the rain in two columns."""
    return dict(scene, rain_cols=2)
