"""The system under test, built from a configuration file: the port's
scene description, parameters and batched step, and its counters.

This is the only module of the harness that imports
``lcp_physics_tpu_torch``; the shapes (``shapes/<shape>.py``) and loops
take the port from here, and the reference never does.
"""
from __future__ import annotations

import dataclasses

import torch

from benchmark.harness import spec
from lcp_physics_tpu_torch.core import (JointSpec, WorldState,
                                        default_params, make_scene_static,
                                        rollout)
from lcp_physics_tpu_torch.core import step as step_mod
from lcp_physics_tpu_torch.lcp import lcp_solve, lcp_solve_full, pdipm
from lcp_physics_tpu_torch.lcp.cone import ConeF
from lcp_physics_tpu_torch.ops import ipm, ipm_iter, linalg
from lcp_physics_tpu_torch.parallel import make_batched_step
from lcp_physics_tpu_torch.utils import SimConfig

__all__ = ["WorldState", "rollout", "lcp_solve", "lcp_solve_full", "ConeF",
           "make_scene_static", "default_params", "scene", "joints",
           "sim_config", "batched_step", "batch_params", "build",
           "counters"]

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def scene(config, device):
    """(static, params) of the configuration's worlds, built by the module
    of its body shape, ``shapes/<shape>.py``."""
    return spec.plugin("shapes", config["shape"]).scene(config, device)


def joints(config):
    """The port's ``JointSpec`` of each entry of the configuration's
    ``joints`` (none where it has no such key), for
    ``make_scene_static(joints=...)``; ``reference/joints.py`` builds the
    reference's rows from the same entries."""
    return tuple(JointSpec(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in entry.items()})
                 for entry in config.get("joints", ()))


def sim_config(config):
    return SimConfig(**config["sim_config"])


def batched_step(static, config, params_batched=False):
    """The port's batched step under the configuration's ``SimConfig``."""
    return make_batched_step(static, sim_config(config), params_batched)


def batch_params(params, B):
    """Shared parameters as per-world ones (a leading batch axis on every
    tensor field), for ``params_batched=True``."""
    return dataclasses.replace(params, **{
        f.name: getattr(params, f.name).expand(
            (B,) + tuple(getattr(params, f.name).shape)).clone()
        for f in dataclasses.fields(params) if f.name != "force_params"})


def build():
    """Build (where not built yet) and load every CUDA library of the
    port at once, one nvcc per source in parallel."""
    from lcp_physics_tpu_torch.ops import _build
    return _build.load_all()


def counters():
    """The port's counters now: host reads (step gates, the IPM loop) and
    launches of its own kernels, one flat dict."""
    out = {f"host_reads.{k}": v for k, v in step_mod.HOST_READS.items()}
    out.update({f"host_reads.{k}": v for k, v in pdipm.HOST_READS.items()})
    for mod in (linalg, ipm, ipm_iter):
        out.update({f"launches.{k}": v for k, v in mod.LAUNCHES.items()})
    return out
