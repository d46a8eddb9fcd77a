"""What every loop shares: the precisions the check runs at, the
reservoir that samples the window's calls, and the check itself.

A loop (``loops/<name>.py``, found by the name a traffic file's ``loop``
gives) is a class ``Loop(cell, seed, device)`` with ``unit`` (what its
rate counts), ``numbers`` (the names of its checked numbers, the keys of
the cell's limits) and ``steps_per_call``, and the methods ``setup()``,
``call()`` (one call of the window; returns the units it did),
``evidence()`` (what the window left for the check, on the host),
``free()``, ``reference(evidence, precision)`` and
``compare(evidence, reference)``.  ``precision`` is ``"reference"``
(float64) or ``"control"`` (float32 with TF32 products, data and results
rounded to bfloat16): the control stands in for the program to show that
the comparison fails a lower precision.
"""
from __future__ import annotations

import dataclasses
import statistics

import numpy as np
import torch

from benchmark.harness import program


@dataclasses.dataclass
class Precision:
    dtype: torch.dtype
    tf32: bool
    data: torch.dtype | None     # data and results rounded through it


PRECISIONS = {"reference": Precision(torch.float64, False, None),
              "control": Precision(torch.float32, True, torch.bfloat16)}


class Tf32:
    """TF32 products on or off inside the block, restored after."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        self.was = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.was


def cast(x, prec):
    """x at the precision's dtype, through its data type if it has one."""
    if prec.data is not None:
        x = x.to(prec.data)
    return x.to(prec.dtype)


def result(x, prec):
    """A reference result as the program's results are compared: float64,
    rounded through the precision's data type first."""
    if prec.data is not None:
        x = x.to(prec.data)
    return x.to(torch.float64)


class Reservoir:
    """A uniform sample of ``size`` of the calls offered, drawn from the
    seed as they come (reservoir sampling): the window keeps only the
    sampled calls' results alive, so its memory stays flat and the
    allocator never grows inside it."""

    def __init__(self, size, seed):
        self.size = size
        self.rng = np.random.default_rng([seed, 2])
        self.kept = []
        self.seen = 0

    def offer(self, item):
        if self.seen < self.size:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.kept[j] = item
        self.seen += 1


def sample_worlds(seed, n_calls, worlds, B):
    """``worlds`` distinct world indices for each of ``n_calls`` sampled
    calls, drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    return [np.sort(rng.choice(B, size=worlds, replace=False)).tolist()
            for _ in range(n_calls)]


def median(xs):
    return float(statistics.median(xs))


def solver(conf):
    """The LCP settings of a world configuration's ``sim_config``, with
    the solver's constants of the configuration's dtype."""
    sim = conf["sim_config"]
    return dict(max_iter=sim["max_iter"], tol=sim["solver_eps"],
                stall_lim=sim.get("solver_stall_lim", 1),
                solver_dtype=program.DTYPES[conf["dtype"]])


def median_gap(a, b):
    """The median over worlds of |a - b| against the larger of b and the
    median world's b (a and b: one non-negative value a world)."""
    floor = max(float(b.median()), 1e-300)
    return median(((a - b).abs() / torch.clamp(b, min=floor)).tolist())


def check(loop, ev):
    """The cell's numbers: the loop's outputs in ``ev`` against the float64
    reference.  Returns (numbers, details)."""
    return loop.compare(ev, loop.reference(ev))


def stand_in(loop, ev, precision):
    """``ev`` with the program's outputs replaced by the reference's at
    ``precision``: the control put in the program's place."""
    return dict(ev, **loop.reference(ev, precision))
