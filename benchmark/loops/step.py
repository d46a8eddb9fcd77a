"""``step``: a closed loop of batched world steps (``make_batched_step``);
every ``restart_every`` calls the batch restarts from the next of the
``batches`` initial batches.  Judged per sampled (call, world): the
reference steps the call's input world once and the program's output
state is compared with it."""
from __future__ import annotations

import torch

from benchmark.harness import check, generate, program
from benchmark.reference import world as ref_world


class Loop:
    """Closed loop of batched world steps (module docstring)."""

    unit = "world-steps"
    numbers = ("v_gap_median", "p_gap_max")

    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.conf, self.traffic = cell.config, cell.traffic
        self.dt = self.conf["dt"]
        self.B = self.conf["worlds"]
        self.steps_per_call = 1

    def setup(self):
        dtype = program.DTYPES[self.conf["dtype"]]
        d = generate.draw(self.traffic, self.conf, self.seed)
        self.p0 = torch.as_tensor(d["p"], dtype=dtype, device=self.device)
        self.v0 = torch.as_tensor(d["v"], dtype=dtype, device=self.device)
        self.static, self.params = program.scene(self.conf, self.device)
        self.step = program.batched_step(self.static, self.conf)
        self.t0 = torch.zeros(self.B, dtype=dtype, device=self.device)
        self.batch = 0
        self.state = self._initial(0)
        with torch.no_grad():
            s = self.state
            for _ in range(self.traffic["warm_calls"]):
                s = self.step(self.params, s, self.dt)[0]
        self.n_calls = 0
        self.sample = check.Reservoir(self.traffic["sample"]["calls"],
                                      self.seed)

    def _initial(self, k):
        return program.WorldState(self.p0[k], self.v0[k], self.t0)

    def call(self):
        s_in = self.state
        with torch.no_grad():
            s_out = self.step(self.params, s_in, self.dt)[0]
        self.sample.offer((s_in, s_out))
        self.n_calls += 1
        if self.n_calls % self.traffic["restart_every"] == 0:
            self.batch = (self.batch + 1) % self.traffic["batches"]
            self.state = self._initial(self.batch)
        else:
            self.state = s_out
        return self.B

    def evidence(self):
        """The sampled calls' sampled worlds, as host tensors: (p_in,
        v_in, p_out, v_out), each (S, N, 3)."""
        kept = self.sample.kept
        ws = check.sample_worlds(self.seed, len(kept),
                                 self.traffic["sample"]["worlds"], self.B)
        pick = lambda i, f: torch.cat([getattr(call[i], f)[w]
                                       for call, w in zip(kept, ws)]).cpu()
        return dict(p_in=pick(0, "p"), v_in=pick(0, "v"),
                    p_out=pick(1, "p"), v_out=pick(1, "v"))

    def free(self):
        self.sample = self.state = self.step = self.p0 = self.v0 = None

    def reference(self, ev, precision="reference"):
        """The reference's step of the sampled input worlds: p_out, v_out
        as float64 host tensors."""
        prec = check.PRECISIONS[precision]
        dev = self.device
        world = ref_world.params(self.conf, prec.dtype, dev)
        with torch.no_grad(), check.Tf32(prec.tf32):
            p, v = ref_world.step(world,
                                  check.cast(ev["p_in"].to(dev), prec),
                                  check.cast(ev["v_in"].to(dev), prec),
                                  self.dt, check.solver(self.conf))
        return dict(p_out=check.result(p, prec).cpu(),
                    v_out=check.result(v, prec).cpu())

    def compare(self, ev, ref):
        """``v_gap_median``: the median over the sampled worlds of
        |v' - v'_ref| / |v'_ref| (2-norms over the world);
        ``p_gap_max``: the largest |p' - p'_ref| of any body coordinate.
        Returns (numbers, per-world gaps)."""
        flat = lambda x: x.double().reshape(x.shape[0], -1)
        v_ref = flat(ref["v_out"])
        v_gap = (torch.linalg.vector_norm(flat(ev["v_out"]) - v_ref, dim=-1)
                 / torch.linalg.vector_norm(v_ref, dim=-1).clamp(min=1e-12))
        p_gap = (flat(ev["p_out"]) - flat(ref["p_out"])).abs().amax(-1)
        return dict(v_gap_median=check.median(v_gap.tolist()),
                    p_gap_max=float(p_gap.max())), \
            dict(v_gap=v_gap.tolist(), p_gap=p_gap.tolist())
