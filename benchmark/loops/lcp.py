"""``lcp``: a closed loop of ``lcp_solve`` over ``batches`` batches of
contact LCPs assembled in set-up by the reference's assembly, cycling.
Judged per sampled (call, world) against the reference's solve of the
same blocks."""
from __future__ import annotations

import torch

from benchmark.harness import check, generate, program
from benchmark.reference import lcp as ref_lcp
from benchmark.reference import world as ref_world


class Loop:
    """Closed loop of batched LCP solves (module docstring)."""

    unit = "solves"
    numbers = ("z_gap_median", "z_gap_p75")

    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.conf, self.traffic = cell.config, cell.traffic
        self.B = self.conf["worlds"]
        self.steps_per_call = 1

    def setup(self):
        dtype = program.DTYPES[self.conf["dtype"]]
        d = generate.draw(self.traffic, self.conf, self.seed)
        world = ref_world.params(self.conf, dtype, self.device)
        self.blocks = []
        with torch.no_grad():
            for k in range(self.traffic["batches"]):
                blk = ref_world.blocks(
                    world, torch.as_tensor(d["p"][k], device=self.device),
                    torch.as_tensor(d["v"][k], device=self.device),
                    self.conf["dt"])
                blk.pop("n_contacts")
                self.blocks.append(blk)
        self.kw = dict(self.conf["lcp"], gamma_rows=self.conf["c_max"],
                       q_is_diag=True)
        self.batch = 0
        for _ in range(self.traffic["warm_calls"]):
            self._solve(self.blocks[0])
        self.sample = check.Reservoir(self.traffic["sample"]["calls"],
                                      self.seed)

    def _solve(self, blk, full=False):
        args = (blk["Q"], blk["p"], blk["G"], blk["h"], None, None,
                program.ConeF(blk["mu"], blk["valid"], 2))
        fn = program.lcp_solve_full if full else program.lcp_solve
        with torch.no_grad():
            return fn(*args, row_mask=blk["row_mask"], **self.kw)

    def call(self):
        z = self._solve(self.blocks[self.batch])
        self.sample.offer((self.batch, z))
        self.batch = (self.batch + 1) % self.traffic["batches"]
        return self.B

    def iterations(self):
        """Per-world IPM iterations of ``lcp_solve_full`` on every batch
        of the cell, (batches * B,)."""
        return torch.cat([self._solve(b, full=True).iters
                          for b in self.blocks])

    def evidence(self):
        """The sampled calls' sampled LCPs (blocks) and their z, host
        tensors."""
        kept = self.sample.kept
        ws = check.sample_worlds(self.seed, len(kept),
                                 self.traffic["sample"]["worlds"], self.B)
        out = {key: torch.cat([self.blocks[b][key][w]
                               for (b, _), w in zip(kept, ws)]).cpu()
               for key in ("Q", "p", "G", "h", "F", "row_mask")}
        out["z"] = torch.cat([z[w] for (_, z), w in zip(kept, ws)]).cpu()
        return out

    def free(self):
        self.sample = self.blocks = None

    def reference(self, ev, precision="reference"):
        """The reference's solutions z of the sampled LCPs (float64, on
        the host)."""
        prec = check.PRECISIONS[precision]
        dev = self.device
        lcp = self.conf["lcp"]
        args = [check.cast(ev[k].to(dev), prec)
                for k in ("Q", "p", "G", "h", "F", "row_mask")]
        with torch.no_grad(), check.Tf32(prec.tf32):
            z = ref_lcp.solve(*args, max_iter=lcp["max_iter"],
                              tol=lcp["tol"],
                              stall_lim=lcp["not_improved_lim"],
                              solver_dtype=program.DTYPES[
                                  self.conf["dtype"]])[0]
        return dict(z=check.result(z, prec).cpu())

    def compare(self, ev, ref):
        """``z_gap_median``: the median over the sampled worlds of
        |z - z_ref| / |z_ref| (2-norms); ``z_gap_p75``: their 75th
        percentile, which a fault in a quarter or more of the answers
        reaches (the float32 solver's own tail of gaps past 1e-4 is a
        fifth to a quarter of the worlds, see PERF.md).  Returns
        (numbers, per-world gaps)."""
        z_ref = ref["z"].double()
        gap = (torch.linalg.vector_norm(ev["z"].double() - z_ref, dim=-1)
               / torch.linalg.vector_norm(z_ref, dim=-1).clamp(min=1e-12))
        return (dict(z_gap_median=check.median(gap.tolist()),
                     z_gap_p75=float(torch.quantile(gap, 0.75))),
                dict(z_gap=gap.tolist()))
