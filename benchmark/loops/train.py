"""``train``: parameter inference, one Adam step on per-world mass and
restitution guesses a call, through ``rollout_steps`` steps with
per-world parameters and the implicit backward.  Set-up runs the first
three calls; the reference follows those three on sampled worlds."""
from __future__ import annotations

import dataclasses

import torch

from benchmark.harness import check, generate, program
from benchmark.reference import train as ref_train
from benchmark.reference import world as ref_world


class Loop:
    """Parameter inference, one Adam step a call (module docstring)."""

    unit = "grad-steps"
    numbers = ("first_loss_gap_median", "grad_gap_median", "change_gap")
    LEAVES = ref_train.LEAVES

    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.conf, self.traffic = cell.config, cell.traffic
        self.dt = self.conf["dt"]
        self.B = self.conf["worlds"]
        self.n = self.traffic["rollout_steps"]
        self.steps_per_call = self.n

    def setup(self):
        dtype = program.DTYPES[self.conf["dtype"]]
        dev = self.device
        d = generate.draw(self.traffic, self.conf, self.seed)
        self.p0 = torch.as_tensor(d["p"][0], dtype=dtype, device=dev)
        self.v0 = torch.as_tensor(d["v"][0], dtype=dtype, device=dev)
        self.guess0 = {k: torch.as_tensor(d["guess"][k], dtype=dtype,
                                          device=dev) for k in self.LEAVES}
        static, params = program.scene(self.conf, dev)
        self.params = program.batch_params(params, self.B)
        self.step = program.batched_step(static, self.conf,
                                         params_batched=True)
        self.state0 = program.WorldState(
            self.p0, self.v0, torch.zeros(self.B, dtype=dtype, device=dev))
        with torch.no_grad():
            self.target = program.rollout(self.step, self.params, self.state0,
                                          self.dt, self.n)[1].p
        self.leaves = {k: self.guess0[k].clone().requires_grad_(True)
                       for k in self.LEAVES}
        self.opt = torch.optim.Adam([self.leaves[k] for k in self.LEAVES],
                                    lr=self.traffic["lr"],
                                    betas=ref_train.BETAS, eps=ref_train.EPS)
        self.losses = []
        self.first_grad = None
        for t in range(3):
            self.call()
            self.losses.append(self.last_loss)
            if t == 0:
                self.first_grad = {
                    k: self.opt.state[self.leaves[k]]["exp_avg"].clone()
                    / (1 - ref_train.BETAS[0]) for k in self.LEAVES}
        self.after3 = {k: self.leaves[k].detach().clone()
                       for k in self.LEAVES}

    def loss(self):
        """Per-world losses (B,) at the current guesses."""
        params = dataclasses.replace(
            self.params, **{k: self.leaves[k] for k in self.LEAVES})
        traj = program.rollout(self.step, params, self.state0, self.dt,
                               self.n)[1].p
        return ((traj - self.target) ** 2).mean(dim=(0, 2, 3))

    def call(self):
        loss = self.loss()
        self.opt.zero_grad(set_to_none=True)
        loss.sum().backward()
        self.opt.step()
        with torch.no_grad():
            for k in self.LEAVES:
                self.leaves[k].clamp_(*ref_train.CLAMPS[k])
        self.last_loss = loss.detach()
        return self.B * self.n

    def evidence(self):
        """The sampled worlds' inputs, guesses and the first three steps'
        losses, first gradient and guesses after three, host tensors."""
        w = torch.as_tensor(check.sample_worlds(
            self.seed, 1, self.traffic["sample"]["worlds"], self.B)[0])
        pick = lambda x: x.detach()[w.to(x.device)].cpu()
        return dict(p0=pick(self.p0), v0=pick(self.v0),
                    guess={k: pick(self.guess0[k]) for k in self.LEAVES},
                    losses=[pick(x) for x in self.losses],
                    first_grad={k: pick(self.first_grad[k])
                                for k in self.LEAVES},
                    after3={k: pick(self.after3[k]) for k in self.LEAVES})

    def free(self):
        self.opt = self.leaves = self.target = self.step = None

    def reference(self, ev, precision="reference"):
        """The reference's first three steps from the sampled worlds'
        guesses: losses (three (S,)), first_grad and after3 (dicts over
        the leaves), float64 on the host; its own target rollout from the
        true parameters."""
        prec = check.PRECISIONS[precision]
        dev = self.device
        world = ref_world.params(self.conf, prec.dtype, dev)
        solver = check.solver(self.conf)
        p0 = check.cast(ev["p0"].to(dev), prec)
        v0 = check.cast(ev["v0"].to(dev), prec)
        guess = {k: check.cast(ev["guess"][k].to(dev), prec)
                 for k in self.LEAVES}
        with check.Tf32(prec.tf32):
            with torch.no_grad():
                target = ref_world.rollout(world, p0, v0, self.dt, self.n,
                                           solver)
            losses, first, after = ref_train.adam(
                world, guess, p0, v0, self.dt, self.n, solver, target,
                self.traffic["lr"], 3)
        res = lambda x: check.result(x, prec).cpu()
        return dict(losses=[res(x) for x in losses],
                    first_grad={k: res(first[k]) for k in self.LEAVES},
                    after3={k: res(after[k]) for k in self.LEAVES})

    def compare(self, ev, ref):
        """``first_loss_gap_median``: the median over the sampled worlds
        of the gap between the world's first-step losses, against the
        larger of its reference loss and the median world's (the later
        steps' guesses have moved apart under Adam, and one world's
        chaotic rollout can carry a mean, see PERF.md);
        ``grad_gap_median``: the same for each leaf's per-world
        first-gradient norms (the program's read back from Adam's state),
        the worst leaf; ``change_gap``: the
        worst leaf's gap between the norms of the change after three
        steps, against the larger of that leaf's reference norm and the
        median leaf's, over the leaves whose reference gradient is at
        least a thousandth of the median leaf's.  The details hold each
        step's loss gap and the whole-leaf gradient norms.  Returns
        (numbers, details)."""
        mean = lambda x: float(x.double().mean())
        loss_gaps = [abs(mean(a) - mean(b)) / abs(mean(b))
                     for a, b in zip(ev["losses"], ref["losses"])]
        norm = lambda x: float(torch.linalg.vector_norm(x.double()))
        rows = lambda x: torch.linalg.vector_norm(x.double(), dim=-1)
        g_ref = {k: norm(ref["first_grad"][k]) for k in self.LEAVES}
        g_med = check.median(list(g_ref.values()))
        world_gaps = {k: check.median_gap(rows(ev["first_grad"][k]),
                                     rows(ref["first_grad"][k]))
                      for k in self.LEAVES}
        moved = [k for k in self.LEAVES if g_ref[k] >= 1e-3 * g_med]
        change = lambda x, k: norm(x[k].double() - ev["guess"][k].double())
        d_ref = {k: change(ref["after3"], k) for k in moved}
        d = {k: change(ev["after3"], k) for k in moved}
        d_med = check.median(list(d_ref.values()))
        change_gap = max(abs(d[k] - d_ref[k]) / max(d_ref[k], d_med, 1e-300)
                         for k in moved)
        return dict(first_loss_gap_median=check.median_gap(
                        ev["losses"][0].double(), ref["losses"][0].double()),
                    grad_gap_median=max(world_gaps.values()),
                    change_gap=change_gap), \
            dict(loss_gaps=loss_gaps, grad_gaps_by_leaf=world_gaps,
                 grad_norms_ref=g_ref,
                 grad_norms={k: norm(ev["first_grad"][k])
                             for k in self.LEAVES},
                 change_norms_ref=d_ref, change_norms=d)
