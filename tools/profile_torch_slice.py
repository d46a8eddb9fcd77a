"""Where the time of the PyTorch port's slices goes, on one GPU.

By default steps chip_smoke.py's forward slice scene (the 8-circle
benchmark scene, B = 4096 worlds, float32) through ``make_batched_step``,
10 steps after 3 warm-up steps.  With ``--train`` it runs chip_smoke.py's
training slice instead: value and gradients of mean(p^2) through the
8-step rollout of the dense 64-circle grid (B = 256, float32), once after
one warm-up; ``--train64`` the same at float64 (B = 32, seed 2: the scalar
panel kernel K5).  With ``--fuse-iter`` it runs path (b): the dense
scene's 8-step forward (B = 256, float32) with ``lcp.pdipm.FUSE_ITER`` set
(K6 per IPM iteration), once after one warm-up.  With ``--lcp`` it runs
path (c): ``lcp_solve(fric_pair=False)`` forward on the benchmark scene's
4096 first-step LCPs (chip_smoke.py's
``slice_lcp`` and ``LCP_KW``), 10 batches after 3 warm-ups, a "step" being
one batch.  It reports:

- ms per rollout step on the host clock around synchronised work
  (profiler off);
- under ``torch.profiler``: device kernel time and launches per step, the
  device's busy share of the profiler-off time, and the top operators by
  device time and by host time; with ``--trace PATH`` also a Chrome
  trace.

Run from the repository root: ``python tools/profile_torch_slice.py
[--train | --train64 | --fuse-iter | --lcp] [--root DIR]``; ``--root``
profiles the package of another checkout (an earlier commit) on this
tree's scenes, so two commits compare on the same work.  The last line
is a JSON object of the step's numbers.  Exits non-zero without a CUDA
device.
"""
import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STEPS = 10


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", default=None, help="Chrome trace output path")
    ap.add_argument("--train", action="store_true",
                    help="profile the dense training step (fwd+bwd)")
    ap.add_argument("--train64", action="store_true",
                    help="profile the dense training step at float64 (K5)")
    ap.add_argument("--fuse-iter", action="store_true",
                    help="profile path (b): the dense forward with FUSE_ITER")
    ap.add_argument("--lcp", action="store_true",
                    help="profile path (c), one lcp_solve batch forward")
    ap.add_argument("--root", default=HERE,
                    help="checkout whose package is profiled (default: this)")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    dev = torch.device("cuda", 0)
    if args.train or args.train64:
        cs = chip_smoke
        Bt, dt, seed = ((cs.TRAIN_B64, torch.float64, 2) if args.train64
                        else (cs.TRAIN_B, torch.float32, 1))
        step, params, s = cs.train_scene(
            torch, dev, dt, *cs.grid_start(Bt, cs.TRAIN_SIDE, seed),
            cs.TRAIN_C)
        cs.train_step(torch, step, params, s, 1)        # warm-up
        unit, per, what = 1, cs.TRAIN_STEPS, (
            f"B={Bt} {str(dt)[6:]} fwd+bwd over {cs.TRAIN_STEPS} steps")

        def work(state):
            cs.train_step(torch, step, params, state, cs.TRAIN_STEPS)
            return state
    elif args.fuse_iter:
        from lcp_physics_tpu_torch.core import rollout
        from lcp_physics_tpu_torch.lcp import pdipm
        cs = chip_smoke
        step, params, s = cs.train_scene(
            torch, dev, torch.float32,
            *cs.grid_start(cs.TRAIN_B, cs.TRAIN_SIDE), cs.TRAIN_C)
        pdipm.FUSE_ITER = True
        unit, per, what = 1, cs.TRAIN_STEPS, (
            f"B={cs.TRAIN_B} f32 forward with FUSE_ITER over "
            f"{cs.TRAIN_STEPS} steps")

        def work(state):
            with torch.no_grad():
                rollout(step, params, state, cs.DT, cs.TRAIN_STEPS)
            return state
        work(s)                                          # warm-up
    elif args.lcp:
        cs = chip_smoke
        blocks = cs.slice_lcp(torch, dev, torch.float32)
        kw = dict(cs.LCP_KW, fric_pair=False)
        for _ in range(3):                              # warm-up
            cs.lcp_fwd_bwd(torch, blocks, False, **kw)
        s = None
        unit, per, what = STEPS, 1, (
            f"lcp_solve(fric_pair=False) forward, B={cs.B} f32, per batch")

        def work(state):
            cs.lcp_fwd_bwd(torch, blocks, False, **kw)
            return state
    else:
        step, params, s = chip_smoke.slice_scene(
            torch, dev, torch.float32, *chip_smoke.slice_start(chip_smoke.B))
        for _ in range(3):                              # warm-up
            s, _ = step(params, s, chip_smoke.DT)
        unit, per, what = STEPS, 1, f"B={chip_smoke.B} f32"

        def work(state):
            return step(params, state, chip_smoke.DT)[0]

    def run(state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(unit):
            state = work(state)
        torch.cuda.synchronize()
        return state, (time.perf_counter() - t0) / unit / per

    s, sec = run(s)
    print(f"{what}: {1e3 * sec:.3f} ms/step (host clock, profiler off)")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s, sec_p = run(s)
    events = prof.key_averages()
    # kernel rows only: an operator row also carries the device time of
    # the kernels it launched, so summing every row counts them twice
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 \
        / (unit * per)
    launches = sum(e.count for e in kernels) / (unit * per)
    # the profiler slows the host, not the device: busy share is device
    # time over the profiler-off step time
    print(f"profiled: {1e3 * sec_p:.3f} ms/step; device kernel time "
          f"{dev_ms:.3f} ms/step, {launches:.0f} device "
          f"launches/step; device busy {dev_ms / (1e3 * sec):.1%} of the "
          "profiler-off step")
    print(events.table(sort_by="self_device_time_total", row_limit=15,
                       max_name_column_width=50))
    # the host's share: operators by their own CPU time
    print(events.table(sort_by="self_cpu_time_total", row_limit=12,
                       max_name_column_width=50))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print(json.dumps(dict(what=what, root=os.path.abspath(args.root),
                          host_ms=1e3 * sec, device_ms=dev_ms,
                          launches=launches)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
