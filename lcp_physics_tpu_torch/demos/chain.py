"""Chain demo: a chain of jointed links swinging from a fixed anchor, then
settling onto the ground with friction (the JAX package's
``demos/chain.py`` through the port).

Run: python -m lcp_physics_tpu_torch.demos.chain [--display] [--device cpu]
"""
import argparse

import torch

from lcp_physics_tpu_torch.physics import (Joint, Rect, TotalConstraint,
                                           World, run_world)
from lcp_physics_tpu_torch.utils import rotate

G = 100.0


def make_world(n_links=5, dtype=torch.float32, device="cuda"):
    bodies = []
    constraints = []
    link_len = 50.0
    x0, y0 = 400.0, 100.0
    prev = None
    for k in range(n_links):
        link = Rect([x0 + link_len * (k + 0.5), y0], [link_len, 10.0],
                    mass=1.0, fric_coeff=0.6, restitution=0.2)
        bodies.append(link)
        constraints.append(Joint(link, prev, [x0 + link_len * k, y0]))
        prev = link
    floor = Rect([400, 400], [700, 40], mass=100.0, fric_coeff=0.6)
    bodies.append(floor)
    constraints.append(TotalConstraint(floor))
    return World(bodies, constraints, dt=1.0 / 60.0, gravity=(0.0, G),
                 dtype=dtype, device=device)


def joint_gaps(world):
    """Distance between the two anchors of every body-body joint."""
    gaps = []
    for c in world.constraints:
        if isinstance(c, Joint) and c.body2 is not None:
            a = [b.p[1:3] + rotate(torch.tensor(loc, dtype=b.p.dtype,
                                                device=b.p.device), b.p[0])
                 for b, loc in ((c.body1, c.local1), (c.body2, c.local2))]
            gaps.append(float(torch.linalg.vector_norm(a[0] - a[1])))
    return gaps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--display", action="store_true")
    ap.add_argument("--time", type=float, default=3.0)
    ap.add_argument("--links", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    world = make_world(args.links, device=args.device)
    screen = None
    if args.display:
        import pygame

        pygame.init()
        screen = pygame.display.set_mode((800, 500))
        pygame.display.set_caption("lcp_physics_tpu_torch: chain")
    run_world(world, run_time=args.time, print_time=True, screen=screen)
    for gap in joint_gaps(world):
        print("joint gap:", gap)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
