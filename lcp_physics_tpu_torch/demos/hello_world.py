"""Hello-world demo: bouncing bodies under gravity inside a box of walls
(the JAX package's ``demos/hello_world.py`` through the port).

Run headless:         python -m lcp_physics_tpu_torch.demos.hello_world
Run with a window:    python -m lcp_physics_tpu_torch.demos.hello_world --display
On the CPU:           ... --device cpu
"""
import argparse

import torch

from lcp_physics_tpu_torch.physics import (Circle, Rect, TotalConstraint,
                                           World, run_world)

G = 100.0  # pixels/s^2, pygame-scale world like the reference demos


def make_world(dtype=torch.float32, device="cuda"):
    bodies = []
    constraints = []
    # dynamic circles
    for x, y, r in [(200, 100, 20), (300, 150, 30), (420, 80, 25),
                    (520, 160, 18), (600, 120, 22)]:
        bodies.append(Circle([x, y], r, restitution=0.7, fric_coeff=0.3))
    # a falling box for hull contacts
    bodies.append(Rect([0.3, 360, 50], [60, 40], restitution=0.5))
    # walls: floor + sides, pinned with TotalConstraint (reference pattern)
    for pos, dims in [((400, 560), (680, 40)),   # floor
                      ((40, 280), (40, 516)),    # left wall
                      ((760, 280), (40, 516))]:  # right wall
        wall = Rect(list(pos), list(dims), mass=100.0, restitution=0.7)
        bodies.append(wall)
        constraints.append(TotalConstraint(wall))
    return World(bodies, constraints, dt=1.0 / 60.0, gravity=(0.0, G),
                 dtype=dtype, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--display", action="store_true")
    ap.add_argument("--time", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    world = make_world(device=args.device)
    screen = None
    if args.display:
        import pygame

        pygame.init()
        screen = pygame.display.set_mode((800, 600))
        pygame.display.set_caption("lcp_physics_tpu_torch: hello world")
    run_world(world, run_time=args.time, print_time=True, screen=screen)
    for b in world.bodies[:6]:
        rot, x, y = b.p.tolist()
        _, vx, vy = b.v.tolist()
        print(f"body at ({x:7.1f}, {y:7.1f}) v=({vx:6.2f}, {vy:6.2f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
