"""The port's rendering and recording paths through SDL's dummy video
driver, as tests/test_render.py runs the JAX package's: every body and
constraint draws, and run_world renders and records frames."""
import os

import pytest
import torch

pygame = pytest.importorskip("pygame")

F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture()
def screen():
    os.environ["SDL_VIDEODRIVER"] = "dummy"
    pygame.init()
    yield pygame.display.set_mode((320, 240))
    pygame.quit()


def test_draw_bodies_and_constraints(screen):
    from lcp_physics_tpu_torch.physics import (Circle, Hull, Joint, Rect,
                                               TotalConstraint, World)

    c = Circle([50, 50], 10)
    r = Rect([120, 50], [30, 20])
    h = Hull([200, 60], [[0, 0], [30, 0], [15, 25]])
    j = Joint(c, r, [85, 50])
    for b in (c, r, h):
        b.draw(screen)
    j.draw(screen)
    TotalConstraint(r).draw(screen)
    # and once the bodies' poses are rows of a world's state
    World([c, r, h], [j], **F64).step()
    for b in (c, r, h):
        b.draw(screen)
    j.draw(screen)


def test_run_world_with_screen_and_recorder(screen, tmp_path):
    from lcp_physics_tpu_torch.physics import (Circle, Recorder, Rect,
                                               TotalConstraint, World,
                                               run_world)

    ball = Circle([160, 40], 10, restitution=0.5)
    floor = Rect([160, 200], [300, 20])
    w = World([ball, floor], [TotalConstraint(floor)], dt=1 / 30,
              gravity=(0.0, 100.0), **F64)
    rec = Recorder(dt=1 / 15, screen=screen, path=str(tmp_path))
    run_world(w, run_time=0.2, screen=screen, recorder=rec)
    assert w.t >= 0.2
    assert rec.frame >= 1
    assert any(f.endswith(".bmp") for f in os.listdir(tmp_path))
