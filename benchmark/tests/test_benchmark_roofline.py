"""The frozen least-work counts against hand counts, and the roofline
readers on a made-up timeline."""
import types

import pytest
import torch

from benchmark.harness import readers, roofline


def test_lcp_counts_by_hand():
    # n = 24, K = 16, two iterations: Schur 16*17*24 = 6528; three LUs of
    # (2/3)16^3; five solves of 2*256 + 4*16*24 = 2048; two residual
    # pairs of 4*16*24 = 1536
    assert roofline.lcp_flops(24, 16, 2) == pytest.approx(
        6528 + 3 * (2 / 3) * 4096 + 5 * 2048 + 2 * 1536)
    # Q, p (24 each), G 32 x 24, h and the mask (32 each), mu and valid
    # (8 each) read, z (24) written: 920 floats
    assert roofline.lcp_bytes(24, 32, 8) == 4 * 920


def test_step_counts_by_hand():
    # N = 4 circles: 6 pairs at 20; C = 4 slots at 40 and 4 bodies at 10;
    # the LCP of n = 12, K = 8, one iteration
    lcp = 8 * 9 * 12 + 2 * (2 / 3) * 512 + 3 * (128 + 384) + 384
    assert roofline.step_flops(4, 4, 8, 1) == pytest.approx(
        120 + 160 + 40 + lcp)
    assert roofline.step_bytes(4) == 4 * (48 + 20)
    assert roofline.least_seconds(67e12, 1.0) == pytest.approx(1.0)
    assert roofline.least_seconds(1.0, 3.35e12) == pytest.approx(1.0)


class _Timeline:
    def __init__(self, kernel_s):
        self._k = kernel_s

    def kernel_s(self):
        return self._k


def test_roofline_readers_divide_least_time_by_kernel_time():
    conf = {"bodies": 8, "c_max": 8, "worlds": 2}
    loop = types.SimpleNamespace(conf=conf)
    iters = torch.tensor([3, 5, 4, 4], dtype=torch.int32)   # two batches
    run = types.SimpleNamespace(timeline=_Timeline(1e-3), lcp_iters=iters,
                                calls=10, loop=loop)
    least = [roofline.least_seconds(
        roofline.lcp_flops(24, 16, a) + roofline.lcp_flops(24, 16, b),
        2 * roofline.lcp_bytes(24, 32, 8)) for a, b in ((3, 5), (4, 4))]
    assert readers.lcp_roofline_pct(run) == pytest.approx(
        100 * (sum(least) / 2) / 1e-4)
    run.timeline = None
    assert readers.lcp_roofline_pct(run) is None

    conf = {"bodies": 64, "c_max": 128, "worlds": 1024}
    step_run = types.SimpleNamespace(
        timeline=_Timeline(2.0), steps=40, loop=types.SimpleNamespace(
            conf=conf), counted=lambda prefix: 400)
    least = roofline.least_seconds(
        1024 * roofline.step_flops(64, 128, 256, 10),
        1024 * roofline.step_bytes(64))
    assert readers.step_roofline_pct(step_run) == pytest.approx(
        100 * least / 0.05)
