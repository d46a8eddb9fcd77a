"""The traced run's device timeline, from ``torch.profiler``'s Chrome
trace: the window's span, every device operation in it, and the host
operations that were running while the device idled.

The profiler records the host (CPU ops, CUDA runtime calls) and the device
(kernels, copies, sets).  The window is the ``record_function`` span the
harness opens around it.  Device operations are clipped to the window;
their union is the busy time (overlaps count once); an idle gap is time
in the window outside that union, named by the innermost host operation
running at its middle.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

WINDOW = "benchmark.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
NAME_CHARS = 96


class Timeline:
    """Device operations and host spans of the window (microseconds)."""

    def __init__(self, events):
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("ph") == "X" and e.get("cat") in HOST_CATS]
        if not win:
            raise RuntimeError("the trace has no window span")
        w = max(win, key=lambda e: e["dur"])
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        clip = lambda e: (max(float(e["ts"]), self.t0),
                          min(float(e["ts"]) + float(e.get("dur", 0)),
                              self.t1))
        self.device = []          # (start, end, cat, name)
        self.host = []            # (start, end, name)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            if cat in DEVICE_CATS:
                a, b = clip(e)
                if b > a:
                    self.device.append((a, b, cat, e.get("name", "?")))
            elif cat in HOST_CATS and e.get("name") != WINDOW:
                a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
                if b > self.t0 and a < self.t1:
                    self.host.append((a, b, e.get("name", "?")))
        if not self.device:
            raise RuntimeError("the trace holds no device operation in the "
                               "window: the profiler saw no device activity")
        self.device.sort()
        self.host.sort()
        self._host_starts = [h[0] for h in self.host]

    @property
    def window_s(self):
        return (self.t1 - self.t0) / 1e6

    def kernels(self):
        return [d for d in self.device if d[2] == "kernel"]

    def kernel_s(self):
        """Summed device time of the window's kernels."""
        return sum(b - a for a, b, _, _ in self.kernels()) / 1e6

    def busy_intervals(self):
        out = []
        for a, b, _, _ in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def gaps(self):
        """Idle intervals of the window: (start, end)."""
        out, t = [], self.t0
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def host_at(self, t, lookback=256):
        """The innermost host span running at ``t`` (the latest-starting
        one that covers it), or None."""
        i = bisect.bisect_right(self._host_starts, t)
        best = None
        for j in range(i - 1, max(i - 1 - lookback, -1), -1):
            a, b, name = self.host[j]
            if b >= t:
                best = name
                break
        return best

    def top_device_ops(self, k=10):
        """[[name, seconds]]: the k device operations of most total time."""
        tot = collections.Counter()
        for a, b, _, name in self.device:
            tot[name[:NAME_CHARS]] += (b - a) / 1e6
        return [[n, s] for n, s in tot.most_common(k)]

    def idle_by_host(self, k=10):
        """[[name, seconds]]: idle time of the window summed by the host
        operation running in the middle of each gap, the k largest."""
        tot = collections.Counter()
        for a, b in self.gaps():
            name = self.host_at(0.5 * (a + b)) or "host outside any op"
            tot[name[:NAME_CHARS]] += (b - a) / 1e6
        return [[n, s] for n, s in tot.most_common(k)]


def read(prof):
    """The :class:`Timeline` of a finished ``torch.profiler.profile``: its
    Chrome trace is written to a temporary file (under ``TMPDIR``), read
    and deleted."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Timeline(events)
