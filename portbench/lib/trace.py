"""The device trace of a traced window, reduced to what the metrics read.

A :class:`Window` runs ``torch.profiler`` (host and device activity)
between :meth:`Window.start` and :meth:`Window.stop`, exports the Chrome
trace into the run's scratch directory, and reduces it:

- ``busy_s``: the union of the device's operations (kernels, copies,
  sets) over the traced window, ``window_s`` its wall length;
- ``device_ops``: device seconds by operation name;
- ``kernels``: (device seconds, launches) by kernel name, which the
  roofline readers match;
- ``idle``: the device's idle seconds by what the host was doing, named
  by the innermost ``portbench.*`` span (:func:`span`) that covers the
  middle of each gap.

On a CPU run (the tests) the CPU's operations stand in for the device's.
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "portbench."


def span(name: str):
    """A host span the trace names idle gaps by (``portbench.<name>``)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Window:
    """``host`` False records the device alone: the profiler's cost on
    every host operation would otherwise show as device idle time where
    the host issues work back to back (the idle gaps then go unnamed)."""

    def __init__(self, scratch: str, cuda: bool, host: bool = True):
        self.scratch = scratch
        self.cuda = cuda
        acts = []
        if host or not cuda:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            # host spans of every thread (the wire server's handlers
            # serve from their own threads), where the profiler can
            cfg = torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)
        except (AttributeError, TypeError):
            cfg = None
        self.prof = torch.profiler.profile(activities=acts,
                                           experimental_config=cfg)
        self.busy_s = 0.0
        self.window_s = 0.0
        self.device_ops: Dict[str, float] = {}
        self.kernels: Dict[str, Tuple[float, int]] = {}
        self.idle: Dict[str, float] = {}

    def start(self) -> "Window":
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.start()
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> "Window":
        if self.cuda:
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()
        path = os.path.join(self.scratch, "trace.json")
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(path)
        self._reduce(events)
        return self

    def _reduce(self, events) -> None:
        dev_cats = DEVICE_CATS if self.cuda else ("cpu_op",)
        dev, spans = [], []
        by_name = defaultdict(float)
        kern = defaultdict(lambda: [0.0, 0])
        t_lo, t_hi = float("inf"), float("-inf")
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            ts, dur = float(ev["ts"]), float(ev["dur"])
            t_lo, t_hi = min(t_lo, ts), max(t_hi, ts + dur)
            cat, name = ev.get("cat", ""), ev.get("name", "")
            if cat in dev_cats:
                dev.append((ts, ts + dur))
                by_name[name[:160]] += dur / 1e6
                if cat == ("kernel" if self.cuda else "cpu_op"):
                    kern[name][0] += dur / 1e6
                    kern[name][1] += 1
            elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
                spans.append((ts, ts + dur, name))
        busy = _union(dev)
        self.busy_s = sum(e - s for s, e in busy) / 1e6
        self.device_ops = dict(by_name)
        self.kernels = {k: (v[0], v[1]) for k, v in kern.items()}
        if not busy:
            return
        gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
        gaps = [(t_lo, busy[0][0])] + gaps + [(busy[-1][1], t_hi)]
        spans.sort()
        starts = [s for s, _, _ in spans]
        idle = defaultdict(float)
        for g0, g1 in gaps:
            if g1 <= g0:
                continue
            mid = (g0 + g1) / 2
            i = bisect.bisect_right(starts, mid)
            inner = [(e - s, n) for s, e, n in spans[max(0, i - 64):i]
                     if e >= mid]
            label = min(inner)[1] if inner else "host.outside_spans"
            idle[label] += (g1 - g0) / 1e6
        self.idle = dict(idle)

    def kernel(self, pattern) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name matches
        the compiled regex ``pattern``."""
        s, n = 0.0, 0
        for name, (sec, cnt) in self.kernels.items():
            if pattern.search(name):
                s, n = s + sec, n + cnt
        return s, n

    def breakdown(self) -> Dict[str, List]:
        top = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}
