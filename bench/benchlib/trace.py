"""The device trace of a traced run, reduced: ``torch.profiler`` over one
stretch after the measured window's close, at the window's load (host
ranges that the benchmark marks ``bench.*``, and every kernel), cut to
the marked ``bench.traced`` range.

* busy seconds: the union of the kernels' intervals;
* device time of a kernel group: kernels whose names contain one of the
  group's patterns (the patterns live in each metric's own file);
* the operations that took most device time, and the idle gaps between
  kernels summed by the innermost ``bench.*`` range the host was in.
"""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

TRACED = "bench.traced"


@dataclass
class Trace:
    window_us: Tuple[float, float]
    kernels: List[Tuple[str, float, float]]          # name, start, end (us)
    ranges: List[Tuple[str, float, float]]           # bench.* host ranges
    wall: Tuple[float, float] = (0.0, 0.0)           # perf_counter span
    merged: List[Tuple[float, float]] = field(default_factory=list)

    def __post_init__(self):
        iv = sorted((s, e) for _, s, e in self.kernels)
        for s, e in iv:
            if self.merged and s <= self.merged[-1][1]:
                self.merged[-1] = (self.merged[-1][0],
                                   max(self.merged[-1][1], e))
            else:
                self.merged.append((s, e))

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged) / 1e6

    def group_s(self, patterns: Sequence[str]) -> float:
        return sum(e - s for name, s, e in self.kernels
                   if any(p in name for p in patterns)) / 1e6

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, s, e in self.kernels:
            key = name[:120]
            by[key] = by.get(key, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle device time in the window, summed by the innermost
        ``bench.*`` host range at each gap's midpoint."""
        ranges = sorted(self.ranges, key=lambda r: (r[1], -r[2]))
        starts = [r[1] for r in ranges]
        edges = [self.window_us[0]]
        for s, e in self.merged:
            edges += [s, e]
        edges.append(self.window_us[1])
        by: Dict[str, float] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            # the ranges nest, so the latest-starting one that holds the
            # midpoint is the innermost
            label = "bench.other"
            hi = bisect.bisect_right(starts, mid) - 1
            for i in range(hi, max(hi - 64, -1), -1):
                name, s, e = ranges[i]
                if s <= mid <= e:
                    label = name
                    break
            by[label] = by.get(label, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]


class Tracer:
    """Profiles one stretch: ``start()`` opens the profiler and the
    ``bench.traced`` range, ``stop()`` synchronises, closes both and
    reduces the events (None when the profiler saw no kernel)."""

    def __init__(self, torch_mod):
        self.torch = torch_mod
        self.prof = None
        self.rng = None
        self.t0 = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.rng = record_function(TRACED)
        self.rng.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> Optional[Trace]:
        self.torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.rng.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        cuda_t = self.torch.autograd.DeviceType.CUDA
        kernels, ranges, window = [], [], None
        for e in self.prof.events():
            s, t = e.time_range.start, e.time_range.end
            if e.device_type == cuda_t:
                if not e.name.startswith("bench."):
                    kernels.append((e.name, s, t))
            elif e.name == TRACED:
                window = (s, t)
            elif e.name.startswith("bench."):
                ranges.append((e.name, s, t))
        self.prof = None
        if window is None or not kernels:
            return None
        kernels = [k for k in kernels
                   if k[1] >= window[0] and k[2] <= window[1]]
        if not kernels:
            return None
        return Trace(window, kernels, ranges, (self.t0, t1))
