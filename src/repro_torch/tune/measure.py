"""Shared measurement harness of the tuner -- the port of
``repro/tune/measure.py``.

One code path times every candidate of every kernel, so the numbers of a
sweep are comparable: warmup calls (the first builds the kernels), then
``reps`` repetitions, each ``inner`` calls enqueued back to back and one
synchronization, reported as microseconds a call; the median of the reps
is the candidate's time.  A failure is captured, not raised: the
candidate loses the sweep.

Timing ``inner`` calls a rep (the JAX harness times one) keeps the host
from pacing the result: below about 0.1 ms a call, one launch and one
synchronization measure the host's launch path, not the kernel.  The
clock and the synchronization are injectable, so tests drive the tuner
with a deterministic stub.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Measurement:
    us: float                # median microseconds a call (inf if not ok)
    reps: int
    ok: bool = True
    error: str = ""


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Harness:
    """Times zero-argument callables that enqueue work on the card."""

    def __init__(self, *, reps: int = 5, warmup: int = 1, inner: int = 10,
                 clock: Callable[[], float] = time.perf_counter,
                 sync: Optional[Callable[[], None]] = None):
        self.reps = max(1, reps)
        self.warmup = max(0, warmup)
        self.inner = max(1, inner)
        self.clock = clock
        self.sync = sync or _synchronize

    def measure(self, fn: Callable[[], object]) -> Measurement:
        try:
            for _ in range(self.warmup):
                fn()
            self.sync()
            times = []
            for _ in range(self.reps):
                t0 = self.clock()
                for _ in range(self.inner):
                    fn()
                self.sync()
                times.append((self.clock() - t0) * 1e6 / self.inner)
            return Measurement(us=statistics.median(times), reps=self.reps)
        except Exception as e:  # the candidate failed: it loses, tuning goes on
            return Measurement(us=float("inf"), reps=0, ok=False,
                               error=f"{type(e).__name__}: {e}")
