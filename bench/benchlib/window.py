"""Window arithmetic on the host's wall clock (``time.perf_counter``).

``WallClock`` takes the serving engine's metric events (the program's
``ServeMetrics`` interface) and stamps each with the wall clock when it
happens, ignoring the engine's virtual clock; the benchmark adds the
time each request was due.  The summaries count what a window [open,
close) saw: a request with no first token at the close counts the wait
it has had so far, and each decoding request's open gap at the close
counts as a gap.  Percentiles are linear between order statistics, as
``numpy.percentile`` takes them (the program's ``ServeMetrics``
arithmetic).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


def percentile(values, q: float) -> Optional[float]:
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


@dataclass
class Timeline:
    rid: int
    due: float
    admitted: Optional[float] = None
    tokens: List[float] = field(default_factory=list)
    finished: Optional[float] = None
    failed: bool = False


class WallClock:
    """The engine's metrics sink, on the wall clock."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.lines: Dict[int, Timeline] = {}

    def due(self, rid: int, t: float) -> None:
        self.lines[rid] = Timeline(rid, t)

    # the program's ServeMetrics events (those an engine without an
    # arrival queue or a drafter sends); ``t`` is its virtual clock
    def on_admit(self, rid: int, t: float) -> None:
        self.lines[rid].admitted = self.clock()

    def on_token(self, rid: int, t: float) -> None:
        self.lines[rid].tokens.append(self.clock())

    def on_finish(self, rid: int, t: float) -> None:
        self.lines[rid].finished = self.clock()

    def on_reject(self, rid: int, t: float) -> None:
        self.lines[rid].failed = True

    def on_truncate(self, rid: int) -> None:
        self.lines[rid].failed = True


def due_in(lines, t_open: float, t_close: float) -> List[Timeline]:
    return [tl for tl in lines if t_open <= tl.due < t_close]


def ttfts(lines, t_open: float, t_close: float) -> List[float]:
    """First token minus due time of each request due in the window; the
    wait so far where no first token came by the close."""
    out = []
    for tl in due_in(lines, t_open, t_close):
        first = tl.tokens[0] if tl.tokens and tl.tokens[0] <= t_close \
            else t_close
        out.append(first - tl.due)
    return out


def queue_waits(lines, t_open: float, t_close: float) -> List[float]:
    """Admission minus due time of each request due in the window; the
    wait so far where it was not admitted by the close."""
    out = []
    for tl in due_in(lines, t_open, t_close):
        adm = tl.admitted if tl.admitted is not None \
            and tl.admitted <= t_close else t_close
        out.append(adm - tl.due)
    return out


def token_gaps(lines, t_open: float, t_close: float) -> List[float]:
    """Gaps between consecutive output tokens of one request that end in
    (open, close], and the gap still open at the close of every request
    that has a token and is not finished."""
    out = []
    for tl in lines:
        ts = [t for t in tl.tokens if t <= t_close]
        out.extend(b - a for a, b in zip(ts, ts[1:]) if b > t_open)
        done = tl.finished is not None and tl.finished <= t_close
        if ts and not done and not tl.failed:
            out.append(t_close - ts[-1])
    return out


def tokens_in(lines, t_open: float, t_close: float) -> int:
    return sum(1 for tl in lines for t in tl.tokens if t_open < t <= t_close)


def steps_rate(step_ends: List[float], t_open: float, tokens_per_step: int
               ) -> Optional[float]:
    """Tokens a second over whole steps: the window runs from ``t_open``
    to the end of the last step."""
    if not step_ends:
        return None
    return len(step_ends) * tokens_per_step / (step_ends[-1] - t_open)
