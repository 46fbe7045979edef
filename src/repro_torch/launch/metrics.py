"""Latency metrics for the serving engine.

Records one :class:`RequestTimeline` per request on the engine's virtual
clock (seconds in ``clock="wall"`` mode, ticks in ``clock="tick"`` mode)
and summarizes the two latencies production serving is judged on:

* **time-to-first-token (TTFT)** — first generated token's timestamp
  minus the request's *arrival* (so queueing delay counts, not just
  prefill compute);
* **per-token latency** — gaps between consecutive generated-token
  timestamps of one request (the inter-token decode cadence).

``summary()`` emits p50/p99 for both, the shape ``BENCH_serve.json``
rows carry and ``scripts/check_bench.py`` gates.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class RequestTimeline:
    rid: int
    arrival: float
    admitted: Optional[float] = None
    first_token: Optional[float] = None
    finished: Optional[float] = None
    token_times: List[float] = field(default_factory=list)


class ServeMetrics:
    """Per-request event sink + percentile summaries."""

    def __init__(self):
        self.timelines: Dict[int, RequestTimeline] = {}
        self.rejected: List[int] = []
        self.truncated: List[int] = []
        # Speculative decoding tallies (zero unless a drafter is active).
        self.spec_steps = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_emitted = 0

    def _tl(self, rid: int, t: float = 0.0) -> RequestTimeline:
        if rid not in self.timelines:
            self.timelines[rid] = RequestTimeline(rid, t)
        return self.timelines[rid]

    def on_arrival(self, rid: int, t: float) -> None:
        self.timelines[rid] = RequestTimeline(rid, t)

    def on_admit(self, rid: int, t: float) -> None:
        self._tl(rid, t).admitted = t

    def on_token(self, rid: int, t: float) -> None:
        tl = self._tl(rid, t)
        if tl.first_token is None:
            tl.first_token = t
        tl.token_times.append(t)

    def on_finish(self, rid: int, t: float) -> None:
        self._tl(rid, t).finished = t

    def on_reject(self, rid: int, t: float) -> None:
        self._tl(rid, t)
        self.rejected.append(rid)

    def on_truncate(self, rid: int) -> None:
        self.truncated.append(rid)

    def on_spec_step(self, drafted: int, accepted: int, emitted: int) -> None:
        """One slot's verify outcome: ``drafted`` candidates proposed,
        ``accepted`` of them matched the target, ``emitted`` tokens
        entered the stream (accepted + the bonus token, capped by the
        request's remaining budget)."""
        self.spec_steps += 1
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        self.spec_emitted += emitted

    # ----------------------------------------------------------- summaries
    def ttfts(self) -> List[float]:
        return [tl.first_token - tl.arrival
                for tl in self.timelines.values()
                if tl.first_token is not None]

    def token_gaps(self) -> List[float]:
        gaps: List[float] = []
        for tl in self.timelines.values():
            ts = tl.token_times
            gaps.extend(b - a for a, b in zip(ts, ts[1:]))
        return gaps

    @staticmethod
    def percentile(values: List[float], q: float) -> Optional[float]:
        if not values:
            return None
        return float(np.percentile(np.asarray(values, np.float64), q))

    def summary(self) -> Dict[str, Optional[float]]:
        ttfts = self.ttfts()
        gaps = self.token_gaps()
        new_tokens = sum(len(tl.token_times)
                         for tl in self.timelines.values())
        finished = [tl for tl in self.timelines.values()
                    if tl.finished is not None]
        span = (max(tl.finished for tl in finished)
                - min(tl.arrival for tl in finished)) if finished else None
        return {
            "requests_finished": len(finished),
            "requests_rejected": len(self.rejected),
            "requests_truncated": len(self.truncated),
            "new_tokens": new_tokens,
            "ttft_p50": self.percentile(ttfts, 50),
            "ttft_p99": self.percentile(ttfts, 99),
            "tok_latency_p50": self.percentile(gaps, 50),
            "tok_latency_p99": self.percentile(gaps, 99),
            "clock_span": span,
            "spec_accept_rate": (self.spec_accepted / self.spec_drafted
                                 if self.spec_drafted else None),
            "spec_tokens_per_step": (self.spec_emitted / self.spec_steps
                                     if self.spec_steps else None),
        }
