"""Arrival-clock load generation for the serving engine.

The continuous-batching engine (``launch/engine.py``) consumes a stream
of timed :class:`Request` s instead of a static list: every request
carries an ``arrival`` timestamp on a virtual clock, and the engine only
sees a request once its clock has reached that time.  Two generators:

* :func:`poisson_stream` — seeded open-loop Poisson arrivals
  (inter-arrival ~ Exp(1/rate)); ``rate == 0`` collapses to a burst at
  t = 0 (every request in-queue before the first iteration — the
  deterministic shape benchmarks prefer).
* :func:`trace_stream` — trace-driven arrivals from explicit
  ``{"t", "prompt_len" | "tokens", "max_new"}`` events (replayed
  production traces, adversarial test workloads).

Both are fully determined by their seed: same seed, same arrival times,
same prompt tokens — the property the engine's determinism tests pin.
:class:`ArrivalQueue` orders a stream by arrival (stable on ties, so
FCFS follows stream order) and pops the ready prefix each iteration.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Mapping, Optional

import numpy as np


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False
    arrival: float = 0.0
    truncated: bool = False    # finished by the context wall, not max_new


def poisson_stream(n: int, *, rate: float, vocab_size: int,
                   prompt_len: int, max_new: int, seed: int = 0,
                   prompt_jitter: int = 0, start_rid: int = 0,
                   shared_prefix_len: int = 0, shared_frac: float = 0.0
                   ) -> List[Request]:
    """``n`` seeded Poisson arrivals at ``rate`` requests per clock unit.

    ``prompt_jitter`` adds a uniform 0..jitter extension to each prompt
    length (ragged traffic); ``rate == 0`` puts every arrival at t = 0.

    ``shared_prefix_len`` > 0 models system/tool-prompt reuse: one common
    prefix of that length is drawn once per stream, and each request
    independently carries it with probability ``shared_frac`` (its unique
    tokens fill the remaining ``prompt_len - shared_prefix_len``
    positions).  The default (0, 0.0) draws exactly the same streams as
    before — the extra rng calls only happen when a prefix is configured.
    """
    if shared_prefix_len > prompt_len:
        raise ValueError(
            f"shared_prefix_len {shared_prefix_len} > prompt_len "
            f"{prompt_len}")
    rng = np.random.default_rng(seed)
    prefix = (rng.integers(0, vocab_size, shared_prefix_len)
              if shared_prefix_len > 0 else None)
    t = 0.0
    reqs: List[Request] = []
    for i in range(n):
        if rate > 0:
            t += float(rng.exponential(1.0 / rate))
        ln = prompt_len + (int(rng.integers(0, prompt_jitter + 1))
                           if prompt_jitter else 0)
        if prefix is not None and float(rng.random()) < shared_frac:
            tail = rng.integers(0, vocab_size, ln - shared_prefix_len)
            prompt = np.concatenate([prefix, tail])
        else:
            prompt = rng.integers(0, vocab_size, ln)
        reqs.append(Request(start_rid + i, prompt, max_new, arrival=t))
    return reqs


def trace_stream(trace: Iterable[Mapping], *, vocab_size: int,
                 seed: int = 0, start_rid: int = 0) -> List[Request]:
    """Trace-driven arrivals: one event per request.

    Each event is a mapping with ``t`` (arrival time, default 0.0),
    ``max_new``, and either explicit ``tokens`` or a ``prompt_len`` whose
    tokens are drawn from the seeded rng.  ``start_rid`` offsets the
    assigned rids so several streams can be mixed without collisions
    (``ServeMetrics.timelines`` and :class:`ArrivalQueue` key on rid).
    """
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    for i, ev in enumerate(trace):
        if "tokens" in ev:
            prompt = np.asarray(ev["tokens"], np.int64)
        else:
            prompt = rng.integers(0, vocab_size, int(ev["prompt_len"]))
        reqs.append(Request(start_rid + i, prompt, int(ev["max_new"]),
                            arrival=float(ev.get("t", 0.0))))
    return reqs


class ArrivalQueue:
    """A request stream ordered by arrival time on the virtual clock.

    The sort is stable, so requests arriving at the same instant keep
    their stream order (FCFS).  ``pop_ready(now)`` hands the engine every
    request whose arrival has passed; ``next_arrival()`` lets an idle
    engine jump its clock forward instead of spinning.
    """

    def __init__(self, requests: Iterable[Request]):
        self._pending: List[Request] = sorted(requests,
                                              key=lambda r: r.arrival)
        rids = [r.rid for r in self._pending]
        if len(set(rids)) != len(rids):
            dups = sorted({r for r in rids if rids.count(r) > 1})
            raise ValueError(
                f"duplicate request rids in stream: {dups} "
                "(mixing streams? pass start_rid to the generators)")
        self._i = 0

    def __len__(self) -> int:
        return len(self._pending) - self._i

    def next_arrival(self) -> Optional[float]:
        if self._i >= len(self._pending):
            return None
        return self._pending[self._i].arrival

    def pop_ready(self, now: float) -> List[Request]:
        out: List[Request] = []
        while (self._i < len(self._pending)
               and self._pending[self._i].arrival <= now):
            out.append(self._pending[self._i])
            self._i += 1
        return out
