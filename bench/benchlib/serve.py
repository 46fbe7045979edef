"""A serving cell: the program's ``ContinuousEngine`` over a
``PagedScheduler``, driven open-loop on the wall clock.

The benchmark hands each request to the engine's waiting list when it is
due, calls ``engine.step()`` while there is work and sleeps until the
next due time when there is none.  The engine's metric events go to
``window.WallClock``; its virtual clock is never read.  A lead-in of the
same traffic runs before the window opens, so that occupancy has settled;
it counts as set-up.  After the close the program's state is freed and
the reference scores a sample of the finished requests (see
``check.served_gap``)."""
from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import check, flops, program, traffic
from .trace import Tracer
from .window import WallClock


@dataclass
class Iteration:
    t0: float
    t1: float = 0.0
    chunks: List[Tuple[int, int]] = field(default_factory=list)
    decode: List[int] = field(default_factory=list)

    def forward(self) -> flops.Forward:
        return flops.Forward(self.chunks, self.decode)


@dataclass
class ServeRun:
    """What a serving run leaves for the metrics and the check."""
    t_open: float
    t_close: float
    lines: list
    iterations: List[Iteration]
    counters: Dict[str, float]
    traces: list
    done: list                      # (rid, prompt, out) of finished ones
    lateness_s: float
    setup: Dict[str, float]
    all_iterations: List[Iteration] = field(default_factory=list)
    kv: Dict[str, float] = field(default_factory=dict)


def _record_plans(engine, sched, iters: List[Iteration]) -> None:
    """Keep, for each iteration, the chunks (start, real tokens) and the
    decode rows (keys attended) its composed plan holds."""
    compose = engine.policy.compose

    def recorded(running, prefilling, drafts=None):
        plan = compose(running, prefilling, drafts=drafts)
        it = iters[-1]
        for slot, st in plan.prefill:
            it.chunks.append((int(st), int(min(engine.states[slot].ln,
                                                st + sched.page) - st)))
        it.decode.extend(int(sched.lengths[s]) + 1 for s in plan.decode)
        return plan
    engine.policy.compose = recorded


def _mark(obj, name: str, label: str) -> None:
    from torch.profiler import record_function
    fn = getattr(obj, name)

    def marked(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    setattr(obj, name, marked)


def _alter_tokens(executor, vocab: int) -> None:
    """Fault: every decode token is replaced where it is produced."""
    decode = executor.decode

    def altered(cur, slots):
        return (decode(cur, slots) + 1) % vocab
    executor.decode = altered


def engine_for(mdl, params, mix: Dict, page: int):
    """A fresh scheduler (its own pools) and engine over the model."""
    from repro_torch.launch.engine import ContinuousEngine
    from repro_torch.launch.serve import PagedScheduler
    sched = PagedScheduler(mdl, params, slots=int(mix["slots"]),
                           max_len=int(mix["max_len"]), page_size=page,
                           prefix_cache=bool(mix.get("prefix_cache", False)),
                           log=None)
    clock = WallClock()
    engine = ContinuousEngine(sched, token_budget=int(mix.get(
        "token_budget", 0)), clock="wall", metrics=clock, log=None)
    return sched, engine, clock


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, log: Callable, fault: Optional[str] = None):
    mix, config = cell.mix, cell.config
    setup: Dict[str, float] = {}
    t = time.perf_counter()
    if device == "cuda":
        program.build_library()
    setup["build_s"] = time.perf_counter() - t

    t = time.perf_counter()
    page = int(mix.get("page_size", 0)) or program.plans_and_page(
        config, int(mix["max_len"]), log)
    mdl = program.model(config, device, torch.bfloat16)
    params = program.params(mdl, seed, device)
    if device == "cuda":
        torch.cuda.synchronize()
    setup["weights_s"] = time.perf_counter() - t

    t = time.perf_counter()
    sched, engine, clock = engine_for(mdl, params, mix, page)
    engine.warmup()
    if device == "cuda":
        torch.cuda.synchronize()
    setup["warmup_s"] = time.perf_counter() - t
    log(f"pool pages={sched.alloc.total} page_size={sched.page} "
        f"slots={sched.slots} max_len={sched.max_len}")

    lead = float(mix["lead_in_s"])
    trace_s = float(mix.get("trace_s", seconds)) if trace else 0.0
    # the stream runs on past the close for the traced stretch
    stream = traffic.serve_stream(mix, int(config["vocab_size"]), seed,
                                  lead + seconds + trace_s + 1.0)
    if fault == "token":
        _alter_tokens(engine.executor, int(config["vocab_size"]))
    setup["other_s"] = time.perf_counter() - t_start - sum(setup.values())
    out = drive(engine, sched, clock, stream, lead, seconds, trace_s)
    out.setup = {**setup, **out.setup}
    return out, (mdl, params, engine, sched)


def drive(engine, sched, clock, stream, lead: float, seconds: float,
          trace_s: float = 0.0, backlog: Optional[list] = None) -> ServeRun:
    """Serve ``stream`` open-loop: a lead-in of ``lead`` seconds, then the
    window of ``seconds``.  Nothing in the window is profiled or marked,
    so what the window's host clock reads is what an untraced run reads.
    With ``trace_s`` the stream runs on past the close and the profiler
    traces the next ``trace_s`` seconds, with the ``bench.*`` host ranges
    marked; that stretch is reduced afterwards and read only by the
    metrics of the device trace.  ``backlog`` collects (time, requests
    waiting, slots in use) after each iteration."""
    iters: List[Iteration] = []
    _record_plans(engine, sched, iters)
    program.reset_counters()
    ex = engine.executor

    def counts():
        return {"t_prefill": ex.t_prefill, "prefill_calls": ex.prefill_calls,
                "t_decode": ex.t_decode, "decode_steps": sched.decode_steps}
    t_lead = time.perf_counter()
    t_open, t_close = t_lead + lead, t_lead + lead + seconds
    state = {"next": 0, "late": 0.0, "marked": False}
    live_kv: List[int] = []

    def tick(until: float) -> None:
        """Hand over what is due, then one engine iteration, or a sleep
        until the next due time when there is no work."""
        now = time.perf_counter()
        while state["next"] < len(stream) \
                and t_lead + stream[state["next"]].due <= now:
            r = stream[state["next"]]
            due = t_lead + r.due
            if t_open <= due < t_close:
                state["late"] = max(state["late"], now - due)
            clock.due(r.rid, due)
            engine.waiting.append(_request(r))
            state["next"] += 1
        if not (engine.waiting or any(a is not None for a in sched.active)):
            nxt = state["next"]
            wake = t_lead + stream[nxt].due if nxt < len(stream) else until
            time.sleep(max(0.0, min(wake, until) - time.perf_counter()))
            return
        iters.append(Iteration(now))
        with _span(state["marked"], "bench.engine_step"):
            engine.step()
        iters[-1].t1 = time.perf_counter()
        if t_open <= now < t_close:
            live_kv.append(sched.kv_bytes_resident())
        if backlog is not None:
            backlog.append((iters[-1].t1 - t_lead, len(engine.waiting),
                            sum(a is not None for a in sched.active)))

    while time.perf_counter() < t_open:
        tick(t_open)
    snap, lead_s = counts(), time.perf_counter() - t_lead
    while time.perf_counter() < t_close:
        tick(t_close)
    end = counts()
    traces = []
    if trace_s:
        _mark(engine.executor, "prefill", "bench.prefill")
        _mark(engine.executor, "decode", "bench.decode")
        state["marked"] = True
        tracer = Tracer(torch)
        tracer.start()
        stop = time.perf_counter() + trace_s
        while time.perf_counter() < stop:
            tick(stop)
        traces = [t for t in [tracer.stop()] if t is not None]
    done = [(r.rid, np.asarray(r.prompt), list(r.out)) for r in engine.done]
    kv = {"max_resident_kv_bytes": engine.max_resident_kv_bytes,
          "live_kv_bytes_max": max(live_kv, default=0),
          "live_kv_bytes_mean": float(np.mean(live_kv)) if live_kv else 0.0,
          "pool_bytes": sched.alloc.total * sched._page_bytes}
    return ServeRun(t_open, t_close, list(clock.lines.values()),
                    [i for i in iters if t_open <= i.t0 < t_close],
                    {k: end[k] - snap[k] for k in end}, traces, done,
                    state["late"], {"lead_in_s": lead_s}, iters, kv)


def _span(on: bool, name: str):
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


def _request(r):
    from repro_torch.launch.loadgen import Request
    return Request(r.rid, r.prompt, r.max_new)


def release(state) -> None:
    """Free the program's state (pools, engine); the weights stay."""
    mdl, params, engine, sched = state
    sched.cache = None
    engine.sched = None
    del engine, sched, state
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sample(done, seed: int, mix: Dict) -> list:
    """Finished requests for the check: the one with most output tokens,
    then others in an order drawn from the seed, until ``min_tokens``
    served tokens or ``max_requests`` requests."""
    rule = mix["check"]
    if not done:
        return []
    first = max(range(len(done)),
                key=lambda i: (len(done[i][2]), len(done[i][1])))
    rng = np.random.default_rng(int(seed) + 1)
    order = [first] + [i for i in rng.permutation(len(done)) if i != first]
    out, tokens = [], 0
    for i in order:
        if tokens >= rule["min_tokens"] or len(out) >= rule["max_requests"]:
            break
        out.append(done[i])
        tokens += len(done[i][2])
    return out


def judge(cell, mdl, params, picked, device: str) -> Dict:
    return check.served_gap(cell.config, program.reference_weights(params,
                                                                   mdl),
                            picked, device)
