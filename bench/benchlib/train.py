"""A training cell: the step ``train/steps.make_train_step`` builds, on
the benchmark's weights and batches.

Set-up builds one training state (float32 master weights, AdamW) and
drives it through the checked steps, the window's own call and feed on
rows that all differ; the readings the check needs are taken there (each
step's loss, the first clipped gradient from the moments after step 1,
the change of every leaf after the last checked step).  The window then
runs further steps back to back until ``--seconds`` have passed, each
ending in a host read of its loss.  After the close the state is freed
and the reference follows the checked steps from the same weights and
batches."""
from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import check, program, traffic
from . import weights as W
from .trace import Tracer

from reference import qwen as ref


@dataclass
class TrainRun:
    t_open: float
    step_ends: List[float]
    losses: List[float]
    tokens_per_step: int
    seq_len: int
    traces: list
    readings: Dict
    setup: Dict[str, float]
    all_step_ends: List[float] = field(default_factory=list)


def _span(trace: bool, name: str):
    if not trace:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


def _fault(step_fn, fault: Optional[str]):
    """Faults the check must catch: a step that leaves the parameters as
    they were; a step on half of the batch (the mean over the rest)."""
    if fault == "unchanged":
        def unchanged(p, o, b):
            keep = [t.clone() for _, t in W.walk(p)]
            p, o, m = step_fn(p, o, b)
            for (_, t), k in zip(W.walk(p), keep):
                t.copy_(k)
            return p, o, m
        return unchanged
    if fault == "half_batch":
        def half(p, o, b):
            n = b["tokens"].shape[0] // 2
            return step_fn(p, o, {k: v[:n] for k, v in b.items()})
        return half
    return step_fn


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, log: Callable, fault: Optional[str] = None):
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.steps import TrainStepConfig, make_train_step

    mix, config = cell.mix, cell.config
    setup: Dict[str, float] = {}
    t = time.perf_counter()
    if device == "cuda":
        program.build_library()
    setup["build_s"] = time.perf_counter() - t

    t = time.perf_counter()
    program.plans(log)
    mdl = program.model(config, device, torch.float32)
    params = program.params(mdl, seed, device)
    opt_cfg = AdamWConfig(**mix["optimizer"])
    opt = adamw_init(params, opt_cfg)
    step_fn = _fault(make_train_step(mdl, TrainStepConfig(opt=opt_cfg)),
                     fault)
    cdf = traffic.zipf_cdf(int(config["vocab_size"]),
                           float(mix["tokens"]["exponent"]), device)
    if device == "cuda":
        torch.cuda.synchronize()
    setup["weights_s"] = time.perf_counter() - t

    t = time.perf_counter()
    checked = int(mix["checked_steps"])
    losses: List[float] = []
    readings: Dict = {}
    for n in range(1, checked + 1):
        tokens, labels = traffic.train_batch(mix, cdf, seed, n)
        params, opt, metrics = step_fn(params, opt, {"tokens": tokens,
                                                     "labels": labels})
        losses.append(float(metrics["loss"]))
        if n == 1:
            # the clipped gradient as AdamW got it: m = (1 - b1) g; kept
            # on the host for the reference's first step
            scale = 1.0 / (1 - opt_cfg.b1)
            ms = [m for _, m in W.walk(opt.m)]
            readings["grad_norms"] = [float(m.norm()) * scale for m in ms]
            readings["first_grad"] = [(m * scale).cpu() for m in ms]
            del ms
    readings["losses"] = list(losses)
    readings["change_norms"] = _change_norms(params, mdl, seed, device)
    if device == "cuda":
        torch.cuda.synchronize()
    setup["checked_steps_s"] = time.perf_counter() - t
    program.reset_counters()

    tokens_per_step = int(mix["batch"]) * int(mix["seq_len"])
    t_open = time.perf_counter()
    setup["other_s"] = t_open - t_start - sum(setup.values())
    state = {"n": checked, "params": params, "opt": opt, "marked": False}

    def one_step() -> float:
        state["n"] += 1
        on = state["marked"]
        with _span(on, "bench.feed"):
            tokens, labels = traffic.train_batch(mix, cdf, seed, state["n"])
        with _span(on, "bench.step"):
            state["params"], state["opt"], metrics = step_fn(
                state["params"], state["opt"], {"tokens": tokens,
                                                "labels": labels})
        with _span(on, "bench.read_loss"):
            losses.append(float(metrics["loss"]))
        return time.perf_counter()

    # the window: whole steps until ``seconds`` have passed, unprofiled
    # and unmarked; with ``trace`` the steps run on after the close for
    # ``trace_s`` seconds under the profiler, a stretch read only by the
    # metrics of the device trace
    step_ends: List[float] = []
    while not step_ends or step_ends[-1] - t_open < seconds:
        step_ends.append(one_step())
    all_ends = list(step_ends)
    traces = []
    if trace:
        trace_s = float(mix.get("trace_s", seconds))
        state["marked"] = True
        tracer = Tracer(torch)
        tracer.start()
        stop = time.perf_counter() + trace_s
        while time.perf_counter() < stop:
            all_ends.append(one_step())
        traces = [t for t in [tracer.stop()] if t is not None]
    params, opt = state["params"], state["opt"]
    window_losses = losses[checked:checked + len(step_ends)]
    return TrainRun(t_open, step_ends, window_losses, tokens_per_step,
                    int(mix["seq_len"]), traces, readings, setup,
                    all_ends), (mdl, params, opt, step_fn)


def _change_norms(params, mdl, seed: int, device) -> List[float]:
    """|p - p0| of every leaf, p0 made again from the seed leaf by
    leaf."""
    out = []
    for i, ((path, p), (_, spec)) in enumerate(
            zip(W.walk(params), W.walk(mdl.param_specs()))):
        p0 = W.make_leaf(path, spec.shape, torch.float32, device, seed, i)
        out.append(float((p.float() - p0).norm()))
        del p0
    return out


def release(state) -> None:
    mdl, params, opt, step_fn = state
    del params, opt, step_fn, state
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_readings(cell, mdl, seed: int, device: str, mm=ref.fp32_mm,
                       others: Optional[Dict] = None,
                       keep_first: bool = False) -> Dict:
    """The reference's losses, first clipped gradient norms (and raw
    ones) and change norms over the checked steps, from the seed's
    weights and batches.  ``others`` maps names to first clipped
    gradients (host leaves, in walk order); ``grad_diff`` in the result
    gives each one's ||g - g_ref|| / ||g_ref|| over all leaves, and
    ``grad_diff_leaf`` its ||g - g_ref|| leaf by leaf over max(the
    reference's norm of the leaf, the median leaf's), in walk order (the
    leaves' names in ``leaf_names``); with ``keep_first`` the first
    clipped gradients come back on the host (``first_grad``)."""
    ref.exact_fp32()
    mix, config = cell.mix, cell.config
    specs = mdl.param_specs()
    leaves = [W.make_leaf(path, spec.shape, torch.float32, device, seed, i)
              for i, (path, spec) in enumerate(W.walk(specs))]
    cdf = traffic.zipf_cdf(int(config["vocab_size"]),
                           float(mix["tokens"]["exponent"]), device)
    batches = [traffic.train_batch(mix, cdf, seed, n)
               for n in range(1, int(mix["checked_steps"]) + 1)]

    def build(ls):
        return program.reference_weights(W.rebuild(specs, ls), mdl)
    diffs: Dict[str, float] = {}
    by_leaf: Dict[str, List[float]] = {}
    kept: List = []

    def compare(clipped):
        if keep_first:
            kept.extend(g.cpu() for g in clipped)
        sq = [float(g.double().square().sum()) for g in clipped]
        med = float(np.median(sq)) ** 0.5
        for name, theirs in (others or {}).items():
            d = [float((t.to(g.device) - g).double().square().sum())
                 for t, g in zip(theirs, clipped)]
            diffs[name] = (sum(d) / sum(sq)) ** 0.5
            by_leaf[name] = [(a / max(b, med ** 2)) ** 0.5
                             for a, b in zip(d, sq)]
    out = ref.train_steps(leaves, build, batches, ref.spec_of(config),
                          ref.AdamW(**mix["optimizer"]), mm,
                          on_first=compare if others or keep_first
                          else None)
    out["grad_diff"] = diffs
    out["grad_diff_leaf"] = by_leaf
    out["leaf_names"] = ["/".join(map(str, path))
                         for path, _ in W.walk(specs)]
    if keep_first:
        out["first_grad"] = kept
    out["change_norms"] = []
    for i, ((path, spec), p) in enumerate(zip(W.walk(specs), leaves)):
        p0 = W.make_leaf(path, spec.shape, torch.float32, device, seed, i)
        out["change_norms"].append(float((p - p0).norm()))
    return out


def judge(cell, mdl, run_: TrainRun, seed: int, device: str) -> Dict:
    first = run_.readings.pop("first_grad")
    refr = reference_readings(cell, mdl, seed, device,
                              others={"program": first})
    del first
    return check.train_numbers(run_.readings, refr,
                               refr["grad_diff"]["program"],
                               refr["grad_diff_leaf"]["program"])
