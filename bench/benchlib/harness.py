"""One run of one cell: set-up, the measured window, the metrics the
cell reports, and the check that decides ``correct``.  ``run_cell``
takes the device as an argument, so that the tests can drive the whole
run on the CPU at a small size; ``bench/run.py`` gives it the card."""
from __future__ import annotations

import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from . import check, flops, program, serve, spec, train
from .peaks import peaks


@dataclass
class Ctx:
    """What a metric's reader may read (``bench/metrics/<name>.py``)."""
    kind: str                          # "serve" | "train"
    sizes: flops.Sizes
    peaks: Dict
    setup_s: float
    serve: Optional[serve.ServeRun] = None
    train: Optional[train.TrainRun] = None
    traces: List = field(default_factory=list)

    @property
    def trace(self):
        return self.traces[0] if self.traces else None


def card(device: str) -> Dict:
    """The card's name and power limit (nvidia-smi), or the CPU."""
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "power_limit": "n/a"}
    limit = "unknown"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        limit = out.stdout.strip().splitlines()[0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "power_limit": limit}


def run_cell(root: Path, cell: spec.Cell, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             log: Callable = print, fault: Optional[str] = None) -> Dict:
    dev = card(device)
    log(f"device {dev['kind']} power_limit={dev['power_limit']} "
        f"cell={cell.name} seed={seed} seconds={seconds} trace={int(trace)}")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    kind = cell.mix["kind"]
    if kind == "serve_open":
        run, state = serve.run(cell, seed, seconds, trace, device, t_start,
                               log, fault)
    elif kind == "train":
        run, state = train.run(cell, seed, seconds, trace, device, t_start,
                               log, fault)
    else:
        raise ValueError(f"mix kind {kind!r}")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    log(f"memory_peak_bytes={peak}")
    log("counters " + str(program.counters()))
    setup_s = run.t_open - t_start
    log("setup_s=" + repr(setup_s) + " " + " ".join(
        f"{k}={v!r}" for k, v in run.setup.items()))

    ctx = Ctx("serve" if kind == "serve_open" else "train",
              flops.sizes(cell.config), peaks(dev["kind"]), setup_s,
              run if kind == "serve_open" else None,
              run if kind == "train" else None, run.traces)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(root, m.name)(ctx)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    attempted, failed = _counts(ctx, log)

    mdl = state[0]
    if kind == "serve_open":
        picked = serve.sample(run.done, seed, cell.mix)
        params = state[1]
        serve.release(state)
        del state
        numbers = serve.judge(cell, mdl, params, picked, device) \
            if picked else {}
        del params
    else:
        train.release(state)
        del state
        numbers = train.judge(cell, mdl, run, seed, device)
    log("check " + " ".join(f"{k}={v!r}" for k, v in numbers.items()))
    verdicts = check.verdict(numbers, cell.limits)
    correct = bool(numbers) and all(v["ok"] for v in verdicts)

    out_dev = {"platform": dev["platform"], "kind": dev["kind"],
               "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": out_dev}
    if trace:
        t = ctx.trace
        if t is None:
            raise RuntimeError("the traced stretch saw no device time")
        out_dev["busy_s"] = t.busy_s()
        out_dev["window_s"] = t.window_s
        result["breakdown"] = {"device_ops": t.top_ops(10),
                               "idle_gaps": t.idle_gaps(10)}
    result["checks"] = {v["name"]: {"value": v["value"], "limit": v["limit"]}
                        for v in verdicts}
    for v in verdicts:
        print(f"check {v['name']} {v['value']!r} limit {v['limit']!r} "
              f"{'ok' if v['ok'] else 'FAILED'}", file=sys.stderr)
    return result


def _counts(ctx: Ctx, log) -> tuple:
    """(attempted, failed): requests due in the window and those rejected
    or truncated; or steps in the window and those with a loss that is
    not finite."""
    if ctx.kind == "serve":
        from .window import (due_in, percentile, queue_waits, token_gaps,
                             tokens_in, ttfts)
        r = ctx.serve
        a, b = r.t_open, r.t_close
        due = due_in(r.lines, a, b)
        gaps = token_gaps(r.lines, a, b)
        log(f"samples: requests_due={len(due)} token_gaps={len(gaps)} "
            f"output_tokens={tokens_in(r.lines, a, b)} "
            f"finished_total={len(r.done)} iterations={len(r.iterations)} "
            f"generator_late_s={r.lateness_s!r} "
            f"window_counters={r.counters}")
        log(f"window: ttft_p50_s={percentile(ttfts(r.lines, a, b), 50)!r} "
            f"ttft_p95_s={percentile(ttfts(r.lines, a, b), 95)!r} "
            f"itl_p95_ms={1e3 * (percentile(gaps, 95) or 0.0)!r} "
            f"queue_wait_p95_s={percentile(queue_waits(r.lines, a, b), 95)!r}"
            f" output_tokens_per_s={tokens_in(r.lines, a, b) / (b - a)!r}")
        log("kv " + " ".join(f"{k}={v!r}" for k, v in r.kv.items()))
        return len(due), sum(1 for tl in due if tl.failed)
    r = ctx.train
    bad = sum(1 for x in r.losses if x != x or x in (float("inf"),
                                                     float("-inf")))
    log(f"samples: steps={len(r.step_ends)} "
        f"tokens_per_step={r.tokens_per_step} "
        f"checked_losses={r.readings['losses']}")
    return len(r.step_ends), bad
