"""Find a serving cell's knee: its traffic at rising rates, one process,
one model; a fresh scheduler and engine for each rate.

    python3 bench/tools/sweep.py --workload codeqwen7b.code.open \\
        --seed 7 --rates 2,3,4,5 --lead 10 --seconds 40 [--out FILE]

One JSON line a rate: the window's TTFT and ITL percentiles, output
tokens a second, requests due and finished, and the backlog (requests
waiting for a slot): its mean over the window's first and last thirds
and its least-squares slope in requests a second.  The knee is the
highest rate whose backlog does not grow."""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--lead", type=float, default=10.0)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "bench")]
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from benchlib import program, serve, spec, traffic, window
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 3
    cell = spec.cell(ROOT, args.workload)
    program.build_library()
    mix = dict(cell.mix, lead_in_s=args.lead)
    page = int(mix.get("page_size", 0)) or program.plans_and_page(
        cell.config, int(mix["max_len"]), print)
    mdl = program.model(cell.config, "cuda", torch.bfloat16)
    params = program.params(mdl, args.seed, "cuda")
    warm = True
    for rate in [float(r) for r in args.rates.split(",")]:
        mix["rate_per_s"] = rate
        sched, engine, clock = serve.engine_for(mdl, params, mix, page)
        if warm:
            engine.warmup()
            warm = False
        stream = traffic.serve_stream(mix, int(cell.config["vocab_size"]),
                                      args.seed, args.lead + args.seconds)
        backlog = []
        r = serve.drive(engine, sched, clock, stream, args.lead,
                        args.seconds, backlog=backlog)
        pts = [(t, w, a) for t, w, a in backlog if t >= args.lead]
        ts = np.array([p[0] for p in pts])
        ws = np.array([p[1] for p in pts], float)
        third = args.seconds / 3
        first = ws[ts < args.lead + third]
        last = ws[ts >= args.lead + 2 * third]
        due = window.due_in(r.lines, r.t_open, r.t_close)
        line = {
            "rate_per_s": rate,
            "ttft_p50_s": window.percentile(
                window.ttfts(r.lines, r.t_open, r.t_close), 50),
            "ttft_p95_s": window.percentile(
                window.ttfts(r.lines, r.t_open, r.t_close), 95),
            "itl_p95_ms": 1e3 * window.percentile(
                window.token_gaps(r.lines, r.t_open, r.t_close), 95),
            "output_tokens_per_s": window.tokens_in(
                r.lines, r.t_open, r.t_close) / args.seconds,
            "requests_due": len(due),
            "requests_finished": sum(1 for tl in due
                                     if tl.finished is not None),
            "backlog_first_third": float(first.mean()) if len(first) else None,
            "backlog_last_third": float(last.mean()) if len(last) else None,
            "backlog_slope_per_s": float(np.polyfit(ts, ws, 1)[0])
            if len(ts) > 2 else None,
            "slots_in_use_mean": float(np.mean([p[2] for p in pts]))
            if pts else None,
            "iteration_ms_mean": 1e3 * float(np.mean(
                [i.t1 - i.t0 for i in r.iterations])) if r.iterations
            else None,
            "prefill_ms_per_call": 1e3 * r.counters["t_prefill"]
            / max(1, r.counters["prefill_calls"]),
            "decode_ms_per_step": 1e3 * r.counters["t_decode"]
            / max(1, r.counters["decode_steps"]),
            "card": torch.cuda.get_device_name(0),
        }
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        sched.cache = None
        del sched, engine, clock, r
        gc.collect()
        torch.cuda.empty_cache()
        time.sleep(1.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
