"""The readings a cell's limits are set from, at the cell's own size, in
one process: for each seed, the number(s) a run compares, from the
program (a short window at the cell's own load for a serving cell; the
checked steps for a training cell), from the control (the reference
computed in float8, the precision below the configuration's bf16, in the
program's place) and, for a training cell, from the program with half of
each batch left out.

    python3 bench/tools/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 20] [--out FILE]

One JSON line a seed; a training cell's also holds each leaf's first
gradient difference on each side (``leaf_names``, ``leaf_diffs``).  A
state left unchanged reads 1 by the change's measure and needs no run."""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _quiet(msg: str) -> None:
    pass


def _free() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def serve_seed(cell, seed: int, seconds: float, page: int, warm: bool,
               device: str = "cuda"):
    import torch
    from benchlib import check, program, serve, traffic, window
    from reference import qwen as ref
    mix = cell.mix
    mdl = program.model(cell.config, device, torch.bfloat16)
    params = program.params(mdl, seed, device)
    sched, engine, clock = serve.engine_for(mdl, params, mix, page)
    if warm:
        engine.warmup()
    lead = float(mix["lead_in_s"])
    stream = traffic.serve_stream(mix, int(cell.config["vocab_size"]), seed,
                                  lead + seconds)
    r = serve.drive(engine, sched, clock, stream, lead, seconds)
    picked = serve.sample(r.done, seed, mix)
    serve.release((mdl, params, engine, sched))
    del engine, sched, clock
    w = program.reference_weights(params, mdl)
    t = time.perf_counter()
    prog = check.served_gap(cell.config, w, picked, device)
    t_ref = time.perf_counter() - t
    ctrl = check.served_gap(cell.config, w, picked, device, mm=ref.fp8_mm)
    out = {"seed": seed, "program": prog, "control": ctrl,
           "reference_s": t_ref,
           "requests_due": len(window.due_in(r.lines, r.t_open, r.t_close)),
           "ttft_p95_s": window.percentile(
               window.ttfts(r.lines, r.t_open, r.t_close), 95)}
    del params, w
    return out


def train_seed(cell, seed: int, device: str = "cuda"):
    from benchlib import check, train
    from reference import qwen as ref
    got = {}
    for fault in (None, "half_batch"):
        run, state = train.run(cell, seed, 0.01, False, device,
                               time.perf_counter(), _quiet, fault)
        mdl = state[0]
        train.release(state)
        del state
        got[fault] = run.readings
    ctrl = train.reference_readings(cell, mdl, seed, device, mm=ref.fp8_mm,
                                    keep_first=True)
    _free()
    t = time.perf_counter()
    refr = train.reference_readings(
        cell, mdl, seed, device,
        others={"program": got[None].pop("first_grad"),
                "half_batch": got["half_batch"].pop("first_grad"),
                "control": ctrl.pop("first_grad")})
    t_ref = time.perf_counter() - t
    diff, leaf = refr["grad_diff"], refr["grad_diff_leaf"]
    return {"seed": seed,
            "program": check.train_numbers(got[None], refr,
                                           diff["program"], leaf["program"]),
            "control": check.train_numbers(ctrl, refr, diff["control"],
                                           leaf["control"]),
            "half_batch": check.train_numbers(got["half_batch"], refr,
                                              diff["half_batch"],
                                              leaf["half_batch"]),
            "leaf_names": refr["leaf_names"], "leaf_diffs": leaf,
            "reference_s": t_ref,
            "losses": {"program": got[None]["losses"],
                       "reference": refr["losses"],
                       "control": ctrl["losses"]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "bench")]
    import torch
    from benchlib import program, spec
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    cell = spec.cell(ROOT, args.workload)
    program.build_library()
    serving = cell.mix["kind"] == "serve_open"
    page = 0
    if serving:
        page = int(cell.mix.get("page_size", 0)) or program.plans_and_page(
            cell.config, int(cell.mix["max_len"]), print)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        line = serve_seed(cell, seed, args.seconds, page, i == 0) \
            if serving else train_seed(cell, seed)
        line["seconds"] = time.perf_counter() - t
        line["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        _free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
