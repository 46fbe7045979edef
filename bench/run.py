"""Run one benchmark cell once and print its result as one JSON line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The cell, its configuration, traffic mix,
limits and metrics are found by name from ``BENCHMARK.json`` (see
``bench/benchlib/spec.py``).  Set-up (the kernel library's build on a
checkout's first run, the weights, the warm-up and any lead-in traffic)
runs before the window; the window lasts ``--seconds``; then the
program's output is checked against the plain reference.  ``--trace 1``
reports the per-layer metrics in place of the end-to-end ones: those of
the host clock from the window, which runs unprofiled as ever, and those
of the device trace from a stretch profiled after the close.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), without the program's sources, or when the
process has loaded JAX or the JAX package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in BANNED})


def log(msg: str) -> None:
    print(f"[bench] {msg}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print("bench: the program's sources (src/repro_torch) are missing",
              file=sys.stderr)
        return 2
    # the program's caches stay in this checkout, at fixed paths
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    sys.path[:0] = [str(src), str(ROOT / "bench")]

    import torch
    # one process with few threads: the host's other cores stay free
    torch.set_num_threads(1)
    from benchlib import harness, spec

    if not torch.cuda.is_available():
        print("bench: no CUDA card", file=sys.stderr)
        return 3
    cell = spec.cell(ROOT, args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"bench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    result = harness.run_cell(ROOT, cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START, log)
    bad = banned_modules()
    if bad:
        print(f"bench: the process loaded {bad}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
