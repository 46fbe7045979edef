#!/usr/bin/env python3
"""chip_smoke.py's serve profile on one NVIDIA GPU, for this checkout's
port or another checkout's: device time by kernel group and the idle
share over the decode steps and the prefill calls of the continuous
float and int8 + prefix serve runs.

    python3 tools/serve_profile.py [--src DIR]

``--src`` names the ``src`` directory of another checkout (an earlier
commit unpacked with ``git archive``), whose ``repro_torch`` then runs
under this checkout's profile, so that an earlier commit's prefill calls
are measured the way chip_smoke.py measures this one's; that checkout
builds its kernels into its own ``build/``.  One JSON line per run, as
chip_smoke.py prints it.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch to profile")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import cuda
    from repro_torch.launch import serve
    print(cuda.library_path(), flush=True)
    if not hasattr(serve, "Server"):
        # a port from before the dense cache serves paged and has no
        # --cache flag
        chip_smoke.SERVE_ARGS = [a for a in chip_smoke.SERVE_ARGS
                                 if a not in ("--cache", "paged")]
    # the prefill kernel's name before the wgmma route (one SIMT kernel)
    chip_smoke.KERNEL_GROUPS += (("prefill_kernel",
                                  "B3/B4b prefill attention"),)
    for label, extra in chip_smoke.PROFILED_SERVE_RUNS:
        chip_smoke.serve_profile(torch, label, extra)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
