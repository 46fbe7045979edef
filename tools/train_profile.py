#!/usr/bin/env python3
"""chip_smoke.py's train profile on one NVIDIA GPU, for this checkout's
port or another checkout's: device time by kernel group, busy time and
idle share of one bf16 train step of qwen2-moe-a2.7b at published width
and chip_smoke.py's depth (4 layers), after a warm-up step.

    python3 tools/train_profile.py [--src DIR]

``--src`` names the ``src`` directory of another checkout (an earlier
commit unpacked with ``git archive``), whose ``repro_torch`` then runs
under this checkout's profile and kernel groups, so that two commits'
steps are measured alike; run the two in turns (parent, change, change,
parent), one process each.  That checkout builds its kernels into its
own ``build/``.  One JSON line, as chip_smoke.py prints it, with no
group required.  Exits non-zero without a CUDA device.
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
        print("train_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import cuda
    print(cuda.library_path(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.train_profile(torch, "moe_train_profile",
                             chip_smoke.moe_train_config(), ())
    return 0


if __name__ == "__main__":
    sys.exit(main())
