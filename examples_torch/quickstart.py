"""Quickstart: the transformation toolbox on the H100 in a minute.

1. Query the paper's cheat sheet (Table 1) for a bottleneck.
2. Run the matmul at the staged levels: the plain version at T0 and T1,
   the hand-written CUDA kernel (B1) at T3 on the card.
3. See the pipeline model and the tiling napkin math of the H100 SXM's
   data sheet (``repro_torch.core.H100_SXM``): a model, not a
   measurement.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import (H100_SXM, Level, Objective, PipelineModel,
                              TilePlanner, recommend)
from repro_torch.kernels import registry
from repro_torch.kernels.matmul import matmul_cuda, matmul_plain


def matmul_at(a: torch.Tensor, b: torch.Tensor, level: Level) -> torch.Tensor:
    """a @ b at a staged level: the plain version below T2, else the
    route the device of ``a`` takes (B1 on the card)."""
    kernel, plan = registry.route("matmul", a, b, level=level)
    return matmul_cuda(a, b, plan=plan) if kernel else matmul_plain(a, b)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    # 1 ---- the cheat sheet -------------------------------------------------
    print("paper Tab. 1 -- transformations for 'resolve loop-carried "
          "dependency':")
    for t in recommend(Objective.LOOP_CARRIED_DEPENDENCY):
        print(f"  §{t.section} {t.name}: {t.gpu_mechanism[:70]}...")

    # 2 ---- staged kernel ---------------------------------------------------
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((256, 256), generator=gen).to(device, torch.bfloat16)
    b = torch.randn((256, 256), generator=gen).to(device, torch.bfloat16)
    ref = a.float() @ b.float()
    errors = {}
    for level in (Level.T0_NAIVE, Level.T1_PIPELINED, Level.T3_REPLICATED):
        out = matmul_at(a, b, level)
        errors[level.name] = float((out.float() - ref).abs().max())
        print(f"matmul @ {level.name:14s} max|err| vs fp32 product = "
              f"{errors[level.name]:.2e}")

    # 3 ---- napkin math (the H100 SXM data sheet's model) -------------------
    plan = TilePlanner(H100_SXM).plan_matmul(8192, 8192, 8192)
    print(f"\nTilePlanner for 8192^3 matmul on {H100_SXM.name}: blocks="
          f"({plan.bm},{plan.bn},{plan.bk}) shared memory="
          f"{plan.vmem_bytes / 2**10:.0f} KiB "
          f"AI={plan.arithmetic_intensity:.0f} flop/B")
    pm = PipelineModel(latency=128, initiation_interval=1,
                       n=plan.grid[0] * plan.grid[1] * plan.grid[2])
    print(f"grid pipeline: {pm.cycles():,.0f} cycles, fill/drain overhead "
          f"{pm.fill_drain_overhead():.2%}  (paper Eq. 1)")
    return {"errors": errors, "plan": (plan.bm, plan.bn, plan.bk)}


if __name__ == "__main__":
    main()
