"""Paper §6.1 walk-through: the stencil transformation ladder, live.

Shows each stage's code-level transformation, holds the 4-point Jacobi
stencil (the hand-written CUDA kernel B9 on the card, its plain version
on the CPU) to its plain version over several sweeps, and prints the
stage progression the H100 SXM's data sheet derives (the Fig. 7
analogue): a model, not a measurement.

Run:  PYTHONPATH=src python examples_torch/stencil_pipeline.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import H100_SXM
from repro_torch.core.plan import PAPER_STAGES
from repro_torch.kernels.stencil import jacobi4
from repro_torch.kernels.stencil.stencil import jacobi4_plain


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((256, 512), generator=gen).to(args.device)

    print("stage ladder (paper §6.1):")
    for level, desc in PAPER_STAGES.items():
        print(f"  {level.name:15s} {desc}")

    # correctness: the stencil against its plain version, several sweeps
    errors = {}
    for steps in (1, 4):
        got = jacobi4(x, steps=steps)
        want = jacobi4_plain(x, steps=steps)
        errors[steps] = float((got - want).abs().max())
        print(f"jacobi4 {steps} sweeps: max|err| = {errors[steps]:.2e}")

    # the Fig. 7 progression for an 8192x8192 fp32 domain, from the H100
    # SXM's data-sheet rates: T0 reads the 4 neighbours and the cell and
    # writes it (6 accesses a cell), T1 reads and writes each cell once,
    # T3 fuses 32 sweeps in one pass, bound by the fp32 rate (4 operations
    # a cell a sweep) once the traffic is amortised
    hw = H100_SXM
    cells = 8192.0 * 8192.0
    stages = {
        "T0 naive (no reuse)": 6 * 4 * cells / hw.hbm_bw,
        "T1 delay-buffered (§2.2)": 2 * 4 * cells / hw.hbm_bw,
        "T3 time-replicated x32 (§3.3)": max(
            2 * 4 * cells / 32 / hw.hbm_bw,
            4 * cells / hw.peak_ops("float32")),
    }
    base = None
    print(f"\nderived {hw.name} data-sheet sweep times (8192^2), a model:")
    for name, t in stages.items():
        base = base or t
        print(f"  {name:32s} {t * 1e3:8.3f} ms   ({base / t:5.1f}x "
              "cumulative)")
    return {"errors": errors, "stages_ms": {k: v * 1e3
                                            for k, v in stages.items()}}


if __name__ == "__main__":
    main()
