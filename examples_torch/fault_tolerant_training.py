"""Fault-tolerance demo: inject failures mid-training, watch the
supervisor restore from the atomic checkpoint and replay to an identical
trajectory, through the port's train CLI with the JAX example's flags.

Run:  PYTHONPATH=src python examples_torch/fault_tolerant_training.py
      [--steps 40 --fail-at 17,33 --save-every 10] [--device cpu]
"""
import argparse
import tempfile
from pathlib import Path

import numpy as np

from repro_torch.launch import train as train_mod


def main(argv=None) -> bool:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--fail-at", default="17,33")
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    base = ["--arch", "qwen2-moe-a2.7b", "--smoke", "--steps",
            str(args.steps), "--batch", "4", "--seq", "32", "--save-every",
            str(args.save_every), "--log-every", "10",
            "--device", args.device]
    with tempfile.TemporaryDirectory(prefix="ft_") as tmp:
        root = Path(tmp)
        print("=== clean run ===")
        clean = train_mod.main(base + ["--ckpt-dir", str(root / "clean")])
        print(f"\n=== run with injected failures at steps {args.fail_at} "
              "===")
        faulty = train_mod.main(base + ["--ckpt-dir", str(root / "faulty"),
                                        "--inject-failures", args.fail_at])
    same = np.allclose(clean[-1], faulty[-1], rtol=1e-5)
    print(f"\nfinal losses match after the failures and restores: {same}")
    assert same
    return same


if __name__ == "__main__":
    main()
