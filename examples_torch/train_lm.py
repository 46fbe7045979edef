"""End-to-end driver example: train a small decoder for a few hundred
steps with the port's production stack (sharded step, AdamW,
checkpoints, supervised restarts, deterministic data), through its train
CLI with the JAX example's flags.

The default is a ~20M config; ``--preset 100m`` is the assignment-scale
run (the same code, wider).

Run:  PYTHONPATH=src python examples_torch/train_lm.py [--preset 100m]
      [--steps N] [--device cpu]
"""
import argparse
import tempfile

from repro_torch.launch import train as train_mod

PRESETS = {
    # (d_model, steps, batch, seq)
    "20m": (256, 300, 8, 128),
    "100m": (640, 200, 8, 256),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="20m")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoints (default: a temporary directory, "
                         "removed at the end)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    d, steps, batch, seq = PRESETS[args.preset]
    if args.steps:
        steps = args.steps
    with tempfile.TemporaryDirectory(prefix="train_lm_") as tmp:
        return train_mod.main([
            "--arch", "codeqwen1.5-7b", "--smoke", "--d-model", str(d),
            "--steps", str(steps), "--batch", str(batch), "--seq", str(seq),
            "--lr", "1e-3", "--save-every", "100",
            "--ckpt-dir", args.ckpt_dir or tmp, "--device", args.device,
        ])


if __name__ == "__main__":
    main()
