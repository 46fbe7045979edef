"""Batched-serving example: continuous batching with KV caches, through
the port's serve CLI with the JAX example's flags.

Run:  PYTHONPATH=src python examples_torch/serve_batch.py [--device cpu]
"""
import argparse

from repro_torch.launch import serve as serve_mod


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    return serve_mod.main(["--arch", "gemma-2b", "--smoke", "--slots", "4",
                           "--requests", "8", "--prompt-len", "8",
                           "--max-new", "16", "--max-len", "64",
                           "--device", args.device])


if __name__ == "__main__":
    main()
