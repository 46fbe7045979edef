"""Long-context decode with O(1) state: why `long_500k` runs for SSM and
hybrid archs.

Decodes with the RWKV6 smoke model while tracking the cache footprint --
constant in context length (one (H, hd, hd) matrix and two d-vectors a
layer) -- against a full-attention arch, whose KV cache grows linearly
and hits the long_500k skip (``configs.shape_applicable``).

Run:  PYTHONPATH=src python examples_torch/long_context_decode.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import SHAPES, get_arch, shape_applicable
from repro_torch.core import tree
from repro_torch.models.transformer import Model


def cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for t in tree.leaves(cache))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    long = SHAPES["long_500k"]
    for arch in ("rwkv6-7b", "codeqwen1.5-7b"):
        ok, why = shape_applicable(get_arch(arch), long)
        print(f"{arch}: long_500k applicable={ok}"
              + (f"  ({why[:60]}...)" if not ok else ""))

    cfg = get_arch("rwkv6-7b").smoke()
    model = Model(cfg, device=args.device)
    params = model.init(0)

    b = 1
    sizes = {}
    for horizon in (64, 4096):
        sizes[horizon] = cache_bytes(model.init_cache(b, max_len=horizon))
        print(f"\nrwkv6 smoke cache @ context {horizon:>6}: "
              f"{sizes[horizon] / 1024:.1f} KiB  (O(1) in context)")

    cache = model.init_cache(b, max_len=1 << 20)
    tok = torch.zeros((b, 1), dtype=torch.int32, device=model.device)
    with torch.no_grad():
        for t in range(32):
            logits = model.decode_step(params, cache, tok, pos=t)
            tok = logits.argmax(dim=-1)[:, None].to(torch.int32)
    print(f"decoded 32 tokens at a 2^20-token horizon; cache still "
          f"{cache_bytes(cache) / 1024:.1f} KiB; last token "
          f"{int(tok[0, 0])}")
    return {"cache_bytes": sizes, "last_token": int(tok[0, 0])}


if __name__ == "__main__":
    main()
