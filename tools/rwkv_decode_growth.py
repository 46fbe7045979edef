#!/usr/bin/env python3
"""How the RWKV decode step grows the residual stream: rwkv6-7b at its
published width from a zero dense cache, fed seeded random tokens one
decode step at a time, with the port's decode (the JAX package's: the
channel mix shifts each token's normed input against the previous
token's raw residual, ``repro/models/transformer.py:270-272``) and with
the shift the JAX forward makes (against the previous token's normed
input, ``:193-194``).  Per step: the largest |x| any layer leaves on the
residual stream and whether the logits are finite.

    python3 tools/rwkv_decode_growth.py [--steps 128] [--dtype bf16 fp32]
                                        [--device cpu --smoke]

The forward's shift is had by normalizing the cached residual before the
channel mix reads it, which equals the forward's normed input while every
``ln2`` scale is zero, as ``Model.init`` draws them (checked).  One JSON
line per (dtype, shift).  Runs on the card unless ``--device cpu``; exits
non-zero without a CUDA device then.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
DTYPES = ("bf16", "fp32")


def growth(torch, cfg, dtype, steps: int, device: str, shift: str) -> dict:
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.models import layers, rwkv, transformer
    model = transformer.Model(cfg, dt=DtypePolicy(param=dtype, compute=dtype),
                              device=device)
    params = model.init(seed=0)
    assert all(float(layer["ln2"]["scale"].abs().max()) == 0
               for layer in model._walk(params))
    cache = model.init_cache(4, steps)
    gen = torch.Generator(device=device).manual_seed(1)
    peaks = []
    real_layer, real_cm = transformer.layer_decode, rwkv.channel_mix_apply

    def layer(*args, **kwargs):
        out = real_layer(*args, **kwargs)
        peaks[-1] = torch.maximum(peaks[-1], out.float().abs().max())
        return out

    def forward_shift(p, s, x, cdt, x_prev=None):
        unit = {"scale": torch.zeros(s.d_model, device=x.device)}
        return real_cm(p, s, x, cdt, x_prev=layers.rmsnorm(unit, x_prev))
    finite = []
    with mock.patch.object(transformer, "layer_decode", layer), \
            mock.patch.object(rwkv, "channel_mix_apply",
                              forward_shift if shift == "forward"
                              else real_cm):
        for pos in range(steps):
            peaks.append(torch.zeros((), device=device))
            toks = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen,
                                 device=device).to(torch.int32)
            logits = model.decode_step(params, cache, toks, pos=pos)
            finite.append(torch.isfinite(logits).all())
    peaks = [float(p) for p in peaks]
    bad = [i for i, f in enumerate(finite) if not bool(f)]
    return {"arch": cfg.name, "dtype": str(dtype).replace("torch.", ""),
            "shift": shift, "steps": steps,
            "first_nonfinite_step": bad[0] if bad else None,
            "max_abs_x": {i: peaks[i] for i in range(0, steps, 8)},
            "max_abs_x_last": peaks[-1]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--dtype", nargs="+", default=list(DTYPES),
                    choices=DTYPES)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (for a CPU run)")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("rwkv_decode_growth: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    cfg = get_arch("rwkv6-7b")
    if args.smoke:
        cfg = cfg.smoke()
    if args.device == "cuda":
        import subprocess
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    for name in args.dtype:
        dtype = torch.bfloat16 if name == "bf16" else torch.float32
        for shift in ("decode", "forward"):
            print(json.dumps(growth(torch, cfg, dtype, args.steps,
                                    args.device, shift)), flush=True)
            if args.device == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
