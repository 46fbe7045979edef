#!/usr/bin/env python3
"""Where the fp32 gradient gap between the kernel and the plain routes of
a recurrent train step comes from.

    python3 tools/recurrent_parity_attribution.py [--arch rwkv6-7b]

Runs ``chip_smoke.py``'s ``recurrent_train_parity`` step (the arch at
published width and its parity depth,
``chip_smoke.recurrent_train_config(arch, parity=True)``, fp32 params
from seed 2, ``chip_smoke.train_batch`` seed 7) once with every op on its
plain route in fp64 (the params cast), once with every op on its plain
route in fp32, and once for each set of ops sent to its plain route with
the rest on the kernels: none (the kernel run), ``wkv`` (B8's forward),
``wkv_bwd`` (the WKV backward kernel), both, and ``matmul`` /
``matmul_bwd`` (B1).  Each fp32 run's gradients are held against the
all-plain fp32 run and against the fp64 run: the three worst leaves by
max |err| over the leaf's max |grad| (leaves in ``core.tree`` order), and
for an RWKV arch the bonus ``u``'s error (the gate's measure, against
both) and its error layer by layer against fp64.  One JSON line a
run, after the card's name and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
# the op sets sent to the plain route, the rest on the kernels
PLAIN_SETS = ((), ("wkv",), ("wkv_bwd",), ("wkv", "wkv_bwd"),
              ("matmul", "matmul_bwd"))


def leaf_err(a, b) -> float:
    """max |a - b| over max |b|: the parity gate's measure of a leaf."""
    scale = b.abs().max().item()
    return (a - b).abs().max().item() / (scale or 1.0)


def worst(got, want, n: int = 3) -> list:
    """The ``n`` leaves farthest from ``want``: (``leaf_err``, leaf
    index)."""
    return sorted(((leaf_err(a, b), i) for i, (a, b) in
                   enumerate(zip(got, want))), reverse=True)[:n]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="rwkv6-7b",
                    choices=("rwkv6-7b", "recurrentgemma-9b"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("recurrent_parity_attribution: no CUDA device",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from repro_torch.core import tree
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer import Model
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    cfg = chip_smoke.recurrent_train_config(args.arch, parity=True)
    batch = chip_smoke.train_batch(torch, cfg, seed=7)
    on_card = dispatch._on_card

    def grads(params, dtype, plain):
        """Loss and gradients with the ops of ``plain`` (or every op, for
        "all") on their plain routes."""
        model = Model(cfg, dt=DtypePolicy(param=dtype, compute=dtype),
                      device="cuda")
        flat, rebuild = tree.flatten(params)
        leaves = [t.detach().requires_grad_(True) for t in flat]
        with mock.patch.object(dispatch, "_on_card", lambda op, t: on_card(
                op, t) and op not in plain and "all" not in plain):
            loss, _ = model.loss_fn(rebuild(leaves), batch)
            out = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), [g.detach() for g in out]

    f32 = DtypePolicy(param=torch.float32, compute=torch.float32)
    params = Model(cfg, dt=f32, device="cuda").init(seed=2)
    names = [f"leaf {i} {tuple(t.shape)}"
             for i, t in enumerate(tree.flatten(params)[0])]
    u = next((i for i, (path, _) in enumerate(tree_paths(params))
              if path.endswith("tm/u")), None)
    loss64, g64 = grads(tree.tree_map(lambda t: t.double(), params),
                        torch.float64, ("all",))
    g64 = [g.float() for g in g64]
    torch.cuda.empty_cache()
    loss_p, g_plain = grads(params, torch.float32, ("all",))
    line = {"arch": cfg.name, "layers": cfg.n_layers,
            "run": "all plain, fp32 against fp64",
            "loss_rel": abs(loss_p - loss64) / abs(loss64),
            "worst": [(r, names[i]) for r, i in worst(g_plain, g64)]}
    if u is not None:
        line["u_vs_fp64"] = leaf_err(g_plain[u], g64[u])
    print(json.dumps(line), flush=True)
    for plain in PLAIN_SETS:
        loss, g = grads(params, torch.float32, plain)
        line = {"arch": cfg.name, "plain_ops": list(plain),
                "loss_rel_vs_plain": abs(loss - loss_p) / abs(loss_p),
                "worst_vs_plain": [(r, names[i])
                                   for r, i in worst(g, g_plain)],
                "worst_vs_fp64": [(r, names[i]) for r, i in worst(g, g64)]}
        if u is not None:
            line["u_vs_plain"] = leaf_err(g[u], g_plain[u])
            line["u_vs_fp64"] = leaf_err(g[u], g64[u])
            line["u_per_layer_vs_fp64"] = [
                ((g[u][j] - g64[u][j]).abs().max()
                 / g64[u][j].abs().max()).item()
                for j in range(g[u].shape[0])]
        print(json.dumps(line), flush=True)
        del g
        torch.cuda.empty_cache()
    return 0


def tree_paths(tree_, prefix=""):
    """(path, leaf) pairs in ``core.tree``'s order (dicts by sorted key)."""
    if isinstance(tree_, dict):
        for k in sorted(tree_):
            yield from tree_paths(tree_[k], f"{prefix}/{k}")
    elif isinstance(tree_, (list, tuple)):
        for i, v in enumerate(tree_):
            yield from tree_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree_


if __name__ == "__main__":
    sys.exit(main())
