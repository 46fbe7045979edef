#!/usr/bin/env python3
"""The host's cost of tensor-parallel serving on one NVIDIA GPU.

    python3 tools/tp_host_cost.py [--profile]

1. One-rank NCCL collectives (``launch/mesh.make_serving_mesh(1)``) on a
   decode step's (4, 2048) bf16 activation: host and total microseconds
   a call of the mesh group's ``all_gather`` and ``psum``, of
   ``torch.distributed``'s list ``all_gather``, ``all_gather_into_tensor``
   and ``all_reduce``, and of one elementwise add, alone and behind a
   4096^2 fp32 matmul (whether a collective waits for queued work).
2. gemma-2b at full width in bf16: ``PagedScheduler.step`` (4 slots at
   lengths 100-160) unsharded and on ``--mesh 1``'s mesh, in turns
   (u, m, u, m), ms a step over 20 steps after 5; with ``--profile`` the
   mesh's steps by op (``torch.profiler``, host time).

Prints one JSON object, and the profile table with ``--profile``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def per_call(torch, fn, n: int) -> dict:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return {"host_us": 1e6 * host / n,
            "total_us": 1e6 * (time.perf_counter() - t0) / n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("tp_host_cost: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_arch
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.kernels import cuda
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.serve import PagedScheduler
    from repro_torch.models.transformer import Model

    cuda.library()
    mesh = make_serving_mesh(1)
    g = mesh.group("model")
    x = torch.randn(4, 2048, device="cuda").to(torch.bfloat16)
    out = torch.empty_like(x)
    big = torch.randn(4096, 4096, device="cuda")
    calls = {
        "x + x": (lambda: x + x, 2000),
        "group.all_gather": (lambda: g.all_gather(x, 1), 2000),
        "group.psum": (lambda: g.psum(x), 2000),
        "dist.all_gather (list)": (
            lambda: dist.all_gather([out], x, group=g.pg), 2000),
        "dist.all_gather_into_tensor": (
            lambda: dist.all_gather_into_tensor(out, x, group=g.pg), 2000),
        "dist.all_reduce": (lambda: dist.all_reduce(out, group=g.pg), 2000),
        "matmul 4096^2 fp32": (lambda: big @ big, 200),
        "matmul + x + x": (lambda: (big @ big, x + x), 200),
        "matmul + group.all_gather": (
            lambda: (big @ big, g.all_gather(x, 1)), 200),
    }
    rows = {name: per_call(torch, fn, n) for name, (fn, n) in calls.items()}
    del big

    model = Model(get_arch("gemma-2b"), dt=DtypePolicy(param=torch.bfloat16))
    params = model.init(seed=0)
    lengths = np.array([100, 120, 140, 160], np.int32)
    table = np.arange(1, 17, dtype=np.int32).reshape(4, 4)
    toks = np.zeros(4, np.int32)
    steps = {}
    table_text = ""
    for turn, m in (("u1", None), ("m1", mesh), ("u2", None), ("m2", mesh)):
        sched = PagedScheduler(model, params, slots=4, max_len=256,
                               page_size=64, mesh=m, log=None)
        for _ in range(5):
            sched.step(toks, view=(lengths, table))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            sched.step(toks, view=(lengths, table))
        steps[turn] = 1e3 * (time.perf_counter() - t0) / 20
        if args.profile and turn == "m2":
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                for _ in range(5):
                    sched.step(toks, view=(lengths, table))
            table_text = prof.key_averages().table(
                sort_by="self_cpu_time_total", row_limit=20)
        del sched
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": smi, "torch": torch.__version__,
                      "collectives": rows, "decode_ms_per_step": steps}))
    if table_text:
        print(table_text)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
