#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--out rows.json]

Phases, one output line or more each:

1. build   -- compile the hand-written kernels (src/repro_torch/kernels/
              csrc) with nvcc for sm_90a; print the seconds and the card's
              name and power limit.
2. kernels -- each kernel against its plain PyTorch version on the card, at
              the serving path's full-width gemma-2b shapes, in bf16 and
              fp32 (rtol = atol = 5e-2 and 2e-4); kernel, plain and library
              times from CUDA events, and the bound the card's peak rates
              set for the same work.
3. serve   -- the port's entry point, ``repro_torch.launch.serve.main``, on
              full-width gemma-2b in bf16 with seeded random weights, once
              with the static and once with the continuous schedule: the
              two must emit identical token streams, every kernel must
              launch on the way, and no call may take the plain route.
4. model   -- one prefill chunk plus 4 teacher-forced decode steps of the
              full-width model in fp32, once through the kernels and once
              through the plain versions, both on the card: logits within
              1e-3 of max |logit|.
5. summary -- one JSON line ``{"kernels": [...]}``, then as the last line
              ``{"ok": true, "device": {...}}``.

fp32 comparisons run with TF32 off (``torch.backends.cuda.matmul.
allow_tf32`` and ``torch.backends.cudnn.allow_tf32`` are set False).  Any
failure raises and exits non-zero; without a CUDA device, or outside a
checkout of the repository, the script exits non-zero before printing
any result.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
# the card's published peaks (H100 SXM data sheet, dense, 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 5e-2, "float32": 2e-4}
SERVE_ARGS = ["--arch", "gemma-2b", "--slots", "4", "--requests", "6",
              "--prompt-len", "100", "--max-new", "16", "--max-len", "256"]
REPLACES = {
    "matmul": "src/repro/kernels/matmul/matmul.py:109",
    "decode_attention": "src/repro/kernels/attention/decode.py:114",
    "prefill_attention": "src/repro/kernels/attention/prefill.py:121",
}
SOURCES = {
    "matmul": "src/repro_torch/kernels/csrc/matmul.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "prefill_attention": "src/repro_torch/kernels/csrc/prefill_attention.cu",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, reps: int = 10) -> float:
    """Mean device milliseconds per call over ``reps`` calls, after one
    warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def compare(torch, name: str, got, want, dtype: str) -> float:
    """Max |got - want|; raises unless |got - want| <= tol * (1 + |want|)."""
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    tol = TOL[dtype]
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    if not bool((diff <= tol + tol * want.float().abs()).all()):
        raise AssertionError(f"{name}: max |err| {diff.max().item():.3e} "
                             f"over tolerance {tol}")
    return diff.max().item()


def row(name, case, dtype, err, ms, plain_ms, bnd, library_ms=None):
    bound_ms, bound_by = bnd
    r = {"kernel": name, "case": case, "dtype": dtype, "max_abs_err": err,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": library_ms}
    emit(r)
    return r


# ------------------------------------------------------------ phase 2
def check_matmul(torch, dtype_name: str):
    from repro_torch.kernels.matmul import matmul_cuda, matmul_plain
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for m in (4, 256):
        for k, n, tied in ((2048, 2048, False), (2048, 256, False),
                           (2048, 16384, False), (16384, 2048, False),
                           (2048, 256000, True)):
            a = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
            if tied:       # the logits head: embed (V, d) read as embed.T
                b = torch.randn(n, k, generator=gen, device="cuda") \
                    .to(dtype).T
            else:
                b = (torch.randn(k, n, generator=gen, device="cuda")
                     / math.sqrt(k)).to(dtype)
            case = f"M={m} K={k} N={n}" + (" tied-transposed" if tied
                                            else "")
            err = compare(torch, "matmul " + case, matmul_cuda(a, b),
                          matmul_plain(a, b), dtype_name)
            size = a.element_size()
            bnd = bound((m * k + k * n + m * n) * size, 2.0 * m * n * k,
                        dtype_name)
            rows.append(row(
                "matmul", case, dtype_name, err,
                time_ms(torch, lambda: matmul_cuda(a, b)),
                time_ms(torch, lambda: matmul_plain(a, b)), bnd,
                time_ms(torch, lambda: torch.matmul(a, b))))
            del a, b
    return rows


def paged_inputs(torch, dtype, gen, *, b, h, hkv, hd, page, n_pages):
    pool = 1 + b * n_pages
    kp = torch.randn(pool, page, hkv, hd, generator=gen, device="cuda")
    vp = torch.randn(pool, page, hkv, hd, generator=gen, device="cuda")
    perm = torch.randperm(pool - 1, generator=gen, device="cuda") + 1
    table = perm[:b * n_pages].reshape(b, n_pages).to(torch.int32)
    return kp.to(dtype), vp.to(dtype), table


def check_decode(torch, dtype_name: str):
    from repro_torch.kernels.attention import (decode_attention_cuda,
                                               decode_attention_plain)
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, h, hkv, hd, page, n_pages = 4, 8, 1, 256, 64, 4
    kp, vp, table = paged_inputs(torch, dtype, gen, b=b, h=h, hkv=hkv,
                                 hd=hd, page=page, n_pages=n_pages)
    q = torch.randn(b, h, hd, generator=gen, device="cuda").to(dtype)
    lens = [0, 65, 117, 256]        # inactive, page +1, ragged, full cache
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    rows = []
    for window in (0, 100):
        err = compare(torch, f"decode window={window}",
                      decode_attention_cuda(q, kp, vp, table, lengths,
                                            window=window),
                      decode_attention_plain(q, kp, vp, table, lengths,
                                             window=window), dtype_name)
        live = sum(min(n, window) if window else n for n in lens)
        size = q.element_size()
        nbytes = (q.numel() * size + 2 * live * hkv * hd * size
                  + table.numel() * 4 + b * 4 + b * h * hd * 4)
        rows.append(row(
            "decode_attention",
            f"B={b} H={h} Hkv={hkv} hd={hd} page={page} lengths={lens} "
            f"window={window}", dtype_name, err,
            time_ms(torch, lambda: decode_attention_cuda(
                q, kp, vp, table, lengths, window=window), 50),
            time_ms(torch, lambda: decode_attention_plain(
                q, kp, vp, table, lengths, window=window), 50),
            bound(nbytes, 4.0 * h * hd * live, dtype_name)))
    return rows


def check_prefill(torch, dtype_name: str):
    from repro_torch.kernels.attention import (prefill_attention_cuda,
                                               prefill_attention_plain)
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, c, h, hkv, hd, page, n_pages = 2, 64, 8, 1, 256, 64, 4
    kp, vp, table = paged_inputs(torch, dtype, gen, b=b, h=h, hkv=hkv,
                                 hd=hd, page=page, n_pages=n_pages)
    q = torch.randn(b, c, h, hd, generator=gen, device="cuda").to(dtype)
    st = [0, 64]                    # a first chunk and one with history
    starts = torch.tensor(st, dtype=torch.int32, device="cuda")
    rows = []
    for window in (0, 100):
        err = compare(torch, f"prefill window={window}",
                      prefill_attention_cuda(q, kp, vp, table, starts,
                                             window=window),
                      prefill_attention_plain(q, kp, vp, table, starts,
                                              window=window), dtype_name)
        # keys each query row sees, and the K/V rows each slot reads
        seen = sum(min(s + i + 1, window) if window else s + i + 1
                   for s in st for i in range(c))
        kv_rows = sum(s + c - (max(0, s - window + 1) if window else 0)
                      for s in st)
        size = q.element_size()
        nbytes = (q.numel() * size + 2 * kv_rows * hkv * hd * size
                  + table.numel() * 4 + b * 4 + q.numel() * 4)
        rows.append(row(
            "prefill_attention",
            f"B={b} C={c} H={h} Hkv={hkv} hd={hd} page={page} starts={st} "
            f"window={window}", dtype_name, err,
            time_ms(torch, lambda: prefill_attention_cuda(
                q, kp, vp, table, starts, window=window), 20),
            time_ms(torch, lambda: prefill_attention_plain(
                q, kp, vp, table, starts, window=window), 20),
            bound(nbytes, 4.0 * hd * h * seen, dtype_name)))
    return rows


# ------------------------------------------------------------ phase 3
def serve_phase(torch):
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    reports, launches = {}, {}
    for schedule, extra in (("static", []),
                            ("continuous", ["--clock", "tick"])):
        dispatch.reset_launch_counts()
        rep = serve.main(SERVE_ARGS + ["--schedule", schedule] + extra)
        launches[schedule] = dispatch.launch_counts()
        reports[schedule] = rep
        streams = {r.rid: list(r.out) for r in rep["done"]}
        emit({"phase": "serve", "schedule": schedule,
              "requests": len(rep["done"]), "new_tokens": rep["new_tokens"],
              "tok_s": rep["tok_s"], "seconds": rep["seconds"],
              "ttft_p50": rep["ttft_p50"], "ttft_p99": rep["ttft_p99"],
              "ttft_unit": "ticks" if schedule == "continuous" else None,
              "phases": rep["phases"],
              "routes": {f"{op}/{route}": n
                         for (op, route), n in rep["routes"].items()},
              "launches": launches[schedule], "streams": streams})
        if len(rep["done"]) != 6 or any(len(r.out) != 16
                                        for r in rep["done"]):
            raise AssertionError(f"{schedule}: not every request served")
        plain = {k: n for k, n in rep["routes"].items() if k[1] == "plain"}
        if plain:
            raise AssertionError(f"{schedule}: plain routes on the card: "
                                 f"{plain}")
        missing = [op for op, n in launches[schedule].items() if n == 0]
        if missing:
            raise AssertionError(f"{schedule}: kernels never launched: "
                                 f"{missing}")
    s = {r.rid: list(r.out) for r in reports["static"]["done"]}
    c = {r.rid: list(r.out) for r in reports["continuous"]["done"]}
    if s != c:
        raise AssertionError(f"static and continuous streams differ:\n"
                             f"{s}\n{c}")
    emit({"phase": "serve", "identical_streams": True})
    return {op: launches["static"][op] + launches["continuous"][op]
            for op in launches["static"]}


# ------------------------------------------------------------ phase 4
def model_phase(torch):
    from repro_torch.configs import get_arch
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer import Model
    f32 = DtypePolicy(param=torch.float32, compute=torch.float32)
    model = Model(get_arch("gemma-2b"), dt=f32, device="cuda")
    params = model.init(seed=1)
    gen = torch.Generator(device="cuda").manual_seed(3)
    page, prompt_len = 64, 50
    toks = torch.zeros(1, page, dtype=torch.int32, device="cuda")
    toks[0, :prompt_len] = torch.randint(0, model.cfg.vocab_size,
                                         (prompt_len,), generator=gen,
                                         device="cuda")
    forced = torch.randint(0, model.cfg.vocab_size, (4,), generator=gen,
                           device="cuda").to(torch.int32)

    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device="cuda")

    def run():
        cache = model.init_paged_cache(1, 2 * page, page)
        table = i32([[1, 2]])
        out = [model.prefill_step_paged(params, cache, toks, i32([0]), table,
                                        i32([prompt_len - 1]))]
        for step, tok in enumerate(forced):
            out.append(model.decode_step(
                params, cache, tok.reshape(1, 1),
                paged=(i32([prompt_len + step]), table)))
        return torch.cat(out)

    kernel = run()
    with mock.patch.object(dispatch, "_on_card", lambda op, t: False):
        plain = run()
    torch.cuda.synchronize()
    scale = plain.abs().max().item()
    err = (kernel - plain).abs().max().item()
    # random weights with the tied, sqrt(d)-scaled embedding put the echo
    # of the input token far above the rest; the spread shows the scale
    # of the other logits
    emit({"phase": "model", "arch": "gemma-2b", "dtype": "float32",
          "positions": 5, "max_abs_err": err, "max_abs_logit": scale,
          "rel_err": err / scale, "logit_std": plain.std().item()})
    if not err <= 1e-3 * scale:
        raise AssertionError(f"full-width logits: max |err| {err:.3e} > "
                             f"1e-3 x {scale:.3e}")


# ------------------------------------------------------------ main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="",
                    help="also write every measured row to this JSON file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import cuda

    t0 = time.time()
    cuda.library()
    emit({"phase": "build", "seconds": time.time() - t0,
          "library": str(cuda.library_path().relative_to(ROOT))})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)

    rows = []
    for dtype_name in ("bfloat16", "float32"):
        rows += check_matmul(torch, dtype_name)
        rows += check_decode(torch, dtype_name)
        rows += check_prefill(torch, dtype_name)
    torch.cuda.empty_cache()

    launches = serve_phase(torch)
    torch.cuda.empty_cache()
    model_phase(torch)

    # the summary line: per kernel, the times of its first bf16 case at
    # the serving shapes (matmul: the decode MLP up-projection, M=4 K=2048
    # N=16384) and the largest error over all its cases
    kernels = []
    for name in SOURCES:
        mine = [r for r in rows if r["kernel"] == name]
        rep = [r for r in mine if r["dtype"] == "bfloat16"
               and (name != "matmul" or r["case"] == "M=4 K=2048 N=16384")][0]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"], "case": rep["case"],
            "dtype": rep["dtype"]})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"device": smi, "rows": rows, "kernels": kernels}, indent=1))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
