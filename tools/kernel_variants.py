#!/usr/bin/env python3
"""Variants of the int8-weight GEMM (B5), the histogram (B11) and the paged
decode (B2/B4a) and prefill (B3/B4b) attention on one NVIDIA GPU: the
measurements behind the choices PERF.md records for them.

    python3 tools/kernel_variants.py [--out rows.json] [--baseline DIR]

A variant is the checkout's kernel sources with a few exact text edits
(``VARIANTS`` below; the script fails if an edit no longer matches),
built with kernels/cuda.py's nvcc flags into build/variants/<name>/ and
called through its C entry with ctypes.  One JSON line per measurement:

- hist: 2^26 int32 values into 2^20 bins (the one-pass route), uniform,
  all in one bin, and sorted (long runs): one atomic per value
  (``none``), equal values of a warp aggregated by __match_any_sync
  (``match``), and the shipped kernel, one atomic per run of equal
  values a lane sees (``run``); beside ``torch.bincount``.
- b5: the four gemma-2b weight shapes at M = 4 and 256 in bf16: every
  split of K from 1 to 16 through the shipped library; at the plan's
  split the shipped kernel against copies without the A-box trim, and
  without the widening or the products (timing only: their results are
  wrong); B1 bf16 at the same shape beside.
- host: microseconds of host time per call of the B1 and B5 wrappers
  (``matmul_cuda``, ``quantized_matmul_cuda``) and of the model's entry
  to them (``dispatch.matmul``, ``dispatch.quantized_matmul``, which
  resolve the tuned plan, here from an empty plan cache) at the four
  shapes at M = 4, the card keeping up (a decode step is paced by the
  host).  ``--src DIR`` times the port of another checkout's ``src``
  instead (``--only host``: an earlier commit beside this one).
- decode: B2 (bf16 pools) and B4a (int8 pools, bf16 q) at chip_smoke.py's
  rows (gemma-2b's heads on the 256-key serving table and at 8192 keys,
  codeqwen1.5-7b's heads at 8192 keys): every split size of
  ``DECODE_SPLITS`` through the shipped library, and at the plan's split
  copies with 4 warps a block (``decode_nw4``) and 2 keys a warp step
  (``decode_u2``); with ``--baseline DIR`` (a checkout of an earlier
  commit) also that commit's decode kernel, one block per slot and kv
  head, through its own C entries.  Also at 8 and 16 kv heads
  (deepseek-67b's and qwen2-moe-a2.7b's), and, per row, whether two
  faulty copies (``decode_mutant_*``) pass the absolute check (bf16
  5e-2, int8 pools 2e-4) and their slot-relative error (chip_smoke's
  limit: 1e-2).

- prefill: B3 (bf16 pools) and B4b (int8 pools, bf16 q) on the wgmma
  route at chip_smoke.py's rows (the serving row, chunks of gemma-2b's
  8192-token context with and without a window of 1024, codeqwen1.5-7b's
  heads): every split size of ``PREFILL_SPLITS`` through the shipped
  library; at the plan's split a copy with one warpgroup a block
  (``prefill_wgs1``) and copies without the products and softmax,
  without the K/V loads, and without the exponentials
  (``prefill_strip_*``, timing
  only); with ``--baseline DIR`` also that commit's prefill kernel
  through its own C entries; and whether a copy that drops the lo half
  of P (``prefill_mutant_no_lo``, int8 pools: P as bf16 alone) passes the
  absolute check and its slot-relative error.

- wkv: B8 at chip_smoke.py's rows (rwkv6-7b's time-mix width B=4 S=4096
  H=64 hd=64 chunk 64 in bf16 and fp32, fp32 under strong decay, and
  heads of 128 in bf16): the shipped mma route at sub-chunks of 8, 16 and
  32; the simt route at the same shape (``simt``: the kernel without the
  tensor cores); copies with ``expf`` for ``ex2.approx``
  (``wkv_expf``) and without the products' lo terms
  (``wkv_mutant_no_lo``: its max |err| / max |out| against
  chip_smoke's LIB_TOL of 1e-4); copies without a phase
  (``wkv_strip_*``: the diagonal sub-blocks, the scaled tiles, the
  off-diagonal products, the chunk products, the next piece's loads;
  timing only); with ``--baseline DIR`` that commit's ``repro_wkv``.
- wkv_bwd: B8's backward (``wkv_bwd_cuda``) at chip_smoke.py's three
  rows (rwkv6-7b's training shape B=2 S=512 H=64 hd=64 in bf16 and fp32,
  fp32 under strong decay at S=4096) and at heads of 128 in bf16: the
  shipped kernel's device time in all and by launch (the chunk products,
  the scans, the gradient kernel, the du sum); copies without one launch
  (``wkv_bwd_strip_chunk``, ``_scan``, ``_grad``) and without one phase
  of the gradient kernel (``wkv_bwd_strip_diag``: A's diagonal
  sub-blocks; ``_er``: the boundary rowsum; ``_mm``: M and A's other
  sub-blocks; ``_products``: the dv, dr, dk tiles; ``_rows``: the
  per-channel diagonal form and the rows' assembly), timing only; with
  ``--baseline DIR`` that commit's ``repro_wkv_bwd`` through its own C
  entry and scratch (the serial design, which stored each row's state
  every 64 steps), its max |diff| from the shipped gradients.
- nbody: B10 at N = 16128 and 65536: every split count of
  ``NBODY_SPLITS`` at 2 targets a thread (shipped) and at 1 and 4
  (``nbody_t1``, ``nbody_t4``), the SM clock beside; with ``--baseline``
  that commit's ``repro_nbody``.
- grouped: the bf16 VJP's dx = g @ w^T (w^T K-major) at qwen2-moe's
  expert shapes, C = 8 and 88, 60 groups, on the short tile (the
  shipped route) and on the tile route through the shipped C entry, in
  turns (tile, short, short, tile), with their bits compared.
- sass: opcode counts (HMMA, MUFU.EX2, MUFU.RSQ, FFMA, ...) of the WKV and
  N-body kernels in the shipped library's SASS (``cuobjdump -sass``) and,
  with ``--baseline``, in that commit's.

Times are the profiler's device time per call (``device_ms``; CUDA events
read the host's launch pace below ~0.1 ms) and, for B11, CUDA events too.
``--only`` runs some of the sections (hist, b5, decode, host, prefill,
wkv, wkv_bwd, nbody, grouped, sass).  ``--baseline`` with the decode and
prefill sections takes a commit whose decode and prefill C entries have
no split arguments; with wkv, wkv_bwd, nbody and sass any earlier commit.
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "build" / "variants"

# name: (source to build, [(file, old text, new text), ...])
_WIDEN_STORE = ("""    *reinterpret_cast<uint4*>(sb + (j / 8) * (BK * 128) +
                              sm90::swizzle128(k, 16 * (j % 8))) =
        widen8(q[i]);""", """    if (q[i].x == 0x12345678u) sb[k] = 1;  // keeps the loads""")
_PRODUCTS = ("""    if (active) {
      const uint8_t* sa = smem + s * R::STAGE + wg * 64 * 128;""",
             """    if (active && nt < 0) {
      const uint8_t* sa = smem + s * R::STAGE + wg * 64 * 128;""")
_RUN = """    if (v == bin) {
      ++n;
      return;
    }
    flush(out);
    bin = v;
    n = 1;"""
VARIANTS = {
    "b5_no_abox": ("quantized_matmul.cu", [
        ("quantized_matmul.cu",
         "const int a_rows = std::min(BM16, (M + 7) / 8 * 8);",
         "const int a_rows = BM16;")]),
    "b5_no_widen": ("quantized_matmul.cu",
                    [("matmul_wgmma.cuh",) + _WIDEN_STORE]),
    "b5_no_products": ("quantized_matmul.cu",
                       [("matmul_wgmma.cuh",) + _PRODUCTS]),
    "b5_neither": ("quantized_matmul.cu",
                   [("matmul_wgmma.cuh",) + _WIDEN_STORE,
                    ("matmul_wgmma.cuh",) + _PRODUCTS]),
    "hist_none": ("histogram.cu", [
        ("histogram.cu", _RUN, "    if (v != NO_BIN) red_add(out + v, 1);")]),
    "hist_match": ("histogram.cu", [
        ("histogram.cu", _RUN,
         """    const unsigned peers = __match_any_sync(0xffffffffu, v);
    if (v != NO_BIN && threadIdx.x % 32 == __ffs(peers) - 1)
      red_add(out + v, __popc(peers));"""),
        # every lane of a warp runs the same rounds (the match needs all)
        ("histogram.cu", """    for (long long i = first; i < n4; i += stride) {
      const int4 x = v4[i];
      run.push""", """    for (long long i = first; i - threadIdx.x % 32 < n4; i += stride) {
      const int4 x = i < n4 ? v4[i] : make_int4(-1, -1, -1, -1);
      run.push"""),
        ("histogram.cu", """  for (long long i = done + first; i < n; i += stride)
    run.push(out, values[i], bins);""",
         """  for (long long i = done + first; i - threadIdx.x % 32 < n; i += stride)
    run.push(out, i < n ? values[i] : -1, bins);""")]),
}
VARIANTS.update({
    "decode_nw4": ("decode_attention.cu", [
        ("decode_attention.cu", "constexpr int NW = 8;",
         "constexpr int NW = 4;")]),
    "decode_u2": ("decode_attention.cu", [
        ("decode_attention.cu",
         "return run<TQ, TKV, VEC, 8, 8, 4>(a, stream);",
         "return run<TQ, TKV, VEC, 8, 8, 2>(a, stream);")]),
    # faults the decode rows' checks must catch (never timed): split 1 of
    # every slot dropped, and the two halves of each bf16 pair swapped
    "decode_mutant_drop_split": ("decode_attention.cu", [
        ("decode_attention.cu", "  if (kb >= ke) {",
         "  if (kb >= ke || r == 1) {")]),
    "decode_mutant_bf16_halves": ("decode_attention.cu", [
        ("decode_attention.cu",
         """      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);""",
         """      f[2 * i + 1] = __uint_as_float(w[i] << 16);
      f[2 * i] = __uint_as_float(w[i] & 0xffff0000u);""")]),
})
VARIANTS.update({
    # int8 pools with P as one bf16 (never timed): the error hi + lo avoids
    "prefill_mutant_no_lo": ("prefill_attention.cu", [
        ("prefill_attention.cu",
         "            sm90::wgmma_rs<HD>(o, alo[kk], "
         "sm90::desc_mnmajor(vt, WK, kk));\n", "")]),
    # timing only (their results are wrong): the K/V ring without the
    # products and softmax, the products and softmax on whatever the
    # tiles hold without their loads, and the softmax without its
    # exponentials
    "prefill_strip_products": ("prefill_attention.cu", [
        ("prefill_attention.cu",
         "const bool active = nw > 0 && key0 < kwe && key0 + WK > kw;",
         "const bool active = nt < 0;")]),
    "prefill_strip_loads": ("prefill_attention.cu", [
        ("prefill_attention.cu",
         "      sm90::mbar_arrive_expect_tx(&full[s], L::STAGE);\n"
         "      for (int j = 0; j < WK / a.box; ++j) {",
         "      sm90::mbar_arrive(&full[s]);\n"
         "      for (int j = 0; j < 0; ++j) {")]),
    "prefill_wgs1": ("prefill_attention.cu", [
        ("prefill_attention.cu", "constexpr int WGS = 2;",
         "constexpr int WGS = 1;")]),
    "prefill_strip_exp": ("prefill_attention.cu", [
        ("prefill_attention.cu",
         "? fast_exp2(sc[i] - ((i & 2) ? mn1 : mn0))",
         "? sc[i] - ((i & 2) ? mn1 : mn0)")]),
})
VARIANTS.update({
    "wkv_expf": ("wkv.cu", [
        ("wkv.cu", "return ex2(x * LOG2E); }", "return expf(x); }")]),
    # drops lo*hi and hi*lo: bf16 hi*hi products only (never timed)
    "wkv_mutant_no_lo": ("wkv.cu", [
        ("wkv.cu", "  if (!A_EXACT) mma(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, "
         "b[0].hi, b[1].hi);\n  mma(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, "
         "b[0].lo, b[1].lo);\n", "")]),
    # timing only (their results are wrong)
    "wkv_strip_diag": ("wkv.cu", [
        ("wkv.cu", "for (int e = tid; e < nsc * tri; e += THREADS) {",
         "for (int e = tid; e < 0; e += THREADS) {")]),
    "wkv_strip_scale": ("wkv.cu", [
        ("wkv.cu", "x = (e % (HD / 4)) * 4, a = i >> lsc;",
         "x = (e % (HD / 4)) * 4, a = i >> lsc;\n        if (e >= 0) continue;")]),
    "wkv_strip_offdiag": ("wkv.cu", [
        ("wkv.cu", "for (int mi = 0; mi < P / 16; ++mi) {",
         "for (int mi = 0; mi < 0; ++mi) {")]),
    "wkv_strip_chunk": ("wkv.cu", [
        ("wkv.cu", "const int nit = P / 8;", "const int nit = 0;"),
        ("wkv.cu", "if (s >= P / 16) break;", "if (s >= 0) break;")]),
    "wkv_strip_loads": ("wkv.cu", [
        ("wkv.cu", "if (s0 + P < S) issue(s0 + P, vb ^ 1);", "")]),
    # timing only (their results are wrong)
    "wkv_bwd_strip_chunk": ("wkv_bwd.cu", [
        ("wkv_bwd.cu", "  wkv_bwd_chunk_kernel<T, HD><<<",
         "  if (blocks < 0) wkv_bwd_chunk_kernel<T, HD><<<")]),
    "wkv_bwd_strip_scan": ("wkv_bwd.cu", [
        ("wkv_bwd.cu", "  wkv_bwd_scan_kernel<HD><<<",
         "  if (blocks < 0) wkv_bwd_scan_kernel<HD><<<")]),
    "wkv_bwd_strip_grad": ("wkv_bwd.cu", [
        ("wkv_bwd.cu", "  wkv_bwd_grad_kernel<T, HD><<<",
         "  if (blocks < 0) wkv_bwd_grad_kernel<T, HD><<<")]),
    "wkv_bwd_strip_chunk_products": ("wkv_bwd.cu", [
        ("wkv_bwd.cu", "for (int u = warp; u < 2 * MT; u += NWARP) {",
         "for (int u = warp; u < 0; u += NWARP) {")]),
    "wkv_bwd_strip_diag": ("wkv_bwd.cu", [
        ("wkv_bwd.cu", "for (int e = tid; e < NSC * TRI; e += NTHR) {",
         "for (int e = tid; e < 0; e += NTHR) {")]),
    "wkv_bwd_strip_er": ("wkv_bwd.cu", [
        ("wkv_bwd.cu",
         "for (int e0 = tid * 16; e0 < HD * HD; e0 += NTHR * 16) {",
         "for (int e0 = tid * 16; e0 < 0; e0 += NTHR * 16) {")]),
    "wkv_bwd_strip_mm": ("wkv_bwd.cu", [
        ("wkv_bwd.cu", "for (int idx = warp; idx < NM + NA; idx += NW) {",
         "for (int idx = warp; idx < 0; idx += NW) {")]),
    "wkv_bwd_strip_products": ("wkv_bwd.cu", [
        ("wkv_bwd.cu", "    if (warp < 3 * MP * NG) {",
         "    if (warp < 0) {")]),
    "wkv_bwd_strip_pairs": ("wkv_bwd.cu", [
        ("wkv_bwd.cu", "    if (half == 0)\n      diag_pairs",
         "    if (half < 0)\n      diag_pairs"),
        ("wkv_bwd.cu", "    else\n      diag_pairs<1, SPLIT>",
         "    else if (half < 0)\n      diag_pairs<1, SPLIT>")]),
    "wkv_bwd_strip_rows": ("wkv_bwd.cu", [
        ("wkv_bwd.cu", "  if (half < 2) {", "  if (half < 0) {"),
        ("wkv_bwd.cu", "  if (half == 0) {", "  if (half < 0) {")]),
    "nbody_t1": ("nbody.cu", [
        ("nbody.cu", "constexpr int TPT = 2;", "constexpr int TPT = 1;")]),
    "nbody_t4": ("nbody.cu", [
        ("nbody.cu", "constexpr int TPT = 2;", "constexpr int TPT = 4;")]),
})
WEIGHT_SHAPES = ((2048, 2048), (2048, 256), (2048, 16384), (16384, 2048))
# (label, heads, kv heads, head width, pages of 64 a slot, lengths)
DECODE_CASES = (("serve", 8, 1, 256, 4, (0, 65, 117, 256)),
                ("long", 8, 1, 256, 128, (8192, 5000, 2049, 1)),
                ("qwen", 32, 32, 128, 128, (8192, 5000, 2049, 1)),
                ("kv8", 64, 8, 128, 128, (8192, 5000, 2049, 1)),
                ("kv16", 16, 16, 128, 128, (8192, 5000, 2049, 1)))
DECODE_SPLITS = (64, 128, 256, 512, 1024, 2048)
# (label, batch, heads, kv heads, head width, pages of 64 a slot, starts,
# windows): chip_smoke.py's prefill rows
PREFILL_CASES = (("serve", 8, 1, 256, 4, (0, 64), (0,)),
                 ("long", 8, 1, 256, 128, (8128, 4992, 1984, 0), (0, 1024)),
                 ("qwen", 32, 32, 128, 128, (8128, 4992, 1984, 0), (0,)))
PREFILL_SPLITS = (256, 512, 1024, 2048, 4096, 8192)
# the C entries of the decode and prefill kernels of an earlier commit
# (before they split the key range)
_P, _I = ctypes.c_void_p, ctypes.c_int
BASELINE_SIGNATURES = {"repro_decode_attention": [_P] * 6 + [_I] * 9 + [_P],
                       "repro_decode_attention_int8":
                           [_P] * 8 + [_I] * 9 + [_P],
                       "repro_prefill_attention": [_P] * 6 + [_I] * 10 + [_P],
                       "repro_prefill_attention_int8":
                           [_P] * 8 + [_I] * 10 + [_P]}
BASELINE_SIGNATURES.update({"repro_wkv": [_P] * 6 + [_I] * 8 + [_P],
                            "repro_wkv_bwd": [_P] * 12 + [_I] * 5 + [_P],
                            "repro_nbody": [_P] * 3 + [_I, ctypes.c_float,
                                                       _P]})
# the sources of each section's baseline kernels
BASELINE_SOURCES = {"decode": ("decode_attention.cu",),
                    "prefill": ("prefill_attention.cu",),
                    "wkv": ("wkv.cu",), "wkv_bwd": ("wkv_bwd.cu",),
                    "nbody": ("nbody.cu",),
                    "sass": ("wkv.cu", "nbody.cu")}
# (label, dtype, strong decay, B, S, H, hd): chip_smoke.py's WKV rows
WKV_CASES = (("init", "bfloat16", False, 4, 4096, 64, 64),
             ("init", "float32", False, 4, 4096, 64, 64),
             ("strong", "float32", True, 4, 4096, 64, 64),
             ("init", "bfloat16", False, 4, 4096, 32, 128))
WKV_SUBCHUNKS = (8, 16, 32)
LIB_TOL = 1e-4
# (label, dtype, strong decay, B, S, H, hd): chip_smoke.py's WKV backward
# rows and heads of 128
WKV_BWD_CASES = (("init", "bfloat16", False, 2, 512, 64, 64),
                 ("init", "float32", False, 2, 512, 64, 64),
                 ("strong", "float32", True, 2, 4096, 64, 64),
                 ("init", "bfloat16", False, 2, 512, 32, 128))
# the launches of the shipped backward, by kernel name
WKV_BWD_KERNELS = ("wkv_bwd_chunk_kernel", "wkv_bwd_scan_kernel",
                   "wkv_bwd_grad_kernel", "wkv_bwd_du_kernel")
NBODY_SIZES = (16128, 65536)
NBODY_SPLITS = (1, 2, 4, 8, 16, 21, 32, 64)
SASS_OPS = ("HMMA", "MUFU.EX2", "MUFU.RSQ", "FFMA", "FMUL", "FADD",
            "FMNMX", "FSETP", "CALL", "BRA", "LDS", "LDGSTS")
SECTIONS = ("hist", "b5", "decode", "host", "prefill", "wkv", "wkv_bwd",
            "nbody", "grouped", "sass")
# the VJP's dx = g @ w^T (K-major B) at qwen2-moe's expert shapes: (C,
# the contraction K = the forward's N, the output's N = the forward's K)
GROUPED_CASES = tuple((c, k, n) for c in (8, 88)
                      for k, n in ((1408, 2048), (2048, 1408)))
HIST_N, HIST_BINS = 1 << 26, 1 << 20


def section_of(variant: str) -> str:
    """The section a variant belongs to: the longest section name its
    name starts with (``wkv_bwd_strip_scan`` is wkv_bwd's, not wkv's)."""
    return max((sec for sec in SECTIONS if variant.startswith(sec + "_")),
               key=len)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build(name: str, cuda) -> Path:
    """The variant's edited copy of csrc, compiled into its own library."""
    source, edits = VARIANTS[name]
    src = OUT_DIR / name / "csrc"
    shutil.rmtree(src.parent, ignore_errors=True)
    shutil.copytree(cuda.CSRC, src)
    for file, old, new in edits:
        text = (src / file).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: edit of {file} matches "
                               f"{text.count(old)} times")
        (src / file).write_text(text.replace(old, new))
    so = src.parent / "lib.so"
    nvcc = cuda._nvcc()
    stubs = Path(nvcc).resolve().parent.parent / "lib64" / "stubs"
    proc = subprocess.run(
        [nvcc, *cuda.NVCC_FLAGS, "-shared", str(src / source),
         f"-L{stubs}", *cuda.LINK_LIBS, "-o", str(so)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    return so


def entry(so: Path, name: str, cuda):
    fn = getattr(ctypes.CDLL(str(so)), name)
    fn.argtypes = cuda.SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def build_baseline(checkout: Path, cuda, sources) -> Path:
    """The kernels of ``sources`` from an earlier commit's checkout, with
    their own C entries (``BASELINE_SIGNATURES``), in one library."""
    src = checkout / "src" / "repro_torch" / "kernels" / "csrc"
    so = OUT_DIR / "baseline" / "lib.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc = cuda._nvcc()
    stubs = Path(nvcc).resolve().parent.parent / "lib64" / "stubs"
    proc = subprocess.run(
        [nvcc, *cuda.NVCC_FLAGS, "-shared", *[str(src / f) for f in sources],
         f"-L{stubs}", *cuda.LINK_LIBS, "-o", str(so)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the baseline:\n{proc.stdout}")
    return so


def load_baseline(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    for name, argtypes in BASELINE_SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    return lib


def device_ms(torch, fn, reps: int = 20) -> float:
    """chip_smoke.py's ``device_ms``: the profiler's kernel time per call,
    taken again where the profile lost kernel events."""
    import chip_smoke
    return chip_smoke.device_ms(torch, fn, reps)


def event_ms(torch, fn, reps: int = 5) -> float:
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


def hist_rows(torch, cuda, libs) -> list:
    from repro_torch.kernels.histogram.histogram import ROUTES
    gen = torch.Generator(device="cuda").manual_seed(11)
    uniform = torch.randint(0, HIST_BINS, (HIST_N,), generator=gen,
                            device="cuda").to(torch.int32)
    inputs = {"uniform": uniform,
              "one bin": torch.full((HIST_N,), 7, dtype=torch.int32,
                                    device="cuda"),
              "sorted": uniform.sort().values}
    rows = []
    for kind, vals in inputs.items():
        want = torch.bincount(vals, minlength=HIST_BINS).to(torch.int32)
        r = {"kernel": "histogram", "case": f"N=2^26 bins=2^20 {kind}",
             "bincount_ms": event_ms(torch, lambda: torch.bincount(
                 vals, minlength=HIST_BINS)),
             "bincount_device_ms": device_ms(torch, lambda: torch.bincount(
                 vals, minlength=HIST_BINS), 5)}
        for name, fn in libs.items():
            out = torch.zeros(HIST_BINS, dtype=torch.int32, device="cuda")

            def call():
                out.zero_()
                rc = fn(vals.data_ptr(), out.data_ptr(), HIST_N, HIST_BINS,
                        ROUTES["global"], cuda.stream_of(vals))
                if rc:
                    raise RuntimeError(f"histogram {name}: CUDA error {rc}")
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"histogram {name} {kind}: counts differ")
            r[name] = {"ms": event_ms(torch, call),
                       "device_ms": device_ms(torch, call, 5)}
        emit(r)
        rows.append(r)
    return rows


def b5_rows(torch, cuda, libs) -> list:
    from repro_torch.core.quant import quantize_channelwise
    from repro_torch.kernels.matmul import matmul_cuda, quantized_matmul_plain
    from repro_torch.kernels.matmul.matmul import (Q_TILE_K,
                                                   quantized_split_plan)
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for m in (4, 256):
        for k, n in WEIGHT_SHAPES:
            a = torch.randn(m, k, generator=gen, device="cuda") \
                .to(torch.bfloat16)
            w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
            q, scale = quantize_channelwise(w)
            b1 = w.to(torch.bfloat16)
            want = quantized_matmul_plain(a, q, scale)
            steps = -(-k // Q_TILE_K)
            plan = quantized_split_plan(k, n, torch.bfloat16)
            r = {"kernel": "quantized_matmul", "case": f"M={m} K={k} N={n}",
                 "plan": list(plan), "b1_bf16_device_ms": device_ms(
                     torch, lambda: matmul_cuda(a, b1)),
                 "split_device_ms": {}, "variant_device_ms": {}}
            runs = [("shipped", libs["shipped"], s) for s in (1, 2, 4, 8, 16)]
            runs += [(name, fn, plan[0]) for name, fn in libs.items()
                     if name != "shipped"]
            for name, fn, split in runs:
                per = -(-steps // split)
                split = -(-steps // per)
                c = torch.empty(m, n, device="cuda")
                part = torch.empty(split, m, n, device="cuda")

                def call():
                    rc = fn(a.data_ptr(), q.data_ptr(), scale.data_ptr(),
                            c.data_ptr(), part.data_ptr(), m, n, k, k, split,
                            per, cuda.dtype_code(a), cuda.stream_of(a))
                    if rc:
                        raise RuntimeError(f"B5 {name}: CUDA error {rc}")
                call()
                torch.cuda.synchronize()
                err = ((c - want).abs() / (1 + want.abs())).max().item()
                if name in ("shipped", "b5_no_abox") and not err <= 2e-4:
                    raise AssertionError(f"B5 {name} split {split}: {err}")
                ms = device_ms(torch, call)
                if name == "shipped":
                    r["split_device_ms"][split] = ms
                else:
                    r["variant_device_ms"][name] = ms
            emit(r)
            rows.append(r)
            del a, w, q, scale, b1, want
    return rows


def decode_rows(torch, cuda, libs, baseline) -> list:
    from repro_torch.core.quant import quantize_pages
    from repro_torch.kernels.attention.decode import (decode_attention_plain,
                                                      decode_split_plan)
    page, rows = 64, []
    for label, h, hkv, hd, n_pages, lens in DECODE_CASES:
        gen = torch.Generator(device="cuda").manual_seed(1)
        pool = 1 + len(lens) * n_pages
        kp, vp = (torch.randn(pool, page, hkv, hd, generator=gen,
                              device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        table = (torch.randperm(pool - 1, generator=gen, device="cuda") + 1)[
            :len(lens) * n_pages].reshape(len(lens), n_pages).to(torch.int32)
        q = torch.randn(len(lens), h, hd, generator=gen,
                        device="cuda").to(torch.bfloat16)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for int8 in (False, True):
            scales = ()
            if int8:
                kq, ks = quantize_pages(kp)
                vq, vs = quantize_pages(vp)
                pools, scales = (kq, vq), (ks, vs)
            else:
                pools = (kp, vp)
            want = decode_attention_plain(q, *pools, table, lengths, *scales)
            plan = decode_split_plan(n_pages, page, hkv)
            name = "repro_decode_attention" + ("_int8" if int8 else "")
            r = {"kernel": "decode_attention" + ("_int8" if int8 else ""),
                 "case": f"{label} B={len(lens)} H={h} Hkv={hkv} hd={hd} "
                         f"lengths={list(lens)}", "plan": list(plan),
                 "split_device_ms": {}, "variant_device_ms": {},
                 "mutants": {}}
            runs = [("shipped", libs["shipped"], s) for s in DECODE_SPLITS]
            runs += [(n, lib, plan[0]) for n, lib in libs.items()
                     if n != "shipped"]
            for variant, lib, keys in runs:
                splits = -(-n_pages * page // keys)
                out = torch.empty(len(lens), h, hd, device="cuda")
                part = torch.empty(len(lens) * h * splits * (hd + 2),
                                   device="cuda")

                def call():
                    ptrs = [t.data_ptr() for t in (q, *pools, *scales,
                                                   table, lengths, out)]
                    rc = getattr(lib, name)(
                        *ptrs, None, part.data_ptr(), len(lens), h, hkv, hd,
                        page, n_pages, pool, 0, keys, splits,
                        cuda.dtype_code(q), cuda.stream_of(q))
                    if rc:
                        raise RuntimeError(f"{variant}: CUDA error {rc}")
                call()
                torch.cuda.synchronize()
                tol = 2e-4 if int8 else 5e-2
                abs_ok = bool(((out - want).abs()
                               <= tol * (1 + want.abs())).all())
                err = (out - want).abs().flatten(1).amax(1)
                ref = want.abs().flatten(1).amax(1)
                rel = (err[ref > 0] / ref[ref > 0]).max().item()
                if "mutant" in variant:
                    r["mutants"][variant] = {"abs_check": abs_ok,
                                             "slot_rel_err": rel}
                    continue
                if not abs_ok or rel > 1e-2:
                    raise AssertionError(f"decode {variant} S={keys}")
                ms = device_ms(torch, call)
                if variant == "shipped":
                    r["split_device_ms"][keys] = ms
                else:
                    r["variant_device_ms"][variant] = ms
            if baseline is not None:
                out = torch.empty(len(lens), h, hd, device="cuda")
                ptrs = [t.data_ptr() for t in (q, *pools, *scales, table,
                                               lengths, out)]
                old = lambda: getattr(baseline, name)(  # noqa: E731
                    *ptrs, len(lens), h, hkv, hd, page, n_pages, pool, 0,
                    cuda.dtype_code(q), cuda.stream_of(q))
                if old():
                    raise RuntimeError("decode baseline: CUDA error")
                r["baseline_device_ms"] = device_ms(torch, old, 5)
            emit(r)
            rows.append(r)
        del kp, vp
        torch.cuda.empty_cache()
    return rows


def prefill_rows(torch, cuda, libs, baseline) -> list:
    from repro_torch.core.quant import quantize_pages
    from repro_torch.kernels.attention.prefill import (
        ROUTES, prefill_attention_plain, prefill_split_plan)
    page, c, rows = 64, 64, []
    for label, h, hkv, hd, n_pages, st, windows in PREFILL_CASES:
        gen = torch.Generator(device="cuda").manual_seed(2)
        b, pool = len(st), 1 + len(st) * n_pages
        kp, vp = (torch.randn(pool, page, hkv, hd, generator=gen,
                              device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        table = (torch.randperm(pool - 1, generator=gen, device="cuda") + 1)[
            :b * n_pages].reshape(b, n_pages).to(torch.int32)
        q = torch.randn(b, c, h, hd, generator=gen,
                        device="cuda").to(torch.bfloat16)
        starts = torch.tensor(st, dtype=torch.int32, device="cuda")
        plan = prefill_split_plan(n_pages, page, hkv, h // hkv, c, hd)
        for int8 in (False, True):
            scales = ()
            if int8:
                kq, ks = quantize_pages(kp)
                vq, vs = quantize_pages(vp)
                pools, scales = (kq, vq), (ks, vs)
            else:
                pools = (kp, vp)
            name = "repro_prefill_attention" + ("_int8" if int8 else "")
            for window in windows:
                want = prefill_attention_plain(q, *pools, table, starts,
                                               *scales, window=window)
                r = {"kernel": "prefill_attention" + ("_int8" if int8
                                                      else ""),
                     "case": f"{label} B={b} C={c} H={h} Hkv={hkv} hd={hd} "
                             f"starts={list(st)} window={window}",
                     "plan": list(plan), "split_device_ms": {},
                     "variant_device_ms": {}, "strip_device_ms": {},
                     "mutants": {}}
                runs = [("shipped", libs["shipped"], k)
                        for k in PREFILL_SPLITS if k <= n_pages * page]
                # the lo half exists for int8 pools only
                runs += [(n, lib, plan[0]) for n, lib in libs.items()
                         if n != "shipped" and (int8 or "mutant" not in n)]
                for variant, lib, keys in runs:
                    splits = -(-n_pages * page // keys)
                    buf = torch.empty(q.numel() + b * c * h * splits
                                      * (hd + 2), device="cuda")
                    out = buf[:q.numel()].view(q.shape)

                    def call():
                        ptrs = [t.data_ptr() for t in (q, *pools, *scales,
                                                       table, starts, out)]
                        rc = getattr(lib, name)(
                            *ptrs, buf.data_ptr() + 4 * q.numel(), b, c, h,
                            hkv, hd, page, n_pages, pool, window, keys,
                            splits, ROUTES["wgmma"], cuda.dtype_code(q),
                            cuda.stream_of(q))
                        if rc:
                            raise RuntimeError(f"{variant}: CUDA error {rc}")
                    call()
                    torch.cuda.synchronize()
                    tol = 2e-4 if int8 else 5e-2
                    abs_ok = bool(((out - want).abs()
                                   <= tol * (1 + want.abs())).all())
                    err = (out - want).abs().flatten(1).amax(1)
                    rel = (err / want.abs().flatten(1).amax(1)).max().item()
                    if "mutant" in variant:
                        r["mutants"][variant] = {
                            "abs_check": abs_ok, "slot_rel_err": rel,
                            "max_abs_err": (out - want).abs().max().item()}
                        continue
                    if "strip" in variant:
                        r["strip_device_ms"][variant] = device_ms(torch, call)
                        continue
                    if not abs_ok or rel > 1e-2:
                        raise AssertionError(f"prefill {variant} S={keys}")
                    if variant != "shipped":
                        r["variant_device_ms"][variant] = device_ms(torch,
                                                                    call)
                        continue
                    if keys == plan[0]:
                        r["max_abs_err"], r["slot_rel_err"] = \
                            (out - want).abs().max().item(), rel
                    r["split_device_ms"][keys] = device_ms(torch, call)
                if baseline is not None:
                    out = torch.empty(q.shape, device="cuda")
                    ptrs = [t.data_ptr() for t in (q, *pools, *scales, table,
                                                   starts, out)]
                    old = lambda: getattr(baseline, name)(  # noqa: E731
                        *ptrs, b, c, h, hkv, hd, page, n_pages, pool, window,
                        cuda.dtype_code(q), cuda.stream_of(q))
                    if old():
                        raise RuntimeError("prefill baseline: CUDA error")
                    r["baseline_device_ms"] = device_ms(torch, old, 3)
                emit(r)
                rows.append(r)
        del kp, vp
        torch.cuda.empty_cache()
    return rows


def wkv_rows(torch, cuda, built, baseline) -> list:
    """B8's routes, sub-chunks and variants at chip_smoke.py's rows."""
    from repro_torch.kernels.wkv import wkv_cuda, wkv_plain
    from repro_torch.kernels.wkv.wkv import (subchunk_len, wkv_piece,
                                             wkv_route, wkv_tiles)
    rows = []
    for label, dtype_name, strong, b, s, h, hd in WKV_CASES:
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator(device="cuda").manual_seed(7 + strong)
        shape = (b, s, h, hd)
        r, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        if strong:
            lw = -torch.randint(80, 201, shape, generator=gen,
                                device="cuda").float() / 4
        else:
            lw = -torch.exp(-6 + 0.5 * torch.randn(shape, generator=gen,
                                                   device="cuda"))
        u = torch.randn(h, hd, generator=gen, device="cuda")
        want = wkv_plain(r, k, v, lw, u, chunk=64)
        scale = want.abs().max().item()
        out = torch.empty(shape, device="cuda")
        ptrs = [x.data_ptr() for x in (r, k, v, lw, u, out)]
        row = {"kernel": "wkv", "case": f"B={b} S={s} H={h} hd={hd} "
               f"chunk=64 decay={label}", "dtype": dtype_name,
               "route": wkv_route(64, 16, hd, dtype), "subchunk_ms": {},
               "subchunk_rel_err": {}, "variant_device_ms": {},
               "strip_device_ms": {}, "mutants": {}}

        def rel(got):
            torch.cuda.synchronize()
            return (got - want).abs().max().item() / scale
        for sub in WKV_SUBCHUNKS:
            call = lambda: wkv_cuda(r, k, v, lw, u, chunk=64,  # noqa: E731
                                    subchunk=sub)
            row["subchunk_rel_err"][sub] = rel(call())
            row["subchunk_ms"][sub] = device_ms(torch, call, 5)
        rows_, cols = wkv_tiles(64, hd)
        simt = lambda lib=None: (lib or cuda.library()).repro_wkv(  # noqa
            *ptrs, b, s, h, hd, 64, rows_, cols, cuda.dtype_code(r),
            cuda.stream_of(r))
        if simt():
            raise RuntimeError("wkv simt: CUDA error")
        row["simt_rel_err"] = rel(out)
        row["simt_device_ms"] = device_ms(torch, simt, 3)
        sc = subchunk_len(64, 16)
        for name, so in built.items():
            fn = entry(so, "repro_wkv_mma", cuda)
            call = lambda: fn(*ptrs, b, s, h, hd, sc,  # noqa: E731
                              wkv_piece(64, sc), cuda.dtype_code(r),
                              cuda.stream_of(r))
            if row["route"] != "mma":
                continue
            if call():
                raise RuntimeError(f"{name}: CUDA error")
            if "mutant" in name:
                err = rel(out)
                row["mutants"][name] = {"rel_err": err,
                                        "caught_by_lib_tol": err > LIB_TOL}
            elif "strip" in name:
                row["strip_device_ms"][name] = device_ms(torch, call, 5)
            else:
                row["variant_device_ms"][name] = device_ms(torch, call, 5)
                row[name + "_rel_err"] = rel(out)
        if baseline is not None:
            old = lambda: baseline.repro_wkv(  # noqa: E731
                *ptrs, b, s, h, hd, 64, rows_, cols, cuda.dtype_code(r),
                cuda.stream_of(r))
            if old():
                raise RuntimeError("wkv baseline: CUDA error")
            row["baseline_rel_err"] = rel(out)
            row["baseline_device_ms"] = device_ms(torch, old, 3)
        emit(row)
        rows.append(row)
        del r, k, v, lw, u, want, out
        torch.cuda.empty_cache()
    return rows


def wkv_bwd_rows(torch, cuda, built, baseline) -> list:
    """B8's backward, its launches and stripped copies, and an earlier
    commit's kernel, at chip_smoke.py's rows."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.wkv import wkv_bwd_cuda
    from repro_torch.kernels.wkv.wkv import wkv_bwd_scratch_floats
    rows = []
    for label, dtype_name, strong, b, s, h, hd in WKV_BWD_CASES:
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator(device="cuda").manual_seed(11 + strong)
        shape = (b, s, h, hd)
        r, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        if strong:
            lw = -torch.randint(80, 201, shape, generator=gen,
                                device="cuda").float() / 4
        else:
            lw = -torch.exp(torch.randn(shape, generator=gen,
                                        device="cuda") - 2)
        u = torch.randn(h, hd, generator=gen, device="cuda")
        do = torch.randn(shape, generator=gen, device="cuda")
        want = wkv_bwd_cuda(r, k, v, lw, u, do)
        grads = [torch.empty(shape, device="cuda") for _ in range(4)]
        du = torch.zeros(h, hd, device="cuda")

        def run(fn, floats):
            scratch = torch.empty(floats, device="cuda")
            ptrs = [x.data_ptr() for x in (r, k, v, lw, u, do, *grads, du,
                                           scratch)]
            return lambda: fn(*ptrs, b, s, h, hd, cuda.dtype_code(r),
                              cuda.stream_of(r))

        def diff():
            torch.cuda.synchronize()
            return max((g - w).abs().max().item()
                       / max(w.abs().max().item(), 1e-300)
                       for g, w in zip((*grads, du), want))
        call = lambda: wkv_bwd_cuda(r, k, v, lw, u, do)  # noqa: E731
        row = {"kernel": "wkv_bwd", "case": f"B={b} S={s} H={h} hd={hd} "
               f"decay={label}", "dtype": dtype_name, "strip_device_ms": {}}
        old = None
        if baseline is not None:
            # timed parent, shipped, shipped, parent; the serial kernel's
            # scratch: each (batch, head)'s state every 64 steps and its
            # du partial
            old = run(baseline.repro_wkv_bwd,
                      b * h * (-(-s // 64) * hd * hd + hd))
            if old():
                raise RuntimeError("wkv_bwd baseline: CUDA error")
            row["baseline_rel_diff"] = diff()
            row["baseline_device_ms"] = [device_ms(torch, old, 3)]
        row["device_ms"] = device_ms(torch, call, 5)
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        row["launch_device_ms"] = {
            name: sum(e.self_device_time_total for e in prof.key_averages()
                      if name in e.key) / 1e3 / 5
            for name in WKV_BWD_KERNELS}
        floats = wkv_bwd_scratch_floats(b, s, h, hd)
        for name, so in built.items():
            fn = run(entry(so, "repro_wkv_bwd", cuda), floats)
            if fn():
                raise RuntimeError(f"{name}: CUDA error")
            row["strip_device_ms"][name] = device_ms(torch, fn, 5)
        row["shipped_device_ms_after"] = device_ms(torch, call, 5)
        if old is not None:
            row["baseline_device_ms"].append(device_ms(torch, old, 3))
        emit(row)
        rows.append(row)
        del r, k, v, lw, u, do, want, grads, du
        torch.cuda.empty_cache()
    return rows


def grouped_rows(torch, cuda, shipped) -> list:
    """dx = g @ w^T on the short tile against the tile route, through
    ``repro_grouped_matmul`` with its route argument set (no split at
    these shapes, so the two compute the same products in the same K
    order)."""
    from repro_torch.kernels.matmul.matmul import split_plan
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []

    def call(a, b, short):
        g, c, k = a.shape
        n = b.shape[2]
        out = torch.empty((g, c, n), dtype=a.dtype, device="cuda")
        split, per = split_plan(k, n, a.dtype, groups=g)
        assert split == 1
        rc = shipped.repro_grouped_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), None, g, c, n, k, k,
            c * k, b.stride(0), b.stride(1), b.stride(2), 1, per, 0,
            int(short), 1, cuda.stream_of(a))
        if rc:
            raise RuntimeError(f"repro_grouped_matmul: CUDA error {rc}")
        return out
    for c, k, n in GROUPED_CASES:
        a = torch.randn(60, c, k, generator=gen, device="cuda")
        w = torch.randn(60, n, k, generator=gen, device="cuda") / math.sqrt(k)
        a, b = a.to(torch.bfloat16), w.to(torch.bfloat16).transpose(1, 2)
        turns = [device_ms(torch, lambda s=s: call(a, b, s))
                 for s in (0, 1, 1, 0)]
        row = {"section": "grouped", "case": f"dx C={c} K={k} N={n} G=60",
               "dtype": "bfloat16",
               "bits_equal": torch.equal(call(a, b, 0), call(a, b, 1)),
               "tile_device_ms": [turns[0], turns[3]],
               "short_device_ms": [turns[1], turns[2]]}
        emit(row)
        rows.append(row)
        del a, b, w
    return rows


def sm_clock() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def nbody_rows(torch, cuda, built, baseline) -> list:
    """B10 at every split count and 1, 2 or 4 targets a thread."""
    from repro_torch.kernels.nbody import nbody_accel_plain
    from repro_torch.kernels.nbody.nbody import (SOFTENING, SOURCE_TILE,
                                                 nbody_split_plan)
    rows = []
    libs = {"shipped": cuda.library().repro_nbody}
    libs.update({name: entry(so, "repro_nbody", cuda)
                 for name, so in built.items()})
    for n in NBODY_SIZES:
        gen = torch.Generator(device="cuda").manual_seed(n)
        pos = torch.randn(3, n, generator=gen, device="cuda")
        mass = torch.rand(n, generator=gen, device="cuda") + 0.1
        want = nbody_accel_plain(pos, mass)
        scale = want.abs().max().item()
        row = {"kernel": "nbody", "case": f"N={n}",
               "plan": list(nbody_split_plan(n)), "device_ms": {}}
        out = torch.empty(3, n, device="cuda")
        tiles = -(-n // SOURCE_TILE)
        for name, fn in libs.items():
            row["device_ms"][name] = {}
            for splits in NBODY_SPLITS:
                per = -(-tiles // splits) * SOURCE_TILE
                splits = -(-n // per)
                part = torch.empty(splits, 3, n, device="cuda")
                call = lambda: fn(  # noqa: E731
                    pos.data_ptr(), mass.data_ptr(), out.data_ptr(),
                    part.data_ptr(), n, splits, per, SOFTENING ** 2,
                    cuda.stream_of(pos))
                if call():
                    raise RuntimeError(f"nbody {name}: CUDA error")
                torch.cuda.synchronize()
                err = (out - want).abs().max().item() / scale
                if not err <= LIB_TOL:
                    raise AssertionError(f"nbody {name} split {splits}")
                row["device_ms"][name][splits] = device_ms(torch, call, 5)
        if baseline is not None:
            old = lambda: baseline.repro_nbody(  # noqa: E731
                pos.data_ptr(), mass.data_ptr(), out.data_ptr(), n,
                SOFTENING ** 2, cuda.stream_of(pos))
            if old():
                raise RuntimeError("nbody baseline: CUDA error")
            row["baseline_device_ms"] = device_ms(torch, old, 5)
        row["sm_clock_mhz"] = sm_clock()
        emit(row)
        rows.append(row)
    return rows


def sass_rows(cuda, libraries: dict) -> list:
    """Opcode counts of the WKV and N-body kernels in each library."""
    tool = Path(cuda._nvcc()).resolve().parent / "cuobjdump"
    rows = []
    for label, so in libraries.items():
        text = subprocess.run([str(tool), "-sass", str(so)],
                              capture_output=True, text=True,
                              check=True).stdout
        counts, name = {}, None
        for line in text.splitlines():
            if "Function :" in line:
                name = line.split("Function :")[1].strip()
                if "wkv" not in name and "nbody" not in name:
                    name = None
                else:
                    counts[name] = {op: 0 for op in SASS_OPS}
            elif name and "*/" in line and line.strip().startswith("/*"):
                words = line.split("*/", 1)[1].split()
                if words and words[0].startswith("@"):   # a predicate
                    words = words[1:]
                op = words[0].rstrip(";") if words else ""
                for want in SASS_OPS:
                    if op == want or op.startswith(want + "."):
                        counts[name][want] += 1
        row = {"kernel": "sass", "library": label, "functions": counts}
        emit(row)
        rows.append(row)
    return rows


def host_rows(torch) -> list:
    import time

    from repro_torch.core.quant import quantize_channelwise
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.matmul import matmul_cuda, quantized_matmul_cuda

    def host_us(fn, calls: int = 200, batches: int = 7) -> float:
        """The median over ``batches`` of the host's microseconds a call
        over ``calls`` calls (the host is shared: one batch moves by a
        third between runs)."""
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        per_call = []
        for _ in range(batches):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            per_call.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        return sorted(per_call)[batches // 2]

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for k, n in WEIGHT_SHAPES:
        a = torch.randn(4, k, generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
        q, scale = quantize_channelwise(w)
        b1 = w.to(torch.bfloat16)
        r = {"kernel": "host", "case": f"M=4 K={k} N={n}",
             "src": str(Path(dispatch.__file__).parents[2]),
             "matmul_us": host_us(lambda: matmul_cuda(a, b1)),
             "quantized_matmul_us": host_us(
                 lambda: quantized_matmul_cuda(a, q, scale)),
             "dispatch_matmul_us": host_us(lambda: dispatch.matmul(a, b1)),
             "dispatch_quantized_matmul_us": host_us(
                 lambda: dispatch.quantized_matmul(a, q, scale))}
        emit(r)
        rows.append(r)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="", help="also write the rows here")
    ap.add_argument("--baseline", default="",
                    help="a checkout of an earlier commit whose decode "
                         "and prefill kernels to time beside the variants")
    ap.add_argument("--src", default="",
                    help="import the port from this src directory (of "
                         "another checkout) instead of this one's")
    ap.add_argument("--only", default=",".join(SECTIONS),
                    help="comma-separated sections to run, of "
                         f"{','.join(SECTIONS)}")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(SECTIONS):
        ap.error(f"--only: unknown sections {only - set(SECTIONS)}")
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()) if args.src
                    else str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    # the model's entries resolve plans from an empty cache: a file that
    # is never written
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(
        ROOT / "build" / "variants" / "no_tuned_plans.json")
    from repro_torch.kernels import cuda
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    # the variants of the sections that run (b5_*, hist_*, decode_*, ...)
    wanted = [v for v in VARIANTS if section_of(v) in only]
    with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        lib = pool.submit(cuda.library)
        built = dict(zip(wanted, pool.map(lambda v: build(v, cuda), wanted)))
        shipped = lib.result()
    def libs(prefix, fns):
        out = {"shipped": shipped}
        for name, so in built.items():
            if name.startswith(prefix):
                out[name] = ctypes.CDLL(str(so))
                for fn in fns:
                    getattr(out[name], fn).argtypes = cuda.SIGNATURES[fn]
                    getattr(out[name], fn).restype = ctypes.c_int
        return out

    baseline_so = baseline = None
    if args.baseline:
        sources = sorted({f for sec in only for f in
                          BASELINE_SOURCES.get(sec, ())})
        baseline_so = build_baseline(Path(args.baseline), cuda, sources)
        baseline = load_baseline(baseline_so)
    rows = []
    if "hist" in only:
        rows += hist_rows(torch, cuda, {
            "none": entry(built["hist_none"], "repro_histogram", cuda),
            "match": entry(built["hist_match"], "repro_histogram", cuda),
            "run": shipped.repro_histogram})
    if "b5" in only:
        b5 = {"shipped": shipped.repro_quantized_matmul}
        b5.update({name: entry(so, "repro_quantized_matmul", cuda)
                   for name, so in built.items() if name.startswith("b5_")})
        rows += b5_rows(torch, cuda, b5)
    if "decode" in only:
        rows += decode_rows(torch, cuda, libs(
            "decode_", ("repro_decode_attention",
                        "repro_decode_attention_int8")), baseline)
    if "host" in only:
        rows += host_rows(torch)
    if "prefill" in only:
        rows += prefill_rows(torch, cuda, libs(
            "prefill_", ("repro_prefill_attention",
                         "repro_prefill_attention_int8")), baseline)
    if "wkv" in only:
        rows += wkv_rows(torch, cuda, {n: so for n, so in built.items()
                                       if section_of(n) == "wkv"}, baseline)
    if "wkv_bwd" in only:
        rows += wkv_bwd_rows(torch, cuda, {
            n: so for n, so in built.items() if section_of(n) == "wkv_bwd"},
            baseline)
    if "nbody" in only:
        rows += nbody_rows(torch, cuda, {n: so for n, so in built.items()
                                         if n.startswith("nbody_")},
                           baseline)
    if "grouped" in only:
        rows += grouped_rows(torch, cuda, shipped)
    if "sass" in only:
        libraries = {"shipped": cuda.library_path()}
        if baseline_so is not None:
            libraries["baseline"] = baseline_so
        rows += sass_rows(cuda, libraries)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"device": smi, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
