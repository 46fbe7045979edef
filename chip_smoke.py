#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--out rows.json]

Phases, one output line or more each:

1. build   -- compile the hand-written kernels (src/repro_torch/kernels/
              csrc) with nvcc for sm_90a; print the seconds and the card's
              name and power limit.
2. kernels -- each kernel against its plain PyTorch version on the card, at
              the serving path's full-width gemma-2b shapes, in bf16 and
              fp32 (rtol = atol = 5e-2 and 2e-4; the int8 kernels compute
              in fp32 and are held at 2e-4 with either input type);
              kernel, plain and library times from CUDA events, and the
              bound the card's peak rates set for the same work.  B1 also
              runs at the training shapes (M=1024, the M=128 head chunk,
              the fp32 head dx), and its M=4 cases are timed again with B
              cold in L2 (``ms_cold``, ``library_ms_cold``).  B5 (the
              int8-weight GEMM) runs at the four weight shapes, M=4 and
              256, beside B1 bf16 at the same shape; both carry the
              profiler's device time (``device_ms``).  B2 and B4a
              (decode attention, float and int8 pools) run at the
              serving shapes and, in bf16, at gemma-2b's 8192-token
              context (no window, and a window of 1024) and at
              codeqwen1.5-7b's 32 kv heads, and B2 over the dense
              serving path's cache viewed as pages at gemma3-4b's heads
              (caps 1024 and 2048); each row carries its split
              plan (``split``: keys a split, splits) and ``device_ms``;
              each slot's max |err| must stay within 1e-2 of its max
              |output| (``slot_rel_err``), and a rerun and each slot
              alone must give the batch's bits.  B3 and B4b (prefill
              attention, float and int8 pools) run at the serving row
              (B=2, C=64, starts 0/64) and, in bf16, at chunks of
              gemma-2b's 8192-token context (starts 8128/4992/1984/0,
              no window and 1024, float and int8 pools) and at
              codeqwen1.5-7b's heads, and, in bf16, at the verify
              window of phase 3c (B=4, C=4, starts 17/62/0/130: mid-page
              and across a page edge, float and int8 pools, the wgmma
              route required); each row carries its route
              (``prefill_route``), split plan and ``device_ms`` and is
              held to the same slot-relative limit, rerun and
              slot-alone bits.  qwen2-moe-a2.7b's shapes: B1's grouped
              route (the MoE experts, one launch for 60 groups) at the
              up and down contractions, decode and prefill-chunk
              capacity (C from ``MoESpec.capacity``), and the backward's
              two GEMMs, and at a training step's capacity (C = 88) the
              bf16 up and down and the fp32 backward's two, each against
              its plain version, rerun bit-equal, beside one
              ``torch.bmm`` and the per-group B1 loop; the bf16 VJP as
              the train step runs it (dx and dw of the up and down at
              C = 88, dw at C = 8; both on the short tile, reading w^T
              and x^T through their strides) beside the fp32 upcast route it
              replaced, timed in turns in the same call
              (``upcast_device_ms``), and ``torch.bmm`` on the bf16
              operands; B1 fp32 at the
              router (N = 60; M = 4, 256 and the training step's 1024)
              and bf16 at the untied head (N = 151936); B2/B4a and B3/B4b
              (and the verify window) at 16 kv heads of 128, group 1.
2c. tune   -- the tuning path (``repro_torch.tune``): ``tune`` sweeps
              each split plan of B1 bf16 at gemma-2b's wq and
              codeqwen1.5-7b's wd tp = 2 shards and at qwen2-moe's fp32
              router, B5 at gemma-2b's wd, B2 and B4a at 8192 keys and B3
              at chunks of 8192 keys with gemma-2b's heads, and B10 at
              N = 16128 (``TUNE_CELLS``; 5 reps of 20 calls a candidate)
              into a temporary plan cache: candidate 0 must be the plan
              the kernel's plan function returns and the best no slower
              within the sweep; the winner is held to the plain version
              at its kernel's tolerance and rerun bit-equal; each row
              carries the heuristic and best plans, their microseconds a
              call and their profiler device ms.  Then full-width
              gemma-2b's paged prefill and 4 decode steps in bf16
              (``prefill_decode_runner``) run under the empty cache and
              under the tuned one: the same launches, every B1/B2/B3 call
              of the tuned run resolved ``exact`` or ``nearest``, no plain
              route, logits within 5e-2 of max |logit| of the empty-cache
              run.
3. serve   -- the port's entry point, ``repro_torch.launch.serve.main``, on
              full-width gemma-2b in bf16 with seeded random weights, once
              with the static and once with the continuous schedule, with
              float KV and weights and again with int8 KV pages, int8
              weights and the prefix cache: each pair must emit identical
              token streams, every kernel of its path must launch, no
              call may take the plain route, and every B3/B4b call must
              take the wgmma route.  A fully-covered static run
              (every prompt one cached page) must copy-on-write and emit
              the streams of the same run without sharing.
3b. dense serve -- ``serve.main`` with ``--cache dense`` (the CLI's
              default layout) on phase 3's traffic, float and int8
              weights: prompts teacher-forced through decode at one shared
              position, every attention layer on B2 over its cache viewed
              as pages; launches exactly B1 and B2 (and B5), no plain
              route, every request served; decode ms per step.
3c. speculative serve -- ``--cache paged --speculate ngram`` and
              ``--speculate model`` (the target's leading 9 layers),
              ``--draft-tokens 3``, static and continuous, and int8 +
              prefix with the n-gram drafter: streams equal phase 3's
              non-speculative streams, every verify window on B3/B4b's
              wgmma route, B6 (wgmma) launched by the model drafter
              alone, no plain route; accept rate, tokens and verify ms
              per verify step.
3d. moe serve -- qwen2-moe-a2.7b at full width and depth in bf16
              through ``serve.main`` on phase 3's traffic: paged static
              and continuous, int8 KV + int8 weights + prefix cache,
              dense, and speculative with the n-gram and the model
              drafter: every request served in full, kernel routes only,
              every forward of the target with exactly the launches its
              config implies (float: B1 193, grouped 72, B2 or B3 24;
              int8: B5 96, B1 97, grouped 72, B4a or B4b 24), the first
              run rerun with the same streams; decode ms a step and new
              tokens/s.  Its continuous float run is profiled too.
3e. recurrent serve -- the recurrent archs at full width and depth in
              bf16 through ``serve.main --cache dense`` (their one
              serving layout) on phase 3's traffic: rwkv6-7b, and
              recurrentgemma-9b with float and int8 weights.  Every
              request served in full, kernel routes only, every decode
              step with exactly the launches its layer kinds imply
              (rwkv6-7b: B1 once, the head; its time and channel mixes are
              plain products, as in the JAX package; recurrentgemma-9b:
              B1 163 = 12 local layers' 4 projections, 38 x 3 GeGLU GEMMs
              and the head, B2 12; int8: B5 162, B1 1, B2 12); decode ms a
              step, new tokens/s, peak memory, and 8 profiled decode
              steps by kernel group with the idle share; recurrentgemma's
              logits finite (rwkv6-7b's decode diverges, as the JAX
              package's does: its first non-finite step is reported).
3f. tp serve -- tensor-parallel paged serving and the expert-parallel
              MoE.  ``serve.main --mesh 1`` (a one-rank NCCL group in
              this process) on phase 3's float continuous run, in turns
              with the unsharded run (u1, m1, m2, u2): streams and
              launches equal phase 3's, every call inside the sharded
              step on its kernel, decode ms a step of both.
              ``moe_apply_sharded`` at qwen2-moe-a2.7b's width on the
              (1, 1) mesh, forward and backward, against ``moe_apply``.
              Then two ranks (``torch.multiprocessing.spawn``, both on
              cuda:0 over gloo, every collective through host memory;
              the kernels built here first): ``serve.main --mesh 2`` on
              gemma-2b float and int8 weights and codeqwen1.5-7b float
              and int8 pools at full width and depth in bf16, streams
              equal across ranks (gemma-2b float's also phase 3's;
              codeqwen's compared with one process's and reported: bf16
              near-ties), no plain route, prefill on wgmma;
              codeqwen1.5-7b in fp32 at 2 layers: streams (float and
              int8 pools) equal to one process's, logits within 1e-4 of
              max |logit|; the MoE layer on a (1, 2) mesh within 1e-5
              (fp32) and 5e-2 (bf16) of max |value| of ``moe_apply``,
              gradients included, 9 grouped launches.  With phase 2's
              rows: kernel rows at the tp = 2 shards' shapes
              (``check_tp_shapes``: B1 column and row shards, B5 at
              K = 8192 with the shard's scales, B2/B4a and B3/B4b at 4
              q heads over 1 kv head and 16 over 16).  Two ranks sharing
              one card time-share it: no speed claim.
4. model   -- one prefill chunk plus 4 teacher-forced decode steps of the
              full-width model in fp32, once through the kernels and once
              through the plain versions, both on the card, with float and
              with int8 KV pages and weights: logits within 1e-3 of
              max |logit|.  4b: gemma3-4b at its published width in
              fp32 on the dense cache (2 slots, max_len 2048), every
              buffer filled with seeded values, 4 decode steps from
              position 1500 (the local layers' buffers wrapped), kernels
              against plain versions: logits within 1e-3 of max |logit|.
              4d: the same comparison in fp32 at published width, one
              model alive at a time: recurrentgemma-9b (34 GB) from
              filled caches at position 2100 (the local layers'
              2048-entry buffers wrapped), rwkv6-7b (30 GB) from a filled
              WKV state and token shifts, and qwen2-vl-2b fed embeddings
              and three differing M-RoPE position streams over a filled
              dense cache and filled page pools; exact launches a step.
              4c: qwen2-moe-a2.7b at full width in fp32 (57 GB of
              parameters), float and int8 KV + weights, as in 4, the
              plain run taking the kernel run's discrete decisions (each
              MoE call's expert choice, each int8 rounding of a K/V
              entry); a plain run on its own decisions beside it, with
              how many choices and int8 entries differ, the smallest
              k-th to (k+1)-th probability gap and its logits' error
              (reported, not held: a flipped decision moves a token by a
              whole expert or an int8 step).  In int8 the replaying run's
              K/V (B5's projections) must lie within 1e-3 of the kernel
              run's, and every int8 entry it would round otherwise must
              differ by one step, with the tie it crosses printed.
5. train   -- the port's training entry point,
              ``repro_torch.launch.train.main``, on full-width, full-depth
              gemma-2b (fp32 master weights, bf16 compute, per-layer remat,
              8 xent chunks, AdamW) for 3 steps of 2 x 512 tokens, with a
              final checkpoint of params and moments: every loss finite,
              only kernel routes for attention, attention_bwd, matmul and
              matmul_bwd, and exactly the launches the config implies
              (B6 2 x 18, B7 18, B1 4 x 134 per step, the recompute
              included), every B6 and B7 call on the wgmma route.
   A profiled extra step gives device time by kernel and the idle
   share (``torch.profiler``; reported as not measured if it sees no
   device time, and failing if it sees device time but none in the
   wgmma B6/B7 kernels).  Phase 3 is followed by a serve profile: the
   continuous float run and the continuous int8 + prefix run again
   under the profiler, in a window of 4 requests of 8 new tokens
   (``PROFILE_WINDOW``), device time by kernel group and the idle share
   over their decode steps and, apart, over their prefill calls.
6. train parity -- one loss and backward of full-width gemma-2b in fp32,
              through the kernels and through the plain versions on the
              card: loss within 1e-5 relative, every gradient leaf within
              1e-3 of that leaf's max |grad|.
6b. moe train -- phase 5's entry point and settings on qwen2-moe-a2.7b
              at its published width with its depth cut to 4 layers
              (2.905e9 params; all 24 would not fit the card's 80 GB),
              reaching ``launch.train`` through a patched ``get_arch``:
              exact launches (B1 4 x 40 per step, the grouped route 48,
              B6 8, B7 4, every flash call on wgmma at hd 128), kernel
              routes only, each MoE layer's remat recompute choosing the
              forward's experts bit for bit (``moe.route`` recorded), peak
              memory under 80 GB, the grouped route's launches by route
              (forward and recompute on the tile route, dx and dw on the
              short tile, none on the fp32 FMA tile: the bf16 VJP takes
              its operands as they are); a profiled step (failing if it
              sees device time but none in the grouped bf16 tile or
              short-tile kernels or the wgmma B6/B7 kernels, or any in
              the grouped fp32 kernel); and ``moe_train_parity``: one
              fp32 loss and backward, kernels against plain versions, the
              plain run replaying the kernel run's expert choices, its
              grouped calls on the fp32 FMA tile only, loss within 1e-5
              relative and every leaf within 1e-3 of its max |grad|, with
              a free-running plain loss, its differing choices and the
              smallest top-k gaps reported.
6c. embed train -- the entry point on the embedding-input archs at full
              width and depth: musicgen-large (hd 64, a non-gated GELU
              MLP; B1 4 x 296 per step, B6 96, B7 48) and qwen2-vl-2b (hd
              128, GQA 6:1, a tied 151936-wide head, M-RoPE; B1 4 x 204,
              B6 56, B7 28), held as phase 5 without the final
              checkpoint (since PR 29, for phase 6e's time), each with a
              profiled step; then ``embed_train_parity``: qwen2-vl-2b's fp32
              loss and backward, kernels against plain versions, on a
              batch whose three M-RoPE position streams differ.
6d. recurrent -- ``recurrent_prefill``: ``Model.prefill`` of rwkv6-7b
              (32 layers) and recurrentgemma-9b (38) at full width and
              depth in bf16 on 2 x 2048 tokens, one model alive at a
              time: exactly their launches (rwkv6-7b B8 32 on mma and B1
              1; recurrentgemma-9b B1 163 and B6 12 on wgmma), kernel
              routes only, finite logits.  ``recurrent_train``: phase
              5's entry point on rwkv6-7b cut to 8 layers (2.286e9
              params) and recurrentgemma-9b cut to 6 (two whole periods;
              2.236e9), through a patched ``get_arch``, its final
              checkpoint patched out (four train runs above write one):
              exact launches by layer kind (rwkv6-7b B1 96, B8 48, its
              backward 24; recurrentgemma-9b B1 408, B6 12, B7 6 on
              wgmma), peak memory under 80 GB, a profiled step each
              (failing without
              device time in B8 and its backward, or in the wgmma B6/B7
              kernels); ``recurrent_train_parity``: each arch's fp32
              loss and backward, kernels against plain versions, at
              less depth (rwkv6-7b 2 layers, recurrentgemma-9b 3).
6e. sharded train -- two ranks (``torch.multiprocessing.spawn``) sharing
              cuda:0 over gloo, every collective through host memory, so
              a check and not a speed result: ``launch.train.main`` on
              its own host mesh, (data 1, model 2), at gemma-2b's width
              cut to SHARDED_CLI_LAYERS layers, 2 steps of 2 x 512 in
              bf16, each rank with exactly one process's B1/B6/B7
              launches (every flash call on wgmma, no plain route), its
              peak memory, stored state bytes and step seconds; fp32 at
              2 layers, without remat, on (1, 2) and (2, 1) against one
              process: the
              loss (1e-5), every gradient leaf (1e-3 of its max |grad|),
              two steps' losses and grad norms (1e-5), the ranks'
              replicated leaves and metrics bit-equal; elastic: the
              (2, 1) state saved whole, ``restore_on_mesh`` onto (1, 2)
              equal to ``reshard_state`` shard for shard and to the plain
              manager's whole leaves, one more step on each layout
              within 1e-5; ``pipeline_apply`` of tanh(x @ w) on B1 over 2
              stages and 4 microbatches of 512 x 2048 in fp32 within
              2e-4 of the sequential product, 5 launches a rank.  The
              older train phases run on the CLI's one-rank mesh: no
              collective.
7. library -- the kernel library's public ops
              (``repro_torch.kernels.{wkv,stencil,nbody,histogram}``) on
              CUDA tensors at phase 2b's sizes, the launch counts set to
              0 just before: only kernel routes, one launch per call
              (the stencil one per sweep; B10 counts its split sum in
              the call's one), WKV once on each route (bf16
              rwkv6-7b on mma, fp32 at hd 128 on simt), outputs equal to
              the plain versions within phase 2b's tolerances.  Then
              the same ops on a transposed or strided view, an
              odd-offset view and int64 histogram values past 2^32: the
              kernel routes, and the plain route's answers (exact for the
              stencil and histogram, LIB_TOL for WKV and N-body).
8. summary -- one JSON line ``{"kernels": [...]}``, then as the last line
              ``{"ok": true, "device": {...}}``.

Every phase but 2c runs under an empty plan cache
(``$REPRO_TORCH_TUNE_CACHE`` points at an empty file in a temporary
directory under ``build/``, removed at the end): the kernels take their
heuristic plans, so the launch, route and stream checks hold whatever
plan file a checkout keeps in ``build/``.  Bounds read the card's peaks
from ``repro_torch.core.model.H100_SXM``.

Phase 2b holds the kernel library's kernels against their plain versions
on the card: WKV (B8) at rwkv6-7b's time-mix width (B=4, S=4096, H=64,
hd=64, chunk 64, sub-chunks of 16) in bf16 and fp32 with init-like and
strong decays, and at the same width in heads of 128 (H=32, hd=128) in
bf16 and fp32, max |err| within 1e-4 of max |out|, each row on the route
``wkv_route`` names (mma, but simt for fp32 at hd 128) with its plan
(sub-chunk and piece, or the simt tiles), a rerun bit-equal, and a bound
from bytes and the function's operations at the peak of the row's type;
mma rows also print what that route issues (bf16 hi + lo products at
the bf16 peak, its FP32 work) apart from the bound; the WKV backward
(the model's, no TPU kernel) at rwkv6-7b's training shape (B=2 S=512
H=64 hd=64) in bf16 and fp32 and at S=4096 in fp32 under strong decays,
each gradient within 5e-2 (bf16) or 2e-4 (fp32) of its max |grad| of
the plain backward run in fp64 on the same inputs, a rerun bit-equal,
beside the fp32 plain backward's time and a bound from bytes and the
recurrence's operations; the Jacobi stencil
(B9) on 8192 x 8192 fp32 (1 and 32 sweeps) and 8191 x 8193, bit for bit, beside one
``F.conv2d`` with the cross kernel; N-body (B10) at N = 16128 and 65536,
within 1e-4 of max |a|, its split plan, a rerun bit-equal, and beside the
19-operation bound an issue bound of 12 FP32-pipe instructions a pair
at the card's maximum SM clock (printed with the clock sampled after the
timing); B8-B10 also with the profiler's device time (``device_ms``);
the histogram (B11) of 2^26 int32 values,
uniform and all in one bin over 256 bins (the shared-memory route) and
over 2^20 bins (the one-pass route), and a small case with values out of
range, exact, beside ``torch.bincount``, with the profiler's device time.

Phase 2 also holds the flash forward (B6) and its fused backward (B7)
at the training shape (B=2, H=8, S=512, hd=256; causal, and a window of
128), and in bf16 also at hd=128 (H=16; causal, and a window of 128) and
hd=64 (H=32, causal), against their plain versions, each on the route
(dtype, hd) names (bf16 at these widths: wgmma; fp32: simt), and B6
alone at the model drafter's forward of phase 3c (bf16, B=4, H=8,
S=259 = max_len 256 + 3 drafts, a tail of 3 past the last 64-row tile,
causal; the wgmma route required); runs B7
twice and requires identical bits, times ``scaled_dot_product_attention``
and its backward beside the causal cases (never called by the port),
each also by its kernels' device time under the profiler (``device_ms``,
``library_device_ms``: a call this short is paced by the host), and
checks the matmul autograd
backward (both fp32 gradient GEMMs through B1) at the down-projection's
training shape.

fp32 comparisons run with TF32 off (``torch.backends.cuda.matmul.
allow_tf32`` and ``torch.backends.cudnn.allow_tf32`` are set False).  Any
failure raises and exits non-zero; without a CUDA device, or outside a
checkout of the repository, the script exits non-zero before printing
any result.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
# the card's published peaks (H100 SXM data sheet, dense, 700 W)
# FP32 lanes of an SM (issue bound of the N-body kernel)
FP32_LANES = 128
TOL = {"bfloat16": 5e-2, "float32": 2e-4}
# decode attention also holds each slot's max |err| to this share of its
# max |output| (bf16 rounds P to 2^-9 of itself: about 2e-3 of a slot)
SLOT_REL_LIMIT = 1e-2
SERVE_ARGS = ["--arch", "gemma-2b", "--cache", "paged", "--slots", "4",
              "--requests", "6", "--prompt-len", "100", "--max-new", "16",
              "--max-len", "256"]
# the dense cache (the serve CLI's default layout) on the same traffic
DENSE_ARGS = ["--arch", "gemma-2b", "--cache", "dense", "--slots", "4",
              "--requests", "6", "--prompt-len", "100", "--max-new", "16",
              "--max-len", "256"]
# speculative decoding: 3 draft tokens a window (W = 4); the model
# drafter is the target's leading 9 of 18 layers (the default half)
SPEC_ARGS = ["--draft-tokens", "3"]
INT8_ARGS = ["--kv-dtype", "int8", "--weights-dtype", "int8"]
PREFIX_ARGS = ["--prefix-cache", "--shared-prefix-len", "64",
               "--shared-frac", "1.0"]
# every prompt is the same single page: all but the first request are
# fully covered by the prefix cache
COVERED_ARGS = ["--arch", "gemma-2b", "--cache", "paged", "--slots", "4",
                "--requests", "3", "--prompt-len", "64",
                "--shared-prefix-len", "64",
                "--shared-frac", "1.0", "--max-new", "4", "--max-len", "256"]
REPLACES = {
    "matmul": "src/repro/kernels/matmul/matmul.py:109",
    # the JAX op's per-expert matmul_pallas calls (B1 per group)
    "grouped_matmul": "src/repro/kernels/matmul/ops.py:250",
    "decode_attention": "src/repro/kernels/attention/decode.py:114",
    "prefill_attention": "src/repro/kernels/attention/prefill.py:121",
    "quantized_matmul": "src/repro/kernels/matmul/matmul.py:75",
    "decode_attention_int8": "src/repro/kernels/attention/decode.py:62",
    "prefill_attention_int8": "src/repro/kernels/attention/prefill.py:63",
    "flash_attention": "src/repro/kernels/attention/flash.py:89",
    "flash_attention_bwd": "src/repro/kernels/attention/backward.py:134",
    "wkv": "src/repro/kernels/wkv/wkv.py:102",
    # no TPU kernel: the JAX package differentiates wkv_chunked by autodiff
    "wkv_bwd": "src/repro/models/rwkv.py:171",
    "stencil": "src/repro/kernels/stencil/stencil.py:51",
    "nbody": "src/repro/kernels/nbody/nbody.py:53",
    "histogram": "src/repro/kernels/histogram/histogram.py:45",
}
SOURCES = {
    "matmul": "src/repro_torch/kernels/csrc/matmul.cu",
    "grouped_matmul": "src/repro_torch/kernels/csrc/matmul.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "prefill_attention": "src/repro_torch/kernels/csrc/prefill_attention.cu",
    "quantized_matmul": "src/repro_torch/kernels/csrc/quantized_matmul.cu",
    "decode_attention_int8":
        "src/repro_torch/kernels/csrc/decode_attention.cu",
    "prefill_attention_int8":
        "src/repro_torch/kernels/csrc/prefill_attention.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_bwd":
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "wkv": "src/repro_torch/kernels/csrc/wkv.cu",
    "wkv_bwd": "src/repro_torch/kernels/csrc/wkv_bwd.cu",
    "stencil": "src/repro_torch/kernels/csrc/stencil.cu",
    "nbody": "src/repro_torch/kernels/csrc/nbody.cu",
    "histogram": "src/repro_torch/kernels/csrc/histogram.cu",
}
# the kernel library's sizes: WKV at rwkv6-7b's time-mix width
# (configs/archs.py:113, chunk 64), the 8192 x 8192 grid and the N = 16128
# bodies benchmarks/run.py models, N = 65536, and 2^26 histogram values
WKV_SHAPE = dict(b=4, s=4096, h=64, hd=64)
# the same model width in heads of 128: two value-column blocks and two
# key-side pieces a head
WKV_WIDE_SHAPE = dict(b=4, s=4096, h=32, hd=128)
WKV_CHUNK, WKV_SUBCHUNK = 64, 16
# the WKV backward at rwkv6-7b's training shape (2 x 512 tokens) and, in
# fp32 under strong decays, at 4096 tokens
WKV_TRAIN_SHAPE = dict(b=2, s=512, h=64, hd=64)
WKV_LONG_SHAPE = dict(b=2, s=4096, h=64, hd=64)
STENCIL_CASES = ((8192, 8192, 1), (8192, 8192, 32), (8191, 8193, 1))
NBODY_SIZES = (16128, 65536)
HIST_N, HIST_BINS = 1 << 26, 256
HIST_WIDE_BINS = 1 << 20     # past one block's shared memory: one pass
LIB_TOL = 1e-4            # WKV and N-body: max |err| / max |plain output|
# the case of each kernel that the summary line reports (bf16 unless
# SUMMARY_DTYPE names another type)
TRAIN_SHAPE = dict(b=2, h=8, s=512, hd=256)
TRAIN_CASE = "B=2 H=8 S=512 hd=256 causal window=0"
WKV_CASE = "B=4 S=4096 H=64 hd=64 chunk=64 decay=init"
WKV_BWD_CASE = "B=2 S=512 H=64 hd=64 decay=init"
SUMMARY_CASE = {"matmul": "M=4 K=2048 N=16384",
                "grouped_matmul": "G=60 C=8 K=2048 N=1408",
                "quantized_matmul": "M=4 K=2048 N=16384",
                "flash_attention": TRAIN_CASE,
                "flash_attention_bwd": TRAIN_CASE,
                "wkv": WKV_CASE,
                "wkv_bwd": WKV_BWD_CASE,
                "stencil": "8192x8192 steps=1",
                "nbody": "N=65536",
                "histogram": "N=2^26 bins=256 uniform"}
SUMMARY_DTYPE = {"stencil": "float32", "nbody": "float32",
                 "histogram": "int32"}
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 3, 2, 512
# qwen2-moe-a2.7b (configs/archs.py:14-25; Qwen1.5-MoE-A2.7B): 24 layers,
# d 2048, 16 heads over 16 kv heads of 128, 60 experts of 1408 (top 4), a
# fused 5632-wide shared MLP, an untied vocabulary of 151936
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_SERVE_ARGS = ["--arch", MOE_ARCH, "--slots", "4", "--requests", "6",
                  "--prompt-len", "100", "--max-new", "16", "--max-len",
                  "256"]
WEIGHT_SHAPES = ((2048, 2048), (2048, 256), (2048, 16384), (16384, 2048))


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


def kernel_events(torch, fn, calls: int) -> dict:
    """{kernel name: [events, device ms]} of ``calls`` calls of ``fn``
    under ``torch.profiler``, the name without namespace, template
    arguments or parameters."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.key.split("(")[0].split("<")[0].split("::")[-1]
            seen = out.setdefault(name, [0, 0.0])
            seen[0] += e.count
            seen[1] += e.self_device_time_total / 1e3
    return out


def launch_device_ms(torch, fn, reps: int = 10, tries: int = 6) -> dict:
    """Device milliseconds per call of each kernel ``fn`` launches, over
    ``reps`` calls under the profiler (after one warm-up call), keyed as
    ``kernel_events`` names them.  A try profiles one call and then the
    ``reps``; it stands only if the profile saw every kernel exactly
    ``reps`` times as often as in the one call (a profile that lost
    events once gave a row less than its bound).  Up to ``tries`` tries,
    a second apart (now and then a profile sees no device event at all,
    three times running, early or late in the script); raises if none
    stands."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        if attempt:
            time.sleep(1.0)
        one = {k: n for k, (n, _) in kernel_events(torch, fn, 1).items()}
        many = kernel_events(torch, fn, reps)
        counts = {k: n for k, (n, _) in many.items()}
        if one and counts == {k: n * reps for k, n in one.items()}:
            return {k: ms / reps for k, (_, ms) in many.items()}
    raise AssertionError(
        f"device time: no profile of {tries} saw every kernel {reps} times "
        f"as often as one call (last: one call {one}, {reps} calls "
        f"{counts})")


def device_ms(torch, fn, reps: int = 10) -> float:
    """Mean device milliseconds of the kernels ``fn`` launches, per call
    (``launch_device_ms`` summed): the card's own time where a short
    kernel's CUDA-event time is paced by the host's launches."""
    return sum(launch_device_ms(torch, fn, reps).values())


def peak_ops(dtype: str) -> float:
    """The card's peak op/s for ``dtype`` (``core.model.H100_SXM``, the
    data sheet's dense rates)."""
    from repro_torch.core.model import H100_SXM
    return H100_SXM.peak_ops(dtype)


def bound(nbytes: float, ops: float, dtype: str):
    from repro_torch.core.model import H100_SXM
    t_bytes, t_ops = nbytes / H100_SXM.hbm_bw, ops / peak_ops(dtype)
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


def slot_rel_err(torch, name: str, got, want) -> float:
    """Decode attention, slot by slot: max |got - want| over max |want|,
    the largest over the live slots; raises past ``SLOT_REL_LIMIT``, or
    unless a slot with no live key is exact zeros.  An output averaged
    over thousands of keys is ~sqrt(e / keys), near bf16's absolute 5e-2,
    so this is the check that holds a bf16 row to its size."""
    err = (got.float() - want.float()).abs().flatten(1).amax(1)
    ref = want.float().abs().flatten(1).amax(1)
    live = ref > 0
    if not torch.equal(got[~live], want[~live]):
        raise AssertionError(f"{name}: a slot with no live key is not zero")
    rel = (err[live] / ref[live]).max().item() if bool(live.any()) else 0.0
    if rel > SLOT_REL_LIMIT:
        raise AssertionError(f"{name}: slot max |err| / max |plain| "
                             f"{rel:.3e} over {SLOT_REL_LIMIT}")
    return rel


def row(name, case, dtype, err, ms, plain_ms, bnd, library_ms=None,
        **extra):
    bound_ms, bound_by = bnd
    r = {"kernel": name, "case": case, "dtype": dtype, "max_abs_err": err,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": library_ms, **extra}
    emit(r)
    return r


# ------------------------------------------------------------ phase 2
# B1's cases: the four weight shapes at decode (M=4), prefill (M=256) and
# training (M=1024, 2 x 512 tokens); the tied head at decode, prefill and
# one of training's 8 cross-entropy chunks (M=128); in fp32 also the head's
# dx = g @ embed, the GEMM with the fewest output tiles per K
MATMUL_CASES = ([(m, k, n, False) for m in (4, 256, 1024)
                 for k, n in WEIGHT_SHAPES]
                + [(m, 2048, 256000, True) for m in (4, 256, 128)])
# qwen2-moe's fp32 router (N = 60 experts, 240-byte rows) at decode, a
# prefill chunk and a training step's 2 x 512 tokens; its untied bf16 head
# (N = 151936) at decode and prefill
MATMUL_F32_CASES = ([(128, 256000, 2048, False)]
                    + [(m, 2048, 60, False) for m in (4, 256, 1024)])
MATMUL_BF16_CASES = [(m, 2048, 151936, False) for m in (4, 256)]
L2_BYTES = 50e6


def time_cold_ms(torch, fn, operands, reps: int) -> float:
    """``time_ms`` with each call on the next of ``operands`` in turn, so
    that every call finds its operand evicted from L2 by the others."""
    it = iter(range(1 << 30))

    def call():
        fn(operands[next(it) % len(operands)])
    for _ in operands:
        call()
    return time_ms(torch, call, reps)


def check_matmul(torch, dtype_name: str):
    """B1 against its plain version at every case, and at M=4 also timed
    with B cold: rotating through copies of B that together exceed the
    50 MB L2 three times, as a decode step finds its weights."""
    from repro_torch.kernels.matmul import matmul_cuda, matmul_plain
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    cases = MATMUL_CASES + (MATMUL_F32_CASES if dtype_name == "float32"
                            else MATMUL_BF16_CASES)
    for m, k, n, tied in cases:
        a = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
        if tied:       # the logits head: embed (V, d) read as embed.T
            b = torch.randn(n, k, generator=gen, device="cuda") \
                .to(dtype).T
        else:
            b = (torch.randn(k, n, generator=gen, device="cuda")
                 / math.sqrt(k)).to(dtype)
        case = f"M={m} K={k} N={n}" + (" tied-transposed" if tied else "")
        if (m, k, n) == MATMUL_F32_CASES[0][:3]:
            case += " head dx"
        elif n == 60:
            case += " qwen2-moe router"
        elif n == 151936:
            case += " qwen2-moe head"
        err = compare(torch, "matmul " + case, matmul_cuda(a, b),
                      matmul_plain(a, b), dtype_name)
        size = a.element_size()
        bnd = bound((m * k + k * n + m * n) * size, 2.0 * m * n * k,
                    dtype_name)
        extra = {}
        # beside B5's at the same shape; the router at every M
        if (m in (4, 256) and not tied) or n == 60:
            extra["device_ms"] = device_ms(torch, lambda: matmul_cuda(a, b))
        if m == 4:
            nbytes = k * n * size
            copies = [b] + [b.clone(memory_format=torch.preserve_format)
                            for _ in range(max(1, math.ceil(
                                3 * L2_BYTES / nbytes)) - 1)]
            reps = max(10, len(copies))
            extra.update(
                ms_cold=time_cold_ms(torch, lambda bb: matmul_cuda(a, bb),
                                     copies, reps),
                library_ms_cold=time_cold_ms(
                    torch, lambda bb: torch.matmul(a, bb), copies, reps),
                cold_copies=len(copies))
            del copies
        rows.append(row(
            "matmul", case, dtype_name, err,
            time_ms(torch, lambda: matmul_cuda(a, b)),
            time_ms(torch, lambda: matmul_plain(a, b)), bnd,
            time_ms(torch, lambda: torch.matmul(a, b)), **extra))
        del a, b
        torch.cuda.empty_cache()
    return rows


def check_quantized_matmul(torch, dtype_name: str, matmul_rows):
    """B5 at the four projection/MLP weight shapes, M = 4 and 256, beside
    B1's bf16 times at the same shape (from ``matmul_rows``), with its
    split plan and the profiler's device time (``device_ms``: CUDA events
    read the host's launch pace below ~0.1 ms)."""
    from repro_torch.core.quant import quantize_channelwise
    from repro_torch.kernels.matmul import (quantized_matmul_cuda,
                                            quantized_matmul_plain)
    from repro_torch.kernels.matmul.matmul import quantized_split_plan
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(4)
    b1 = {r["case"]: r for r in matmul_rows
          if r["kernel"] == "matmul" and r["dtype"] == "bfloat16"}
    rows = []
    for m in (4, 256):
        for k, n in WEIGHT_SHAPES:
            a = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
            w = (torch.randn(k, n, generator=gen, device="cuda")
                 / math.sqrt(k)).to(dtype)
            b_q, scale = quantize_channelwise(w)
            del w
            case = f"M={m} K={k} N={n}"
            # fp32 arithmetic on both routes whatever A's type
            err = compare(torch, "quantized_matmul " + case,
                          quantized_matmul_cuda(a, b_q, scale),
                          quantized_matmul_plain(a, b_q, scale), "float32")
            nbytes = k * n + n * 4 + m * k * a.element_size() + m * n * 4
            rows.append(row(
                "quantized_matmul", case, dtype_name, err,
                time_ms(torch, lambda: quantized_matmul_cuda(a, b_q, scale)),
                time_ms(torch, lambda: quantized_matmul_plain(a, b_q,
                                                              scale)),
                bound(nbytes, 2.0 * m * n * k, dtype_name), None,
                device_ms=device_ms(torch, lambda: quantized_matmul_cuda(
                    a, b_q, scale)),
                split=list(quantized_split_plan(k, n, dtype)),
                b1_bf16_ms=b1[case]["ms"],
                b1_bf16_device_ms=b1[case]["device_ms"]))
            del a, b_q, scale
    return rows


# B1's grouped route at qwen2-moe's experts (60 groups): the up (K=2048,
# N=1408) and the down (K=1408, N=2048) contraction, at a decode step's
# capacity (4 tokens) and a prefill chunk's (4 x 64 tokens), C from
# MoESpec.capacity; at the decode up-projection also the backward's two
# GEMMs (dx = g @ w^T with a K-major B, dw = x^T @ g).  At a training
# step's capacity (2 x 512 tokens: C = 88) the bf16 forward's up and
# down, and the fp32 backward's dx and dw at the up shape
GROUPED_TOKENS = (4, 256)
GROUPED_SHAPES = ((2048, 1408), (1408, 2048))


def moe_spec():
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import _moe_spec
    return _moe_spec(get_arch(MOE_ARCH))


def gemm_bound(g: int, m: int, k: int, n: int, dtype_name: str):
    """The bound of (G, M, K) @ (G, K, N) -> (G, M, N): each operand read
    once, the output written once, in the row's type."""
    size = 2 if dtype_name == "bfloat16" else 4
    return bound((g * m * k + g * k * n + g * m * n) * size,
                 2.0 * g * m * k * n, dtype_name)


def grouped_call(case: str, a, b):
    """``grouped_matmul_cuda(a, b)`` and the route it launched: the one
    whose count went up."""
    from repro_torch.kernels.matmul import grouped_matmul_cuda
    before = dict(grouped_matmul_cuda.routes)
    out = grouped_matmul_cuda(a, b)
    taken = [r for r, n in grouped_matmul_cuda.routes.items()
             if n != before[r]]
    if len(taken) != 1:
        raise AssertionError(f"grouped_matmul {case}: routes {taken}")
    return out, taken[0]


def grouped_row(torch, case: str, dtype_name: str, a, b):
    """One grouped-route row: its route, against the plain version, a
    rerun bit-equal, the bound, one ``torch.bmm`` (cuBLAS) as the library
    time, and the per-group B1 launches the JAX lowering's form would take
    (``b1_loop_ms``)."""
    from repro_torch.kernels.matmul import (grouped_matmul_cuda,
                                            grouped_matmul_plain, matmul_cuda)
    from repro_torch.kernels.matmul.matmul import split_plan
    out, route = grouped_call(case, a, b)
    err = compare(torch, "grouped_matmul " + case, out,
                  grouped_matmul_plain(a, b), dtype_name)
    if not torch.equal(grouped_matmul_cuda(a, b), out):
        raise AssertionError(f"grouped_matmul {case}: a rerun changed bits")
    g, c, k = a.shape
    n = b.shape[2]
    bnd = gemm_bound(g, c, k, n, dtype_name)

    def call():
        return grouped_matmul_cuda(a, b)

    def loop():
        return [matmul_cuda(a[i], b[i]) for i in range(g)]
    return row("grouped_matmul", case, dtype_name, err, time_ms(torch, call),
               time_ms(torch, lambda: grouped_matmul_plain(a, b)), bnd,
               time_ms(torch, lambda: torch.bmm(a, b)),
               device_ms=device_ms(torch, call),
               library_device_ms=device_ms(torch, lambda: torch.bmm(a, b)),
               b1_loop_ms=time_ms(torch, loop),
               b1_loop_device_ms=device_ms(torch, loop), route=route,
               split=(None if route == "wgmma_short"    # it never splits
                      else list(split_plan(k, n, a.dtype, groups=g))),
               rerun_bit_equal=True)


def grouped_vjp_row(torch, case: str, a, b, upcast):
    """One of the bf16 VJP's grouped GEMMs as the train step runs it (a @ b
    on bf16 operands, x^T or w^T read through its strides, on the short
    tile: the route whose launch count went up, checked) beside
    ``upcast``, the fp32 route it replaced (fp32 copies of the operands,
    the FMA tile, the cast back), device times in turns (upcast, new,
    new, upcast), against the plain version, a rerun bit-equal, the
    upcast route's answer within one bf16 rounding, and one ``torch.bmm``
    on the bf16 operands."""
    from repro_torch.kernels.matmul import (grouped_matmul_cuda,
                                            grouped_matmul_plain)

    def new():
        return grouped_matmul_cuda(a, b)

    def bmm():
        return torch.bmm(a, b)
    out, route = grouped_call(case, a, b)
    if route != "wgmma_short":
        raise AssertionError(f"grouped_matmul {case}: route {route}, "
                             f"expected the short tile")
    err = compare(torch, "grouped_matmul " + case, out,
                  grouped_matmul_plain(a, b), "bfloat16")
    if not torch.equal(new(), out):
        raise AssertionError(f"grouped_matmul {case}: a rerun changed bits")
    before = upcast()
    up_diff = (before.float() - out.float()).abs().max().item()
    step = (2.0 ** -7) * out.float().abs().max().item()
    if not up_diff <= step:
        raise AssertionError(f"grouped_matmul {case}: {up_diff:.3e} from "
                             f"the fp32 route, over one bf16 step {step:.3e}")
    del before
    turns = [device_ms(torch, fn) for fn in (upcast, new, new, upcast)]
    g, m, k = a.shape
    n = b.shape[2]
    speedup = (turns[0] + turns[3]) / (turns[1] + turns[2])
    return row("grouped_matmul", case, "bfloat16", err, time_ms(torch, new),
               time_ms(torch, lambda: grouped_matmul_plain(a, b)),
               gemm_bound(g, m, k, n, "bfloat16"), time_ms(torch, bmm),
               route=route,
               device_ms=turns[1], device_ms_turns=[turns[1], turns[2]],
               upcast_ms=time_ms(torch, upcast),
               upcast_device_ms=[turns[0], turns[3]],
               upcast_over_new_device=speedup,
               upcast_max_abs_diff=up_diff,
               library_device_ms=device_ms(torch, bmm),
               rerun_bit_equal=True)


def check_grouped_vjp(torch, gen, spec):
    """The bf16 VJP of the experts' contractions at a training step's
    capacity (dx = g @ w^T and dw = x^T @ g of the up and the down) and dw
    at a decode step's, each beside the fp32 route it replaced as that
    route ran (``_GroupedMatmul.backward`` before bf16 operands: g, w and
    x upcast, x^T made contiguous; each row makes the copies its GEMM
    reads, where that backward shared g's)."""
    from repro_torch.kernels.matmul import grouped_matmul_cuda
    bf16 = torch.bfloat16
    g = spec.e_pad
    rows = []
    for tokens in (TRAIN_BATCH * TRAIN_SEQ, GROUPED_TOKENS[0]):
        c = spec.capacity(tokens)
        for k, n in GROUPED_SHAPES:
            if tokens != TRAIN_BATCH * TRAIN_SEQ and k != 2048:
                continue
            x = torch.randn(g, c, k, generator=gen, device="cuda").to(bf16)
            w = (torch.randn(g, k, n, generator=gen, device="cuda")
                 / math.sqrt(k)).to(bf16)
            gout = torch.randn(g, c, n, generator=gen,
                               device="cuda").to(bf16)
            case = f"G={g} C={c} K={k} N={n} bf16 VJP"
            if tokens == TRAIN_BATCH * TRAIN_SEQ:
                rows.append(grouped_vjp_row(
                    torch, case + " dx = g @ w^T", gout, w.transpose(1, 2),
                    lambda: grouped_matmul_cuda(
                        gout.float().contiguous(),
                        w.float().transpose(1, 2)).to(bf16)))
            rows.append(grouped_vjp_row(
                torch, case + " dw = x^T @ g", x.transpose(1, 2), gout,
                lambda: grouped_matmul_cuda(
                    x.float().transpose(1, 2).contiguous(),
                    gout.float().contiguous()).to(bf16)))
            del x, w, gout
            torch.cuda.empty_cache()
    return rows


def check_grouped(torch, dtype_name: str):
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(8)
    spec = moe_spec()
    g = spec.e_pad
    rows = []
    for tokens in GROUPED_TOKENS:
        c = spec.capacity(tokens)
        for k, n in GROUPED_SHAPES:
            x = torch.randn(g, c, k, generator=gen, device="cuda").to(dtype)
            w = (torch.randn(g, k, n, generator=gen, device="cuda")
                 / math.sqrt(k)).to(dtype)
            case = f"G={g} C={c} K={k} N={n}"
            rows.append(grouped_row(torch, case, dtype_name, x, w))
            if tokens == GROUPED_TOKENS[0] and k == 2048:
                gout = torch.randn(g, c, n, generator=gen,
                                   device="cuda").to(dtype)
                rows.append(grouped_row(
                    torch, case + " backward dx = g @ w^T", dtype_name,
                    gout, w.transpose(1, 2)))
                rows.append(grouped_row(
                    torch, case + " backward dw = x^T @ g", dtype_name,
                    x.transpose(1, 2).contiguous(), gout))
            del x, w
    c = spec.capacity(TRAIN_BATCH * TRAIN_SEQ)
    for k, n in GROUPED_SHAPES:
        if dtype_name == "float32" and k != 2048:
            continue
        x = torch.randn(g, c, k, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(g, k, n, generator=gen, device="cuda")
             / math.sqrt(k)).to(dtype)
        case = f"G={g} C={c} K={k} N={n} training"
        if dtype_name == "bfloat16":
            rows.append(grouped_row(torch, case, dtype_name, x, w))
        else:
            gout = torch.randn(g, c, n, generator=gen, device="cuda")
            rows.append(grouped_row(
                torch, case + " backward dx = g @ w^T", dtype_name, gout,
                w.transpose(1, 2)))
            rows.append(grouped_row(
                torch, case + " backward dw = x^T @ g", dtype_name,
                x.transpose(1, 2).contiguous(), gout))
            del gout
        del x, w
    torch.cuda.empty_cache()
    if dtype_name == "bfloat16":
        rows += check_grouped_vjp(torch, gen, spec)
    return rows


def paged_inputs(torch, dtype, gen, *, b, h, hkv, hd, page, n_pages):
    pool = 1 + b * n_pages
    kp = torch.randn(pool, page, hkv, hd, generator=gen, device="cuda")
    vp = torch.randn(pool, page, hkv, hd, generator=gen, device="cuda")
    perm = torch.randperm(pool - 1, generator=gen, device="cuda") + 1
    table = perm[:b * n_pages].reshape(b, n_pages).to(torch.int32)
    return kp.to(dtype), vp.to(dtype), table


# B2/B4a's cases: the serving shapes (gemma-2b's heads, the 256-key table
# of the serve runs); in bf16 also gemma-2b's published 8192-token context
# (128 pages of 64 a slot, no window and gemma3-4b's local window of 1024,
# configs/archs.py:69), float and int8 pools, and codeqwen1.5-7b's heads
# (32 kv heads of 128, grp 1, configs/archs.py:102) at the same lengths
DECODE_SERVE = dict(b=4, h=8, hkv=1, hd=256, page=64, n_pages=4,
                    lens=(0, 65, 117, 256), windows=(0, 100))
DECODE_LONG = dict(b=4, h=8, hkv=1, hd=256, page=64, n_pages=128,
                   lens=(8192, 5000, 2049, 1), windows=(0, 1024))
DECODE_QWEN = dict(b=4, h=32, hkv=32, hd=128, page=64, n_pages=128,
                   lens=(8192, 5000, 2049, 1), windows=(0,))
# the dense serving path's call (layers.attention_decode): gemma3-4b's heads
# (8 over 4 kv heads of 256, configs/archs.py:65) over 2 slots' dense
# caches viewed as pages, each slot's own run of pages its table, at
# position 1500: the local layers' 1024-entry buffer wrapped (every entry
# live), the global layers' 2048-entry buffer holding 1501 keys
# qwen2-moe-a2.7b's heads (16 kv heads of 128, group 1,
# configs/archs.py:18) on the MoE serving phase's 256-key table
DECODE_MOE = dict(b=4, h=16, hkv=16, hd=128, page=64, n_pages=4,
                  lens=(0, 65, 117, 256), windows=(0,))
DECODE_DENSE = [dict(b=2, h=8, hkv=4, hd=256, page=64, n_pages=cap // 64,
                     lens=(min(1501, cap),) * 2, windows=(0,), dense=True)
                for cap in (1024, 2048)]


def decode_rows(torch, dtype_name: str, shape: dict, int8: bool,
                reps: int):
    """B2 (float pools) or B4a (int8 pools) at one shape and its windows
    against the plain version, with the split plan and the profiler's
    device time; each slot's error is also held to its output's size
    (``slot_rel_err``), and a rerun and each slot alone must give the
    batch's bits."""
    from repro_torch.core.quant import quantize_pages
    from repro_torch.kernels.attention.decode import (
        decode_attention_cuda, decode_attention_int8_cuda,
        decode_attention_plain, decode_split_plan)
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, h, hkv, hd, page, n_pages = (shape[k] for k in (
        "b", "h", "hkv", "hd", "page", "n_pages"))
    if shape.get("dense"):
        # (B, cap, Hkv, hd) caches viewed as (B * cap / page) pages
        kp, vp = (torch.randn(b * n_pages, page, hkv, hd, generator=gen,
                              device="cuda").to(dtype) for _ in range(2))
        table = torch.arange(b * n_pages, dtype=torch.int32,
                             device="cuda").view(b, n_pages)
    else:
        kp, vp, table = paged_inputs(torch, dtype, gen, b=b, h=h, hkv=hkv,
                                     hd=hd, page=page, n_pages=n_pages)
    q = torch.randn(b, h, hd, generator=gen, device="cuda").to(dtype)
    lens = list(shape["lens"])
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    scales, name, kernel, tol = (), "decode_attention", \
        decode_attention_cuda, dtype_name
    if int8:        # quantized page by page, as the serve runs write them
        kp, ks = quantize_pages(kp)
        vp, vs = quantize_pages(vp)
        scales, name, kernel, tol = (ks, vs), "decode_attention_int8", \
            decode_attention_int8_cuda, "float32"
    args = (q, kp, vp, table, lengths, *scales)
    case = (f"B={b} H={h} Hkv={hkv} hd={hd} page={page} lengths={lens}"
            + (f" dense cache={n_pages * page}" if shape.get("dense")
               else ""))
    rows = []
    for window in shape["windows"]:
        def call():
            return kernel(*args, window=window)
        out = call()
        want = decode_attention_plain(*args, window=window)
        err = compare(torch, f"{name} {case} window={window}", out, want,
                      tol)
        rel = slot_rel_err(torch, f"{name} {case} window={window}", out,
                           want)
        alone = [kernel(q[i:i + 1], kp, vp, table[i:i + 1],
                        lengths[i:i + 1], *scales, window=window)
                 for i in range(b)]
        if not torch.equal(call(), out) or not all(
                torch.equal(one, out[i:i + 1]) for i, one in enumerate(alone)):
            raise AssertionError(f"{name} {case} window={window}: a rerun "
                                 f"or a slot alone changed bits")
        live = sum(min(n, window) if window else n for n in lens)
        pages = sum(-(-n // page) - ((max(0, n - window) // page) if window
                                     else 0) for n in lens)
        elem = 1 if int8 else q.element_size()
        nbytes = (q.numel() * q.element_size() + 2 * live * hkv * hd * elem
                  + (2 * pages * hkv * 4 if int8 else 0)
                  + table.numel() * 4 + b * 4 + b * h * hd * 4)
        rows.append(row(
            name, f"{case} window={window}" + (" int8 pools" if int8
                                               else ""),
            dtype_name, err, time_ms(torch, call, reps),
            time_ms(torch, lambda: decode_attention_plain(
                *args, window=window), reps),
            bound(nbytes, 4.0 * h * hd * live, dtype_name),
            device_ms=device_ms(torch, call, 20),
            split=list(decode_split_plan(n_pages, page, hkv)),
            slot_rel_err=rel))
    del kp, vp, args
    torch.cuda.empty_cache()
    return rows


def check_decode(torch, dtype_name: str):
    rows = []
    for int8 in (False, True):
        rows += decode_rows(torch, dtype_name, DECODE_SERVE, int8, 50)
    if dtype_name == "bfloat16":
        for int8 in (False, True):
            rows += decode_rows(torch, dtype_name, DECODE_LONG, int8, 20)
        rows += decode_rows(torch, dtype_name, DECODE_QWEN, False, 20)
        for int8 in (False, True):
            rows += decode_rows(torch, dtype_name, DECODE_MOE, int8, 50)
    for shape in DECODE_DENSE:
        rows += decode_rows(torch, dtype_name, shape, False, 20)
    return rows


# B3/B4b's cases: the serving row (gemma-2b's heads, a first chunk and one
# with a page of history on the 256-key table); in bf16 also chunks at
# gemma-2b's published 8192-token context (128 pages of 64 a slot,
# page-aligned starts, no window and gemma3-4b's local window of 1024,
# configs/archs.py:69), float and int8 pools, and codeqwen1.5-7b's heads
# (32 kv heads of 128, grp 1, configs/archs.py:102) at the same starts
PREFILL_SERVE = dict(b=2, c=64, h=8, hkv=1, hd=256, page=64, n_pages=4,
                     starts=(0, 64), windows=(0, 100))
PREFILL_LONG = dict(b=4, c=64, h=8, hkv=1, hd=256, page=64, n_pages=128,
                    starts=(8128, 4992, 1984, 0), windows=(0, 1024))
PREFILL_QWEN = dict(b=4, c=64, h=32, hkv=32, hd=128, page=64, n_pages=128,
                    starts=(8128, 4992, 1984, 0), windows=(0,))
# the speculative serve runs' verify window (layers.attention_verify_paged
# at --draft-tokens 3: C = 4 rows from each slot's length, on the 256-key
# table): starts mid-page, a window that crosses a page edge (62 + 4) and
# a slot at 0; gemma-2b has no window.  The serve runs take the wgmma route
PREFILL_VERIFY = dict(b=4, c=4, h=8, hkv=1, hd=256, page=64, n_pages=4,
                      starts=(17, 62, 0, 130), windows=(0,), route="wgmma")
# qwen2-moe-a2.7b's heads (16 kv heads of 128, group 1) at the MoE serving
# phase's prefill chunk and verify window; its serve runs take the wgmma
# route
PREFILL_MOE = [dict(shape, h=16, hkv=16, hd=128) for shape in (
    dict(b=2, c=64, page=64, n_pages=4, starts=(0, 64), windows=(0,),
         route="wgmma"), PREFILL_VERIFY)]


def prefill_rows(torch, dtype_name: str, shape: dict, int8: bool,
                 reps: int):
    """B3 (float pools) or B4b (int8 pools) at one shape and its windows
    against the plain version, with the route, the split plan and the
    profiler's device time; each slot's error is also held to its output's
    size (``slot_rel_err``), and a rerun and each slot alone must give the
    batch's bits."""
    from repro_torch.core.quant import quantize_pages
    from repro_torch.kernels.attention.prefill import (
        prefill_attention_cuda, prefill_attention_int8_cuda,
        prefill_attention_plain, prefill_route, prefill_split_plan)
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, c, h, hkv, hd, page, n_pages = (shape[k] for k in (
        "b", "c", "h", "hkv", "hd", "page", "n_pages"))
    kp, vp, table = paged_inputs(torch, dtype, gen, b=b, h=h, hkv=hkv,
                                 hd=hd, page=page, n_pages=n_pages)
    q = torch.randn(b, c, h, hd, generator=gen, device="cuda").to(dtype)
    st = list(shape["starts"])
    starts = torch.tensor(st, dtype=torch.int32, device="cuda")
    scales, name, kernel, tol = (), "prefill_attention", \
        prefill_attention_cuda, dtype_name
    if int8:        # quantized page by page, as the serve runs write them
        kp, ks = quantize_pages(kp)
        vp, vs = quantize_pages(vp)
        scales, name, kernel, tol = (ks, vs), "prefill_attention_int8", \
            prefill_attention_int8_cuda, "float32"
    args = (q, kp, vp, table, starts, *scales)
    route = prefill_route(dtype, hd, h // hkv)
    if shape.get("route", route) != route:
        raise AssertionError(f"prefill {shape}: route {route}, the serve "
                             f"path's is {shape['route']}")
    split = (list(prefill_split_plan(n_pages, page, hkv, h // hkv, c, hd))
             if route == "wgmma" else [n_pages * page, 1])
    case = f"B={b} C={c} H={h} Hkv={hkv} hd={hd} page={page} starts={st}"
    rows = []
    for window in shape["windows"]:
        label = f"{name} {case} window={window}"

        def call():
            return kernel(*args, window=window)
        before = kernel.routes[route]
        out = call()
        if kernel.routes[route] != before + 1:
            raise AssertionError(f"{label}: not on the {route} route")
        want = prefill_attention_plain(*args, window=window)
        err = compare(torch, label, out, want, tol)
        rel = slot_rel_err(torch, label, out, want)
        alone = [kernel(q[i:i + 1], kp, vp, table[i:i + 1], starts[i:i + 1],
                        *scales, window=window) for i in range(b)]
        if not torch.equal(call(), out) or not all(
                torch.equal(one, out[i:i + 1]) for i, one in enumerate(alone)):
            raise AssertionError(f"{label}: a rerun or a slot alone changed "
                                 f"bits")
        # keys each query row sees, and the K/V rows and pages each slot
        # reads
        seen = sum(min(s + i + 1, window) if window else s + i + 1
                   for s in st for i in range(c))
        lo = [max(0, s - window + 1) if window else 0 for s in st]
        kv_rows = sum(s + c - k for s, k in zip(st, lo))
        pages = sum(-(-(s + c) // page) - k // page for s, k in zip(st, lo))
        elem = 1 if int8 else q.element_size()
        nbytes = (q.numel() * q.element_size() + 2 * kv_rows * hkv * hd * elem
                  + (2 * pages * hkv * 4 if int8 else 0)
                  + table.numel() * 4 + b * 4 + q.numel() * 4)
        rows.append(row(
            name, f"{case} window={window}" + (" int8 pools" if int8
                                               else ""),
            dtype_name, err, time_ms(torch, call, reps),
            time_ms(torch, lambda: prefill_attention_plain(
                *args, window=window), reps),
            bound(nbytes, 4.0 * hd * h * seen, dtype_name),
            device_ms=device_ms(torch, call, 20), route=route, split=split,
            slot_rel_err=rel))
    del kp, vp, args
    torch.cuda.empty_cache()
    return rows


def check_prefill(torch, dtype_name: str):
    rows = []
    for int8 in (False, True):
        rows += prefill_rows(torch, dtype_name, PREFILL_SERVE, int8, 20)
    if dtype_name == "bfloat16":
        for int8 in (False, True):
            rows += prefill_rows(torch, dtype_name, PREFILL_LONG, int8, 10)
        rows += prefill_rows(torch, dtype_name, PREFILL_QWEN, False, 10)
        for int8 in (False, True):
            rows += prefill_rows(torch, dtype_name, PREFILL_VERIFY, int8, 20)
        for shape in PREFILL_MOE:
            for int8 in (False, True):
                rows += prefill_rows(torch, dtype_name, shape, int8, 20)
    return rows


def _live_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal (windowed) attention of length s
    scores."""
    return sum(min(i + 1, window) if window else i + 1 for i in range(s))


# B6/B7 cases beyond the training shape, bf16 only: the wgmma route's other
# head widths at gemma-2b's model width (H x hd = 2048), causal (SDPA
# timed beside) and one windowed
FLASH_BF16_CASES = ((256, 0), (256, 128), (128, 0), (64, 0), (128, 128))
# B7 on the wgmma route splits the fp32 dO into bf16 halves, hi + lo
# (~2^-16 relative).  Each gradient's ||got - plain|| / ||plain|| is held
# to a limit well above the kernel's readings and well below those of a
# build that loses one lo product (both in PERF.md §6)
BWD_SPLIT_LIMIT = {"dq": 6e-4, "dk": 6e-4, "dv": 1e-4}
FLASH_F32_CASES = ((256, 0), (256, 128))
# the model drafter's forward in the speculative serve runs (Model.forward
# on gemma-2b's heads, the K/V heads expanded): 4 slots of max_len 256 + 3
# drafts, a sequence that ends 3 rows into its last 64-row tile
FLASH_DRAFTER = dict(b=4, h=8, s=259, hd=256)


def check_flash(torch, dtype_name: str):
    """B6 and B7 at the training shape (and, in bf16, at hd 128 and 64)
    against their plain versions; B7 twice on the same inputs must give
    the same bits.  Library: one ``scaled_dot_product_attention(
    is_causal=True)`` call and its backward, timed beside the causal
    cases only (it has no window).  Each row names the route
    ``flash_route`` chose and holds the route counts to it."""
    import torch.nn.functional as F

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attention import (flash_attention_bwd_cuda,
                                               flash_attention_bwd_plain,
                                               flash_attention_cuda,
                                               flash_attention_plain)
    from repro_torch.kernels.attention.flash import flash_route
    dtype = getattr(torch, dtype_name)
    b, s = TRAIN_SHAPE["b"], TRAIN_SHAPE["s"]
    width = TRAIN_SHAPE["h"] * TRAIN_SHAPE["hd"]
    rows = []
    cases = FLASH_BF16_CASES if dtype_name == "bfloat16" else FLASH_F32_CASES
    for hd, window in cases:
        h = width // hd
        gen = torch.Generator(device="cuda").manual_seed(5 + hd)
        q, k, v = (torch.randn(b, h, s, hd, generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        do = torch.randn(b, h, s, hd, generator=gen, device="cuda")
        size, n = q.element_size(), q.numel()
        route = flash_route(dtype, hd)
        case = f"B={b} H={h} S={s} hd={hd} causal window={window}"
        kw = dict(causal=True, window=window)
        dispatch.reset_launch_counts()
        o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        counts = dispatch.route_counts()
        if (counts[f"flash_attention/{route}"],
                counts[f"flash_attention_bwd/{route}"]) != (1, 1):
            raise AssertionError(f"flash {case} {dtype_name}: routes "
                                 f"{counts}, expected {route}")
        o_p, lse_p = flash_attention_plain(q, k, v, return_lse=True, **kw)
        err = max(compare(torch, "flash_attention " + case, o, o_p,
                          dtype_name),
                  compare(torch, "flash_attention lse " + case, lse, lse_p,
                          dtype_name))
        pairs = b * h * _live_pairs(s, window)
        lib_fwd = lib_bwd = None
        dev = {}   # device-only times (the event times may be host-paced)
        if window == 0:
            def sdpa():
                return F.scaled_dot_product_attention(q, k, v, is_causal=True)
            lib_fwd = time_ms(torch, sdpa)
            dev["library_device_ms"] = device_ms(torch, sdpa)
            qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
            do_lib = do.to(dtype)

            def sdpa_bwd():
                return torch.autograd.grad(out, (qg, kg, vg), do_lib,
                                           retain_graph=True)
            lib_bwd = time_ms(torch, sdpa_bwd)
            dev["library_bwd_device_ms"] = device_ms(torch, sdpa_bwd)
            del qg, kg, vg, out
        def fwd():
            return flash_attention_cuda(q, k, v, **kw)
        rows.append(row(
            "flash_attention", case, dtype_name, err, time_ms(torch, fwd),
            time_ms(torch, lambda: flash_attention_plain(q, k, v, **kw)),
            bound(3 * n * size + n * 4 + b * h * s * 4,
                  4.0 * hd * pairs, dtype_name), lib_fwd, route=route,
            device_ms=device_ms(torch, fwd),
            library_device_ms=dev.get("library_device_ms")))

        # the backward on the plain forward's o and lse
        got = flash_attention_bwd_cuda(q, k, v, o_p, lse_p, do, **kw)
        again = flash_attention_bwd_cuda(q, k, v, o_p, lse_p, do, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd {case}: two runs "
                                 f"on the same inputs differ")
        want = flash_attention_bwd_plain(q, k, v, o_p, lse_p, do, **kw)
        err = max(compare(torch, f"flash_attention_bwd {name} {case}",
                          g, w_, dtype_name)
                  for name, g, w_ in zip(("dq", "dk", "dv"), got, want))
        split = {}
        if route == "wgmma":
            split = {name: ((g - w_).norm() / w_.norm()).item()
                     for name, g, w_ in zip(("dq", "dk", "dv"), got, want)}
            if not all(split[n] <= BWD_SPLIT_LIMIT[n] for n in split):
                raise AssertionError(
                    f"flash_attention_bwd {case}: ||err|| / ||plain|| "
                    f"{split} over {BWD_SPLIT_LIMIT} (a lo half lost?)")
        del got, again, want
        # bytes: q, k, v in; o, dO fp32 and lse in; dq, dk, dv fp32 out.
        # operations: the five products of one pass (S and dP recomputed
        # once, dQ, dK, dV), 2 hd each per live pair
        def bwd():
            return flash_attention_bwd_cuda(q, k, v, o_p, lse_p, do, **kw)
        rows.append(row(
            "flash_attention_bwd", case, dtype_name, err, time_ms(torch, bwd),
            time_ms(torch, lambda: flash_attention_bwd_plain(
                q, k, v, o_p, lse_p, do, **kw)),
            bound(3 * n * size + 2 * n * 4 + b * h * s * 4 + 3 * n * 4,
                  10.0 * hd * pairs, dtype_name), lib_bwd,
            deterministic=True, route=route, device_ms=device_ms(torch, bwd),
            library_device_ms=dev.get("library_bwd_device_ms"),
            norm_rel_err=split or None))
        del q, k, v, do, o, lse, o_p, lse_p
    if dtype_name == "bfloat16":
        rows.append(flash_drafter_row(torch))
    return rows


def flash_drafter_row(torch):
    """B6 alone (the drafter runs no backward) at ``FLASH_DRAFTER`` in
    bf16, causal, on the wgmma route, against its plain version, beside
    one ``scaled_dot_product_attention(is_causal=True)`` call."""
    import torch.nn.functional as F

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attention import (flash_attention_cuda,
                                               flash_attention_plain)
    from repro_torch.kernels.attention.flash import flash_route
    b, h, s, hd = (FLASH_DRAFTER[k] for k in ("b", "h", "s", "hd"))
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn(b, h, s, hd, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    case = f"B={b} H={h} S={s} hd={hd} causal window=0 drafter"
    route = flash_route(torch.bfloat16, hd)
    dispatch.reset_launch_counts()
    o, lse = flash_attention_cuda(q, k, v, causal=True, return_lse=True)
    if (route, dispatch.route_counts()["flash_attention/wgmma"]) != (
            "wgmma", 1):
        raise AssertionError(f"flash {case}: route {route}, "
                             f"{dispatch.route_counts()}; expected wgmma")
    o_p, lse_p = flash_attention_plain(q, k, v, causal=True, return_lse=True)
    err = max(compare(torch, "flash_attention " + case, o, o_p, "bfloat16"),
              compare(torch, "flash_attention lse " + case, lse, lse_p,
                      "bfloat16"))

    def fwd():
        return flash_attention_cuda(q, k, v, causal=True)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)
    n = q.numel()
    r = row("flash_attention", case, "bfloat16", err, time_ms(torch, fwd),
            time_ms(torch, lambda: flash_attention_plain(q, k, v,
                                                         causal=True)),
            bound(3 * n * q.element_size() + n * 4 + b * h * s * 4,
                  4.0 * hd * b * h * _live_pairs(s, 0), "bfloat16"),
            time_ms(torch, sdpa), route=route, device_ms=device_ms(torch, fwd),
            library_device_ms=device_ms(torch, sdpa))
    del q, k, v, o, lse, o_p, lse_p
    return r


def check_matmul_backward(torch, dtype_name: str):
    """The matmul autograd backward at the down-projection's training
    shape (x (1024, 16384) @ w (16384, 2048)): both fp32 gradient GEMMs
    through B1 against the plain route on the same inputs."""
    from repro_torch.kernels import dispatch
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(6)
    m, k, n = TRAIN_BATCH * TRAIN_SEQ, 16384, 2048
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(k, n, generator=gen, device="cuda")
         / math.sqrt(k)).to(dtype)
    g = torch.randn(m, n, generator=gen, device="cuda").to(dtype)

    xg, wg = x.requires_grad_(True), w.requires_grad_(True)
    out = dispatch.matmul(xg, wg)

    def grads():
        return torch.autograd.grad(out, (xg, wg), g, retain_graph=True)

    def plain_grads():
        # the backward routes when it runs: the same graph, plain GEMMs
        with mock.patch.object(dispatch, "_on_card", lambda op, t: False):
            return grads()

    got, want = grads(), plain_grads()
    case = f"backward M={m} K={k} N={n} (dx = g @ w.T, dw = x.T @ g, fp32)"
    err = max(compare(torch, f"matmul {name} {case}", a, b_, dtype_name)
              for name, a, b_ in zip(("dx", "dw"), got, want))
    xf, wf, gf = x.detach().float(), w.detach().float(), g.float()
    size = x.element_size()
    r = row("matmul_bwd", case, dtype_name, err,
            time_ms(torch, grads, 3), time_ms(torch, plain_grads, 3),
            bound(size * (2 * m * k + 2 * k * n + m * n), 4.0 * m * n * k,
                  "float32"),
            time_ms(torch, lambda: (gf @ wf.T, xf.T @ gf), 3))
    del out, got, want
    x.requires_grad_(False)
    w.requires_grad_(False)
    return [r]


# ------------------------------------------------------------ phase 2b
# The kernel library (B8-B11).  Each input maker is seeded, so the
# library phase rebuilds the same inputs.
def rel_check(torch, name: str, got, want) -> tuple:
    """(max |got - want|, that over max |want|); raises above LIB_TOL or
    on a non-finite output."""
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs().max().item()
    rel = err / max(want.abs().max().item(), 1e-30)
    if not rel <= LIB_TOL:
        raise AssertionError(f"{name}: max |err| {err:.3e} is {rel:.3e} of "
                             f"max |out|, over {LIB_TOL}")
    return err, rel


def equal_check(torch, name: str, got, want) -> float:
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel and plain version differ")
    return 0.0


def wkv_inputs(torch, dtype_name: str, strong: bool, shape=None):
    """rwkv6-7b time-mix inputs: r, k, v in ``dtype_name``; log-decays
    -exp(-6 + noise) as the decay LoRA gives at init (w0 = -6,
    repro/models/rwkv.py:68), or with ``strong`` in [-50, -20] on a grid
    of 1/4 (exact cumsums in fp32, so the comparison is not fp32's
    conditioning at |cum| ~ 3000); u and the rest N(0, 1)."""
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(7 + strong)
    shape = tuple((shape or WKV_SHAPE)[x] for x in ("b", "s", "h", "hd"))
    r, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    if strong:
        lw = -torch.randint(80, 201, shape, generator=gen,
                            device="cuda").float() / 4
    else:
        lw = -torch.exp(-6 + 0.5 * torch.randn(shape, generator=gen,
                                               device="cuda"))
    u = torch.randn(shape[2:], generator=gen, device="cuda")
    return r, k, v, lw, u


def wkv_ops(b: int, s: int, h: int, hd: int, c: int, sc: int) -> float:
    """Operations the chunked WKV needs, in the TPU kernel's sub-chunked
    form (repro/kernels/wkv/wkv.py:57-86) with sub-chunks of ``sc``.  Per
    chunk: the inclusive cumsum (c hd); the inter-chunk product with its
    row scaling (2 c hd^2 + 2 c hd); the state update, each key row
    scaled by one exponential, the state by another (2 c hd^2 + 3 c hd +
    2 hd^2 + hd); the bonus and its product with v (5 c hd).  Intra-chunk:
    the rows of every sub-chunk after the first scaled once (3 hd each);
    per off-diagonal sub-block, its key columns scaled (3 sc hd) and
    2 operations per (i, j, channel); per diagonal sub-block, the direct
    form at 5 operations per (i, j < i, channel); then the (c, c) @
    (c, hd) product over j < i and its add into the output (c^2 hd)."""
    n_sc = c // sc
    off_blocks = n_sc * (n_sc - 1) // 2
    intra = (3 * (c - sc) * hd
             + off_blocks * (3 * sc * hd + 2 * sc * sc * hd)
             + n_sc * 5 * hd * sc * (sc - 1) // 2
             + c * c * hd)
    per_chunk = (4 * c * hd * hd + 2 * hd * hd + hd + 11 * c * hd + intra)
    return float(b * h * (s // c) * per_chunk)


def wkv_mma_issued(b: int, s: int, h: int, hd: int, c: int, sc: int,
                   dtype_name: str) -> tuple:
    """(tensor-core flops, FP32-pipe operations) that the mma route
    (csrc/wkv.cu) issues, for diagnosis only (never the row's bound, which
    counts the function's own work, ``wkv_ops``): m16n8k16 products of
    4096 flops, three per split product and two where v is bf16 (exact),
    over the off-diagonal tiles, the inter-chunk term, the state update
    and the blocks of A on or below the diagonal; on the FP32 pipe at
    least 5 operations per (i, j < i, channel) of the diagonal
    sub-blocks, 3 per element for the bonus and 6 for the scaled tiles.
    Follows the kernel's loop nest: update it with the kernel."""
    from repro_torch.kernels.wkv.wkv import wkv_piece
    p = wkv_piece(c, sc)
    mt, v_terms = hd // 16, (2 if dtype_name == "bfloat16" else 3)
    off = sum(min(p // 8, (mi * 16 + 15) // sc * sc // 8)
              for mi in range(p // 16)) * (hd // 16) * 3
    inter = mt * (hd // 16) * (p // 8) * 3
    state = mt * (hd // 8) * (p // 16) * v_terms
    intra = mt * v_terms * sum(
        1 for s_ in range(p // 16) for it in range(p // 8)
        if it * 8 // sc >= s_ * 16 // sc)
    pieces = b * h * (s // p)
    fp32 = (p // sc) * sc * (sc - 1) // 2 * hd * 5 + 9 * p * hd
    return 4096.0 * (off + inter + state + intra) * pieces, fp32 * pieces


# phase 2b's WKV rows: (dtype, strong decays, shape, the route
# ``wkv_route`` gives it); fp32 at hd 128 holds the simt kernel at full
# width
WKV_ROWS = (("bfloat16", False, WKV_SHAPE, "mma"),
            ("float32", False, WKV_SHAPE, "mma"),
            ("float32", True, WKV_SHAPE, "mma"),
            ("bfloat16", False, WKV_WIDE_SHAPE, "mma"),
            ("float32", False, WKV_WIDE_SHAPE, "simt"))


def check_wkv(torch):
    from repro_torch.kernels.wkv import wkv_cuda, wkv_plain
    from repro_torch.kernels.wkv.wkv import (subchunk_len, wkv_piece,
                                             wkv_route, wkv_tiles)
    from repro_torch.models.rwkv import chunk_len
    rows = []
    for dtype_name, strong, shape, want_route in WKV_ROWS:
        b, s, h, hd = (shape[x] for x in ("b", "s", "h", "hd"))
        c = chunk_len(s, WKV_CHUNK)
        sc = subchunk_len(c, WKV_SUBCHUNK)
        r, k, v, lw, u = wkv_inputs(torch, dtype_name, strong, shape)
        case = (f"B={b} S={s} H={h} hd={hd} chunk={c} "
                f"decay={'strong' if strong else 'init'}")
        route = wkv_route(c, sc, hd, r.dtype)
        if route != want_route:
            raise AssertionError(f"wkv {case}: route {route}, not "
                                 f"{want_route}")

        def call():
            return wkv_cuda(r, k, v, lw, u, chunk=c, subchunk=WKV_SUBCHUNK)
        before = dict(wkv_cuda.routes)
        got = call()
        if wkv_cuda.routes[route] != before[route] + 1:
            raise AssertionError(f"wkv {case}: not on the {route} route")
        err, rel = rel_check(torch, "wkv " + case, got,
                             wkv_plain(r, k, v, lw, u, chunk=c))
        if not torch.equal(got, call()):
            raise AssertionError(f"wkv {case}: a rerun changed the bits")
        n = r.numel()
        nbytes = 3 * n * r.element_size() + 4 * n + 4 * h * hd + 4 * n
        if route == "mma":
            plan = {"subchunk": sc, "piece": wkv_piece(c, sc)}
            tc, fp32 = wkv_mma_issued(b, s, h, hd, c, sc, dtype_name)
            issued = {"issued_tensor_flops": tc, "issued_fp32_ops": fp32,
                      "issued_ms": max(tc / peak_ops("bfloat16"),
                                       fp32 / peak_ops("float32")) * 1e3}
        else:
            plan = dict(zip(("rows", "cols"), wkv_tiles(c, hd)))
            issued = {}
        rows.append(row(
            "wkv", case, dtype_name, err, time_ms(torch, call, 5),
            time_ms(torch, lambda: wkv_plain(r, k, v, lw, u, chunk=c), 2),
            bound(nbytes, wkv_ops(b, s, h, hd, c, sc), dtype_name), None,
            rel_err=rel, route=route, plan=plan, rerun_bit_equal=True,
            device_ms=device_ms(torch, call, 5),
            bound_peaks=f"bytes at 3.35 TB/s; the function's operations "
            f"(wkv_ops) at the {dtype_name} peak, "
            f"{peak_ops(dtype_name) / 1e12:g} TFLOP/s", **issued))
        del r, k, v, lw, u, got
    return rows


def wkv_bwd_ops(b: int, s: int, h: int, hd: int) -> float:
    """Operations the WKV recurrence's gradient needs, per (batch, step,
    head), at their least: the state and its gradient advanced by k v^T
    and r do^T (2 hd^2 each; the chunked form scales a chunk's state by
    its decay once), the state-side products dr' = S do, dk' = G v and
    dv' = G^T k (2 hd^2 each), 10 hd^2 in all; dlw as reverse running
    sums of r * dr' and k * dk' (the fewest operations; in fp32 that form
    cancels under strong decay, so the kernel sums terms that each carry
    w_t, at ~hd^2 / 64 + ~10 hd more a step, not counted here) and the
    bonus terms (v . do and r . (u * k), their products into dr, dk, dv,
    du), about 20 hd."""
    return float(b * s * h * (10 * hd * hd + 20 * hd))


def wkv_bwd_reference(torch, args, do):
    """The plain backward (the autograd of ``wkv_chunked``) in fp64, one
    batch row at a time, du summed over the rows: in fp32 its dlw is the
    difference of O(1) terms, whose rounding is most of a strong decay's
    dlw of e^-20 size; fp64 of one row at 4096 tokens holds ~26 GB of
    intra-chunk weights."""
    from repro_torch.kernels.wkv import wkv_bwd_plain
    r, k, v, lw, u = args
    parts = []
    for i in range(r.shape[0]):
        rows = [t[i:i + 1].double() for t in (r, k, v, lw)]
        parts.append(wkv_bwd_plain(*rows, u.double(), do[i:i + 1].double(),
                                   chunk=WKV_CHUNK))
        torch.cuda.empty_cache()
    grads = [torch.cat([p[j] for p in parts]) for j in range(4)]
    return grads + [sum(p[4] for p in parts)]


# phase 2b's WKV backward rows: (dtype, strong decays, shape)
WKV_BWD_ROWS = (("bfloat16", False, WKV_TRAIN_SHAPE),
                ("float32", False, WKV_TRAIN_SHAPE),
                ("float32", True, WKV_LONG_SHAPE))
WKV_BWD_NAMES = ("dr", "dk", "dv", "dlw", "du")


def check_wkv_bwd(torch):
    """The WKV backward kernel against the plain backward in fp64 on the
    same inputs (``wkv_bwd_reference``): each gradient within the row
    type's tolerance of its max |grad|, a rerun bit-equal, the call on
    the mma route (the chunked form on the tensor cores); times of the
    kernel (and of each of its four launches) and of the plain backward
    in the row's type (the model's CPU route), a bound from bytes and
    ``wkv_bwd_ops``."""
    from repro_torch.kernels.wkv import wkv_bwd_cuda, wkv_bwd_plain
    rows = []
    for dtype_name, strong, shape in WKV_BWD_ROWS:
        b, s, h, hd = (shape[x] for x in ("b", "s", "h", "hd"))
        args = wkv_inputs(torch, dtype_name, strong, shape)
        gen = torch.Generator(device="cuda").manual_seed(11 + strong)
        do = torch.randn(args[0].shape, generator=gen, device="cuda")
        case = (f"B={b} S={s} H={h} hd={hd} "
                f"decay={'strong' if strong else 'init'}")

        def call():
            return wkv_bwd_cuda(*args, do)
        before = wkv_bwd_cuda.routes["mma"]
        got = call()
        if wkv_bwd_cuda.routes["mma"] != before + 1:
            raise AssertionError(f"wkv_bwd {case}: not on the mma route")
        want = wkv_bwd_reference(torch, args, do)
        torch.cuda.synchronize()
        rel, err = {}, 0.0
        for name, g, w in zip(WKV_BWD_NAMES, got, want):
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"wkv_bwd {case}: non-finite {name}")
            e = (g.double() - w).abs().max().item()
            rel[name] = e / max(w.abs().max().item(), 1e-300)
            err = max(err, e)
        del want
        bad = {n: x for n, x in rel.items() if not x <= TOL[dtype_name]}
        if bad:
            raise AssertionError(f"wkv_bwd {case}: {bad} of max |grad|, "
                                 f"over {TOL[dtype_name]}")
        if not all(torch.equal(x, y) for x, y in zip(got, call())):
            raise AssertionError(f"wkv_bwd {case}: a rerun changed the bits")
        del got
        n = args[0].numel()
        nbytes = (3 * n * args[0].element_size() + 2 * 4 * n + 4 * h * hd
                  + 4 * 4 * n + 4 * h * hd)
        reps = 2 if s > WKV_TRAIN_SHAPE["s"] else 5
        launches = launch_device_ms(torch, call, reps)
        rows.append(row(
            "wkv_bwd", case, dtype_name, err, time_ms(torch, call, reps),
            time_ms(torch, lambda: wkv_bwd_plain(*args, do, chunk=WKV_CHUNK),
                    reps // 2),
            bound(nbytes, wkv_bwd_ops(b, s, h, hd), dtype_name), None,
            rel_err=rel, rerun_bit_equal=True, route="mma",
            device_ms=sum(launches.values()), launch_device_ms=launches,
            reference="plain backward in fp64",
            library="none: no PyTorch call computes WKV6's gradient",
            bound_peaks=f"bytes at 3.35 TB/s; the recurrence's operations "
            f"(wkv_bwd_ops) at the {dtype_name} peak, "
            f"{peak_ops(dtype_name) / 1e12:g} TFLOP/s"))
        del args, do
        torch.cuda.empty_cache()
    return rows


def stencil_input(torch, rows_: int, cols: int):
    gen = torch.Generator(device="cuda").manual_seed(rows_ + cols)
    return torch.randn(rows_, cols, generator=gen, device="cuda")


def check_stencil(torch):
    """B9 bit for bit against its plain version in fp32.  Library: one
    ``F.conv2d`` with the 3 x 3 cross kernel over the grid (the interior
    of one sweep), beside the one-sweep cases."""
    import torch.nn.functional as F

    from repro_torch.kernels.stencil import jacobi4_cuda, jacobi4_plain
    cross = torch.tensor([[0., .25, 0.], [.25, 0., .25], [0., .25, 0.]],
                         device="cuda").reshape(1, 1, 3, 3)
    out = []
    for rows_, cols, steps in STENCIL_CASES:
        x = stencil_input(torch, rows_, cols)
        case = f"{rows_}x{cols} steps={steps}"
        err = equal_check(torch, "stencil " + case,
                          jacobi4_cuda(x, steps=steps),
                          jacobi4_plain(x, steps=steps))
        library = None
        if steps == 1:
            x4 = x.reshape(1, 1, rows_, cols)
            library = time_ms(torch, lambda: F.conv2d(x4, cross))
        # the function reads the grid once and writes it once, however
        # many sweeps it makes; 4 operations per interior cell and sweep
        bnd = bound(2 * x.numel() * 4,
                    4.0 * steps * max(rows_ - 2, 0) * max(cols - 2, 0),
                    "float32")
        out.append(row(
            "stencil", case, "float32", err,
            time_ms(torch, lambda: jacobi4_cuda(x, steps=steps)),
            time_ms(torch, lambda: jacobi4_plain(x, steps=steps), 3),
            bnd, library, bit_equal=True,
            device_ms=device_ms(torch, lambda: jacobi4_cuda(x, steps=steps),
                                5)))
        del x
    return out


def nbody_inputs(torch, n: int):
    gen = torch.Generator(device="cuda").manual_seed(n)
    pos = torch.randn(3, n, generator=gen, device="cuda")
    mass = torch.rand(n, generator=gen, device="cuda") + 0.1
    return pos, mass


def sm_clocks_mhz() -> tuple:
    """The SM clock now and its maximum, MHz (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]
    now, most = (float(x) for x in out.split(","))
    return now, most


def check_nbody(torch):
    from repro_torch.kernels.nbody import nbody_accel_cuda, nbody_accel_plain
    from repro_torch.kernels.nbody.nbody import (TARGETS_PER_THREAD,
                                                 nbody_split_plan)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for n in NBODY_SIZES:
        pos, mass = nbody_inputs(torch, n)
        got = nbody_accel_cuda(pos, mass)
        err, rel = rel_check(torch, f"nbody N={n}", got,
                             nbody_accel_plain(pos, mass))
        if not torch.equal(got, nbody_accel_cuda(pos, mass)):
            raise AssertionError(f"nbody N={n}: a rerun changed the bits")
        ms = time_ms(torch, lambda: nbody_accel_cuda(pos, mass), 5)
        dev = device_ms(torch, lambda: nbody_accel_cuda(pos, mass), 5)
        clock, clock_max = sm_clocks_mhz()
        # 19 operations per pair, an FMA counted as 2 (nbody.cu's header);
        # and 12 FP32-pipe instructions a pair on 128 lanes an SM
        out.append(row(
            "nbody", f"N={n}", "float32", err, ms,
            time_ms(torch, lambda: nbody_accel_plain(pos, mass), 2),
            bound(28.0 * n, 19.0 * n * n, "float32"), None, rel_err=rel,
            rerun_bit_equal=True, device_ms=dev,
            split=list(nbody_split_plan(n)),
            targets_per_thread=TARGETS_PER_THREAD,
            issue_bound_ms=12.0 * n * n / (sms * FP32_LANES
                                           * clock_max * 1e6) * 1e3,
            sm_clock_mhz=clock, sm_clock_max_mhz=clock_max))
        del pos, mass, got
    return out


def histogram_inputs(torch, kind: str):
    gen = torch.Generator(device="cuda").manual_seed(11)
    if kind.startswith("uniform"):
        vals = torch.randint(0, HIST_CASES[kind][1], (HIST_N,),
                             generator=gen, device="cuda")
    elif kind.startswith("one bin"):  # every update hits one address
        vals = torch.full((HIST_N,), 7, device="cuda")
    else:                            # out of range both ways: dropped
        vals = torch.tensor([0, 1, 255, 256, 300, -1, -5, 3] * 4,
                            device="cuda")
    return vals.to(torch.int32)


# kind: (case, n_bins)
HIST_CASES = {"uniform": (f"N=2^26 bins={HIST_BINS} uniform", HIST_BINS),
              "one bin": (f"N=2^26 bins={HIST_BINS} one bin", HIST_BINS),
              "out of range": ("N=32 bins=256 out of range", HIST_BINS),
              "uniform wide": ("N=2^26 bins=2^20 uniform", HIST_WIDE_BINS),
              "one bin wide": ("N=2^26 bins=2^20 one bin", HIST_WIDE_BINS)}


def check_histogram(torch):
    """Exact counts, on the route ``histogram_route`` names (2^20 bins:
    the one-pass route), with the profiler's device time.  Library:
    ``torch.bincount(values, minlength=bins)`` where every value is in
    range."""
    from repro_torch.kernels.histogram import histogram_cuda, histogram_plain
    from repro_torch.kernels.histogram.histogram import histogram_route
    out = []
    for kind, (case, bins) in HIST_CASES.items():
        vals = histogram_inputs(torch, kind)
        got = histogram_cuda(vals, bins)
        err = equal_check(torch, "histogram " + case, got,
                          histogram_plain(vals, bins))
        if kind == "out of range" and int(got.sum()) != 16:
            raise AssertionError(f"histogram {case}: counted {got.sum()}")
        library = None
        if kind != "out of range":
            library = time_ms(torch, lambda: torch.bincount(
                vals, minlength=bins))
        out.append(row(
            "histogram", case, "int32", err,
            time_ms(torch, lambda: histogram_cuda(vals, bins)),
            time_ms(torch, lambda: histogram_plain(vals, bins)),
            # one compare-and-add per value, at the scalar rate
            bound(4.0 * vals.numel() + 4 * bins, float(vals.numel()),
                  "float32"), library, exact=True,
            route=histogram_route(bins),
            device_ms=device_ms(torch, lambda: histogram_cuda(vals, bins))))
        del vals
    return out


# ------------------------------------------------------------ library
LIBRARY_KERNELS = ("wkv", "stencil", "nbody", "histogram")


def library_phase(torch):
    """The four public ops of the kernel library on CUDA tensors at the
    phase-2b sizes, with every launch count set to 0 just before and read
    just after: only kernel routes, exactly one launch per call (the
    stencil one per sweep).  The outputs are then held to the plain
    versions, after the counts are read."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.histogram import histogram, histogram_plain
    from repro_torch.kernels.nbody import nbody_accel, nbody_accel_plain
    from repro_torch.kernels.stencil import jacobi4, jacobi4_plain
    from repro_torch.kernels.wkv import wkv, wkv_plain
    # rwkv6-7b in bf16 (the mma route) and in fp32 at hd 128 (simt)
    w_args = [wkv_inputs(torch, "bfloat16", False),
              wkv_inputs(torch, "float32", False, WKV_WIDE_SHAPE)]
    grids = [(stencil_input(torch, r_, c_), steps)
             for r_, c_, steps in STENCIL_CASES]
    bodies = [nbody_inputs(torch, n) for n in NBODY_SIZES]
    hists = [(histogram_inputs(torch, kind), bins)
             for kind, (_, bins) in HIST_CASES.items()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dispatch.reset_launch_counts()
    with dispatch.stats_scope() as stats:
        w_out = [wkv(*args, chunk=WKV_CHUNK, subchunk=WKV_SUBCHUNK)
                 for args in w_args]
        s_out = [jacobi4(x, steps=steps) for x, steps in grids]
        n_out = [nbody_accel(pos, mass) for pos, mass in bodies]
        h_out = [histogram(vals, bins) for vals, bins in hists]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dispatch.launch_counts()
        routes = stats()
    want_routes = {("wkv", "kernel"): len(w_args),
                   ("stencil", "kernel"): len(grids),
                   ("nbody", "kernel"): len(bodies),
                   ("histogram", "kernel"): len(hists)}
    want = {op: 0 for op in launches}
    want.update(wkv=len(w_args),
                stencil=sum(steps for _, steps in grids),
                nbody=len(bodies), histogram=len(hists))
    emit({"phase": "library", "seconds": seconds,
          "routes": {f"{op}/{route}": n for (op, route), n in routes.items()},
          "launches": {op: launches[op] for op in LIBRARY_KERNELS},
          "kernel_routes": {k: n for k, n in dispatch.route_counts().items()
                            if k.startswith("wkv/")}})
    if routes != want_routes:
        raise AssertionError(f"library: routes {routes}, expected "
                             f"{want_routes}")
    if launches != want:
        raise AssertionError(f"library: launches {launches}, expected "
                             f"{want}")
    wkv_routes = {k: n for k, n in dispatch.route_counts().items()
                  if k.startswith("wkv/")}
    if wkv_routes != {"wkv/mma": 1, "wkv/simt": 1}:
        raise AssertionError(f"library: wkv routes {wkv_routes}")
    for args, got in zip(w_args, w_out):
        rel_check(torch, "library wkv", got,
                  wkv_plain(*args, chunk=WKV_CHUNK))
    for (x, steps), got in zip(grids, s_out):
        equal_check(torch, "library stencil", got,
                    jacobi4_plain(x, steps=steps))
    for (pos, mass), got in zip(bodies, n_out):
        rel_check(torch, "library nbody", got, nbody_accel_plain(pos, mass))
    for (vals, bins), got in zip(hists, h_out):
        equal_check(torch, "library histogram", got,
                    histogram_plain(vals, bins))
    emit({"phase": "library", "outputs_match_plain": True})
    return {op: launches[op] for op in LIBRARY_KERNELS}


def library_inputs_phase(torch):
    """The public ops on what their plain routes take and the kernels do
    not read as they are: a transposed or strided view, a contiguous view
    at an odd offset (off a 16-byte boundary), and int64 histogram values
    past 2^32 (which a bare int32 cast would wrap into range).  Every call
    on its kernel route; results equal the plain route's exactly (B9,
    B11) or within LIB_TOL of max |plain output| (B8, B10)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.histogram import histogram, histogram_plain
    from repro_torch.kernels.nbody import nbody_accel, nbody_accel_plain
    from repro_torch.kernels.stencil import jacobi4, jacobi4_plain
    from repro_torch.kernels.wkv import wkv, wkv_plain
    t0 = time.time()

    def odd(t):
        """A contiguous copy of t one element past a 16-byte boundary."""
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out

    def transposed(t, dims):
        """t's values as a view with the strides of a transpose."""
        return t.transpose(*dims).contiguous().transpose(*dims)

    r, k, v, lw, u = wkv_inputs(torch, "bfloat16", False)
    w_args = (transposed(r, (1, 2)), odd(k), odd(v), transposed(lw, (0, 1)),
              u)
    grid = stencil_input(torch, 8192, 8192)
    grids = (grid.T, grid[1:-1, 3:-2], odd(grid))
    pos, mass = nbody_inputs(torch, NBODY_SIZES[0])
    bodies = ((pos.T.contiguous().T, mass), (odd(pos), odd(mass)),
              (transposed(pos, (0, 1)), torch.stack([mass, mass], 1)[:, 0]))
    gen = torch.Generator(device="cuda").manual_seed(9)
    vals = torch.randint(-5, HIST_BINS + 5, (HIST_N,), generator=gen,
                         device="cuda")
    vals[::7] += 1 << 32          # an int32 cast would wrap these back
    vals[1::11] = (1 << 33) + 3
    hists = (vals, vals[::3], odd(vals[::2].to(torch.int32)))
    with dispatch.stats_scope() as stats:
        w_out = wkv(*w_args, chunk=WKV_CHUNK, subchunk=WKV_SUBCHUNK)
        s_out = [jacobi4(x) for x in grids]
        n_out = [nbody_accel(p, m) for p, m in bodies]
        h_out = [histogram(x, HIST_BINS) for x in hists]
        torch.cuda.synchronize()
        routes = stats()
    if any(route == "plain" for _, route in routes):
        raise AssertionError(f"library inputs: plain routes {routes}")
    errs = {"wkv": rel_check(torch, "library inputs wkv", w_out,
                             wkv_plain(*w_args, chunk=WKV_CHUNK))[1]}
    for x, got in zip(grids, s_out):
        equal_check(torch, "library inputs stencil", got, jacobi4_plain(x))
    errs["nbody"] = max(rel_check(torch, "library inputs nbody", got,
                                  nbody_accel_plain(p, m))[1]
                        for (p, m), got in zip(bodies, n_out))
    for x, got in zip(hists, h_out):
        equal_check(torch, "library inputs histogram", got,
                    histogram_plain(x, HIST_BINS))
    if h_out[0].sum().item() != int(((vals >= 0) & (vals < HIST_BINS)).sum()):
        raise AssertionError("library inputs: out-of-range int64 counted")
    emit({"phase": "library_inputs", "routes": {
        f"{op}/{route}": n for (op, route), n in routes.items()},
        "rel_err": errs, "stencil_histogram_exact": True,
        "seconds": time.time() - t0})


# ------------------------------------------------------------ phase 3
FLOAT_PATH = ("matmul", "decode_attention", "prefill_attention")
INT8_PATH = ("matmul", "quantized_matmul", "decode_attention_int8",
             "prefill_attention_int8")


def serve_run(torch, label, argv, path):
    """One ``serve.main`` run with every launch count set to 0 just before
    it and read just after; raises on a plain route, on a kernel of
    ``path`` that never launched, on one off the path that did, or on a
    prefill (verify included) or flash call off the wgmma route."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    dispatch.reset_launch_counts()
    rep = serve.main(argv)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    attn_routes = {k: n for k, n in dispatch.route_counts().items()
                   if k.startswith(("prefill_attention", "flash_attention/"))}
    streams = {r.rid: list(r.out) for r in rep["done"]}
    emit({"phase": "serve", "run": label,
          "requests": len(rep["done"]), "new_tokens": rep["new_tokens"],
          "tok_s": rep["tok_s"], "seconds": rep["seconds"],
          "ttft_p50": rep["ttft_p50"], "ttft_p99": rep["ttft_p99"],
          "phases": rep["phases"], "prefix": rep["prefix"],
          "dense": rep["dense"], "spec": rep["spec"],
          "max_resident_kv_bytes": rep["max_resident_kv_bytes"],
          "routes": {f"{op}/{route}": n
                     for (op, route), n in rep["routes"].items()},
          "launches": launches, "attention_routes": attn_routes,
          "streams": streams})
    plain = {k: n for k, n in rep["routes"].items() if k[1] == "plain"}
    if plain:
        raise AssertionError(f"{label}: plain routes on the card: {plain}")
    wrong = [op for op, n in launches.items() if (n > 0) != (op in path)]
    if wrong:
        raise AssertionError(f"{label}: launches off the expected path "
                             f"{path}: {launches}")
    # bf16 at gemma-2b's heads: every prefill call (verify windows
    # included) and every flash call (the model drafter) on wgmma
    want = {f"{op}/{route}": launches[op] if route == "wgmma" else 0
            for op in ("prefill_attention", "prefill_attention_int8",
                       "flash_attention")
            for route in ("wgmma", "simt")}
    if attn_routes != want:
        raise AssertionError(f"{label}: attention routes {attn_routes}, "
                             f"expected {want}")
    return rep, streams, launches


def serve_phase(torch):
    launches = {}

    def add(counts):
        for op, n in counts.items():
            launches[op] = launches.get(op, 0) + n

    kv_bytes = {}
    base_streams = {}
    base_runs = {}
    for name, extra, path in (("float", [], FLOAT_PATH),
                              ("int8+prefix", INT8_ARGS + PREFIX_ARGS,
                               INT8_PATH)):
        streams = {}
        for schedule, sched_args in (("static", []),
                                     ("continuous", ["--clock", "tick"])):
            rep, streams[schedule], counts = serve_run(
                torch, f"{name} {schedule}",
                SERVE_ARGS + extra + ["--schedule", schedule] + sched_args,
                path)
            add(counts)
            base_runs[f"{name} {schedule}"] = (counts, rep["phases"])
            if len(rep["done"]) != 6 or any(len(r.out) != 16
                                            for r in rep["done"]):
                raise AssertionError(f"{name} {schedule}: not every request "
                                     f"served")
            if rep["prefix"] is not None and rep["prefix"]["hits"] == 0:
                raise AssertionError(f"{name} {schedule}: no prefix hit")
            if schedule == "continuous":
                kv_bytes[name] = rep["max_resident_kv_bytes"]
        if streams["static"] != streams["continuous"]:
            raise AssertionError(f"{name}: static and continuous streams "
                                 f"differ:\n{streams['static']}\n"
                                 f"{streams['continuous']}")
        base_streams[name] = streams["static"]
        emit({"phase": "serve", "run": name, "identical_streams": True})
    emit({"phase": "serve", "max_resident_kv_bytes": kv_bytes})

    # fully covered: every request after the first binds the cached page
    # and takes its first token through a decode that copies that page
    rep, shared, counts = serve_run(
        torch, "int8 fully-covered static",
        COVERED_ARGS + INT8_ARGS + ["--prefix-cache"], INT8_PATH)
    add(counts)
    if rep["prefix"]["cow_copies"] < 1:
        raise AssertionError(f"fully-covered run made no copy: "
                             f"{rep['prefix']}")
    _, alone, counts = serve_run(torch, "int8 unshared static",
                                 COVERED_ARGS + INT8_ARGS, INT8_PATH)
    add(counts)
    if shared != alone:
        raise AssertionError(f"sharing changed the streams:\n{shared}\n"
                             f"{alone}")
    emit({"phase": "serve", "run": "int8 fully-covered",
          "cow_copies": rep["prefix"]["cow_copies"],
          "streams_equal_unshared": True})
    return launches, base_streams, base_runs


# ------------------------------------------------------------ phase 3b
DENSE_PATHS = {"float": ("matmul", "decode_attention"),
               "int8 weights": ("matmul", "quantized_matmul",
                                "decode_attention")}


def dense_serve_phase(torch):
    """The dense cache through ``serve.main``, float and int8 weights:
    prompts teacher-forced through the decode step at one shared
    position, every attention layer on B2 over its cache viewed as pages.
    Every request served in full; launches exactly B1 and B2 (and B5)."""
    t0 = time.time()
    launches = {}
    for name, extra in (("float", []),
                        ("int8 weights", ["--weights-dtype", "int8"])):
        rep, streams, counts = serve_run(torch, f"dense {name}",
                                         DENSE_ARGS + extra,
                                         DENSE_PATHS[name])
        for op, n in counts.items():
            launches[op] = launches.get(op, 0) + n
        if len(rep["done"]) != 6 or any(len(r.out) != 16
                                        for r in rep["done"]) \
                or rep["dense"]["truncated"] or rep["dense"]["rejected"]:
            raise AssertionError(f"dense {name}: not every request served "
                                 f"in full: {rep['dense']}")
        ph = rep["phases"]
        emit({"phase": "dense_serve", "run": name,
              "decode_steps": ph["decode_steps"],
              "decode_ms_per_step": 1e3 * ph["decode_seconds"]
              / ph["decode_steps"],
              "new_tokens": rep["new_tokens"], "tok_s": rep["tok_s"],
              "decode_attention_launches": counts["decode_attention"],
              "streams": streams})
    emit({"phase": "dense_serve", "seconds": time.time() - t0})
    return launches


# ------------------------------------------------------------ phase 3c
SPEC_RUNS = (  # (label, base run, extra arguments, schedule)
    ("ngram static", "float", ["--speculate", "ngram"], "static"),
    ("ngram continuous", "float", ["--speculate", "ngram"], "continuous"),
    ("model static", "float", ["--speculate", "model"], "static"),
    ("model continuous", "float", ["--speculate", "model"], "continuous"),
    ("int8+prefix ngram static", "int8+prefix",
     INT8_ARGS + PREFIX_ARGS + ["--speculate", "ngram"], "static"))


def spec_path(base: str, extra: list, schedule: str) -> tuple:
    """The kernels a speculative run launches: the GEMMs and the prefill
    kernel of its pools (prompts, then every verify window); B6 for the
    model drafter's forwards; B2 only in the continuous engine's warm-up
    decode."""
    path = (("matmul", "quantized_matmul", "prefill_attention_int8")
            if base == "int8+prefix" else ("matmul", "prefill_attention"))
    if "model" in extra:
        path += ("flash_attention",)
    if schedule == "continuous":
        path += ("decode_attention_int8" if base == "int8+prefix"
                 else "decode_attention",)
    return path


def spec_serve_phase(torch, base_streams):
    """Speculative decoding through ``serve.main`` on the paged cache: the
    n-gram and the model drafter (static and continuous), and int8 +
    prefix with the n-gram drafter.  Each run's streams must equal the
    non-speculative run's of phase 3; every verify call on B3/B4b's wgmma
    route; B6 launched by the model drafter alone."""
    t0 = time.time()
    launches = {}
    for label, base, extra, schedule in SPEC_RUNS:
        argv = SERVE_ARGS + extra + SPEC_ARGS + ["--schedule", schedule]
        if schedule == "continuous":
            argv += ["--clock", "tick"]
        rep, streams, counts = serve_run(torch, f"spec {label}", argv,
                                         spec_path(base, extra, schedule))
        for op, n in counts.items():
            launches[op] = launches.get(op, 0) + n
        if streams != base_streams[base]:
            raise AssertionError(f"spec {label}: streams differ from the "
                                 f"non-speculative run:\n{streams}\n"
                                 f"{base_streams[base]}")
        sp = rep["spec"]
        emit({"phase": "spec_serve", "run": label,
              "verify_steps": sp["verify_steps"], "drafted": sp["drafted"],
              "accepted": sp["accepted"], "accept_rate": sp["accept_rate"],
              "tokens_per_step": sp["tokens_per_step"],
              "verify_ms_per_step": 1e3 * sp["verify_seconds"]
              / sp["verify_steps"],
              "draft_ms_per_step": 1e3 * sp["draft_seconds"]
              / sp["verify_steps"],
              "new_tokens": rep["new_tokens"], "tok_s": rep["tok_s"],
              "flash_launches": counts["flash_attention"],
              "streams_equal_non_speculative": True})
    emit({"phase": "spec_serve", "seconds": time.time() - t0})
    return launches


# ------------------------------------------------------------ phase 3f
# tensor-parallel paged serving (runtime/tp.py, serve --mesh) and the
# expert-parallel MoE (models/moe_sharded.py).  One card runs one rank of
# its own, so a mesh of N >= 2 runs here as N ranks sharing cuda:0 over
# gloo (NCCL refuses two ranks on one device), every collective staged
# through host memory: a check of the sharded path at shard shapes, not a
# speed result.
QWEN_ARCH = "codeqwen1.5-7b"
TP_QWEN_ARGS = ["--arch", QWEN_ARCH] + SERVE_ARGS[2:]
KV8_PATH = ("matmul", "decode_attention_int8", "prefill_attention_int8")
W8_PATH = ("matmul", "quantized_matmul", "decode_attention",
           "prefill_attention")
# (label, arguments, path, streams held equal to the one-process run's).
# gemma-2b's random weights echo the input (ROADMAP Queue 3), so its
# streams hold; codeqwen1.5-7b's untied random head leaves near-ties that
# bf16 roundings decide, and a shard's row-parallel sum rounds otherwise
# than one GEMM does: its bf16 streams are compared with the one-process
# run's and reported (first divergence), and the exact comparison is made
# in fp32 (TP_FP32_LAYERS layers: tp_fp32_streams); int8 weights carry
# their shard's own scales, so that run is held to its ranks only
TP_RUNS = (
    ("gemma-2b float", SERVE_ARGS, FLOAT_PATH, True),
    ("codeqwen1.5-7b float", TP_QWEN_ARGS, FLOAT_PATH, False),
    ("codeqwen1.5-7b int8 pools", TP_QWEN_ARGS + ["--kv-dtype", "int8"],
     KV8_PATH, False),
    ("gemma-2b int8 weights", SERVE_ARGS + ["--weights-dtype", "int8"],
     W8_PATH, False))
TP_FP32_LAYERS = 2
# every tp run on the continuous engine's tick clock, as phase 3's
# continuous runs: its decode steps are timed
TP_SCHEDULE = ["--schedule", "continuous", "--clock", "tick"]
TP_RANKS = 2
TP_LOGITS_LAYERS = 2
TP_LOGITS_LIMIT = 1e-4
# the MoE layer at qwen2-moe-a2.7b's width: 2 x 128 tokens, capacity
# factor E / k = 15, so a capacity of every token an expert could get
# (no drop on either path); fp32 within 1e-5 of max |out|, bf16 5e-2
TP_MOE_TOKENS = (2, 128)
TP_MOE_LIMIT = {"float32": 1e-5, "bfloat16": 5e-2}
# B1 at the tp = 2 shards' shapes: gemma-2b's column-parallel wq (N = 4
# heads of 256) and up projections (N = 8192), its row-parallel wd (K =
# 8192); codeqwen1.5-7b's wq (N = 16 heads of 128), up projections (N =
# 6720) and wd (K = 6720)
TP_WEIGHT_SHAPES = ((2048, 1024), (2048, 8192), (8192, 2048),
                    (4096, 2048), (4096, 6720), (6720, 4096))
# B2/B3 at gemma-2b's 4 q heads over 1 kv head and codeqwen1.5-7b's 16
# over 16, on the serve runs' 256-key table
DECODE_TP = [dict(DECODE_SERVE, h=4, windows=(0,)),
             dict(DECODE_SERVE, h=16, hkv=16, hd=128, windows=(0,))]
PREFILL_TP = [dict(PREFILL_SERVE, h=4, windows=(0,), route="wgmma"),
              dict(PREFILL_SERVE, h=16, hkv=16, hd=128, windows=(0,),
                   route="wgmma")]


def check_tp_shapes(torch):
    """Phase 3f's kernel rows: B1 (bf16) at the shards' weight shapes and
    B5 at gemma-2b's row-parallel wd (K = 8192) with scales of that K
    slice, M = 4 and 256, each against its plain version with the
    profiler's device time and ``torch.matmul``; B2/B4a and B3/B4b at the
    shards' heads."""
    from repro_torch.core.quant import quantize_channelwise
    from repro_torch.kernels.matmul import (matmul_cuda, matmul_plain,
                                            quantized_matmul_cuda,
                                            quantized_matmul_plain)
    from repro_torch.kernels.matmul.matmul import (quantized_split_plan,
                                                   split_plan)
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16 = torch.bfloat16
    rows = []
    for m in (4, 256):
        for k, n in TP_WEIGHT_SHAPES:
            a = torch.randn(m, k, generator=gen, device="cuda").to(bf16)
            b = (torch.randn(k, n, generator=gen, device="cuda")
                 / math.sqrt(k)).to(bf16)
            case = f"M={m} K={k} N={n} tp shard"
            err = compare(torch, "matmul " + case, matmul_cuda(a, b),
                          matmul_plain(a, b), "bfloat16")
            extra = {"device_ms": device_ms(torch,
                                            lambda: matmul_cuda(a, b)),
                     "library_device_ms": device_ms(
                         torch, lambda: torch.matmul(a, b)),
                     "split": list(split_plan(k, n, bf16))}
            rows.append(row(
                "matmul", case, "bfloat16", err,
                time_ms(torch, lambda: matmul_cuda(a, b)),
                time_ms(torch, lambda: matmul_plain(a, b)),
                bound((m * k + k * n + m * n) * 2, 2.0 * m * n * k,
                      "bfloat16"),
                time_ms(torch, lambda: torch.matmul(a, b)), **extra))
            if (k, n) == (8192, 2048):
                b_q, scale = quantize_channelwise(b)
                case = f"M={m} K={k} N={n} tp shard, scales of the shard"
                err = compare(torch, "quantized_matmul " + case,
                              quantized_matmul_cuda(a, b_q, scale),
                              quantized_matmul_plain(a, b_q, scale),
                              "float32")
                extra = {"device_ms": device_ms(
                    torch, lambda: quantized_matmul_cuda(a, b_q, scale)),
                         "split": list(quantized_split_plan(k, n, bf16))}
                rows.append(row(
                    "quantized_matmul", case, "bfloat16", err,
                    time_ms(torch, lambda: quantized_matmul_cuda(a, b_q,
                                                                 scale)),
                    time_ms(torch, lambda: quantized_matmul_plain(
                        a, b_q, scale)),
                    bound(k * n + n * 4 + m * k * 2 + m * n * 4,
                          2.0 * m * n * k, "bfloat16"), None, **extra))
                del b_q, scale
            del a, b
    for shape in DECODE_TP:
        for int8 in (False, True):
            rows += decode_rows(torch, "bfloat16", shape, int8, 50)
    for shape in PREFILL_TP:
        for int8 in (False, True):
            rows += prefill_rows(torch, "bfloat16", shape, int8, 20)
    torch.cuda.empty_cache()
    return rows


def tp_serve_run(torch, label, argv, path):
    """One ``serve.main`` run on a mesh, the launch counts set to 0 just
    before it and read just after: the report's numbers, and a raise on a
    plain route, on a kernel off ``path``, on a prefill call off wgmma, or
    on a call inside the sharded step that took no kernel route."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    dispatch.reset_launch_counts()
    rep = serve.main(argv)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    routes = dispatch.route_counts()
    plain = {k: n for k, n in rep["routes"].items() if k[1] == "plain"}
    tp_plain = {k: n for k, n in rep["tp_routes"].items()
                if k[1] != "kernel"}
    wrong = [op for op, n in launches.items() if (n > 0) != (op in path)]
    off = {k: n for k, n in routes.items()
           if k.startswith("prefill_attention") and k.endswith("/simt")
           and n}
    if plain or tp_plain or wrong or off:
        raise AssertionError(f"{label}: plain routes {plain}, in the scope "
                             f"{tp_plain}, launches {launches} (path "
                             f"{path}), prefill off wgmma {off}")
    ops = {op.replace("_int8", "") for op, _ in rep["tp_routes"]}
    if not {"decode_attention", "prefill_attention"} <= ops \
            or not ops & {"matmul", "quantized_matmul"}:
        raise AssertionError(f"{label}: the serving ops did not run inside "
                             f"the sharded step: {rep['tp_routes']}")
    return {"label": label, "tp": rep["tp"],
            "streams": {r.rid: list(r.out) for r in rep["done"]},
            "launches": launches, "seconds": rep["seconds"],
            "new_tokens": rep["new_tokens"],
            "decode_ms_per_step": decode_ms(rep["phases"]),
            "tp_routes": {f"{op}/{route}": n
                          for (op, route), n in rep["tp_routes"].items()}}


def decode_ms(phases: dict) -> float:
    """A continuous run's decode milliseconds a step."""
    return 1e3 * phases["decode_seconds"] / phases["decode_steps"]


def tp_fp32_streams(torch, kv_dtype: str, mesh=None) -> dict:
    """codeqwen1.5-7b at full width and TP_FP32_LAYERS layers in fp32,
    float or int8 pools: the greedy streams of phase 3's traffic through
    ``PagedScheduler`` and the continuous engine on the tick clock, on a
    mesh's shards or in one process."""
    from repro_torch.configs import get_arch
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.launch.engine import ContinuousEngine
    from repro_torch.launch.loadgen import poisson_stream
    from repro_torch.launch.serve import PagedScheduler
    from repro_torch.models.transformer import Model
    f32 = DtypePolicy(param=torch.float32, compute=torch.float32)
    cfg = dataclasses.replace(get_arch(QWEN_ARCH), n_layers=TP_FP32_LAYERS,
                              kv_dtype=kv_dtype)
    model = Model(cfg, dt=f32, device="cuda")
    sched = PagedScheduler(model, model.init(seed=2), slots=4, max_len=256,
                           page_size=64, mesh=mesh, log=None)
    reqs = poisson_stream(6, rate=0.0, vocab_size=cfg.vocab_size,
                          prompt_len=100, max_new=16, seed=0)
    done = ContinuousEngine(sched, clock="tick", log=None).run(reqs)
    return {r.rid: list(r.out) for r in done}


def tp_logits(torch, mesh=None):
    """codeqwen1.5-7b at full width and TP_LOGITS_LAYERS layers in fp32:
    ``prefill_decode_runner``'s 5 rows of logits, on a mesh's shards or in
    one process."""
    from repro_torch.configs import get_arch
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.models.transformer import Model
    f32 = DtypePolicy(param=torch.float32, compute=torch.float32)
    cfg = dataclasses.replace(get_arch(QWEN_ARCH), n_layers=TP_LOGITS_LAYERS)
    model = Model(cfg, dt=f32, device="cuda")
    run = prefill_decode_runner(torch, model, model.init(seed=1), seed=3,
                                mesh=mesh)
    return run()


def tp_moe_layer(torch, mesh, dtype_name: str) -> dict:
    """``moe_apply_sharded`` on ``mesh`` (data, model) at qwen2-moe-a2.7b's
    width against the port's ``moe_apply`` on the same inputs, forward and
    the backward of sum(out^2): the output, the input's and the router's
    gradients and this rank's expert shards' within TP_MOE_LIMIT of their
    max |value|; B1 grouped launches of the sharded pass counted."""
    from repro_torch.configs import get_arch
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.kernels import dispatch
    from repro_torch.models.moe import moe_apply, moe_init
    from repro_torch.models.moe_sharded import moe_apply_sharded, moe_pspecs
    from repro_torch.models.transformer import _moe_spec
    from repro_torch.runtime import tp
    dtype = getattr(torch, dtype_name)
    dt = DtypePolicy(param=dtype, compute=dtype)
    n_ep = mesh.shape["model"]
    spec = _moe_spec(get_arch(MOE_ARCH), pad_to=n_ep)
    spec = dataclasses.replace(spec,
                               capacity_factor=spec.n_experts / spec.top_k)
    gen = torch.Generator(device="cuda").manual_seed(11)
    full = moe_init(gen, spec, dtype=dtype)
    x = torch.randn(*TP_MOE_TOKENS, spec.d_model, generator=gen,
                    device="cuda").to(dtype)

    def pass_(p, run):
        p = {k: (v.detach().requires_grad_(True) if torch.is_tensor(v)
                 else {kk: vv.detach().requires_grad_(True)
                       for kk, vv in v.items()}) for k, v in p.items()}
        xx = x.detach().requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, aux = run(p, xx)
        out.float().square().sum().backward()
        torch.cuda.synchronize()
        return out.detach(), aux.detach(), xx.grad, p, \
            time.perf_counter() - t0

    want = pass_(full, lambda p, xx: moe_apply(p, spec, xx, dt))
    local = tp.shard_tree(full, moe_pspecs({"moe": full})["moe"], mesh)
    dispatch.reset_launch_counts()
    got = pass_(local, lambda p, xx: moe_apply_sharded(
        p, spec, xx, dt, mesh=mesh, dp_axes=("data",)))
    grouped = dispatch.launch_counts()["grouped_matmul"]
    routes = {k: n for k, n in dispatch.route_counts().items()
              if k.startswith("grouped_matmul/")}
    limit = TP_MOE_LIMIT[dtype_name]
    errs = {}

    def check(name, a, b):
        a, b = a.float(), b.float()
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        errs[name] = err / scale if scale else err
        if not (bool(torch.isfinite(a).all()) and err <= limit * scale):
            raise AssertionError(f"moe {dtype_name} {name}: max |err| "
                                 f"{err:.3e} over {limit} x {scale:.3e}")
    check("out", got[0], want[0])
    check("aux", got[1], want[1])
    check("dx", got[2], want[2])
    specs = moe_pspecs({"moe": full})["moe"]
    for name in ("router", "wg", "wu", "wd"):
        check("d" + name, got[3][name].grad,
              tp.shard_leaf(want[3][name].grad, specs[name], mesh))
    if grouped != 9:     # 3 forward, 2 x 3 backward
        raise AssertionError(f"moe {dtype_name}: {grouped} grouped launches")
    return {"dtype": dtype_name, "mesh": dict(mesh.shape),
            "tokens": list(TP_MOE_TOKENS), "rel_err": errs,
            "grouped_launches": grouped, "grouped_routes": routes,
            "sharded_s": got[4], "global_s": want[4]}


def tp_one_rank(rank: int, out_dir: str) -> None:
    """Phase 3f (a) in a process of its own, so this script's process
    never starts NCCL (a profiler used before a process's first NCCL
    group saw no device events after it): phase 3's float continuous run
    unsharded and on ``--mesh 1`` (a one-rank NCCL group) in turns (u1,
    m1, m2, u2), then the MoE layer on the (1, 1) mesh; results to
    ``out_dir``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    out = {}
    for turn in ("u1", "m1", "m2", "u2"):
        argv = SERVE_ARGS + TP_SCHEDULE
        if turn[0] == "m":
            out[turn] = tp_serve_run(torch, "gemma-2b float --mesh 1",
                                     argv + ["--mesh", "1"], FLOAT_PATH)
            continue
        dispatch.reset_launch_counts()
        rep = serve.main(argv)
        torch.cuda.synchronize()
        out[turn] = {"streams": {r.rid: list(r.out) for r in rep["done"]},
                     "launches": dispatch.launch_counts(),
                     "decode_ms_per_step": decode_ms(rep["phases"]),
                     "plain": [k for k in rep["routes"] if k[1] == "plain"]}
        torch.cuda.empty_cache()
    out["moe"] = [tp_moe_layer(torch, make_mesh((1, 1), ("data", "model")),
                               d) for d in ("float32", "bfloat16")]
    torch.save(out, Path(out_dir) / "one_rank.pt")
    dist.destroy_process_group()


def tp_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One of the TP_RANKS processes sharing cuda:0 over gloo: every
    TP_RUNS run through ``serve.main --mesh``, the fp32 logits and the MoE
    layer on a (1, TP_RANKS) mesh; results to ``out_dir``."""
    import datetime
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=3))
    from repro_torch.launch.mesh import make_mesh, make_serving_mesh
    out = {"runs": []}
    for label, argv, path, _ in TP_RUNS:
        out["runs"].append(tp_serve_run(
            torch, label, argv + TP_SCHEDULE + ["--mesh", str(world)],
            path))
        torch.cuda.empty_cache()
    mesh = make_serving_mesh(world)
    out["backend"] = mesh.backend
    out["fp32_streams"] = [tp_fp32_streams(torch, kv, mesh)
                           for kv in ("", "int8")]
    torch.cuda.empty_cache()
    out["logits"] = tp_logits(torch, mesh).cpu()
    torch.cuda.empty_cache()
    mesh = make_mesh((1, world), ("data", "model"))
    out["moe"] = [tp_moe_layer(torch, mesh, d)
                  for d in ("float32", "bfloat16")]
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def tp_serve_phase(torch, base_streams, base_run):
    """Phase 3f (its kernel rows, ``check_tp_shapes``, run with phase
    2's).  (a) ``serve.main --mesh 1`` on phase 3's float continuous run
    (``base_run``: its launches and phases), in turns with the unsharded
    run: streams and launches equal that run's, every op in the sharded
    step on its kernel, decode ms a step of both; the MoE layer on the
    degenerate (1, 1) mesh (``tp_one_rank``).
    (b, c) TP_RANKS ranks on the one card: every TP_RUNS run with the
    ranks' streams equal (gemma-2b float's also equal to phase 3's; the
    codeqwen1.5-7b runs compared with the same run in one process, run
    first here, and reported), codeqwen1.5-7b's fp32 streams at
    TP_FP32_LAYERS layers (float and int8 pools) equal to one process's,
    its fp32 logits within TP_LOGITS_LIMIT of max |logit| of one
    process's, and the MoE layer on a (1, TP_RANKS) mesh.  This process
    starts no process group.  Returns the launches of the runs."""
    import tempfile
    import torch.multiprocessing as mp
    t0 = time.time()
    launches = Counter()
    base_launches, base_phases = base_run
    # (a), in a process of its own (``tp_one_rank``)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        mp.spawn(tp_one_rank, args=(tmp,), nprocs=1, join=True)
        one_rank = torch.load(Path(tmp) / "one_rank.pt", weights_only=False)
    for turn in ("u1", "m1", "m2", "u2"):
        rep = one_rank[turn]
        launches.update(rep["launches"])
        if rep["streams"] != base_streams["float"] \
                or rep["launches"] != base_launches \
                or rep.get("plain"):
            raise AssertionError(f"{turn}: streams {rep['streams']}, "
                                 f"launches {rep['launches']} or plain "
                                 f"routes {rep.get('plain')} differ from "
                                 f"phase 3's run ({base_launches})")
        if turn[0] == "m":
            emit({"phase": "tp_serve", "run": rep["label"], "turn": turn,
                  "tp": 1, "seconds": rep["seconds"],
                  "decode_ms_per_step": rep["decode_ms_per_step"],
                  "tp_routes": rep["tp_routes"], "launches": rep["launches"],
                  "streams_equal_unsharded": True,
                  "launches_equal_unsharded": True})
    emit({"phase": "tp_serve", "decode_ms_per_step_turns": {
              turn: one_rank[turn]["decode_ms_per_step"]
              for turn in ("u1", "m1", "m2", "u2")},
          "phase3_decode_ms_per_step": decode_ms(base_phases)})
    emit({"phase": "tp_serve", "moe_layer": one_rank["moe"]})

    # the one-process runs the ranks are held to
    one = {TP_RUNS[0][0]: base_streams["float"]}
    for label, argv, path, _ in TP_RUNS[1:3]:
        _, one[label], counts = serve_run(
            torch, label + " one process", argv + TP_SCHEDULE, path)
        launches.update(counts)
    want_fp32 = [tp_fp32_streams(torch, kv) for kv in ("", "int8")]
    want_logits = tp_logits(torch).cpu()
    release(torch)

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        mp.spawn(tp_rank, args=(TP_RANKS, str(Path(tmp) / "store"), tmp),
                 nprocs=TP_RANKS, join=True)
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(TP_RANKS)]
    failed = []     # every comparison is reported before any raises
    for i, (label, _, _, equal) in enumerate(TP_RUNS):
        runs = [r["runs"][i] for r in ranks]
        for r in runs:
            launches.update(r["launches"])
        across = all(r["streams"] == runs[0]["streams"] for r in runs)
        same = runs[0]["streams"] == one[label] if label in one else None
        # per request, the first token the two-rank run chose otherwise
        diverge = None if label not in one else {
            rid: next((i for i, (a, b) in enumerate(zip(s, one[label][rid]))
                       if a != b), None)
            for rid, s in runs[0]["streams"].items()}
        emit({"phase": "tp_serve", "run": label, "tp": TP_RANKS,
              "ranks_share": "cuda:0 over gloo, collectives through host",
              "seconds": runs[0]["seconds"],
              "decode_ms_per_step": runs[0]["decode_ms_per_step"],
              "new_tokens": runs[0]["new_tokens"],
              "tp_routes": runs[0]["tp_routes"],
              "launches": [r["launches"] for r in runs],
              "streams_equal_across_ranks": across,
              "streams_equal_one_process": same,
              "held_to_one_process": equal,
              "first_divergence": diverge})
        if not across or (equal and not same):
            failed.append(f"{label}: streams equal across ranks {across}, "
                          f"to one process {same}")
    for kv, want in zip(("float", "int8"), want_fp32):
        got = [r["fp32_streams"][kv == "int8"] for r in ranks]
        equal = all(g == want for g in got)
        emit({"phase": "tp_serve", "run": f"{QWEN_ARCH} fp32 "
              f"{TP_FP32_LAYERS} layers {kv} pools", "tp": TP_RANKS,
              "streams_equal_across_ranks": all(g == got[0] for g in got),
              "streams_equal_one_process": equal,
              "distinct_tokens": len({t for s in want.values() for t in s})})
        if not equal:
            failed.append(f"fp32 {kv} pools: streams {got} differ from one "
                          f"process's {want}")
    scale = want_logits.abs().max().item()
    err = (ranks[0]["logits"] - want_logits).abs().max().item()
    emit({"phase": "tp_serve", "logits": QWEN_ARCH, "dtype": "float32",
          "layers": TP_LOGITS_LAYERS, "backend": ranks[0]["backend"],
          "max_abs_err": err, "max_abs_logit": scale,
          "rel_err": err / scale})
    if not err <= TP_LOGITS_LIMIT * scale:
        failed.append(f"tp fp32 logits: max |err| {err:.3e} > "
                      f"{TP_LOGITS_LIMIT} x {scale:.3e}")
    emit({"phase": "tp_serve", "moe_layer": [r["moe"] for r in ranks]})
    emit({"phase": "tp_serve", "seconds": time.time() - t0})
    if failed:
        raise AssertionError("; ".join(failed))
    return dict(launches)


# ------------------------------------------------------------ phase 3d
# the kernels of each MoE serve run's path; the model drafter's forwards
# add B6
MOE_FLOAT_PATH = ("matmul", "grouped_matmul", "decode_attention",
                  "prefill_attention")
MOE_INT8_PATH = ("matmul", "quantized_matmul", "grouped_matmul",
                 "decode_attention_int8", "prefill_attention_int8")
PAGED = ["--cache", "paged"]
MOE_SERVE_RUNS = (  # (label, extra arguments, kernels of its path)
    ("paged static", PAGED + ["--schedule", "static"], MOE_FLOAT_PATH),
    ("paged continuous",
     PAGED + ["--schedule", "continuous", "--clock", "tick"],
     MOE_FLOAT_PATH),
    ("int8+prefix continuous",
     PAGED + INT8_ARGS + PREFIX_ARGS
     + ["--schedule", "continuous", "--clock", "tick"], MOE_INT8_PATH),
    ("dense", ["--cache", "dense"],
     ("matmul", "grouped_matmul", "decode_attention")),
    ("spec ngram static", PAGED + ["--speculate", "ngram"] + SPEC_ARGS,
     ("matmul", "grouped_matmul", "prefill_attention")),
    ("spec model static", PAGED + ["--speculate", "model"] + SPEC_ARGS,
     ("matmul", "grouped_matmul", "prefill_attention", "flash_attention")))
# the target model's forwards, whose launches are held to the counts the
# config implies, forward by forward
FORWARDS = {"decode_step": "decode_attention",
            "prefill_step_paged": "prefill_attention",
            "verify_step_paged": "prefill_attention"}


def forward_launches(cfg, method: str) -> dict:
    """The launches one serving forward of ``cfg`` makes, from its layer
    kinds: an attention layer's q, k, v, o projections (B1, or B5 on int8
    weights) and one attention call (B2 for a decode step, B3 for a
    prefill chunk or a verify window; the int8 branches on int8 pools);
    an MLP's GEMMs (3 gated, else 2; B1 or B5); a MoE layer's fp32 router
    and its shared MLP's three GEMMs (B1: MoE layers stay float) and its
    three expert contractions (B1's grouped route); the RWKV mixes and
    the RG-LRU block none (plain products, as in the JAX package); plus
    the head (B1)."""
    proj = "quantized_matmul" if cfg.weights_dtype == "int8" else "matmul"
    attn = FORWARDS[method] + ("_int8" if cfg.kv_dtype == "int8" else "")
    want = Counter(matmul=1)
    for mixer, ffn in cfg.layer_kinds():
        if mixer in ("attn", "swa"):
            want[proj] += 4
            want[attn] += 1
        if ffn == "mlp":
            want[proj] += 3 if cfg.activation in ("swiglu", "geglu") else 2
        elif ffn == "moe":
            want["matmul"] += 1 + 3 * bool(cfg.n_shared_experts)
            want["grouped_matmul"] += 3
    return dict(want)


@contextlib.contextmanager
def counted_forwards(record: list):
    """Every serving forward of a ``Model`` (decode, prefill chunk, verify)
    appends (method, the config, its launches by kernel, its host ms: the
    enqueue, with no synchronisation) to ``record``."""
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer import Model

    def counted(method, name):
        def run(self, *args, **kwargs):
            before = dispatch.launch_counts()
            t0 = time.perf_counter()
            out = method(self, *args, **kwargs)
            ms = (time.perf_counter() - t0) * 1e3
            after = dispatch.launch_counts()
            record.append((name, self.cfg, {
                op: after[op] - before[op] for op in after
                if after[op] != before[op]}, ms))
            return out
        return run
    with contextlib.ExitStack() as stack:
        for name in FORWARDS:
            stack.enter_context(mock.patch.object(
                Model, name, counted(getattr(Model, name), name)))
        yield record


def moe_serve_phase(torch):
    """qwen2-moe-a2.7b at full width and depth in bf16 through
    ``serve.main`` on phase 3's traffic: paged static and continuous, int8
    KV + int8 weights + prefix cache, dense, and speculative with the
    n-gram and the model drafter.  Every request served in full, kernel
    routes only, every forward of the target with exactly the launches
    its config implies, and a rerun of the first run bit-equal.  Streams
    of different schedules are not compared: the experts' capacity
    depends on each call's batch shape, as in the JAX package."""
    t0 = time.time()
    launches = {}
    first = None
    for label, extra, path in MOE_SERVE_RUNS + (MOE_SERVE_RUNS[0],):
        record = []
        with counted_forwards(record):
            rep, streams, counts = serve_run(torch, f"moe {label}",
                                             MOE_SERVE_ARGS + extra, path)
        torch.cuda.empty_cache()
        if first is None:
            first = streams
        elif label == MOE_SERVE_RUNS[0][0]:
            if streams != first:
                raise AssertionError(f"moe {label}: a rerun changed the "
                                     f"streams:\n{first}\n{streams}")
            emit({"phase": "moe_serve", "run": label,
                  "rerun_bit_equal": True})
            continue
        for op, n in counts.items():
            launches[op] = launches.get(op, 0) + n
        if len(rep["done"]) != 6 or any(len(r.out) != 16
                                        for r in rep["done"]) \
                or (rep["dense"] or {}).get("truncated"):
            raise AssertionError(f"moe {label}: not every request served "
                                 f"in full")
        wrong = [(name, got, forward_launches(cfg, name))
                 for name, cfg, got, _ in record
                 if got != forward_launches(cfg, name)]
        if not record or wrong:
            raise AssertionError(f"moe {label}: {len(record)} forwards; "
                                 f"(forward, launches, expected): "
                                 f"{wrong[:3]}")
        by_method = {}
        for name, cfg, got, ms in record:
            by_method.setdefault(name, []).append(ms)
        ph, sp = rep["phases"], rep["spec"]
        line = {"phase": "moe_serve", "run": label,
                "new_tokens": rep["new_tokens"], "tok_s": rep["tok_s"],
                "seconds": rep["seconds"],
                "forwards": {k: len(v) for k, v in by_method.items()},
                "host_ms_per_forward": {k: sum(v) / len(v)
                                        for k, v in by_method.items()},
                "launches_per_forward": {
                    name: forward_launches(record[0][1], name)
                    for name in by_method},
                "streams": streams}
        if ph.get("decode_steps"):
            line["decode_ms_per_step"] = (1e3 * ph["decode_seconds"]
                                          / ph["decode_steps"])
        if sp:
            line.update(verify_steps=sp["verify_steps"],
                        accept_rate=sp["accept_rate"],
                        tokens_per_step=sp["tokens_per_step"],
                        verify_ms_per_step=1e3 * sp["verify_seconds"]
                        / sp["verify_steps"],
                        draft_ms_per_step=1e3 * sp["draft_seconds"]
                        / sp["verify_steps"])
        if rep["prefix"] is not None:
            line["prefix"] = rep["prefix"]
            if rep["prefix"]["hits"] == 0:
                raise AssertionError(f"moe {label}: no prefix hit")
        emit(line)
    emit({"phase": "moe_serve", "seconds": time.time() - t0})
    return launches


# ------------------------------------------------------------ phase 3e
# the recurrent archs at published width and depth in bf16 on the dense
# cache, their one serving layout (configs/archs.py): rwkv6-7b (32 layers
# of RWKV6 time mix and channel mix, d 4096, d_ff 14336, an untied
# vocabulary of 65536) and recurrentgemma-9b (38 layers, two RG-LRU
# blocks of width 4096 to one local attention of window 2048 with one kv
# head of 256, GeGLU d_ff 12288, a tied vocabulary of 256000)
RECURRENT_SERVE_RUNS = (  # (label, arch, extra arguments, kernels of its path)
    ("rwkv6-7b", "rwkv6-7b", [], ("matmul",)),
    ("recurrentgemma-9b", "recurrentgemma-9b", [],
     ("matmul", "decode_attention")),
    ("recurrentgemma-9b int8 weights", "recurrentgemma-9b",
     ["--weights-dtype", "int8"],
     ("matmul", "quantized_matmul", "decode_attention")))
# each run profiles decode steps [40, 48), inside the first wave's prompts
RECURRENT_PROFILE = dict(skip=40, active=8)
# the JAX package's RWKV decode shifts the channel mix's normed input
# against the previous token's raw residual (ROADMAP Queue 3, reference
# caveats), which the port mirrors: at rwkv6-7b's width with random
# weights the residual stream grows step by step until the logits stop
# being finite (tools/rwkv_decode_growth.py), so its served tokens are
# reported, not held to be finite
DIVERGING_DECODE = ("rwkv6-7b",)


def recurrent_serve_phase(torch):
    """The recurrent archs through ``serve.main --cache dense`` on phase
    3's traffic: every request served in full, kernel routes only, every
    decode step with exactly the launches its layer kinds imply (rwkv6-7b:
    the head alone; recurrentgemma-9b: B1 163 and B2 12, or on int8
    weights B5 162, B1 1 and B2 12).  The head (B1) never makes a
    non-finite logit from a finite input, and recurrentgemma-9b's logits
    stay finite (rwkv6-7b's first non-finite step is reported:
    ``DIVERGING_DECODE``).  Each run's ms per decode step (host wall, the
    argmax read included), new tokens/s, peak memory, and a profile of 8
    decode steps: device time by kernel group and the idle share (or "not
    measured" if the profiler sees no device time)."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    from repro_torch.launch import serve
    from repro_torch.models.transformer import Model
    t0 = time.time()
    launches = {}
    skip, active = RECURRENT_PROFILE["skip"], RECURRENT_PROFILE["active"]
    for label, arch, extra, path in RECURRENT_SERVE_RUNS:
        release(torch)
        torch.cuda.reset_peak_memory_stats()
        record, step_ms, traces = [], [], []
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       schedule=schedule(wait=skip - 1, warmup=1,
                                         active=active, repeat=1),
                       on_trace_ready=lambda p: traces.append(p.events()))
        real, real_logits = serve.Server.step, Model._logits
        finite = []     # per head call: its input's and output's finiteness

        def step(self, tokens):
            t = time.perf_counter()
            with record_function(DECODE_RANGE):
                out = real(self, tokens)
            step_ms.append((time.perf_counter() - t) * 1e3)
            prof.step()
            return out

        def logits(self, params, x):
            out = real_logits(self, params, x)
            finite.append(torch.stack([torch.isfinite(x).all(),
                                       torch.isfinite(out).all()]))
            return out
        with counted_forwards(record), prof, \
                mock.patch.object(serve.Server, "step", step), \
                mock.patch.object(Model, "_logits", logits):
            rep, streams, counts = serve_run(
                torch, f"recurrent {label}",
                ["--arch", arch] + DENSE_ARGS[2:] + extra, path)
        peak = torch.cuda.max_memory_allocated()
        for op, n in counts.items():
            launches[op] = launches.get(op, 0) + n
        if len(rep["done"]) != 6 or any(len(r.out) != 16
                                        for r in rep["done"]) \
                or rep["dense"]["truncated"] or rep["dense"]["rejected"]:
            raise AssertionError(f"recurrent {label}: not every request "
                                 f"served in full: {rep['dense']}")
        cfg = record[0][1] if record else None
        want = forward_launches(cfg, "decode_step") if cfg else None
        wrong = [(name, got) for name, _, got, _ in record
                 if name != "decode_step" or got != want]
        steps = rep["phases"]["decode_steps"]
        if len(record) != steps or wrong:
            raise AssertionError(f"recurrent {label}: {len(record)} "
                                 f"forwards of {steps} steps; expected "
                                 f"{want}, got {wrong[:3]}")
        flags = torch.stack(finite).tolist()
        nonfinite = [i for i, (_, out) in enumerate(flags) if not out]
        if any(inp and not out for inp, out in flags):
            raise AssertionError(f"recurrent {label}: the head made a "
                                 f"non-finite logit from a finite input")
        if nonfinite and arch not in DIVERGING_DECODE:
            raise AssertionError(f"recurrent {label}: non-finite logits "
                                 f"from decode step {nonfinite[0]}")
        outside = sorted(ms for i, ms in enumerate(step_ms)
                         if not skip - 1 <= i < skip + active)
        line = {"phase": "recurrent_serve", "run": label,
                "layers": cfg.n_layers, "decode_steps": steps,
                "decode_ms_per_step": 1e3 * rep["phases"]["decode_seconds"]
                / steps,
                "decode_ms_per_step_median_unprofiled":
                    outside[len(outside) // 2],
                "new_tokens": rep["new_tokens"], "tok_s": rep["tok_s"],
                "seconds": rep["seconds"], "peak_memory_bytes": peak,
                "first_nonfinite_step": nonfinite[0] if nonfinite else None,
                "launches_per_step": want, "streams": streams}
        if traces:
            n, window_ms, groups, other = range_breakdown(
                torch, traces[0], DECODE_RANGE)
            busy = sum(groups.values())
            line.update({
                "profiled_steps": n,
                "profiled_window_ms_per_step": window_ms / n if n else None,
                "device_ms_per_step": ({g: ms / n for g, ms in groups.items()}
                                       if busy and n else "not measured"),
                "device_busy_ms_per_step": busy / n if busy and n else None,
                "idle_share": 1 - busy / window_ms if busy and window_ms
                else None,
                "top_other": [{"ms_per_step": ms / n, "kernel": k}
                              for k, ms in sorted(other.items(),
                                                  key=lambda kv: -kv[1])[:6]]
                if n else []})
        else:
            line["device_ms_per_step"] = "not measured"
        emit(line)
        del rep
    emit({"phase": "recurrent_serve", "seconds": time.time() - t0})
    return launches


# ------------------------------------------------------------ phase 4
def prefill_decode_runner(torch, model, params, seed: int, mesh=None):
    """A function that runs one 64-token prefill chunk (50 prompt tokens)
    and 4 teacher-forced decode steps of one slot from a fresh paged cache
    and returns the 5 rows of logits; the tokens come from ``seed``.  With
    a ``mesh``, the tensor-parallel steps on this rank's shards of
    ``params`` and of the cache (``runtime/tp.py``)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    page, prompt_len = 64, 50
    toks = torch.zeros(1, page, dtype=torch.int32, device="cuda")
    toks[0, :prompt_len] = torch.randint(0, model.cfg.vocab_size,
                                         (prompt_len,), generator=gen,
                                         device="cuda")
    forced = torch.randint(0, model.cfg.vocab_size, (4,), generator=gen,
                           device="cuda").to(torch.int32)

    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device="cuda")

    prefill, decode = model.prefill_step_paged, model.decode_step
    if mesh is not None:
        from repro_torch.runtime import tp
        params = tp.shard_params(params, model.cfg, mesh)
        decode, prefill = tp.sharded_paged_fns(model, mesh)

    def run():
        cache = model.init_paged_cache(1, 2 * page, page)
        if mesh is not None:
            cache = tp.shard_cache(cache, model.cfg, mesh)
        table = i32([[1, 2]])
        out = [prefill(params, cache, toks, i32([0]), table,
                       i32([prompt_len - 1]))]
        for step, tok in enumerate(forced):
            out.append(decode(params, cache, tok.reshape(1, 1),
                              paged=(i32([prompt_len + step]), table)))
        return torch.cat(out)
    return run


def model_phase(torch, int8: bool):
    from repro_torch.configs import get_arch
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer import Model
    f32 = DtypePolicy(param=torch.float32, compute=torch.float32)
    cfg = get_arch("gemma-2b")
    if int8:
        cfg = dataclasses.replace(cfg, kv_dtype="int8", weights_dtype="int8")
    model = Model(cfg, dt=f32, device="cuda")
    params = model.bind_params(model.init(seed=1))
    run = prefill_decode_runner(torch, model, params, seed=3)
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
          "kv_dtype": cfg.kv_dtype or "float32",
          "weights_dtype": cfg.weights_dtype or "float32",
          "positions": 5, "max_abs_err": err, "max_abs_logit": scale,
          "rel_err": err / scale, "logit_std": plain.std().item()})
    if not err <= 1e-3 * scale:
        raise AssertionError(f"full-width logits: max |err| {err:.3e} > "
                             f"1e-3 x {scale:.3e}")
    del params, kernel, plain


# ------------------------------------------------------------ phase 4c
def moe_model_phase(torch, int8: bool):
    """qwen2-moe-a2.7b at full width and depth in fp32 (57 GB of
    parameters): one prefill chunk and 4 decode steps through the kernels,
    then twice through the plain versions, on the card.

    A run's discrete decisions are each MoE call's expert choice and, on
    int8 pools, each rounding of a K/V entry to int8.  The first plain run
    makes its own: the line gives how many (token, k) choices and int8
    entries differ from the kernel run's, the first MoE call where a
    choice does, the smallest gap between the k-th and (k+1)-th
    probability each run saw, and its logits' error (an ulp between the
    routes flips a choice whose gap is that small, or an int8 entry at a
    rounding tie; a flip moves that token by a whole expert or one int8
    step, and the next layers carry it on).  The second plain run takes
    the kernel run's decisions (the choices gated by its own
    probabilities, the int8 pages and scales as written): its logits must
    lie within 1e-3 of max |logit| of the kernel run's.

    The replayed writes would hide the K/V projections (B5 at the int8
    run's shapes), so each quantizer call of the replaying run also
    rounds its own input: that input must lie within 1e-3 of max |K/V|
    of the kernel run's, and each int8 entry it rounds otherwise must
    differ by one step.  The line gives how many do, and, over them, the
    largest distance between the two runs' unrounded values and the
    largest distance of the kernel run's from a rounding tie, in int8
    steps: an ulp-sized input difference that flips an entry leaves both
    tiny.  At the first call both plain runs hold the same state, so its
    count is the free-running run's there too."""
    from repro_torch.configs import get_arch
    from repro_torch.core import quant
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.kernels import dispatch
    from repro_torch.models import moe
    from repro_torch.models.transformer import Model
    t0 = time.time()
    f32 = DtypePolicy(param=torch.float32, compute=torch.float32)
    cfg = get_arch(MOE_ARCH)
    if int8:
        cfg = dataclasses.replace(cfg, kv_dtype="int8", weights_dtype="int8")
    model = Model(cfg, dt=f32, device="cuda")
    params = model.bind_params(model.init(seed=1))
    run = prefill_decode_runner(torch, model, params, seed=3)
    route = moe.route
    # a list a run: (expert ids, top-k gap) a MoE call; (int8 pages,
    # scales) a K/V quantizer call, and (float input, unrounded values in
    # int8 steps, its own int8 pages) of that call
    routed, written, rounded = [], [], []

    def recording(p, spec, tokens):
        gate, eidx, probs = route(p, spec, tokens)
        top = torch.topk(probs, spec.top_k + 1, dim=-1).values
        routed[-1].append((eidx, float((top[:, -2] - top[:, -1]).min())))
        return gate, eidx, probs

    def replaying(p, spec, tokens):
        _, _, probs = route(p, spec, tokens)
        eidx = routed[0][len(routed[-1])][0]
        routed[-1].append((eidx, None))
        gate = probs.gather(1, eidx)
        if spec.norm_topk:
            gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        return gate, eidx, probs

    def unrounded(args, out):
        """The float input of a K/V quantizer call and the values it
        rounds (in int8 steps) for every entry of the pages it returns."""
        safe = torch.where(out[1] > 0, out[1], torch.ones_like(out[1]))
        if len(args) == 1:                  # quantize_pages(x)
            return args[0].float(), args[0].float() / safe[..., None, :,
                                                           None]
        page_q, page_scale, token, off = args   # append_token_quantized
        u = page_q.float() * (page_scale / safe)[:, None, :, None]
        u[torch.arange(len(off), device=off.device), off.long()] = \
            token.float() / safe[..., None]
        return token.float(), u

    def quantizer(real, replay):
        def call(*args):
            args = tuple(a.clone() for a in args)
            out = real(*args)
            rounded[-1].append(unrounded(args, out) + (out[0],))
            if replay:
                out = tuple(t.clone() for t in written[0][len(written[-1])])
            written[-1].append(out)
            return out
        return call

    def logits(replay, on_card=True):
        routed.append([])
        written.append([])
        rounded.append([])
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(
                moe, "route", replaying if replay else recording))
            for name in ("quantize_pages", "append_token_quantized"):
                stack.enter_context(mock.patch.object(
                    quant, name, quantizer(getattr(quant, name), replay)))
            if not on_card:
                stack.enter_context(mock.patch.object(
                    dispatch, "_on_card", lambda op, t: False))
            out = run()
            torch.cuda.synchronize()
        return out

    dispatch.reset_launch_counts()
    with dispatch.stats_scope() as stats:
        kernel = logits(False)
        routes = stats()
    launches = dispatch.launch_counts()
    plain = logits(False, on_card=False)
    replayed = logits(True, on_card=False)
    scale = replayed.abs().max().item()
    err = (kernel - replayed).abs().max().item()
    free_err = (kernel - plain).abs().max().item()
    calls = len(routed[0])
    differ = [int((a != b).sum()) for (a, _), (b, _) in zip(*routed[:2])]
    # the replaying run's own rounding against the kernel run's writes
    kv_err = kv_scale = 0.0
    flips, step, crossing, tie = [], 0, 0.0, 0.0
    for (xk, uk, _), (xr, ur, qr), (qk, _) in zip(rounded[0], rounded[2],
                                                  written[0]):
        kv_err = max(kv_err, (xr - xk).abs().max().item())
        kv_scale = max(kv_scale, xk.abs().max().item())
        flip = qr != qk
        flips.append(int(flip.sum()))
        if flips[-1]:
            step = max(step, int((qr[flip].int() - qk[flip].int()).abs()
                                 .max()))
            crossing = max(crossing, (ur[flip] - uk[flip]).abs().max()
                           .item())
            tie = max(tie, (uk[flip] - uk[flip].floor() - 0.5).abs().max()
                      .item())
    emit({"phase": "moe_model", "arch": cfg.name, "dtype": "float32",
          "kv_dtype": cfg.kv_dtype or "float32",
          "weights_dtype": cfg.weights_dtype or "float32",
          "positions": 5, "max_abs_err": err, "max_abs_logit": scale,
          "rel_err": err / scale, "logit_std": replayed.std().item(),
          "own_decisions_max_abs_err": free_err,
          "own_decisions_rel_err": free_err / scale,
          "moe_calls": calls,
          "expert_choices": sum(e.numel() for e, _ in routed[0]),
          "expert_choices_differ": sum(differ),
          "first_differing_call": next(
              (i for i, n in enumerate(differ) if n), None),
          "min_topk_gap": [min(gap for _, gap in r) for r in routed[:2]],
          "kv_int8_writes": len(written[0]),
          "kv_int8_entries": sum(q.numel() for q, _ in written[0]),
          "kv_int8_entries_differ": sum(
              int((a[0] != b[0]).sum()) for a, b in zip(*written[:2])),
          "kv_input_max_abs_err": kv_err, "kv_input_max_abs": kv_scale,
          "kv_replay_own_entries_differ": sum(flips),
          "kv_replay_own_first_call_differ": flips[0] if flips else None,
          "kv_replay_own_max_step": step,
          "kv_replay_own_max_crossing_steps": crossing,
          "kv_replay_own_max_tie_dist_steps": tie,
          "grouped_launches": launches["grouped_matmul"],
          "seconds": time.time() - t0})
    if any(route_ == "plain" for _, route_ in routes):
        raise AssertionError(f"moe model: plain routes {routes}")
    if calls != 5 * cfg.n_layers or {len(r) for r in routed} != {calls} \
            or launches["grouped_matmul"] != 3 * calls \
            or len({len(w) for w in written}) != 1:
        raise AssertionError(f"moe model: {[len(r) for r in routed]} MoE "
                             f"calls, {[len(w) for w in written]} K/V "
                             f"writes, {launches['grouped_matmul']} grouped "
                             f"launches")
    if not err <= 1e-3 * scale:
        raise AssertionError(f"moe full-width logits: max |err| {err:.3e} "
                             f"> 1e-3 x {scale:.3e}")
    if not kv_err <= 1e-3 * kv_scale or step > 1:
        raise AssertionError(f"moe model K/V: max |err| {kv_err:.3e} of "
                             f"{kv_scale:.3e}, own rounding {step} int8 "
                             f"steps off the kernel run's")
    del params, kernel, plain, replayed, rounded


# ------------------------------------------------------------ phase 4b
DENSE_MODEL = dict(arch="gemma3-4b", slots=2, max_len=2048, pos=1500,
                   steps=4)


def dense_model_phase(torch):
    """gemma3-4b at its published width (34 layers, d 2560, 8 heads over 4
    kv heads of 256, window 1024) in fp32 on the dense cache: every buffer
    filled with seeded values, then 4 decode steps from position 1500, so
    the local layers' 1024-entry buffers have wrapped; through the
    kernels and through the plain versions on the card, logits within
    1e-3 of max |logit|.  The kernel run must launch B2 once a layer a
    step and take no plain route."""
    from repro_torch.configs import get_arch
    t0 = time.time()
    cfg = get_arch(DENSE_MODEL["arch"])
    model, params = fp32_model(torch, cfg, seed=5)
    gen = torch.Generator(device="cuda").manual_seed(6)
    b, max_len, pos0, steps = (DENSE_MODEL[k] for k in (
        "slots", "max_len", "pos", "steps"))
    filled = filled_cache(model.init_cache(b, max_len), gen)
    toks = torch.randint(0, cfg.vocab_size, (steps, b, 1), generator=gen,
                         device="cuda").to(torch.int32)

    def run():
        cache = clone_cache(filled)
        return torch.stack([model.decode_step(params, cache, toks[i],
                                              pos=pos0 + i)
                            for i in range(steps)])

    kernel, plain, routes, launches = kernel_and_plain(torch, run)
    scale = plain.abs().max().item()
    err = (kernel - plain).abs().max().item()
    caps = sorted({layer["k"].shape[-3] for group in filled.values()
                   for layer in group})
    emit({"phase": "dense_model", "arch": cfg.name, "dtype": "float32",
          "slots": b, "max_len": max_len, "positions": [pos0, pos0 + steps],
          "caches": caps, "max_abs_err": err, "max_abs_logit": scale,
          "rel_err": err / scale, "logit_std": plain.std().item(),
          "decode_attention_launches": launches["decode_attention"],
          "seconds": time.time() - t0})
    if not bool(torch.isfinite(kernel).all()) \
            or kernel.shape != (steps, b, cfg.vocab_size):
        raise AssertionError(f"dense model: logits {tuple(kernel.shape)}, "
                             f"finite {bool(torch.isfinite(kernel).all())}")
    if any(route == "plain" for _, route in routes):
        raise AssertionError(f"dense model: plain routes {routes}")
    if launches["decode_attention"] != steps * cfg.n_layers:
        raise AssertionError(f"dense model: B2 launched "
                             f"{launches['decode_attention']} times, not "
                             f"{steps * cfg.n_layers}")
    if not err <= 1e-3 * scale:
        raise AssertionError(f"dense model logits: max |err| {err:.3e} > "
                             f"1e-3 x {scale:.3e}")
    del params, filled, kernel, plain


def fp32_model(torch, cfg, seed: int):
    """``cfg`` on the card in fp32 (params and compute) and its seeded
    params."""
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.models.transformer import Model
    model = Model(cfg, dt=DtypePolicy(param=torch.float32,
                                      compute=torch.float32), device="cuda")
    return model, model.init(seed=seed)


def filled_cache(cache, gen):
    """Every leaf of a cache tree (K/V, page pools, recurrent states and
    buffers) filled in place with seeded normal values."""
    for group in cache.values():
        for layer in group:
            for leaf in layer.values():
                leaf.normal_(generator=gen)
    return cache


def clone_cache(cache):
    return {g: [{k: t.clone() for k, t in layer.items()} for layer in group]
            for g, group in cache.items()}


def kernel_and_plain(torch, run):
    """``run()`` through the kernels, its routes and the launch counts of
    that run alone, then ``run()`` again through the plain versions on the
    card: (kernel output, plain output, routes, launches)."""
    from repro_torch.kernels import dispatch
    dispatch.reset_launch_counts()
    with dispatch.stats_scope() as stats:
        kernel = run()
        torch.cuda.synchronize()
        routes = stats()
    launches = dispatch.launch_counts()
    with mock.patch.object(dispatch, "_on_card", lambda op, t: False):
        plain = run()
    torch.cuda.synchronize()
    return kernel, plain, routes, launches


# ------------------------------------------------------------ phase 4d
# (label, arch, layout, slots, max_len, first positions, steps): the
# recurrent archs from filled dense caches (recurrentgemma's local
# layers' 2048-entry buffers wrapped at position 2100), and qwen2-vl-2b
# fed embeddings and three-axis M-RoPE positions over a filled dense
# cache and filled page pools (pages of 64; each slot at its own length)
RECURRENT_MODEL = (
    ("recurrentgemma-9b", "recurrentgemma-9b", "dense", 2, 2112,
     (2100, 2100), 4),
    ("rwkv6-7b", "rwkv6-7b", "dense", 2, 256, (200, 200), 4),
    ("qwen2-vl-2b dense", "qwen2-vl-2b", "dense", 2, 2048, (1500, 1500), 4),
    ("qwen2-vl-2b paged", "qwen2-vl-2b", "paged", 2, 2048, (700, 1500), 4))
MROPE_PAGE = 64


def recurrent_model_phase(torch):
    """Each model of ``RECURRENT_MODEL`` at its published width and depth
    in fp32, one alive at a time: a few decode steps from seeded caches
    through the kernels and through the plain versions on the card,
    logits within 1e-3 of max |logit|, exactly the launches its layer
    kinds imply a step, and no plain route in the kernel run.  The M-RoPE
    runs' three position streams differ: the first is the slot's
    position, the others jump."""
    from repro_torch.configs import get_arch
    for label, arch, layout, b, max_len, first, steps in RECURRENT_MODEL:
        release(torch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        cfg = get_arch(arch)
        model, params = fp32_model(torch, cfg, seed=8)
        gen = torch.Generator(device="cuda").manual_seed(9)
        starts = torch.tensor(first, dtype=torch.int32, device="cuda")
        if layout == "paged":
            filled = model.init_paged_cache(b, max_len, MROPE_PAGE)
            n_pages = -(-max_len // MROPE_PAGE)
            table = torch.arange(1, 1 + b * n_pages, dtype=torch.int32,
                                 device="cuda").view(b, n_pages)
        else:
            filled = model.init_cache(b, max_len)
        filled_cache(filled, gen)
        inputs = []
        for i in range(steps):
            if cfg.input_mode == "embeddings":
                pos = torch.stack(
                    [starts + i] + [torch.randint(0, max_len, (b,),
                                                  generator=gen,
                                                  device="cuda")
                                    for _ in range(2)], -1)
                inputs.append({"embeddings": torch.randn(
                    b, 1, cfg.d_model, generator=gen, device="cuda"),
                    "positions": pos.to(torch.int32)[:, None]})
            else:
                inputs.append({"tokens": torch.randint(
                    0, cfg.vocab_size, (b, 1), generator=gen,
                    device="cuda").to(torch.int32)})

        def run():
            cache = clone_cache(filled)
            return torch.stack([model.decode_step(
                params, cache, **inputs[i],
                **({"paged": (starts + i, table)} if layout == "paged"
                   else {"pos": first[0] + i})) for i in range(steps)])

        kernel, plain, routes, launches = kernel_and_plain(torch, run)
        scale = plain.abs().max().item()
        err = (kernel - plain).abs().max().item()
        want = {op: steps * n
                for op, n in forward_launches(cfg, "decode_step").items()}
        got = {op: n for op, n in launches.items() if n}
        emit({"phase": "recurrent_model", "run": label, "arch": cfg.name,
              "layout": layout, "dtype": "float32", "slots": b,
              "max_len": max_len,
              "positions": [[p, p + steps] for p in first],
              "max_abs_err": err, "max_abs_logit": scale,
              "rel_err": err / scale, "logit_std": plain.std().item(),
              "launches": got,
              "peak_memory_bytes": torch.cuda.max_memory_allocated(),
              "seconds": time.time() - t0})
        if not bool(torch.isfinite(kernel).all()) \
                or kernel.shape != (steps, b, cfg.vocab_size):
            raise AssertionError(f"recurrent model {label}: logits "
                                 f"{tuple(kernel.shape)}, finite "
                                 f"{bool(torch.isfinite(kernel).all())}")
        if any(route == "plain" for _, route in routes):
            raise AssertionError(f"recurrent model {label}: plain routes "
                                 f"{routes}")
        if got != want:
            raise AssertionError(f"recurrent model {label}: launches {got}, "
                                 f"expected {want}")
        if not err <= 1e-3 * scale:
            raise AssertionError(f"recurrent model {label} logits: max "
                                 f"|err| {err:.3e} > 1e-3 x {scale:.3e}")
        del model, params, filled, kernel, plain, inputs


# ------------------------------------------------------------ phase 5
# qwen2-moe-a2.7b trains at its published width with its depth cut to 4
# of 24 layers: a layer holds 570.6M params (experts 519.0M, shared MLP
# 34.6M, attention 16.8M, router 0.12M) and the untied embed and head
# 622.3M, so 4 layers make 2.905e9 params, 46.5 GB of fp32 params,
# gradients and AdamW moments (6 layers 64.7 GB, all 24 about 229 GB)
MOE_TRAIN_LAYERS = 4
# the embedding-input archs, trained at their published width and depth
EMBED_TRAIN_ARCHS = ("musicgen-large", "qwen2-vl-2b")
MEMORY_LIMIT_BYTES = 80e9


def release(torch) -> None:
    """Free what earlier phases left before a phase that measures or needs
    the card's memory: the first ``torch.utils.checkpoint`` call in a
    process imports torch._dynamo, and that import's frames hold the
    calling run's stack (its params and moments) until the cycle
    collector runs."""
    gc.collect()
    torch.cuda.empty_cache()


def one_rank_state(model, ts, seed: int):
    """``init_train_state`` on the train CLI's host mesh of this one
    process (a local mesh: every spec replicates), as the CLI lays it
    out: ((params, opt), the params' ``TrainSharding``)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import sharded_train_state
    from repro_torch.runtime.sharding import make_rules
    rules = make_rules(make_host_mesh(device="cuda"), fsdp=True)
    state, _, shd, _ = sharded_train_state(model, ts, rules, TRAIN_BATCH,
                                           seed=seed)
    return state, shd


def moe_train_config():
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)


def layer_launches(cfg) -> Counter:
    """The launches one forward of ``cfg``'s layers makes, per kernel, by
    layer kind: an attention layer B6 and its q, k, v, o GEMMs, an RWKV
    time mix B8 (its mixes, like the channel mix and the RG-LRU block,
    are plain products, as in the JAX package); a dense MLP's two or
    three GEMMs, a MoE layer's fp32 router and its shared MLP's three on
    B1 and its experts' two or three contractions on B1's grouped
    route."""
    glu = 3 if cfg.activation in ("swiglu", "geglu") else 2
    want = Counter()
    for mixer, ffn in cfg.layer_kinds():
        if mixer in ("attn", "swa"):
            want["matmul"] += 4
            want["flash_attention"] += 1
        if mixer == "rwkv":
            want["wkv"] += 1
        if ffn == "moe":
            want["matmul"] += 1 + (glu if cfg.n_shared_experts else 0)
            want["grouped_matmul"] += glu
        elif ffn == "mlp":
            want["matmul"] += glu
    return want


def expected_train_launches(cfg, steps: int = TRAIN_STEPS):
    """Launches per kernel that ``steps`` steps of ``cfg`` imply (on one
    process, or on each rank of a mesh that gathers every leaf at its
    use): every layer's forward and its remat recompute make the layers'
    ``layer_launches`` once each, and each of the 8 xent chunks (also
    recomputed) one head GEMM.  Every GEMM backward is two launches of
    its route, every attention layer's backward one B7 call, every time
    mix's one WKV backward."""
    from repro_torch.models.transformer import ExecOptions
    fwd = layer_launches(cfg)
    gemms = fwd["matmul"] + min(ExecOptions().xent_chunks, TRAIN_SEQ)
    want = {"matmul": steps * 4 * gemms}
    if fwd["flash_attention"]:
        want.update(flash_attention=steps * 2 * fwd["flash_attention"],
                    flash_attention_bwd=steps * fwd["flash_attention"])
    if fwd["wkv"]:
        want.update(wkv=steps * 2 * fwd["wkv"], wkv_bwd=steps * fwd["wkv"])
    if fwd["grouped_matmul"]:
        want["grouped_matmul"] = steps * 4 * fwd["grouped_matmul"]
    return want


# the dispatch ops of a train step: each kernel's forward op and its
# backward's
TRAIN_OP_OF = {"matmul": ("matmul", "matmul_bwd"),
               "grouped_matmul": ("grouped_matmul", "grouped_matmul_bwd"),
               "flash_attention": ("attention", "attention_bwd"),
               "wkv": ("wkv", "wkv_bwd")}


def train_ops(cfg) -> tuple:
    """The dispatch ops every train step of ``cfg`` must route to a
    kernel."""
    want = expected_train_launches(cfg)
    return tuple(op for kernel, ops in TRAIN_OP_OF.items() if kernel in want
                 for op in ops)


class RemattedRoutes:
    """``moe.route`` recording each call's expert ids.  Within a step a MoE
    layer's first call is its forward and its second the remat recompute
    in the backward, which gets the same router view again, so calls pair
    up by that view."""

    def __init__(self, route):
        self.route, self.pending, self.pairs, self.layers = route, {}, [], {}

    def __call__(self, p, spec, tokens):
        gate, eidx, probs = self.route(p, spec, tokens)
        key = p["router"].data_ptr()
        self.layers.setdefault(key, len(self.layers))
        if key in self.pending:
            self.pairs.append((self.layers[key], self.pending.pop(key), eidx))
        else:
            self.pending[key] = eidx
        return gate, eidx, probs

    def differ(self):
        """(token, k) choices of the recompute unlike the forward's, per
        layer, summed over the steps."""
        out = [0] * len(self.layers)
        for layer, fwd, again in self.pairs:
            out[layer] += int((fwd != again).sum())
        return out


def train_run(torch, phase: str, cfg, checkpoint: bool = True):
    """``launch.train.main`` on ``cfg`` (fp32 master weights, bf16
    compute, per-layer remat, 8 xent chunks, AdamW) for ``TRAIN_STEPS``
    steps of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens with a final
    checkpoint, in the checkout's (git-ignored) build/ and removed
    afterwards; with ``checkpoint`` false the save is patched out (the
    same save of a tree of tensors, 18-35 GB written at ~0.7 GB/s, that
    the other train runs make).  The entry point looks the arch up by
    name; a config cut in depth reaches it through a patched
    ``get_arch``.  Every loss
    finite, kernel routes only, exactly the launches ``cfg`` implies
    (``expected_train_launches``), every flash call on wgmma and every
    WKV on mma, peak memory under 80 GB; a MoE config's remat recompute
    must choose the forward's experts, bit for bit."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train
    from repro_torch.models import moe
    from repro_torch.runtime import collectives
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    collectives.reset_collective_counts()
    moe_layers = sum(ffn == "moe" for _, ffn in cfg.layer_kinds())
    remat = RemattedRoutes(moe.route)
    report = {}
    with contextlib.ExitStack() as stack:
        stack.callback(shutil.rmtree, ckpt_dir, ignore_errors=True)
        if cfg != get_arch(cfg.name):
            stack.enter_context(mock.patch.object(train, "get_arch",
                                                  lambda name: cfg))
        stack.enter_context(mock.patch.object(moe, "route", remat))
        if not checkpoint:
            stack.enter_context(mock.patch.object(
                CheckpointManager, "save", lambda *args, **kwargs: None))
        losses = train.main(
            ["--arch", cfg.name, "--steps", str(TRAIN_STEPS), "--batch",
             str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--log-every", "1",
             "--ckpt-dir", str(ckpt_dir)], report=report)
        torch.cuda.synchronize()
        launches = dispatch.launch_counts()
        kernel_routes = {k: n for k, n in dispatch.route_counts().items()
                         if k.startswith(("flash_attention", "wkv",
                                          "grouped_matmul"))}
    peak = torch.cuda.max_memory_allocated()
    issued = collectives.collective_counts()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    routes = {f"{op}/{route}": n for (op, route), n in report[
        "routes"].items()}
    differ = remat.differ()
    line = {"phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
            "params": report["params"], "head_dim": cfg.head_dim,
            "steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "losses": losses, "step_seconds": report["step_seconds"],
            "tok_s_per_step": [tokens / t for t in report["step_seconds"]],
            "seconds": report["seconds"], "max_memory_allocated": peak,
            "checkpoint": checkpoint,
            "checkpoint_bytes": report["checkpoint_bytes"],
            "checkpoint_seconds": report["checkpoint_seconds"],
            "routes": routes, "launches": launches,
            "kernel_routes": kernel_routes, "mesh": report["mesh"],
            "collectives": issued}
    if moe_layers:
        line.update(aux=report["aux"],
                    remat_route_pairs=len(remat.pairs),
                    remat_choices_differ_per_layer=differ)
    emit(line)
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{phase}: losses {losses}")
    # the CLI's one-rank host mesh shards nothing and runs no collective
    if report["mesh"] != {"data": 1, "model": 1} or issued:
        raise AssertionError(f"{phase}: mesh {report['mesh']}, "
                             f"collectives {issued}")
    off = {k: n for k, n in report["routes"].items() if k[1] != "kernel"}
    missing = [op for op in train_ops(cfg)
               if report["routes"].get((op, "kernel"), 0) == 0]
    if off or missing:
        raise AssertionError(f"{phase}: routes {routes}")
    want = expected_train_launches(cfg)
    got = {op: n for op, n in launches.items() if n or op in want}
    if got != want:
        raise AssertionError(f"{phase}: launches {got}, expected {want}")
    # bf16 compute at hd 64, 128 or 256: every flash call on wgmma; at
    # rwkv6-7b's hd 64, chunk 64 and sub-chunk 16 every WKV on mma
    want_routes = {f"{op}/{route}": want.get(op, 0) if route == fast else 0
                   for op, fast in (("flash_attention", "wgmma"),
                                    ("flash_attention_bwd", "wgmma"),
                                    ("wkv", "mma"))
                   for route in (fast, "simt")}
    want_routes["wkv_bwd/mma"] = want.get("wkv_bwd", 0)
    # the experts (bf16): the forward and its recompute on B1's tile, dx =
    # g @ w^T and dw = x^T @ g on the short tile, nothing on the fp32 FMA
    # tile
    grouped = want.get("grouped_matmul", 0) // 2
    want_routes.update({"grouped_matmul/wgmma": grouped,
                        "grouped_matmul/wgmma_short": grouped,
                        "grouped_matmul/simt": 0})
    if kernel_routes != want_routes:
        raise AssertionError(f"{phase}: kernel routes {kernel_routes}, "
                             f"expected {want_routes}")
    if not peak < MEMORY_LIMIT_BYTES:
        raise AssertionError(f"{phase}: peak memory {peak} bytes")
    if moe_layers and (remat.pending or len(remat.pairs)
                       != TRAIN_STEPS * moe_layers or any(differ)):
        raise AssertionError(
            f"{phase}: {len(remat.pairs)} forward/recompute route pairs "
            f"({len(remat.pending)} unpaired), choices differ {differ}")
    return launches


# kernel name substrings and their groups, first match wins (B5's
# kernels first: none of their names contains a B1 key, nor the reverse)
KERNEL_GROUPS = (("quantized_wgmma_kernel", "B5 int8 matmul bf16 (wgmma)"),
                 ("quantized_f32_kernel", "B5 int8 matmul fp32 (SIMT)"),
                 ("quantized_splitk_sum_kernel", "B5 split-K sum"),
                 # B1's kernels are templated on <B K-major, grouped>, its
                 # fp32 ones on <grouped, B K-major, aligned>
                 ("matmul_bf16_wgmma_kernel<false, true>",
                  "B1 grouped bf16 (wgmma)"),
                 ("matmul_bf16_wgmma_kernel<true, true>",
                  "B1 grouped bf16 (wgmma)"),
                 ("matmul_bf16_wgmma_kernel", "B1 matmul bf16 (wgmma)"),
                 ("matmul_bf16_grouped_short_kernel",
                  "B1 grouped bf16 short (wgmma)"),
                 ("matmul_f32_simt_kernel<true,", "B1 grouped fp32 (SIMT)"),
                 ("matmul_f32_simt_kernel", "B1 matmul fp32 (SIMT)"),
                 ("matmul_splitk_reduce_kernel", "B1 split-K sum"),
                 ("flash_fwd_wgmma_kernel", "B6 flash forward bf16 (wgmma)"),
                 ("flash_fwd_kernel", "B6 flash forward (SIMT)"),
                 ("flash_bwd_split_kernel", "B7 dO split bf16 (wgmma route)"),
                 ("flash_dq_wgmma_kernel", "B7 dQ sweep bf16 (wgmma)"),
                 ("flash_dkv_wgmma_kernel", "B7 dK/dV sweep bf16 (wgmma)"),
                 ("flash_dq_kernel", "B7 dQ sweep (SIMT)"),
                 ("flash_dkv_kernel", "B7 dK/dV sweep (SIMT)"),
                 ("decode_split_kernel", "B2/B4a decode attention"),
                 ("decode_combine_kernel", "B2/B4a decode attention"),
                 ("prefill_wgmma_kernel", "B3/B4b prefill attention"),
                 ("prefill_combine_kernel", "B3/B4b prefill attention"),
                 ("prefill_simt_kernel", "B3/B4b prefill attention"),
                 # the WKV backward's four launches (the chunk products,
                 # the scans, the gradient kernel, the du sum) before B8's
                 # routes (wkv_mma_kernel, the simt wkv_kernel)
                 ("wkv_bwd_chunk_kernel", "B8 backward (WKV gradient)"),
                 ("wkv_bwd_scan_kernel", "B8 backward (WKV gradient)"),
                 ("wkv_bwd_grad_kernel", "B8 backward (WKV gradient)"),
                 ("wkv_bwd_du_kernel", "B8 backward (WKV gradient)"),
                 ("wkv_mma_kernel", "B8 WKV (mma)"),
                 ("wkv_kernel", "B8 WKV (SIMT)"))
OTHER_GROUP = "other (PyTorch ops)"
# what a bf16 train step's attention must run on (hd 64, 128 or 256)
TRAIN_WGMMA_GROUPS = ("B6 flash forward bf16 (wgmma)",
                      "B7 dQ sweep bf16 (wgmma)",
                      "B7 dK/dV sweep bf16 (wgmma)")
# and a MoE step's experts: the bf16 forward on B1's tile, dx and dw on
# the short tile; none of it on the fp32 FMA tile
MOE_TRAIN_GROUPS = TRAIN_WGMMA_GROUPS + ("B1 grouped bf16 (wgmma)",
                                         "B1 grouped bf16 short (wgmma)")
MOE_TRAIN_FORBIDDEN = ("B1 grouped fp32 (SIMT)",)
# and an RWKV step's time mixes: B8 forward and the WKV backward
RWKV_TRAIN_GROUPS = ("B8 WKV (mma)", "B8 backward (WKV gradient)")


def kernel_group(name: str) -> str:
    return next((g for key, g in KERNEL_GROUPS if key in name), OTHER_GROUP)


def train_profile(torch, phase: str, cfg, required, forbidden=()):
    """Where one train step of ``cfg`` spends the card's time, by kernel,
    from ``torch.profiler`` over one step after a warm-up step (the same
    step function, settings and batch as the train phases, without the
    supervisor and checkpoint).  If the profiler sees no device time,
    says so instead of failing: it is a breakdown, not a check; if it sees
    device time, every group of ``required`` must have some and no group
    of ``forbidden`` any."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import collectives
    from repro_torch.train.steps import TrainStepConfig, make_train_step
    model = Model(cfg, device="cuda")
    ts = TrainStepConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=10,
                                         total_steps=TRAIN_STEPS))
    (params, opt), shd = one_rank_state(model, ts, seed=0)
    step_fn = make_train_step(model, dataclasses.replace(
        ts, grad_shardings=shd))
    batch = train_batch(torch, cfg, seed=0)
    collectives.reset_collective_counts()
    params, opt, metrics = step_fn(params, opt, batch)
    float(metrics["loss"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        float(metrics["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, other = {}, []
    for evt in prof.key_averages():
        # device-side events only: a CPU op's self device time repeats
        # the kernels it launched
        ms = evt.self_device_time_total / 1e3
        if evt.device_type != torch.autograd.DeviceType.CUDA or ms <= 0:
            continue
        group = kernel_group(evt.key)
        if group == OTHER_GROUP:
            other.append((ms, evt.count, evt.key[:90]))
        groups[group] = groups.get(group, 0.0) + ms
    busy = sum(groups.values())
    missing = [g for g in required if busy and not groups.get(g)]
    present = [g for g in forbidden if groups.get(g)]
    emit({"phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
          "profiled_step_wall_ms": wall_ms,
          "device_ms": groups if busy else "not measured",
          "device_busy_ms": busy if busy else None,
          "idle_share": 1 - busy / wall_ms if busy else None,
          "top_other": [{"ms": ms, "calls": n, "kernel": name}
                        for ms, n, name in sorted(other, reverse=True)[:8]]})
    if missing:
        raise AssertionError(f"{phase}: no device time in {missing}")
    if present:
        raise AssertionError(f"{phase}: device time in {present}")
    if collectives.collective_counts():
        raise AssertionError(f"{phase}: collectives "
                             f"{collectives.collective_counts()}")
    del params, opt, metrics


DECODE_RANGE = "chip_smoke.decode_step"
PREFILL_RANGE = "chip_smoke.prefill_call"


# the serve runs profiled after phase 3: its continuous float and int8 +
# prefix runs
PROFILED_SERVE_RUNS = (("float continuous", []),
                       ("int8+prefix continuous", INT8_ARGS + PREFIX_ARGS))
# a profile's window: one wave of 4 requests (one a slot) and 8 new
# tokens each, a third of the runs' decode steps (for the script's time:
# the profiler's events cost the host in proportion to them)
PROFILE_WINDOW = ["--requests", "4", "--max-new", "8"]


def range_breakdown(torch, events, name: str):
    """Device time by kernel group of the kernels that start inside the
    host ranges ``name`` marks: (ranges, their ms, ms by group, ms by
    kernel of the other group).  The profiler also mirrors each range onto
    the device's timeline as an annotation, which is no kernel."""
    cuda_t = torch.autograd.DeviceType.CUDA
    windows = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.name == name and e.device_type != cuda_t)
    starts = [w[0] for w in windows]
    groups, other = {}, {}
    for e in events:
        if e.device_type != cuda_t or e.name.startswith("chip_smoke."):
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i < 0 or e.time_range.start > windows[i][1]:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        group = kernel_group(e.name)
        groups[group] = groups.get(group, 0.0) + ms
        if group == OTHER_GROUP:
            other[e.name[:90]] = other.get(e.name[:90], 0.0) + ms
    window_ms = sum(end - start for start, end in windows) / 1e3
    return len(windows), window_ms, groups, other


def serve_profile(torch, label: str, extra: list, base=None):
    """Where the decode steps and the prefill calls of a continuous serve
    run spend the card's time: phase 3's continuous run with ``extra``
    arguments again under ``torch.profiler``, with each
    ``StepExecutor.decode`` and each ``StepExecutor.prefill`` call (host
    work, launches and the argmax read) marked as a range.  Device time by
    kernel group sums the kernels that start inside those ranges; the idle
    share is the part of the ranges with no kernel running.  If the
    profiler sees no device time, says so instead of failing."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.launch import engine, serve

    def marked(method, name):
        def run(self, *args, **kwargs):
            with record_function(name):
                return method(self, *args, **kwargs)
        return run

    ex = engine.StepExecutor
    with mock.patch.object(ex, "decode", marked(ex.decode, DECODE_RANGE)), \
            mock.patch.object(ex, "prefill",
                              marked(ex.prefill, PREFILL_RANGE)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rep = serve.main((base or SERVE_ARGS) + extra + PROFILE_WINDOW
                             + ["--schedule", "continuous", "--clock",
                                "tick"])
            torch.cuda.synchronize()
    events = prof.events()
    line = {"phase": "serve_profile", "run": label, "phases": rep["phases"],
            "new_tokens": rep["new_tokens"]}
    for key, name in (("decode", DECODE_RANGE), ("prefill", PREFILL_RANGE)):
        n, window_ms, groups, other = range_breakdown(torch, events, name)
        busy = sum(groups.values())
        unit = "step" if key == "decode" else "call"
        line.update({
            f"{key}_{unit}s": n, f"{key}_window_ms": window_ms,
            f"{key}_window_ms_per_{unit}": window_ms / n if n else None,
            f"{key}_device_ms_per_{unit}": (
                {g: ms / n for g, ms in groups.items()} if busy and n
                else "not measured"),
            f"{key}_device_busy_ms": busy if busy else None,
            f"{key}_device_busy_ms_per_{unit}": busy / n if busy and n
            else None,
            f"{key}_idle_share": 1 - busy / window_ms if busy and window_ms
            else None,
            f"{key}_top_other": [{"ms": ms, "kernel": k} for k, ms in sorted(
                other.items(), key=lambda kv: -kv[1])[:8]]})
    emit(line)


# ------------------------------------------------------------ phase 6d
# the recurrent archs' whole-sequence prefill at full width and depth in
# bf16: 2 x 2048 tokens; exact launches (``prefill_launches``: rwkv6-7b
# B8 once a layer and B1 for the head, recurrentgemma-9b its decode
# step's B1 163 and B6 once a local layer)
RECURRENT_ARCHS = ("rwkv6-7b", "recurrentgemma-9b")
RECURRENT_PREFILL = dict(batch=2, seq=2048)
# training at published width with the depth cut: fp32 master weights and
# AdamW take ~16 bytes a parameter (rwkv6-7b 7.535e9 params, ~121 GB;
# recurrentgemma-9b 8.579e9, ~137 GB); rwkv6-7b 8 layers (2.286e9),
# recurrentgemma-9b 6 (two whole rglru, rglru, swa periods; 2.236e9)
RECURRENT_TRAIN_LAYERS = {"rwkv6-7b": 8, "recurrentgemma-9b": 6}
# the fp32 parity step (a kernel run and a plain run, each with its
# gradients) at less depth, every layer kind still present: rwkv6-7b 2
# layers, recurrentgemma-9b 3 (one whole rglru, rglru, swa period)
RECURRENT_PARITY_LAYERS = {"rwkv6-7b": 2, "recurrentgemma-9b": 3}
RECURRENT_TRAIN_GROUPS = {"rwkv6-7b": RWKV_TRAIN_GROUPS,
                          "recurrentgemma-9b": TRAIN_WGMMA_GROUPS}


def prefill_launches(cfg) -> dict:
    """The launches one whole-sequence prefill of ``cfg`` makes: its
    layers' ``layer_launches`` and the head once (B1)."""
    want = layer_launches(cfg)
    want["matmul"] += 1
    return dict(want)


def recurrent_prefill_phase(torch):
    """``Model.prefill`` of each recurrent arch at full width and depth in
    bf16 (one model alive at a time) on ``RECURRENT_PREFILL`` seeded
    tokens, every launch count set to 0 just before and read just after:
    exactly ``prefill_launches``, kernel routes only (B6 on wgmma, B8 on
    mma), finite logits; its seconds (host wall, synchronised), tokens/s
    and peak memory."""
    from repro_torch.configs import get_arch
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer import Model
    launches = {}
    b, s = RECURRENT_PREFILL["batch"], RECURRENT_PREFILL["seq"]
    for arch in RECURRENT_ARCHS:
        release(torch)
        cfg = get_arch(arch)
        model = Model(cfg, dt=DtypePolicy(param=torch.bfloat16),
                      device="cuda")
        params = model.init(seed=3)
        gen = torch.Generator(device="cuda").manual_seed(5)
        tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                               device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            model.prefill(params, {"tokens": tokens})        # warm-up
            torch.cuda.synchronize()
            dispatch.reset_launch_counts()
            with dispatch.stats_scope() as stats:
                t0 = time.perf_counter()
                logits = model.prefill(params, {"tokens": tokens})
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                routes = stats()
        got = {op: n for op, n in dispatch.launch_counts().items() if n}
        kernel_routes = {k: n for k, n in dispatch.route_counts().items()
                         if n}
        want = prefill_launches(cfg)
        finite = bool(torch.isfinite(logits).all())
        emit({"phase": "recurrent_prefill", "arch": arch,
              "layers": cfg.n_layers, "batch": b, "seq": s,
              "seconds": seconds, "tok_s": b * s / seconds,
              "peak_memory_bytes": torch.cuda.max_memory_allocated(),
              "launches": got, "kernel_routes": kernel_routes,
              "routes": {f"{op}/{r}": n for (op, r), n in routes.items()},
              "logits_finite": finite, "logits_shape": list(logits.shape)})
        if any(r != "kernel" for _, r in routes):
            raise AssertionError(f"recurrent_prefill {arch}: routes "
                                 f"{routes}")
        if got != want:
            raise AssertionError(f"recurrent_prefill {arch}: launches "
                                 f"{got}, expected {want}")
        fast = {"flash_attention/wgmma": want.get("flash_attention", 0),
                "wkv/mma": want.get("wkv", 0)}
        if {k: kernel_routes.get(k, 0) for k in fast} != fast \
                or set(kernel_routes) - set(fast):
            raise AssertionError(f"recurrent_prefill {arch}: kernel routes "
                                 f"{kernel_routes}")
        if not finite or tuple(logits.shape) != (b, cfg.vocab_size):
            raise AssertionError(f"recurrent_prefill {arch}: logits "
                                 f"{tuple(logits.shape)}, finite {finite}")
        for op, n in got.items():
            launches[op] = launches.get(op, 0) + n
        del model, params, logits
    release(torch)
    return launches


def recurrent_train_config(arch: str, parity: bool = False):
    """``arch`` at its published width, its depth cut to
    ``RECURRENT_TRAIN_LAYERS`` (``RECURRENT_PARITY_LAYERS`` for the
    parity step)."""
    from repro_torch.configs import get_arch
    depth = RECURRENT_PARITY_LAYERS if parity else RECURRENT_TRAIN_LAYERS
    return dataclasses.replace(get_arch(arch), n_layers=depth[arch])


# ------------------------------------------------------------ phase 6
def train_batch(torch, cfg, seed: int):
    """A ``TRAIN_BATCH`` x ``TRAIN_SEQ`` batch of the synthetic stream on
    the card (embeddings for an embedding-input arch); an M-RoPE arch's
    positions are three different streams, the text position and a seeded
    permutation of it per row for each further section (the train CLI's
    positions repeat the text position, which makes M-RoPE plain RoPE)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                  seed=seed, input_mode=cfg.input_mode,
                                  d_model=cfg.d_model))
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in data.batch_at(0).items()}
    if cfg.mrope_sections:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        text = torch.arange(TRAIN_SEQ, device="cuda").expand(TRAIN_BATCH, -1)
        streams = [text] + [
            torch.stack([torch.randperm(TRAIN_SEQ, generator=gen,
                                        device="cuda")
                         for _ in range(TRAIN_BATCH)])
            for _ in cfg.mrope_sections[1:]]
        batch["positions"] = torch.stack(streams, -1).to(torch.int32)
    return batch


def train_parity_phase(torch, phase: str, cfg, seed: int = 7):
    """One fp32 loss and backward of ``cfg``, kernels against the plain
    versions on the card (TF32 is off): loss within 1e-5 relative, every
    gradient leaf within 1e-3 of that leaf's max |grad|.

    An ulp between the routes flips a MoE expert choice whose k-th to
    (k+1)-th probability gap is that small, and a flip moves its token by
    a whole expert, so for a MoE config the held plain run takes the
    kernel run's choices (each MoE layer's, by its router; the remat
    recompute gets the same).  A free-running plain loss beside it
    reports its own choices: how many differ, and the smallest gap each
    run saw (reported, not held)."""
    from repro_torch.core import tree
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.kernels import dispatch
    from repro_torch.models import moe
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.runtime import collectives
    from repro_torch.runtime.sharding import (make_rules, shard_state,
                                              train_sharding)
    f32 = DtypePolicy(param=torch.float32, compute=torch.float32)
    model = Model(cfg, dt=f32, device="cuda")
    # the params as the train CLI lays them out on its one-rank host mesh,
    # the loss gathering each leaf at its use (nothing to gather there)
    rules = make_rules(make_host_mesh(device="cuda"), fsdp=True)
    params = model.init(seed=2)
    shd = train_sharding(rules, params, TRAIN_BATCH)
    params = shard_state(params, shd.specs, rules.mesh)
    model = Model(cfg, dt=f32, device="cuda", opts=dataclasses.replace(
        model.opts, sharding=shd))
    collectives.reset_collective_counts()
    flat, rebuild = tree.flatten(params)
    for t in flat:
        t.requires_grad_(True)
    batch = train_batch(torch, cfg, seed)
    route = moe.route
    chosen = [{}, {}]     # a run's (expert ids, smallest gap) by router

    def recording(store):
        def call(p, spec, tokens):
            gate, eidx, probs = route(p, spec, tokens)
            key = p["router"].data_ptr()
            if key not in store:     # the forward (the recompute saves
                # what the forward saved, so nothing is read off the graph)
                top = torch.topk(probs.detach(), spec.top_k + 1,
                                 dim=-1).values
                store[key] = (eidx, float((top[:, -2] - top[:, -1]).min()))
            return gate, eidx, probs
        return call

    def replaying(p, spec, tokens):
        _, _, probs = route(p, spec, tokens)
        eidx = chosen[0][p["router"].data_ptr()][0]
        gate = probs.gather(1, eidx)
        if spec.norm_topk:
            gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        return gate, eidx, probs

    def run(route_fn, on_card=True, backward=True):
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(moe, "route", route_fn))
            if not on_card:
                stack.enter_context(mock.patch.object(
                    dispatch, "_on_card", lambda op, t: False))
            loss, _ = model.loss_fn(rebuild(flat), batch)
            grads = torch.autograd.grad(loss, flat) if backward else None
        return float(loss.detach()), grads

    dispatch.reset_launch_counts()
    loss_k, grads_k = run(recording(chosen[0]))
    grouped_routes = {k: n for k, n in dispatch.route_counts().items()
                      if k.startswith("grouped_matmul/")}
    moe_layers = len(chosen[0])
    line = {}
    if moe_layers:
        # fp32 operands: every grouped call on the FMA tile
        if grouped_routes["grouped_matmul/simt"] != sum(
                grouped_routes.values()) or not grouped_routes[
                    "grouped_matmul/simt"]:
            raise AssertionError(f"{phase}: grouped routes {grouped_routes}")
        line.update(grouped_routes=grouped_routes)
        loss_free, _ = run(recording(chosen[1]), on_card=False,
                           backward=False)
        loss_p, grads_p = run(replaying, on_card=False)
        line.update(
            moe_layers=moe_layers,
            expert_choices=sum(e.numel() for e, _ in chosen[0].values()),
            own_choices_differ=sum(int((chosen[0][k][0] != e).sum())
                                   for k, (e, _) in chosen[1].items()),
            own_loss_plain=loss_free,
            own_loss_rel_err=abs(loss_k - loss_free) / abs(loss_free),
            min_topk_gap=[min(gap for _, gap in c.values())
                          for c in chosen])
    else:
        loss_p, grads_p = run(route, on_card=False)
    torch.cuda.synchronize()
    names = [f"leaf {i} {tuple(t.shape)}" for i, t in enumerate(flat)]
    worst = (0.0, "", 0.0)
    for name, gk, gp in zip(names, grads_k, grads_p):
        scale = gp.abs().max().item()
        err = (gk - gp).abs().max().item()
        ratio = err / scale if scale > 0 else err
        if ratio >= worst[0]:
            worst = (ratio, name, scale)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    emit({"phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
          "dtype": "float32", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "loss_kernel": loss_k, "loss_plain": loss_p, "loss_rel_err": rel,
          "worst_leaf": worst[1], "worst_leaf_err_over_max_grad": worst[0],
          "worst_leaf_max_grad": worst[2], "leaves": len(flat), **line})
    if not rel <= 1e-5:
        raise AssertionError(f"{phase}: loss {loss_k} vs {loss_p}")
    if not worst[0] <= 1e-3:
        raise AssertionError(f"{phase}: {worst[1]} off by "
                             f"{worst[0]:.3e} of its max |grad|")
    if collectives.collective_counts():
        raise AssertionError(f"{phase}: collectives "
                             f"{collectives.collective_counts()}")
    del params, flat, grads_k, grads_p


# ------------------------------------------------------------ phase 6e
# sharded training on two ranks sharing cuda:0 over gloo (a check, not a
# speed result: the ranks time-share the card and every collective goes
# through host memory)
SHARDED_RANKS = 2
# make_host_mesh's (1, 2) for two ranks, and the data-parallel (2, 1)
SHARDED_MESHES = ((1, 2), (2, 1))
SHARDED_PARITY_LAYERS, SHARDED_PARITY_BATCH, SHARDED_PARITY_SEQ = 2, 2, 128
SHARDED_STEPS = 2
# the CLI's run: gemma-2b at full width, its depth cut from 18 layers to
# fit the phase's time (6 layers: 46 s of a 304 s phase; PR 29 call 1)
SHARDED_CLI_LAYERS = 2
# the stage pipeline: 2 stages of tanh(x @ w) at gemma-2b's width, M = 4
# microbatches of 512 rows, fp32
SHARDED_PIPE = dict(m=4, mb=512, d=2048)
SHARDED_LIMITS = {"loss": 1e-5, "grad": 1e-3, "grad_norm": 1e-5}


def _fp32_opts():
    # the fp32 runs without remat: each leaf gathered once a forward
    # through the host, not again in the backward (the CLI's bf16 run
    # keeps remat and its gathers inside the recompute)
    from repro_torch.models.transformer import ExecOptions
    return ExecOptions(remat=False)


def sharded_config(layers: int):
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("gemma-2b"), n_layers=layers)


def sharded_batches(torch, cfg, n: int, seed: int):
    """``n`` whole batches of the synthetic stream, on the card."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=SHARDED_PARITY_SEQ,
                                  global_batch=SHARDED_PARITY_BATCH,
                                  seed=seed))
    return [{k: torch.from_numpy(v).to("cuda")
             for k, v in data.batch_at(i).items()} for i in range(n)]


def sharded_fp32(torch, rules, seed: int):
    """The fp32 model at SHARDED_PARITY_LAYERS and its train step on
    ``rules.mesh``: (model, step config, state, spec tree, sharding)."""
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.launch.train import sharded_train_state
    from repro_torch.models.transformer import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import TrainStepConfig
    cfg = sharded_config(SHARDED_PARITY_LAYERS)
    model = Model(cfg, dt=DtypePolicy(compute=torch.float32), device="cuda",
                  opts=_fp32_opts())
    ts = TrainStepConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=10,
                                         total_steps=SHARDED_STEPS))
    state, specs, shd, _ = sharded_train_state(model, ts, rules,
                                               SHARDED_PARITY_BATCH, seed)
    return model, ts, state, specs, shd


def digest(torch, t) -> str:
    import hashlib
    return hashlib.sha1(t.detach().cpu().reshape(-1).view(torch.uint8)
                        .numpy().tobytes()).hexdigest()


def one_process_grads_and_steps(torch, batches):
    """The fp32 gemma-2b at SHARDED_PARITY_LAYERS in this process alone:
    the loss and the gradient at the drawn params (on the card), and the
    metrics of SHARDED_STEPS train steps."""
    from repro_torch.core import tree
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.models.transformer import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import (TrainStepConfig, init_train_state,
                                         make_train_step)
    model = Model(sharded_config(SHARDED_PARITY_LAYERS),
                  dt=DtypePolicy(compute=torch.float32), device="cuda",
                  opts=_fp32_opts())
    ts = TrainStepConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=10,
                                         total_steps=SHARDED_STEPS))
    params, opt = init_train_state(model, ts, seed=2)
    flat, rebuild = tree.flatten(params)
    for t in flat:
        t.requires_grad_(True)
    loss, _ = model.loss_fn(rebuild(flat), batches[0])
    grads = torch.autograd.grad(loss, flat)
    for t in flat:
        t.requires_grad_(False)
    step = make_train_step(model, ts)
    metrics = []
    for batch in batches:
        params, opt, met = step(params, opt, batch)
        metrics.append({k: float(v) for k, v in met.items()})
    return {"loss": float(loss.detach()), "grads": grads,
            "metrics": metrics}


def sharded_grads_and_steps(torch, mesh, batches, one):
    """On this rank, the fp32 gemma-2b at SHARDED_PARITY_LAYERS laid out
    on ``mesh``: the loss and the gradient at the drawn params, each
    leaf's shard held to the same block of one process's gradient
    (``one``; over the ranks, the gathered leaf), then SHARDED_STEPS
    train steps.  Returns the row (loss, the worst gradient error over
    its leaf's max |grad| and that leaf, the metrics, a digest of every
    leaf no axis splits) and the run (model, step config, state, spec
    tree, sharding)."""
    from repro_torch.core import tree
    from repro_torch.models.transformer import Model
    from repro_torch.runtime import sharding
    from repro_torch.train.steps import make_train_step
    rules = sharding.make_rules(mesh, fsdp=True)
    model, ts, (params, opt), specs, shd = sharded_fp32(torch, rules, 2)
    view = Model(model.cfg, model.dt, model.device,
                 dataclasses.replace(model.opts, sharding=shd))
    flat, rebuild = tree.flatten(params)
    for t in flat:
        t.requires_grad_(True)
    loss, _ = view.loss_fn(rebuild(flat), shd.split_batch(batches[0]))
    grads = torch.autograd.grad(loss, flat)
    for t in flat:
        t.requires_grad_(False)
    worst = (0.0, -1)
    for i, (g, spec, want) in enumerate(zip(grads, shd.leaf_specs,
                                            one["grads"])):
        scale = want.abs().max().item()
        err = (g - sharding.shard_leaf(want, spec, mesh)).abs().max().item()
        worst = max(worst, (err / scale if scale > 0 else err, i))
    del grads
    step = make_train_step(model, dataclasses.replace(ts,
                                                      grad_shardings=shd))
    metrics = []
    for batch in batches:
        params, opt, met = step(params, opt, shd.split_batch(batch))
        metrics.append({k: float(v) for k, v in met.items()})
    digests = [digest(torch, t) for t, spec in zip(
        tree.leaves((params, opt)), sharding.spec_leaves(specs))
        if not sharding.sharded_axes(spec, mesh)]
    row = {"loss": float(loss.detach()), "grad_worst": worst,
           "metrics": metrics, "digests": digests}
    return row, (model, ts, (params, opt), specs, shd)


def sharded_elastic(torch, mesh_a, run_a, batch, ckpt_dir: Path) -> dict:
    """The fp32 run ``run_a`` on ``mesh_a`` (2, 1) after its steps: its
    state saved whole; ``restore_on_mesh`` onto (1, 2) against
    ``reshard_state`` from (2, 1) to (1, 2), shard for shard; the plain
    manager's whole leaves in one process (on every rank), cut by the new
    specs, against the resharded shards; one more step on the resharded
    state and on the (2, 1) one."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.core import tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import elastic, sharding
    from repro_torch.train.steps import make_train_step
    model, ts, state, specs_a, shd_a = run_a
    t0 = time.time()
    CheckpointManager(str(ckpt_dir), specs=specs_a, mesh=mesh_a).save(
        SHARDED_STEPS, state)
    saved = time.time()
    mesh_b = make_mesh((1, 2), ("data", "model"), device="cuda")
    rules_b = sharding.make_rules(mesh_b, fsdp=True)
    like = sharding.global_like(state, specs_a, mesh_a)
    restored, step, _ = elastic.restore_on_mesh(
        CheckpointManager(str(ckpt_dir)), like, rules_b)
    moved, specs_m = elastic.reshard_state(state, rules_b, specs=specs_a,
                                           mesh=mesh_a)
    flat_m = tree.leaves(moved)
    new = sharding.spec_leaves(specs_m)
    out = {"step_restored": step,
           "specs_equal": new == sharding.spec_leaves(
               sharding.tree_specs(rules_b, like)),
           "restored_equal": all(torch.equal(r, m) for r, m in zip(
               tree.leaves(restored), flat_m))}
    del restored
    whole = CheckpointManager(str(ckpt_dir)).restore(tree.tree_map(
        lambda x: torch.empty(x.shape, dtype=x.dtype, device="cpu"),
        like))[0]
    out["one_process_equal"] = all(
        torch.equal(sharding.shard_leaf(w, s, mesh_b), m)
        for w, s, m in zip(tree.leaves(whole), new, flat_m))
    del whole
    shd_b = sharding.train_sharding(rules_b, like[0], SHARDED_PARITY_BATCH)
    step_b = make_train_step(model, dataclasses.replace(
        ts, grad_shardings=shd_b))
    step_a = make_train_step(model, dataclasses.replace(
        ts, grad_shardings=shd_a))
    _, _, met_b = step_b(*moved, shd_b.split_batch(batch))
    _, _, met_a = step_a(*state, shd_a.split_batch(batch))
    out["metrics_resharded"] = {k: float(v) for k, v in met_b.items()}
    out["metrics_kept"] = {k: float(v) for k, v in met_a.items()}
    out["save_seconds"] = saved - t0
    out["seconds"] = time.time() - t0
    out["state_bytes"] = sum(x.numel() * x.element_size()
                             for x in tree.leaves(like))
    return out


def sharded_pipeline(torch) -> dict:
    """``pipeline_apply`` of tanh(x @ w_s) through ``dispatch.matmul``
    (B1, fp32) over 2 stages on a ("pod",) mesh, M = SHARDED_PIPE["m"]:
    the output against the sequential product in plain PyTorch, the
    launches, ``bubble_fraction``."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import sharding
    from repro_torch.runtime.pipeline_parallel import (bubble_fraction,
                                                       pipeline_apply)
    m, mb, d = SHARDED_PIPE["m"], SHARDED_PIPE["mb"], SHARDED_PIPE["d"]
    mesh = make_mesh((SHARDED_RANKS,), ("pod",), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    w = torch.randn((SHARDED_RANKS, d, d), generator=gen, device="cuda") \
        / d ** 0.5
    x = torch.randn((m, mb, d), generator=gen, device="cuda")
    stage = sharding.shard_leaf(w, sharding.P("pod"), mesh)
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    out = pipeline_apply(
        lambda p, h: torch.tanh(dispatch.matmul(h, p["w"])), {"w": stage},
        x, mesh=mesh, stage_axis="pod")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    want = x
    for i in range(SHARDED_RANKS):
        want = torch.tanh(torch.matmul(want, w[i]))
    return {"max_abs_err": (out - want).abs().max().item(),
            "launches": {k: n for k, n in launches.items() if n},
            "bubble_fraction": bubble_fraction(SHARDED_RANKS, m),
            "seconds": seconds}


def sharded_cli(torch) -> dict:
    """``launch.train.main`` on this rank: gemma-2b at full width cut to
    SHARDED_CLI_LAYERS, bf16 compute, SHARDED_STEPS steps of
    TRAIN_BATCH x TRAIN_SEQ on the CLI's own host mesh, its checkpoint
    patched out."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train
    from repro_torch.runtime import collectives
    cfg = sharded_config(SHARDED_CLI_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    collectives.reset_collective_counts()
    report = {}
    with mock.patch.object(train, "get_arch", lambda name: cfg), \
            mock.patch.object(CheckpointManager, "save",
                              lambda *args, **kwargs: None):
        losses = train.main(
            ["--arch", cfg.name, "--steps", str(SHARDED_STEPS), "--batch",
             str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--log-every", "1",
             "--ckpt-dir", str(ROOT / "build" / "chip_smoke_sharded_ckpt")],
            report=report)
    torch.cuda.synchronize()
    return {"losses": losses, "mesh": report["mesh"],
            "launches": dispatch.launch_counts(),
            "flash_routes": {k: n for k, n in dispatch.route_counts().items()
                             if k.startswith("flash_attention")},
            "plain": [f"{op}/{r}" for (op, r) in report["routes"]
                      if r != "kernel"],
            "peak": torch.cuda.max_memory_allocated(),
            "state_bytes": report["state_bytes"],
            "params": report["params"],
            "step_seconds": report["step_seconds"],
            "collectives": collectives.collective_counts()}


def sharded_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One of the SHARDED_RANKS processes sharing cuda:0 over gloo: the
    CLI; one process's fp32 gradient and steps, then the same on each of
    SHARDED_MESHES held to them; the elastic run from the last mesh's
    state; the pipeline.  Results to ``out_dir``."""
    import datetime
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=3))
    from repro_torch.launch.mesh import make_mesh
    out = {"t": {}}
    t0 = time.time()
    out["cli"] = sharded_cli(torch)
    out["t"]["cli"] = time.time() - t0
    torch.cuda.empty_cache()
    cfg = sharded_config(SHARDED_PARITY_LAYERS)
    batches = sharded_batches(torch, cfg, SHARDED_STEPS, seed=11)
    # one process's run, on each rank alone, to hold its shards to
    one = one_process_grads_and_steps(torch, batches)
    out["one_process"] = {"loss": one["loss"], "metrics": one["metrics"]}
    out["t"]["one process"] = time.time() - t0
    out["meshes"] = {}
    for shape in SHARDED_MESHES:
        mesh = make_mesh(shape, ("data", "model"), device="cuda")
        out["meshes"][shape], run = sharded_grads_and_steps(
            torch, mesh, batches, one)
        out["t"][f"parity {shape}"] = time.time() - t0
    del one
    torch.cuda.empty_cache()
    # the elastic check on the last mesh's run, (2, 1)
    out["elastic"] = sharded_elastic(
        torch, mesh, run, sharded_batches(torch, cfg, 1, seed=12)[0],
        Path(out_dir) / "elastic_ckpt")
    del run
    dist.barrier()
    torch.cuda.empty_cache()
    out["t"]["elastic"] = time.time() - t0
    out["pipeline"] = sharded_pipeline(torch)
    out["t"]["pipeline"] = time.time() - t0
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def sharded_train_phase(torch) -> dict:
    """Phase 6e: SHARDED_RANKS ranks sharing cuda:0 over gloo
    (``torch.multiprocessing.spawn``, a ``file://`` store; the kernels
    built here first).  The CLI on both ranks (its (1, 2) host mesh):
    finite losses, per rank exactly the B1/B6/B7 launches one process of
    that config makes, every flash call on wgmma, no plain route; each
    rank's peak memory, stored state bytes and step seconds.  fp32 at
    SHARDED_PARITY_LAYERS on (1, 2) and (2, 1): the loss and every
    gradient leaf (each rank's shard against the same block of one
    process's gradient: over the ranks, the gathered leaf) against one
    process's (1e-5 relative, 1e-3 of the leaf's max |grad|),
    SHARDED_STEPS steps' losses and grad norms (1e-5), the ranks'
    replicated leaves and metrics equal bit for bit.  Elastic (from the
    (2, 1) run): restore onto (1, 2) equal to the live reshard shard for
    shard, the plain manager's whole leaves equal to both, one more step
    on each layout within the fp32 gate.  The pipeline within TOL's fp32
    limit of the sequential product.  Returns the ranks' launches."""
    import torch.multiprocessing as mp
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        mp.spawn(sharded_rank, args=(SHARDED_RANKS, str(Path(tmp) / "store"),
                                     tmp), nprocs=SHARDED_RANKS, join=True)
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(SHARDED_RANKS)]
    failed = []
    launches = Counter()
    cli_cfg = sharded_config(SHARDED_CLI_LAYERS)
    want = expected_train_launches(cli_cfg, SHARDED_STEPS)
    one_process_bytes = ranks[0]["cli"]["params"] * 4 * 3
    for rank, r in enumerate(ranks):
        cli = r["cli"]
        launches.update(cli["launches"])
        got = {op: n for op, n in cli["launches"].items() if n or op in want}
        emit({"phase": "sharded_train", "run": "cli", "rank": rank,
              "arch": cli_cfg.name, "layers": SHARDED_CLI_LAYERS,
              "mesh": cli["mesh"], "ranks_share": "cuda:0 over gloo, "
              "collectives through host", "steps": SHARDED_STEPS,
              "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
              "losses": cli["losses"], "step_seconds": cli["step_seconds"],
              "max_memory_allocated": cli["peak"],
              "state_bytes": cli["state_bytes"],
              "one_process_state_bytes": one_process_bytes,
              "launches": got, "expected_launches": want,
              "flash_routes": cli["flash_routes"],
              "collectives": cli["collectives"], "seconds": r["t"]})
        flash = want["flash_attention"] + want["flash_attention_bwd"]
        if got != want or cli["plain"] \
                or not all(map(math.isfinite, cli["losses"])) \
                or cli["flash_routes"].get("flash_attention/wgmma", 0) \
                + cli["flash_routes"].get("flash_attention_bwd/wgmma", 0) \
                != flash or cli["mesh"] != {"data": 1, "model": 2} \
                or not cli["state_bytes"] < one_process_bytes:
            failed.append(f"cli rank {rank}: launches {got} (want {want}), "
                          f"plain {cli['plain']}, losses {cli['losses']}, "
                          f"flash {cli['flash_routes']}, mesh "
                          f"{cli['mesh']}, bytes {cli['state_bytes']}")
    one = ranks[0]["one_process"]
    for shape in SHARDED_MESHES:
        got = [r["meshes"][shape] for r in ranks]
        ratio, leaf = max(g["grad_worst"] for g in got)
        loss_rel = abs(got[0]["loss"] - one["loss"]) / abs(one["loss"])
        steps = [(abs(g["loss"] - w["loss"]) / abs(w["loss"]),
                  abs(g["grad_norm"] - w["grad_norm"]) / w["grad_norm"])
                 for g, w in zip(got[0]["metrics"], one["metrics"])]
        equal = all(g["metrics"] == got[0]["metrics"]
                    and g["digests"] == got[0]["digests"] for g in got) \
            and all(r["one_process"] == one for r in ranks)
        emit({"phase": "sharded_train", "run": "fp32 parity",
              "mesh": dict(zip(("data", "model"), shape)),
              "layers": SHARDED_PARITY_LAYERS,
              "batch": SHARDED_PARITY_BATCH, "seq": SHARDED_PARITY_SEQ,
              "loss": got[0]["loss"], "loss_one_process": one["loss"],
              "loss_rel_err": loss_rel,
              "worst_grad_err_over_max_grad": ratio, "worst_leaf": leaf,
              "steps_loss_and_grad_norm_rel_err": steps,
              "replicated_leaves": len(got[0]["digests"]),
              "ranks_bit_equal": equal})
        if not (loss_rel <= SHARDED_LIMITS["loss"]
                and ratio <= SHARDED_LIMITS["grad"] and equal
                and all(a <= SHARDED_LIMITS["loss"]
                        and b <= SHARDED_LIMITS["grad_norm"]
                        for a, b in steps)):
            failed.append(f"fp32 parity on {shape}: loss {loss_rel:.3e}, "
                          f"grad {ratio:.3e} (leaf {leaf}), steps {steps}, "
                          f"ranks equal {equal}")
    el = [r["elastic"] for r in ranks]
    kept, moved = el[0]["metrics_kept"], el[0]["metrics_resharded"]
    more = (abs(moved["loss"] - kept["loss"]) / abs(kept["loss"]),
            abs(moved["grad_norm"] - kept["grad_norm"]) / kept["grad_norm"])
    emit({"phase": "sharded_train", "run": "elastic (2, 1) -> (1, 2)",
          "layers": SHARDED_PARITY_LAYERS,
          "restored_equal_resharded": [e["restored_equal"] for e in el],
          "one_process_equal_resharded": [e["one_process_equal"]
                                          for e in el],
          "specs_equal": [e["specs_equal"] for e in el],
          "step_restored": [e["step_restored"] for e in el],
          "next_step_rel_err": more, "state_bytes": el[0]["state_bytes"],
          "save_seconds": el[0]["save_seconds"],
          "seconds": el[0]["seconds"]})
    if not (all(e["restored_equal"] and e["one_process_equal"]
                and e["specs_equal"] and e["step_restored"] == SHARDED_STEPS
                for e in el)
            and more[0] <= SHARDED_LIMITS["loss"]
            and more[1] <= SHARDED_LIMITS["grad_norm"]):
        failed.append(f"elastic: {el}")
    pipe = [r["pipeline"] for r in ranks]
    for p in pipe:
        launches.update(p["launches"])
    emit({"phase": "sharded_train", "run": "pipeline", **SHARDED_PIPE,
          "stages": SHARDED_RANKS, "per_rank": pipe})
    ticks = SHARDED_PIPE["m"] + SHARDED_RANKS - 1
    if any(p["max_abs_err"] > TOL["float32"] or p["launches"]
           != {"matmul": ticks} for p in pipe) or abs(
               pipe[0]["bubble_fraction"] - (SHARDED_RANKS - 1) / ticks) \
            > 1e-12:
        failed.append(f"pipeline: {pipe}")
    emit({"phase": "sharded_train", "seconds": time.time() - t0})
    if failed:
        raise AssertionError("; ".join(failed))
    return dict(launches)


# ------------------------------------------------------------ main
# ------------------------------------------------------------ phase 2c
# the tune phase: cells of the shapes the main paths launch (PERF.md §6),
# swept into a temporary plan cache.  (op, cell, dtype, tolerance): the
# GEMMs at the kernel tolerance of their dtype (B5 computes in fp32:
# 2e-4 with either input type), the attention kernels also by slot
# (slot_rel_err), N-body at LIB_TOL of max |a|
TUNE_CELLS = (
    ("matmul", (4, 2048, 1024), "bfloat16"),     # gemma-2b's wq, tp = 2
    ("matmul", (4, 6720, 4096), "bfloat16"),     # codeqwen1.5-7b's wd, tp = 2
    ("matmul", (4, 2048, 60), "float32"),        # qwen2-moe's fp32 router
    ("quantized_matmul", (4, 16384, 2048), "bfloat16"),  # gemma-2b's wd
    ("decode_attention", (4, 8, 1, 256, 64, 128), "bfloat16"),
    ("decode_attention_int8", (4, 8, 1, 256, 64, 128), "bfloat16"),
    ("prefill_attention", (4, 64, 8, 1, 256, 64, 128), "bfloat16"),
    ("nbody", (16128,), "float32"),
)
TUNE_REPS, TUNE_INNER = 5, 20
TUNE_LOGIT_LIMIT = 5e-2      # of max |logit| of the empty-cache run
TUNE_PATH_OPS = ("matmul", "decode_attention", "prefill_attention")


def heuristic_plan_of(op: str, key: tuple, dtype) -> dict:
    """The plan the kernel's own plan function returns at ``key``, which
    candidate 0 of its space must equal."""
    from repro_torch.kernels.attention import decode, prefill
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.nbody import nbody
    if op == "matmul":
        return {"split": matmul.split_plan(*key, dtype)[0]}
    if op == "quantized_matmul":
        return {"split": matmul.quantized_split_plan(*key, dtype)[0]}
    if op.startswith("decode_attention"):
        return {"split_keys": decode.decode_split_plan(*key)[0]}
    if op.startswith("prefill_attention"):
        return {"split_keys": prefill.prefill_split_plan(*key)[0]}
    return {"splits": nbody.nbody_split_plan(*key)[0]}


def tune_check(torch, op: str, args, out, want, dtype_name: str) -> float:
    """The winner against the plain version at its kernel's tolerance."""
    if op == "nbody":
        return rel_check(torch, "tune nbody", out, want)[0]
    tol = "float32" if op == "quantized_matmul" or "int8" in op \
        else dtype_name
    err = compare(torch, f"tune {op}", out, want, tol)
    if "attention" in op:
        slot_rel_err(torch, f"tune {op}", out, want)
    return err


def tune_cells(torch, cache) -> list:
    """Sweep every cell into ``cache``: candidate 0 must be the heuristic
    plan and the best no slower within the sweep; the winner is held to
    the plain version and rerun bit-equal; the profiler's device time of
    the heuristic and the best beside the sweep's microseconds."""
    from repro_torch.kernels import registry
    from repro_torch.tune import Harness, tune
    rows = []
    for op, cell, dtype_name in TUNE_CELLS:
        dtype = getattr(torch, dtype_name)
        res = tune(op, cell, dtype=dtype, cache=cache,
                   harness=Harness(reps=TUNE_REPS, inner=TUNE_INNER))
        spec = registry.get(op)
        args = spec.tune.make_inputs(cell, dtype, "cuda")
        key, key_dtype = spec.key(*args)
        want_heur = heuristic_plan_of(op, key, dtype)
        if res.heuristic != want_heur:
            raise AssertionError(f"tune {op} {cell}: candidate 0 "
                                 f"{res.heuristic} is not the heuristic "
                                 f"plan {want_heur}")
        if not res.best_us <= res.heuristic_us:
            raise AssertionError(f"tune {op} {cell}: best {res.best_us} us "
                                 f"over the heuristic's {res.heuristic_us}")

        def call(plan):
            return spec.tune.call(args, plan)
        out = call(res.best)
        err = tune_check(torch, op, args, out, spec.plain(*args), dtype_name)
        if not torch.equal(out, call(res.best)):
            raise AssertionError(f"tune {op} {cell}: the winner's rerun "
                                 f"is not bit-equal")
        row = {"phase": "tune", "kernel": op, "cell": list(cell),
               "dtype": dtype_name, "key": list(key),
               "key_dtype": str(key_dtype).split(".")[-1],
               "heuristic": res.heuristic, "best": res.best,
               "heuristic_us": res.heuristic_us, "best_us": res.best_us,
               "speedup": res.speedup,
               "heuristic_device_ms": device_ms(
                   torch, lambda: call(res.heuristic)),
               "best_device_ms": device_ms(torch, lambda: call(res.best)),
               "sweep_us": [[r["plan"], r["us"]] for r in res.rows],
               "max_abs_err": err, "rerun_bit_equal": True}
        emit(row)
        rows.append(row)
        del args, out
        torch.cuda.empty_cache()
    return rows


def tune_phase(torch, empty_cache: Path) -> dict:
    """Phase 2c.  Sweep ``TUNE_CELLS`` into a temporary cache, then run
    full-width gemma-2b's paged prefill and 4 decode steps in bf16
    (``prefill_decode_runner``) under the empty cache and under the
    tuned one: the same launches, every B1/B2/B3 call of the tuned run
    resolved ``exact`` or ``nearest``, logits within TUNE_LOGIT_LIMIT of
    max |logit| of the empty-cache run.  Returns the launches of the
    tuned run."""
    from repro_torch.configs import get_arch
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer import Model
    from repro_torch.tune import PlanCache, cache as tune_cache, preload
    t0 = time.time()
    tuned_path = empty_cache.parent / "tuned_plans.json"
    cache = PlanCache(tuned_path)
    rows = tune_cells(torch, cache)
    cache.save()

    model = Model(get_arch("gemma-2b"), dt=DtypePolicy(param=torch.bfloat16),
                  device="cuda")
    run = prefill_decode_runner(torch, model, model.init(seed=1), seed=3)
    runs = {}
    for label, path in (("empty", empty_cache), ("tuned", tuned_path)):
        os.environ[tune_cache.ENV] = str(path)
        preload()
        dispatch.reset_launch_counts()
        with dispatch.stats_scope() as stats:
            logits = run()
            torch.cuda.synchronize()
            runs[label] = (logits, dispatch.launch_counts(), stats(),
                           dispatch.plan_source_stats())
    os.environ[tune_cache.ENV] = str(empty_cache)
    preload()
    (base, base_launches, _, base_sources), \
        (tuned, launches, routes, sources) = runs["empty"], runs["tuned"]
    if launches != base_launches:
        raise AssertionError(f"tune: launches under the tuned cache "
                             f"{launches} differ from the empty cache's "
                             f"{base_launches}")
    if any(src != "heuristic" for (_, _, src) in base_sources):
        raise AssertionError(f"tune: the empty cache resolved {base_sources}")
    for op in TUNE_PATH_OPS:
        calls = routes.get((op, "kernel"), 0)
        hits = sum(n for (o, _, src), n in sources.items()
                   if o == op and src in ("exact", "nearest"))
        if not calls or hits != calls:
            raise AssertionError(f"tune: {op} made {calls} kernel calls, "
                                 f"{hits} of them on a tuned plan "
                                 f"({sources})")
    if any(route == "plain" for (_, route) in routes):
        raise AssertionError(f"tune: a plain route ran: {routes}")
    scale = base.float().abs().max().item()
    err = (tuned.float() - base.float()).abs().max().item()
    if not bool(torch.isfinite(tuned).all()) or \
            err > TUNE_LOGIT_LIMIT * scale:
        raise AssertionError(f"tune: logits under the tuned cache differ by "
                             f"{err:.3e}, over {TUNE_LOGIT_LIMIT} of "
                             f"{scale:.3e}")
    emit({"phase": "tune", "arch": "gemma-2b", "dtype": "bfloat16",
          "cached_plans": len(cache), "launches": launches,
          "plan_sources": {"|".join(k): n for k, n in sources.items()},
          "max_abs_logit": scale, "logit_max_abs_diff": err,
          "logit_limit": TUNE_LOGIT_LIMIT * scale,
          "cells": len(rows), "seconds": time.time() - t0})
    del model, run, runs
    release(torch)
    return launches


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
    from repro_torch.tune import PlanCache
    from repro_torch.tune import cache as tune_cache

    t0 = time.time()
    cuda.library()
    emit({"phase": "build", "seconds": time.time() - t0,
          "library": str(cuda.library_path().relative_to(ROOT)),
          "ptxas_matmul": cuda.ptxas_report("matmul"),
          "ptxas_flash": cuda.ptxas_report("flash")})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)

    # every phase runs under an empty plan cache: the kernels' heuristic
    # plans, whatever a checkout holds in build/; phase 2c tunes into a
    # cache of its own beside it
    tune_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_tune_",
                                     dir=cuda.library_path().parents[1]))
    empty_cache = tune_dir / "empty_plans.json"
    PlanCache(empty_cache).save()
    os.environ[tune_cache.ENV] = str(empty_cache)
    tune_cache.preload()
    try:
        return run_phases(torch, args, smi, empty_cache)
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def run_phases(torch, args, smi: str, empty_cache: Path) -> int:
    rows = []
    for dtype_name in ("bfloat16", "float32"):
        rows += check_matmul(torch, dtype_name)
    for dtype_name in ("bfloat16", "float32"):
        rows += check_quantized_matmul(torch, dtype_name, rows)
        rows += check_grouped(torch, dtype_name)
        rows += check_decode(torch, dtype_name)
        rows += check_prefill(torch, dtype_name)
        rows += check_flash(torch, dtype_name)
        rows += check_matmul_backward(torch, dtype_name)
    rows += check_tp_shapes(torch)
    torch.cuda.empty_cache()
    for check in (check_wkv, check_wkv_bwd, check_stencil, check_nbody,
                  check_histogram):
        rows += check(torch)
        torch.cuda.empty_cache()
    tune_launches = tune_phase(torch, empty_cache)

    launches, base_streams, base_runs = serve_phase(torch)
    torch.cuda.empty_cache()
    for phase_launches in (dense_serve_phase(torch),
                           spec_serve_phase(torch, base_streams)):
        for op, n in phase_launches.items():
            launches[op] = launches.get(op, 0) + n
        torch.cuda.empty_cache()
    tp_launches = tp_serve_phase(torch, base_streams,
                                 base_runs["float continuous"])
    for op, n in tp_launches.items():
        launches[op] = launches.get(op, 0) + n
    release(torch)
    for op, n in moe_serve_phase(torch).items():
        launches[op] = launches.get(op, 0) + n
    torch.cuda.empty_cache()
    for op, n in recurrent_serve_phase(torch).items():
        launches[op] = launches.get(op, 0) + n
    release(torch)
    for label, extra in PROFILED_SERVE_RUNS:
        serve_profile(torch, label, extra)
        torch.cuda.empty_cache()
    serve_profile(torch, "moe float continuous", PAGED, MOE_SERVE_ARGS)
    torch.cuda.empty_cache()
    for int8 in (False, True):
        model_phase(torch, int8)
        torch.cuda.empty_cache()
    dense_model_phase(torch)
    torch.cuda.empty_cache()
    recurrent_model_phase(torch)
    release(torch)
    for int8 in (False, True):
        moe_model_phase(torch, int8)
        torch.cuda.empty_cache()
    from repro_torch.configs import get_arch
    for phase, cfg, groups, forbidden in (
            ("train", get_arch("gemma-2b"), TRAIN_WGMMA_GROUPS, ()),
            ("moe_train", moe_train_config(), MOE_TRAIN_GROUPS,
             MOE_TRAIN_FORBIDDEN)):
        for op, n in train_run(torch, phase, cfg).items():
            launches[op] = launches.get(op, 0) + n
        release(torch)
        train_profile(torch, phase + "_profile", cfg, groups, forbidden)
        release(torch)
        train_parity_phase(torch, phase + "_parity", cfg)
        release(torch)
    for arch in EMBED_TRAIN_ARCHS:
        # their checkpoints patched out for phase 6e's time (gemma-2b's
        # and qwen2-moe's runs still write one each)
        for op, n in train_run(torch, "embed_train", get_arch(arch),
                               checkpoint=False).items():
            launches[op] = launches.get(op, 0) + n
        release(torch)
        train_profile(torch, "embed_train_profile", get_arch(arch),
                      TRAIN_WGMMA_GROUPS)
        release(torch)
    train_parity_phase(torch, "embed_train_parity", get_arch("qwen2-vl-2b"))
    release(torch)
    for op, n in recurrent_prefill_phase(torch).items():
        launches[op] = launches.get(op, 0) + n
    for arch in RECURRENT_ARCHS:
        cfg = recurrent_train_config(arch)
        for op, n in train_run(torch, "recurrent_train", cfg,
                               checkpoint=False).items():
            launches[op] = launches.get(op, 0) + n
        release(torch)
        train_profile(torch, "recurrent_train_profile", cfg,
                      RECURRENT_TRAIN_GROUPS[arch])
        release(torch)
    for arch in RECURRENT_ARCHS:
        train_parity_phase(torch, "recurrent_train_parity",
                           recurrent_train_config(arch, parity=True))
        release(torch)
    for op, n in sharded_train_phase(torch).items():
        launches[op] = launches.get(op, 0) + n
    release(torch)
    for op, n in library_phase(torch).items():
        launches[op] = launches.get(op, 0) + n
    torch.cuda.empty_cache()
    library_inputs_phase(torch)
    torch.cuda.empty_cache()
    for op, n in tune_launches.items():
        launches[op] = launches.get(op, 0) + n

    # the summary line: per kernel, the times of its first bf16 case at
    # the serving shapes (the GEMMs: the decode MLP up-projection, M=4
    # K=2048 N=16384; B6/B7: the causal training case; B8-B11: the case
    # SUMMARY_CASE names, in SUMMARY_DTYPE) and the largest error over
    # all its cases; launches sum the serve, prefill and train runs and
    # the library phase
    kernels = []
    for name in SOURCES:
        mine = [r for r in rows if r["kernel"] == name]
        rep = [r for r in mine
               if r["dtype"] == SUMMARY_DTYPE.get(name, "bfloat16")
               and r["case"] == SUMMARY_CASE.get(name, r["case"])][0]
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
