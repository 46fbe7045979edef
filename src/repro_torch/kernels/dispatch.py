"""Kernel dispatch: the one entry point the model uses for its hot
contractions, and the routing rule and counters that the kernel
library's public ops (``kernels.{wkv,stencil,nbody,histogram}``) share.

The route is chosen by the device of the tensors and by nothing else: a
CPU tensor takes the kernel's plain PyTorch version, a CUDA tensor takes
the hand-written CUDA kernel (whose wrapper raises on what it does not
take; there is no fallback).  Each call ticks an ``(op, route)`` counter,
route "kernel" or "plain", so a run can show which path it took;
``stats_scope`` isolates the counters for a probe.  Every kernel wrapper
also counts its launches (``launch_counts``); the flash forward and
backward and the paged prefill (float and int8 pools), which have two
CUDA routes (``wgmma`` and ``simt``, chosen by dtype and head width, and
for the prefill the GQA group), count them by route too
(``route_counts``).

On the kernel route (only there) the split-planned ops -- ``matmul``
and both of its gradient GEMMs (``matmul_bwd``), ``grouped_matmul``'s
forward (B1's namespace), ``quantized_matmul``, ``decode_attention`` and
``prefill_attention`` (float and int8 pools) -- resolve their plan
through the tuned-plan cache (``tune.cache.tuned_plan``: exact key, then
the nearest feasible shape, then the heuristic) and pass it to the
kernel's wrapper; ``plan_source_stats()`` counts each such call by (op,
route, source).  An empty cache runs every kernel at its heuristic plan,
as before the cache existed.  The ops, their kernels, plain versions,
plan keys and tensor-parallel contracts are declared once, in
``kernels/registry.py``, which also holds the counters.

Tensor parallelism (``runtime/tp.py``): inside ``tp_scope(group)``,
``matmul`` and ``quantized_matmul`` called with ``tp="col"`` or
``tp="row"`` and the paged attention ops (which tag themselves
``"heads"``) complete themselves with the collective their contract
declares over ``group`` (``runtime.collectives.Group``), on the op's
output, as the JAX registry's ``OpSpec.tp`` tables do: ``col`` none,
``row`` a psum (in rank order), ``heads`` an all_gather of the heads
(dim 1 of decode's output, dim 2 of prefill's).  ``tp_stats`` counts
the routes taken inside a scope.  Outside a scope the tags are inert.

``matmul``, ``grouped_matmul``, ``attention`` and ``wkv`` are
``torch.autograd.Function``s (a ctypes launch is invisible to autograd):
their backwards route by the device of the incoming gradient in the same
way (``matmul_bwd``: both gradient GEMMs through B1 in fp32;
``grouped_matmul_bwd``: both through B1's grouped route, on bf16 operands
as they are when x, w and the gradient are all bf16, else in fp32;
``attention_bwd``: the fused recompute backward; ``wkv_bwd``: the WKV
backward kernel), so the CPU tests walk the control flow and counters
the card does.  B1's grouped route also counts its launches by route
(``wgmma``, ``wgmma_short``, ``simt``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..tune import cache as tune_cache
from . import registry
from .attention import (decode_attention_cuda, decode_attention_int8_cuda,
                        decode_attention_plain, flash_attention_bwd_cuda,
                        flash_attention_bwd_plain, flash_attention_cuda,
                        flash_attention_plain, prefill_attention_cuda,
                        prefill_attention_int8_cuda, prefill_attention_plain)
from .matmul import (grouped_matmul_cuda, grouped_matmul_plain, matmul_cuda,
                     matmul_plain, quantized_matmul_cuda,
                     quantized_matmul_plain)
from .wkv.wkv import (aligned, wkv_bwd_cuda, wkv_bwd_plain, wkv_cuda,
                      wkv_plain)
from .registry import (plan_source_stats, reset_stats,  # noqa: F401
                       stats, stats_scope, tp_group, tp_scope, tp_stats)

# the collective that completes each op under each tp tag, from the
# registry's TPContracts (the JAX registry's tables:
# matmul/ops.py:406-429, attention/ops.py:845-871): None, "psum", or
# ("all_gather", dim)
TP_CONTRACTS = registry.tp_contracts()

# every kernel wrapper, by op name; each carries its launch count.  The
# int8 attention branches count under their own names, so a run shows
# which branch launched.
KERNELS = {name: spec.kernel for name, spec in registry.ops().items()}


def _tp_complete(op: str, out: torch.Tensor,
                 tp: Optional[str]) -> torch.Tensor:
    """Apply the collective ``op``'s contract ``tp`` declares, inside a
    scope; outside one the tag is inert."""
    group = registry.tp_group()
    if tp is None or group is None:
        return out
    contracts = TP_CONTRACTS.get(op, {})
    if tp not in contracts:
        raise ValueError(
            f"op {op!r} declares no tp contract {tp!r} (has: "
            f"{sorted(contracts)}); sharded serving cannot complete this "
            "call inside the tensor-parallel step")
    how = contracts[tp]
    if how == "psum":
        return group.psum(out)
    if how is not None:
        return group.all_gather(out, how[1])
    return out


def launch_counts() -> Dict[str, int]:
    return {op: fn.launches for op, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        for route in getattr(fn, "routes", ()):
            fn.routes[route] = 0


def route_counts() -> Dict[str, int]:
    """Launches by route (``op/route``) of the kernels that have more than
    one (the flash forward and backward and the paged prefill: ``wgmma``
    and ``simt``; B1's grouped route also ``wgmma_short``)."""
    return {f"{op}/{route}": n for op, fn in KERNELS.items()
            for route, n in getattr(fn, "routes", {}).items()}


def _on_card(op: str, t: torch.Tensor) -> bool:
    kernel = t.is_cuda
    registry.count_route(op, "kernel" if kernel else "plain")
    return kernel


def _plan(op: str, namespace: str, key: tuple, dtype: torch.dtype):
    """The tuned plan of one kernel-route call (None: the heuristic's),
    counted in ``plan_source_stats`` by its source."""
    plan, source = tune_cache.tuned_plan(namespace, key, dtype)
    registry.count_plan_source(op, "kernel", source)
    return plan


def _kernel_plan(op: str, *args, spec: Optional[str] = None):
    """The tuned plan of a kernel-route call of registry op ``spec``
    (default ``op``), counted under ``op``, at the key its
    ``plan_shape`` reads (None where the call's route takes no plan)."""
    spec = registry.get(spec or op)
    key = spec.key(*args)
    return None if key is None else _plan(op, spec.namespace, *key)


def _b1(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One GEMM on B1 at the tuned plan of its (K, N, dtype)."""
    return matmul_cuda(a, b, plan=_kernel_plan(op, a, b, spec="matmul"))


def _grad_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One fp32 gradient GEMM, routed and counted as ``matmul_bwd``."""
    if _on_card("matmul_bwd", a):
        return _b1("matmul_bwd", a, b)
    return matmul_plain(a, b)


class _Matmul(torch.autograd.Function):
    """a (M, K) @ b (K, N) with the JAX op's custom VJP
    (``repro/kernels/matmul/ops.py::_matmul_vjp_bwd``): both gradient
    GEMMs run in fp32 through the device's route, dx = g @ b.T (b.T read
    through its strides) and db = a.T @ g (a.T made contiguous, as B1's
    A operand must be), each cast back to its primal dtype."""

    @staticmethod
    def forward(ctx, a, b):
        a = a.contiguous()
        ctx.save_for_backward(a, b)
        return _b1("matmul", a, b) if _on_card("matmul", a) \
            else matmul_plain(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.float().contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _grad_gemm(g, b.float().T).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _grad_gemm(a.float().T.contiguous(), g).to(b.dtype)
        return da, db


def matmul(x: torch.Tensor, w: torch.Tensor, *,
           tp: Optional[str] = None) -> torch.Tensor:
    """Contract the last axis of ``x`` with the first axis of ``w``.

    x: (..., K); w: (K, N1[, N2, ...]).  Returns x.shape[:-1] + w.shape[1:]
    in the promoted input dtype; differentiable in both.  ``tp`` tags the
    call's tensor-parallel contract ("col": output channels local, no
    collective; "row": contraction sharded, psum of the output)."""
    k = x.shape[-1]
    out = _Matmul.apply(x.reshape(-1, k), w.reshape(k, -1))
    return _tp_complete("matmul", out.reshape(x.shape[:-1] + w.shape[1:]),
                        tp)


def _grouped_grad_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One grouped gradient GEMM, routed and counted as
    ``grouped_matmul_bwd``.  The plain route takes A contiguous, as the
    fp32 route always passes it, so its bits do not depend on A's layout
    (the card's bf16 route reads x^T through its strides)."""
    if _on_card("grouped_matmul_bwd", a):
        return grouped_matmul_cuda(a, b)
    return grouped_matmul_plain(a.contiguous(), b)


class _GroupedMatmul(torch.autograd.Function):
    """x (G, C, K) @ w (G, K, N) with the JAX op's custom VJP
    (``repro/kernels/matmul/ops.py::_grouped_vjp_bwd``): per group, dx =
    g @ w^T (w^T read through its strides) and dw = x^T @ g, each
    accumulated in fp32 and rounded once to its primal dtype.

    The JAX VJP upcasts x, w and g to fp32 and runs fp32 GEMMs.  Where all
    three are bf16 (the bf16 compute policy), the GEMMs take them as they
    are: a product of two bf16 values is exact in fp32, so bf16 operands
    with fp32 accumulation compute JAX's function up to the order of the
    fp32 sums, with no fp32 copies of w (a (60, 2048, 1408) expert weight
    is 692 MB in fp32) and no fp32 gradient to cast back; on the card
    both run on B1's short tile, which reads w^T and x^T through their
    strides.  Otherwise (the fp32 policy, mixed dtypes) the operands are
    upcast as in JAX and x^T made contiguous.  The choice depends on the
    dtypes alone; each route raises on what it does not take."""

    @staticmethod
    def forward(ctx, x, w):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        if not _on_card("grouped_matmul", x):
            return grouped_matmul_plain(x, w)
        return grouped_matmul_cuda(
            x, w, plan=_kernel_plan("grouped_matmul", x, w))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        x_dtype, w_dtype = x.dtype, w.dtype
        bf16 = x_dtype == w_dtype == g.dtype == torch.bfloat16
        if not bf16:
            x, w, g = x.float(), w.float(), g.float()
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _grouped_grad_gemm(g, w.transpose(1, 2)).to(x_dtype)
        if ctx.needs_input_grad[1]:
            xt = x.transpose(1, 2)
            dw = _grouped_grad_gemm(xt if bf16 else xt.contiguous(),
                                    g).to(w_dtype)
        return dx, dw


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-group matmul, the MoE expert contraction: x (G, C, K) @ w
    (G, K, N) -> (G, C, N) in the promoted input dtype; differentiable in
    both."""
    return _GroupedMatmul.apply(x, w)


class _Attention(torch.autograd.Function):
    """Flash attention with the JAX op's custom VJP
    (``repro/kernels/attention/ops.py::_attention_vjp_fwd`` / ``_bwd``):
    the forward keeps (q, k, v, o, lse) in (B, H, S, hd) layout, the
    backward recomputes P tiles from lse in the fused backward on the
    fp32 cotangent and casts the gradients to the primal dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, out_dtype):
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        fn = flash_attention_cuda if _on_card("attention", q) \
            else flash_attention_plain
        o, lse = fn(qt, kt, vt, causal=causal, window=window,
                    return_lse=True)
        ctx.save_for_backward(qt, kt, vt, o, lse)
        ctx.mask = (causal, window)
        return o.transpose(1, 2).to(out_dtype,
                                    memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        qt, kt, vt, o, lse = ctx.saved_tensors
        causal, window = ctx.mask
        gt = g.transpose(1, 2).float().contiguous()
        fn = flash_attention_bwd_cuda if _on_card("attention_bwd", g) \
            else flash_attention_bwd_plain
        grads = fn(qt, kt, vt, o, lse, gt, causal=causal, window=window)
        dq, dk, dv = (d.transpose(1, 2).to(t.dtype)
                      for d, t in zip(grads, (qt, kt, vt)))
        return dq, dk, dv, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Self-attention over model-layout tensors: q, k, v (B, S, H, hd),
    k and v already GQA-expanded to H heads.  Returns (B, S, H, hd) in
    ``out_dtype`` (default q's dtype); differentiable in q, k and v."""
    return _Attention.apply(q, k, v, bool(causal), int(window),
                            q.dtype if out_dtype is None else out_dtype)


class _Wkv(torch.autograd.Function):
    """The model's WKV recurrence from a zero state, o (B, S, H, hd) fp32:
    forward on B8 (``wkv_cuda``) on the card and ``wkv_chunked`` on the
    CPU; backward on the WKV backward kernel on the card and the autograd
    of ``wkv_chunked`` on the CPU (the JAX package differentiates
    ``wkv_chunked`` by autodiff), the fp32 gradients cast to each input's
    dtype."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, chunk, intra, subchunk):
        ctx.dtypes = tuple(t.dtype for t in (r, k, v, lw, u))
        ctx.form = (chunk, intra, subchunk)
        acc = torch.promote_types(r.dtype, torch.float32)
        args = (r, k, v, lw.to(acc), u.to(acc))
        if _on_card("wkv", r):
            args = tuple(aligned(t) for t in args)
            o = wkv_cuda(*args, chunk=chunk, subchunk=subchunk)
        else:
            o = wkv_plain(*args, chunk=chunk, intra=intra,
                          subchunk=subchunk)
        ctx.save_for_backward(*args)
        return o

    @staticmethod
    def backward(ctx, do):
        args = ctx.saved_tensors
        chunk, intra, subchunk = ctx.form
        if _on_card("wkv_bwd", do):
            grads = wkv_bwd_cuda(*args, aligned(do.float()))
        else:
            grads = wkv_bwd_plain(*args, do, chunk=chunk, intra=intra,
                                  subchunk=subchunk)
        return (*(g.to(dt) for g, dt in zip(grads, ctx.dtypes)),
                None, None, None)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lw: torch.Tensor,
        u: torch.Tensor, *, chunk: int, intra: str = "direct",
        subchunk: int = 16) -> torch.Tensor:
    """The RWKV6 time mix's WKV over whole sequences from a zero state:
    r, k, v (B, S, H, hd) in one float type, lw (B, S, H, hd) fp32
    log-decays (<= 0), u (H, hd).  Returns o (B, S, H, hd) fp32 (fp64
    for fp64 inputs on the CPU); differentiable in all five.  ``chunk``,
    ``intra`` and ``subchunk`` set the chunked form
    (``models.rwkv.wkv_chunked``); the card's kernel computes the
    sub-chunked form at ``subchunk``, whose e^-60 clamp differs from the
    direct form's by less than e^-60 of a term."""
    return _Wkv.apply(r, k, v, lw, u, int(chunk), intra, int(subchunk))


def quantized_matmul(x: torch.Tensor, w_q: torch.Tensor,
                     w_scale: torch.Tensor, *,
                     tp: Optional[str] = None) -> torch.Tensor:
    """Int8-weight matmul with per-output-channel dequant (§4.4 type
    demotion).  x: (..., K) float; w_q: (K, N) int8; w_scale: (N,) fp32
    (``core.quant.quantize_channelwise``).  Returns x.shape[:-1] + (N,)
    fp32; ``tp`` as in ``matmul`` (a "row" shard's fp32 partials are
    summed)."""
    k = x.shape[-1]
    a = x.reshape(-1, k)
    if _on_card("quantized_matmul", x):
        out = quantized_matmul_cuda(a, w_q, w_scale, plan=_plan(
            "quantized_matmul", "quantized_matmul", (k, w_q.shape[1]),
            a.dtype))
    else:
        out = quantized_matmul_plain(a, w_q, w_scale)
    return _tp_complete("quantized_matmul",
                        out.reshape(x.shape[:-1] + w_q.shape[1:]), tp)


def decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, table: torch.Tensor,
                     lengths: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None, *,
                     window: int = 0,
                     out_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """Ragged decode attention over a paged KV cache (layout in
    ``attention/decode.py``).  int8 pools pass their (P, Hkv) fp32
    ``k_scale`` / ``v_scale`` (both or neither) and take the int8 branch,
    op ``decode_attention_int8``.  Returns (B, H, hd) in ``out_dtype``
    (default q's dtype).  Inside a ``tp_scope`` q and the pools hold this
    shard's heads and the output is all-gathered to every head."""
    op = "decode_attention" if k_scale is None else "decode_attention_int8"
    if _on_card(op, q):
        plan = _kernel_plan(op, q, k_pages, v_pages, table, lengths)
        if k_scale is None:
            out = decode_attention_cuda(q, k_pages, v_pages, table, lengths,
                                        window=window, plan=plan)
        else:
            out = decode_attention_int8_cuda(q, k_pages, v_pages, table,
                                             lengths, k_scale, v_scale,
                                             window=window, plan=plan)
    else:
        out = decode_attention_plain(q, k_pages, v_pages, table, lengths,
                                     k_scale, v_scale, window=window)
    return _tp_complete("decode_attention",
                        out.to(q.dtype if out_dtype is None else out_dtype),
                        "heads")


def prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, table: torch.Tensor,
                      starts: torch.Tensor,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None, *,
                      window: int = 0,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """Ragged multi-token prefill attention over a paged KV cache (layout
    in ``attention/prefill.py``); int8 pools as in ``decode_attention``
    (op ``prefill_attention_int8``).  Returns (B, C, H, hd) in
    ``out_dtype`` (default q's dtype), all-gathered over the heads inside
    a ``tp_scope``."""
    op = "prefill_attention" if k_scale is None \
        else "prefill_attention_int8"
    if _on_card(op, q):
        plan = _kernel_plan(op, q, k_pages, v_pages, table, starts)
        if k_scale is None:
            out = prefill_attention_cuda(q, k_pages, v_pages, table, starts,
                                         window=window, plan=plan)
        else:
            out = prefill_attention_int8_cuda(q, k_pages, v_pages, table,
                                              starts, k_scale, v_scale,
                                              window=window, plan=plan)
    else:
        out = prefill_attention_plain(q, k_pages, v_pages, table, starts,
                                      k_scale, v_scale, window=window)
    return _tp_complete("prefill_attention",
                        out.to(q.dtype if out_dtype is None else out_dtype),
                        "heads")
