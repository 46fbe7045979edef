"""C = A @ B with fp32 accumulation, and its int8-weight variant: the CUDA
kernels' wrappers and their plain PyTorch versions.

Replaces ``repro/kernels/matmul/matmul.py::matmul_pallas`` (kernel
``kernels/csrc/matmul.cu``) and ``::quantized_matmul_pallas`` (kernel
``kernels/csrc/quantized_matmul.cu``).  ``matmul`` returns A's dtype, the
JAX lowering's ``astype(result_type(x, w))`` of the fp32 accumulator;
``quantized_matmul`` returns fp32, as the JAX op does.  ``grouped_matmul``
is B1's grouped route (``repro_grouped_matmul`` in ``matmul.cu``): the MoE
experts' (G, C, K) @ (G, K, N), which the JAX op lowers to one
``matmul_pallas`` call per group
(``repro/kernels/matmul/ops.py::_grouped_kernel_lowering``), in one
launch, on the CUDA route ``grouped_route`` names.
"""
from __future__ import annotations

import torch

from .. import cuda


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N), accumulated in fp32, in the promoted dtype."""
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    return (a.float() @ b.float()).to(out_dtype)


# B1's tiles (csrc/matmul.cu): 128 x 128 outputs; a split's K slices come
# in units of TILE_K (bf16: the kernel's 64-deep K step; fp32: 32, which
# both of its K steps, 32 and 16, divide)
TILE_M, TILE_N = 128, 128
TILE_K = {torch.bfloat16: 64, torch.float32: 32}
# the card's SMs, a fixed number so that the plan never depends on the
# device; the most blocks that share an output tile; the least K a slice
# takes (measured on the card: shorter slices cost prefill and training
# more in partial products than they save at decode)
SMS, MAX_SPLIT = 132, 8
MIN_SLICE = 4096


def _check_rows(name: str, m: int, tile_m: int) -> None:
    if -(-m // tile_m) > 65535:                # the grid's row-tile axis
        raise ValueError(f"{name}: M={m} exceeds 65535 row tiles of "
                         f"{tile_m}")


def split_at(k: int, tile_k: int, split: int) -> tuple:
    """(split, slice_steps) of K in units of ``tile_k`` for a wanted
    ``split``: slices of ``slice_steps`` units, the split cut to the K
    steps there are and to the slices the rounding leaves non-empty.  A
    plan's ``{"split": s}`` (``tune/space.py``) is applied here, at the
    call's own K, so no slice is ever empty."""
    steps = -(-k // tile_k)
    split = max(1, min(split, steps))
    per = -(-steps // split)
    if per:
        split = -(-steps // per)      # drop slices the rounding left empty
    return split, per


def _split(k: int, tile_k: int, tiles_n: int, max_split: int,
           min_slice: int) -> tuple:
    """(split, slice_steps) of K in units of ``tile_k``: split while the N
    tiles alone leave SMs idle, at most ``max_split`` ways, each slice at
    least ``min_slice`` deep and no slice empty."""
    return split_at(k, tile_k, min(max_split, SMS // tiles_n,
                                   k // min_slice))


def split_plan(k: int, n: int, dtype: torch.dtype, groups: int = 1) -> tuple:
    """(split, slice_steps): how many blocks of B1 share an output tile,
    each taking ``slice_steps`` units of ``TILE_K`` of K (rank r the units
    [r * slice_steps, (r + 1) * slice_steps)), their fp32 partial products
    summed in rank order by a second pass.  A function of (K, N, dtype,
    groups) only, never of M (or of the rows a group of the grouped route
    holds), so a row's bits do not depend on how many rows share the call:
    split K while the N tiles of all ``groups`` alone leave SMs idle, each
    slice at least ``MIN_SLICE`` deep and no slice empty."""
    return _split(k, TILE_K[dtype], groups * -(-n // TILE_N), MAX_SPLIT,
                  MIN_SLICE)


# B5's tiles (csrc/quantized_matmul.cu): bf16 A on B1's tensor-core tile
# (128 x 128, csrc/matmul_wgmma.cuh), fp32 A on a 64 x 64 FMA tile; both
# take a split's K slices in units of Q_TILE_K.  B5 reads half B1's bytes
# per output tile and serves no training GEMM, so it splits further: up
# to Q_MAX_SPLIT ways, slices down to Q_MIN_SLICE of K.  Measured on the
# card (PERF.md): shorter slices cost the M=256 calls a second wave of
# blocks and a larger split sum for less than they save at M=4
Q_TILE_M = {torch.bfloat16: 128, torch.float32: 64}
Q_TILE_N = {torch.bfloat16: 128, torch.float32: 64}
Q_TILE_K = 64
Q_MAX_SPLIT, Q_MIN_SLICE = 16, 512


def quantized_split_plan(k: int, n: int, dtype: torch.dtype) -> tuple:
    """(split, slice_steps) of B5, as ``split_plan`` is B1's: ``split``
    blocks share an output tile, rank r taking the units of ``Q_TILE_K``
    [r * slice_steps, (r + 1) * slice_steps) of K, their fp32 partials
    summed in rank order and scaled by a second pass.  A function of
    (K, N, dtype) only, never of M."""
    return _split(k, Q_TILE_K, -(-n // Q_TILE_N[dtype]), Q_MAX_SPLIT,
                  Q_MIN_SLICE)


def planned_split(name: str, k: int, tile_k: int, max_split: int,
                  plan, heuristic) -> tuple:
    """(split, slice_steps) of a call: the heuristic's (``heuristic()``)
    without a plan, else the plan's ``{"split": s}`` applied at the call's
    K; a split past ``max_split`` (the heuristic's own limit, which bounds
    the fp32 scratch) raises."""
    if not plan:
        return heuristic()
    s = plan["split"]
    if not 1 <= s <= max_split:
        raise ValueError(f"{name}: plan split {s} outside 1..{max_split}")
    return split_at(k, tile_k, s)


def check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    """What ``repro_matmul`` takes: a (M, K) contiguous @ b (K, N) at two
    strides of which one is 1, of one dtype."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: want (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"matmul: operand dtypes differ ({a.dtype}, "
                        f"{b.dtype})")
    if not a.is_contiguous():
        raise ValueError("matmul: A must be contiguous")
    if 1 not in b.stride():
        raise ValueError(f"matmul: B needs a unit stride along K or N, got "
                         f"strides {b.stride()}")


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, *,
                plan=None) -> torch.Tensor:
    """Launch ``repro_matmul``: a (M, K) contiguous, b (K, N) at two
    strides of which one is 1 (weights are N-contiguous, the tied head
    passes the K-contiguous ``embed.T``), both bf16 or both fp32, on one
    CUDA device.  K splits by ``split_plan``, or by ``plan``'s
    ``{"split": s}`` (a tuned plan).  Returns a new (M, N) tensor of a's
    dtype."""
    cuda.require_cuda("matmul", a, b, contiguous=False)
    check_operands(a, b)
    m, k = a.shape
    n = b.shape[1]
    code = cuda.dtype_code(a)
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    _check_rows("matmul", m, TILE_M)
    split, per = planned_split("matmul", k, TILE_K[a.dtype], MAX_SPLIT,
                               plan, lambda: split_plan(k, n, a.dtype))
    # the split's partial products, summed in rank order by a second pass
    scratch = (torch.empty((split, m, n), dtype=torch.float32,
                           device=a.device) if split > 1 else None)
    rc = cuda.library().repro_matmul(
        a.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        *cuda.c_ints("matmul", m, n, k, k, b.stride(0), b.stride(1), split,
                     per), code, cuda.stream_of(a))
    cuda.check(rc, "matmul")
    matmul_cuda.launches += 1
    return c


matmul_cuda.launches = 0


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (G, C, K) @ w (G, K, N) group by group, accumulated in fp32, in the
    promoted dtype (the JAX op's ``einsum("gck,gkn->gcn")``)."""
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    return torch.einsum("gck,gkn->gcn", x.float(), w.float()).to(out_dtype)


def grouped_route(dtype: torch.dtype, x_kmajor: bool = True,
                  w_kmajor: bool = False) -> str:
    """The CUDA route of a grouped call, a function of (dtype, the
    operands' layout) only, never of the rows a group holds: fp32
    ``simt`` (B1's FMA tile); bf16 ``wgmma``, B1's tile with split K, for
    the forward's layout (x contiguous, w N-contiguous), and
    ``wgmma_short``, the persistent short tile, for the two layouts only
    the backward sends: x read C-major with w N-contiguous (dw = x^T @ g)
    and x contiguous with w K-contiguous (dx = g @ w^T).  A bf16 x read
    C-major with a K-contiguous w takes no route."""
    if dtype == torch.float32:
        return "simt"
    if not x_kmajor and w_kmajor:
        raise ValueError("grouped_matmul: a bf16 x read C-major needs w "
                         "N-contiguous")
    return "wgmma" if x_kmajor and not w_kmajor else "wgmma_short"


def grouped_matmul_cuda(x: torch.Tensor, w: torch.Tensor, *,
                        plan=None) -> torch.Tensor:
    """Launch ``repro_grouped_matmul`` once for all groups: x (G, C, K)
    contiguous (in bf16 also the transpose of a contiguous (G, K, C)
    tensor, the backward's x^T), w (G, K, N) with a unit stride along K or
    N in each group (the experts' weights are N-contiguous; the
    backward's w^T is K-contiguous), both bf16 or both fp32, on one CUDA
    device, on the route ``grouped_route`` names for their layouts; the
    tile route splits K by ``split_plan(k, n, dtype, groups=g)``, the
    short tile never (``plan``'s ``{"split": s}`` replaces the heuristic
    on the tile route, and the short tile takes only split 1).  Returns a
    new (G, C, N) tensor of x's dtype."""
    cuda.require_cuda("grouped_matmul", x, w, contiguous=False)
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"grouped_matmul: want (G, C, K) @ (G, K, N), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype != w.dtype:
        raise TypeError(f"grouped_matmul: operand dtypes differ ({x.dtype}, "
                        f"{w.dtype})")
    x_kmajor = x.is_contiguous()
    if not x_kmajor and not (x.dtype == torch.bfloat16
                             and x.transpose(1, 2).is_contiguous()):
        raise ValueError("grouped_matmul: x must be contiguous (bf16 also "
                         "the transpose of a contiguous (G, K, C) tensor)")
    if 1 not in w.stride()[1:]:
        raise ValueError(f"grouped_matmul: w needs a unit stride along K or "
                         f"N, got strides {w.stride()}")
    g, c, k = x.shape
    n = w.shape[2]
    code = cuda.dtype_code(x)
    out = torch.empty((g, c, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    _check_rows("grouped_matmul", c, TILE_M)
    route = grouped_route(x.dtype, x_kmajor, w.stride(2) != 1)
    short = route == "wgmma_short"
    split, per = planned_split(
        "grouped_matmul", k, TILE_K[x.dtype], 1 if short else MAX_SPLIT,
        plan, lambda: ((1, -(-k // TILE_K[x.dtype])) if short
                       else split_plan(k, n, x.dtype, groups=g)))
    if g * split > 65535:                      # the grid's group axis
        raise ValueError(f"grouped_matmul: {g} groups x split {split} "
                         f"exceed 65535")
    # the split's partial products, summed in rank order by a second pass
    scratch = (torch.empty((split, g, c, n), dtype=torch.float32,
                           device=x.device) if split > 1 else None)
    rc = cuda.library().repro_grouped_matmul(
        x.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        *cuda.c_ints("grouped_matmul", g, c, n, k, k if x_kmajor else c,
                     c * k, w.stride(0), w.stride(1), w.stride(2), split,
                     per, int(not x_kmajor), int(short)), code,
        cuda.stream_of(x))
    cuda.check(rc, "grouped_matmul")
    grouped_matmul_cuda.launches += 1
    grouped_matmul_cuda.routes[route] += 1
    return out


grouped_matmul_cuda.launches = 0
grouped_matmul_cuda.routes = {"wgmma": 0, "wgmma_short": 0, "simt": 0}


def quantized_matmul_plain(a: torch.Tensor, b_q: torch.Tensor,
                           b_scale: torch.Tensor) -> torch.Tensor:
    """a (M, K) float @ dequantized b_q (K, N) int8 with per-column f32
    scales (N,): B is dequantized to fp32 first, then multiplied in fp32
    (``repro/kernels/matmul/ref.py::quantized_matmul_ref``).  Returns
    (M, N) fp32."""
    b = b_q.float() * b_scale.float()[None, :]
    return a.float() @ b


def quantized_matmul_cuda(a: torch.Tensor, b_q: torch.Tensor,
                          b_scale: torch.Tensor, *,
                          plan=None) -> torch.Tensor:
    """Launch ``repro_quantized_matmul``: a (M, K) bf16 or fp32, b_q
    (K, N) int8, b_scale (N,) fp32, all contiguous on one CUDA device;
    K split by ``quantized_split_plan`` or ``plan``'s ``{"split": s}``.  The scale multiplies each
    column's fp32 sum once, at the flush, so the result agrees with the
    plain version at fp32 tolerance, not bit for bit.  Returns a new
    (M, N) fp32 tensor, contiguous (the head of its buffer)."""
    cuda.require_cuda("quantized_matmul", a, b_q, b_scale)
    if a.dim() != 2 or b_q.dim() != 2 or a.shape[1] != b_q.shape[0] \
            or b_scale.shape != (b_q.shape[1],):
        raise ValueError(f"quantized_matmul: want (M, K) @ (K, N) with (N,) "
                         f"scales, got {tuple(a.shape)} @ "
                         f"{tuple(b_q.shape)}, {tuple(b_scale.shape)}")
    if b_q.dtype != torch.int8 or b_scale.dtype != torch.float32:
        raise TypeError(f"quantized_matmul: want int8 weights and fp32 "
                        f"scales, got {b_q.dtype} and {b_scale.dtype}")
    m, k = a.shape
    n = b_q.shape[1]
    code = cuda.dtype_code(a)
    split, per = planned_split("quantized_matmul", k, Q_TILE_K,
                               Q_MAX_SPLIT, plan,
                               lambda: quantized_split_plan(k, n, a.dtype))
    # one allocation on the host's hot path: the output, then the split's
    # fp32 partial products (summed in rank order by a second pass), which
    # the output's storage holds until it is freed
    buf = torch.empty(((1 + (split > 1) * split) * m, n),
                      dtype=torch.float32, device=a.device)
    c = buf[:m]
    if m == 0 or n == 0:
        return c
    _check_rows("quantized_matmul", m, Q_TILE_M[a.dtype])
    rc = cuda.library().repro_quantized_matmul(
        a.data_ptr(), b_q.data_ptr(), b_scale.data_ptr(), c.data_ptr(),
        buf.data_ptr() + 4 * m * n if split > 1 else None,
        *cuda.c_ints("quantized_matmul", m, n, k, k, split, per), code,
        cuda.stream_of(a))
    cuda.check(rc, "quantized_matmul")
    quantized_matmul_cuda.launches += 1
    return c


quantized_matmul_cuda.launches = 0
