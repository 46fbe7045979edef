"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc and skips without one (the
``card`` fixture decides inside the test run, never at import).  The
file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Small shapes cover what the full-width chip_smoke.py does not: ragged
GEMM edges (also of B1's grouped route for the MoE experts, at 1 and 60
groups, both weight layouts, split K and its backward; its short tile at
the capacities the backward's dw contracts over, x^T read C-major, and
dx's w^T read K-major), GQA groups
1/4/8, tiny pages, windows and empty slots, for the float kernels and for
the int8 ones (the int8-weight GEMM and the
int8 branches of the attention kernels); the paged prefill's wgmma route
at full width over page sizes and split boundaries, with batch
invariance and route counts; the flash forward and its
fused backward at ragged sequence lengths, windows and head widths up to
gemma's 256, with their autograd routes; and the kernel library's WKV,
Jacobi stencil, N-body and histogram at ragged chunks, grids, particle
counts and bin counts; and the WKV backward kernel at ragged lengths
and strong decay, with the model's differentiable WKV op on the card.
fp32 runs with TF32 off; tolerances are those of
tests/test_paged_decode.py (the int8 kernels compute in fp32, so a bf16
q costs only its own rounding).
"""
import math

import pytest
import torch

from repro_torch.core import quant
from repro_torch.kernels import dispatch
from repro_torch.kernels.attention import (decode_attention_cuda,
                                           decode_attention_int8_cuda,
                                           decode_attention_plain,
                                           prefill_attention_cuda,
                                           prefill_attention_int8_cuda,
                                           prefill_attention_plain)
from repro_torch.kernels.attention.decode import decode_split_plan
from repro_torch.kernels.matmul import (grouped_matmul_cuda,
                                        grouped_matmul_plain, matmul_cuda,
                                        matmul_plain, quantized_matmul_cuda,
                                        quantized_matmul_plain)
from repro_torch.kernels.matmul.matmul import split_plan

torch.set_num_threads(1)
TOLS = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    torch.cuda.synchronize()
    tol = TOLS[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (3, 37, 70), (65, 130, 67),
                                   (130, 16, 200), (5, 2048, 256)])
def test_matmul_ragged_edges(card, dtype, m, k, n):
    gen = torch.Generator(device=card).manual_seed(m * 1000 + n)
    a = torch.randn(m, k, generator=gen, device=card).to(dtype)
    b = (torch.randn(k, n, generator=gen, device=card)
         / math.sqrt(k)).to(dtype)
    out = matmul_cuda(a, b)
    assert out.dtype == dtype and out.shape == (m, n)
    _close(out, matmul_plain(a, b), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_matmul_transposed_b_and_row_independence(card, dtype):
    """The tied head's embed.T view is read through its strides, and a
    row's result does not depend on how many rows share the call."""
    gen = torch.Generator(device=card).manual_seed(0)
    embed = torch.randn(300, 96, generator=gen, device=card).to(dtype)
    a = torch.randn(70, 96, generator=gen, device=card).to(dtype)
    full = matmul_cuda(a, embed.T)
    _close(full, matmul_plain(a, embed.T), dtype)
    assert torch.equal(matmul_cuda(a[:3].contiguous(), embed.T), full[:3])


def _gemma_operands(card, dtype, gen, m, k, n, tied):
    a = torch.randn(m, k, generator=gen, device=card).to(dtype)
    if tied:       # the logits head: embed (V, d) read as embed.T
        return a, torch.randn(n, k, generator=gen, device=card).to(dtype).T
    return a, (torch.randn(k, n, generator=gen, device=card)
               / math.sqrt(k)).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n,tied", [(16384, 2048, False),
                                      (2048, 20000, True)],
                         ids=["down-proj", "tied-head"])
def test_matmul_rows_independent_of_m_at_gemma_shapes(card, dtype, k, n,
                                                      tied):
    """Rows 0-3 of a decode-sized call equal, bit for bit, the same rows of
    prefill- and training-sized calls (the down-projection's K is split
    across a cluster; the head at a reduced vocab reads embed.T), and a
    rerun gives the same bits."""
    gen = torch.Generator(device=card).manual_seed(11)
    a, b = _gemma_operands(card, dtype, gen, 1024, k, n, tied)
    full = matmul_cuda(a, b)
    _close(full, matmul_plain(a, b), dtype)
    assert torch.equal(matmul_cuda(a, b), full)
    mid = matmul_cuda(a[:256].contiguous(), b)
    assert torch.equal(mid, full[:256])
    assert torch.equal(matmul_cuda(a[:4].contiguous(), b), full[:4])


def _misaligned(t):
    """A copy of t whose storage starts one element past a 16-byte
    boundary, so no TMA or 16-byte copy can read it."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tied", [False, True], ids=["mn-major", "k-major"])
def test_matmul_misaligned_strides_give_the_aligned_bits(card, dtype, tied):
    """The masked path (strides or base pointers that are not 16-byte
    multiples) fills the tiles the aligned path fills and gives its bits."""
    gen = torch.Generator(device=card).manual_seed(12)
    m, k, n = 70, 4096, 520
    a, b = _gemma_operands(card, dtype, gen, m, k, n, tied)
    b = b.contiguous() if not tied else b
    want = matmul_cuda(a, b)
    _close(want, matmul_plain(a, b), dtype)
    # B with a row stride one element past the aligned one
    if tied:
        wide = torch.zeros(n, k + 1, dtype=dtype, device=card)
        wide[:, :k] = b.T
        b_odd = wide[:, :k].T
    else:
        wide = torch.zeros(k, n + 1, dtype=dtype, device=card)
        wide[:, :n] = b
        b_odd = wide[:, :n]
    assert torch.equal(matmul_cuda(a, b_odd), want)
    assert torch.equal(matmul_cuda(_misaligned(a), b), want)


def test_matmul_rejects_b_without_unit_stride(card):
    a = torch.ones(4, 8, device=card)
    b = torch.ones(16, 12, device=card)[::2, ::2]       # strides (24, 2)
    before = matmul_cuda.launches
    with pytest.raises(ValueError, match="unit stride"):
        matmul_cuda(a, b)
    assert matmul_cuda.launches == before


GROUPED_SHAPES = [(1, 1, 1, 1), (1, 9, 37, 70), (3, 5, 130, 67),
                  (60, 8, 200, 130), (60, 9, 72, 30), (2, 130, 96, 200)]


def _grouped_operands(card, dtype, gen, g, c, k, n, kmajor):
    x = torch.randn(g, c, k, generator=gen, device=card).to(dtype)
    w = torch.randn(g, k, n, generator=gen, device=card) / math.sqrt(k)
    if kmajor:        # (G, N, K) storage read as (G, K, N): w^T's layout
        w = w.transpose(1, 2).contiguous().transpose(1, 2)
    return x, w.to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kmajor", [False, True], ids=["mn-major", "k-major"])
@pytest.mark.parametrize("g,c,k,n", GROUPED_SHAPES)
def test_grouped_matmul_matches_plain_and_b1(card, dtype, kmajor, g, c, k,
                                             n):
    """One launch for every group; each group's bits are B1's on that
    group alone (no split at these K), and a rerun and fewer rows give
    the same bits."""
    gen = torch.Generator(device=card).manual_seed(g * 1000 + c + n)
    x, w = _grouped_operands(card, dtype, gen, g, c, k, n, kmajor)
    before = grouped_matmul_cuda.launches
    out = grouped_matmul_cuda(x, w)
    assert grouped_matmul_cuda.launches == before + 1
    assert out.dtype == dtype and out.shape == (g, c, n)
    _close(out, grouped_matmul_plain(x, w), dtype)
    assert split_plan(k, n, dtype, groups=g)[0] == 1
    for i in {0, g // 2, g - 1}:
        assert torch.equal(matmul_cuda(x[i], w[i]), out[i])
    assert torch.equal(grouped_matmul_cuda(x, w), out)
    if c > 1:
        assert torch.equal(grouped_matmul_cuda(x[:, :c - 1].contiguous(), w),
                           out[:, :c - 1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_matmul_split_k(card, dtype):
    """Past MIN_SLICE of K with few output tiles the groups split K; the
    partials of every group are summed in rank order."""
    gen = torch.Generator(device=card).manual_seed(5)
    for g in (1, 2):
        x, w = _grouped_operands(card, dtype, gen, g, 7, 9000, 130, False)
        assert split_plan(9000, 130, dtype, groups=g)[0] > 1
        out = grouped_matmul_cuda(x, w)
        _close(out, grouped_matmul_plain(x, w), dtype)
        assert torch.equal(grouped_matmul_cuda(x, w), out)


@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_matmul_misaligned_groups_give_the_aligned_bits(card, dtype):
    """Groups whose bases or strides are not 16-byte multiples take the
    masked path and give the TMA path's bits."""
    gen = torch.Generator(device=card).manual_seed(6)
    x, w = _grouped_operands(card, dtype, gen, 4, 9, 130, 70, False)
    want = grouped_matmul_cuda(x, w)
    assert torch.equal(grouped_matmul_cuda(_misaligned(x), w), want)
    assert torch.equal(grouped_matmul_cuda(x, _misaligned(w)), want)
    wide = torch.zeros(4, 130, 71, dtype=dtype, device=card)
    wide[..., :70] = w
    assert torch.equal(grouped_matmul_cuda(x, wide[..., :70]), want)


def test_grouped_matmul_autograd_on_the_card(card):
    """dispatch.grouped_matmul's backward: dx = g @ w^T (K-major B) and
    dw = x^T @ g through the grouped route (bf16 operands as they are when
    x, w and the gradient are bf16, on the short tile; fp32 otherwise),
    against the plain route's gradients; three launches,
    no plain route."""
    gen = torch.Generator(device=card).manual_seed(7)
    for dtype in DTYPES:
        x, w = _grouped_operands(card, dtype, gen, 60, 8, 72, 40, False)
        cot = torch.randn(60, 8, 40, generator=gen, device=card)
        grads = []
        for route in ("kernel", "plain"):
            xr = x.detach().clone().requires_grad_(True)
            wr = w.detach().clone().requires_grad_(True)
            with dispatch.stats_scope() as stats:
                if route == "kernel":
                    before = grouped_matmul_cuda.launches
                    out = dispatch.grouped_matmul(xr, wr)
                else:
                    out = dispatch._GroupedMatmul.apply(xr.cpu(), wr.cpu())
                grads.append(torch.autograd.grad(
                    (out.float() * cot.to(out.device)).sum(), (xr, wr)))
                routes = stats()
            if route == "kernel":
                assert grouped_matmul_cuda.launches == before + 3
                assert routes == {("grouped_matmul", "kernel"): 1,
                                  ("grouped_matmul_bwd", "kernel"): 2}
        for got, want in zip(*grads):
            assert got.dtype == dtype
            _close(got, want.to(got.device), torch.float32
                   if dtype == torch.float32 else dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n", [(130, 67), (72, 1409), (2048, 1408)])
def test_grouped_matmul_backward_at_training_capacity(card, dtype, k, n):
    """The grouped VJP at a training step's capacity (C = 88: 2 x 512
    tokens, top 4, factor 1.25, 60 experts): dx (K-major B) and dw (the
    capacity its contraction) through the grouped route (bf16 operands on
    the short tile, fp32 on the FMA tile) at ragged K
    and N edges, against the plain version's gradients, and a rerun
    bit-equal."""
    gen = torch.Generator(device=card).manual_seed(k + n)
    x, w = _grouped_operands(card, dtype, gen, 60, 88, k, n, False)
    cot = torch.randn(60, 88, n, generator=gen, device=card)
    grads = []
    for route in ("kernel", "plain", "kernel"):
        xr = x.detach().clone().requires_grad_(True)
        wr = w.detach().clone().requires_grad_(True)
        with dispatch.stats_scope() as stats:
            if route == "kernel":
                out = dispatch.grouped_matmul(xr, wr)
            else:
                with _plain_routes():
                    out = dispatch.grouped_matmul(xr, wr)
            grads.append(torch.autograd.grad((out.float() * cot).sum(),
                                             (xr, wr)))
            routes = stats()
        if route == "kernel":
            assert routes == {("grouped_matmul", "kernel"): 1,
                              ("grouped_matmul_bwd", "kernel"): 2}
    for got, want, again in zip(*grads):
        assert got.dtype == dtype
        # the backward's GEMMs accumulate in fp32 (bf16 operands, whose
        # products are exact, or fp32 ones); a bf16 gradient rounds once
        _close(got, want, dtype)
        assert torch.equal(got, again)


def _plain_routes():
    """Route every dispatch call to its plain version, on the card."""
    from unittest import mock
    return mock.patch.object(dispatch, "_on_card", lambda op, t: False)


def test_grouped_matmul_rejects_what_it_does_not_take(card):
    x = torch.ones(2, 4, 8, device=card)
    before = grouped_matmul_cuda.launches
    with pytest.raises(ValueError, match="unit stride"):
        grouped_matmul_cuda(x, torch.ones(2, 16, 24, device=card)[:, ::2,
                                                                     ::2])
    with pytest.raises(ValueError, match="contiguous"):
        grouped_matmul_cuda(torch.ones(2, 8, 4, device=card).transpose(1, 2),
                            torch.ones(2, 8, 3, device=card))
    with pytest.raises(TypeError, match="dtypes"):
        grouped_matmul_cuda(x, torch.ones(2, 8, 3, device=card,
                                          dtype=torch.bfloat16))
    assert grouped_matmul_cuda.launches == before


# the short tile's capacities: one row, a decode step's (8), a prefill
# chunk's (24), a training step's (88), one K step and a half past two
SHORT_CAPACITIES = [1, 8, 24, 88, 96, 130]


@pytest.mark.parametrize("kin,n", [(130, 67), (72, 1409), (256, 128)])
@pytest.mark.parametrize("c", SHORT_CAPACITIES)
def test_grouped_short_tile_reads_x_transposed(card, c, kin, n):
    """dw = x^T @ g on the short tile, x^T read C-major through wgmma's
    transpose bit (at C > 1): against the plain version, a rerun
    bit-equal, the bits of the same product on a contiguous copy of x^T
    (the tile route) and of B1 on each group, and misaligned x or g (the
    masked path, element-wise stores where c's rows are not 16-byte
    multiples) giving the aligned bits."""
    gen = torch.Generator(device=card).manual_seed(c * 1000 + kin + n)
    x = torch.randn(4, c, kin, generator=gen, device=card).to(torch.bfloat16)
    g = torch.randn(4, c, n, generator=gen, device=card).to(torch.bfloat16)
    xt = x.transpose(1, 2)
    # x^T of a one-row x is contiguous as well: the tile route takes it
    route = "wgmma" if xt.is_contiguous() else "wgmma_short"
    before = dict(grouped_matmul_cuda.routes)
    dw = grouped_matmul_cuda(xt, g)
    assert grouped_matmul_cuda.routes == {**before,
                                          route: before[route] + 1}
    assert dw.dtype == torch.bfloat16 and dw.shape == (4, kin, n)
    _close(dw, grouped_matmul_plain(xt, g), torch.bfloat16)
    assert torch.equal(grouped_matmul_cuda(xt, g), dw)
    copy = xt.contiguous()
    before = dict(grouped_matmul_cuda.routes)
    assert torch.equal(grouped_matmul_cuda(copy, g), dw)
    assert grouped_matmul_cuda.routes == {**before,
                                          "wgmma": before["wgmma"] + 1}
    for i in (0, 3):
        assert torch.equal(matmul_cuda(copy[i], g[i]), dw[i])
    assert torch.equal(
        grouped_matmul_cuda(_misaligned(x).transpose(1, 2), g), dw)
    assert torch.equal(grouped_matmul_cuda(xt, _misaligned(g)), dw)


@pytest.mark.parametrize("kin,n", [(130, 67), (72, 1409), (2048, 1408)])
@pytest.mark.parametrize("c", SHORT_CAPACITIES)
def test_grouped_short_tile_reads_w_transposed(card, c, kin, n):
    """dx = g @ w^T on the short tile, w^T read K-major: against the
    plain version, a rerun bit-equal, the bits of B1 on each group, and
    misaligned g or w^T (the masked path) giving the aligned bits; a bf16
    x read C-major with a K-major w is refused before a launch."""
    gen = torch.Generator(device=card).manual_seed(c * 1000 + kin + n)
    g = torch.randn(4, c, n, generator=gen, device=card).to(torch.bfloat16)
    w = (torch.randn(4, kin, n, generator=gen, device=card)
         / math.sqrt(n)).to(torch.bfloat16)
    wt = w.transpose(1, 2)
    before = dict(grouped_matmul_cuda.routes)
    dx = grouped_matmul_cuda(g, wt)
    assert grouped_matmul_cuda.routes == {
        **before, "wgmma_short": before["wgmma_short"] + 1}
    assert dx.dtype == torch.bfloat16 and dx.shape == (4, c, kin)
    _close(dx, grouped_matmul_plain(g, wt), torch.bfloat16)
    assert torch.equal(grouped_matmul_cuda(g, wt), dx)
    for i in (0, 3):
        assert torch.equal(matmul_cuda(g[i], wt[i]), dx[i])
    assert torch.equal(grouped_matmul_cuda(_misaligned(g), wt), dx)
    assert torch.equal(grouped_matmul_cuda(g, _misaligned(w).transpose(1, 2)),
                       dx)
    launches = grouped_matmul_cuda.launches
    x_cmajor = torch.zeros(4, n, 2, dtype=torch.bfloat16,
                           device=card).transpose(1, 2)
    with pytest.raises(ValueError, match="C-major"):
        grouped_matmul_cuda(x_cmajor, wt)
    assert grouped_matmul_cuda.launches == launches


def test_grouped_matmul_bf16_backward_routes(card):
    """The bf16 VJP at a training step's capacity: dx and dw on the short
    tile, reading w^T and x^T through their strides, with bf16 operands
    (no fp32 copy, no SIMT launch), equal to the fp32 upcast path's
    gradients within one bf16 rounding; the fp32 VJP stays on the FMA
    tile."""
    gen = torch.Generator(device=card).manual_seed(9)
    for dtype in DTYPES:
        x, w = _grouped_operands(card, dtype, gen, 60, 88, 256, 200, False)
        cot = torch.randn(60, 88, 200, generator=gen, device=card).to(dtype)
        xr = x.detach().clone().requires_grad_(True)
        wr = w.detach().clone().requires_grad_(True)
        out = dispatch.grouped_matmul(xr, wr)
        dispatch.reset_launch_counts()
        dx, dw = torch.autograd.grad(out, (xr, wr), cot)
        counts = dispatch.route_counts()
        want = ({"wgmma": 0, "wgmma_short": 2, "simt": 0}
                if dtype == torch.bfloat16
                else {"wgmma": 0, "wgmma_short": 0, "simt": 2})
        assert {r: counts[f"grouped_matmul/{r}"] for r in want} == want
        up_dx = grouped_matmul_cuda(cot.float(), w.float().transpose(1, 2))
        up_dw = grouped_matmul_cuda(x.float().transpose(1, 2).contiguous(),
                                    cot.float())
        assert (dx.dtype, dw.dtype) == (dtype, dtype)
        # one rounding of each side's fp32 sum: a bf16 step at most
        _close(dx, up_dx.to(dtype), dtype)
        _close(dw, up_dw.to(dtype), dtype)


def _int8_weight(card, gen, k, n):
    w = torch.randn(k, n, generator=gen, device=card) / math.sqrt(k)
    return quant.quantize_channelwise(w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (3, 37, 70), (65, 130, 67),
                                   (130, 16, 200), (5, 2048, 256)])
def test_quantized_matmul_ragged_edges(card, dtype, m, k, n):
    gen = torch.Generator(device=card).manual_seed(m * 1000 + n + 1)
    q, s = _int8_weight(card, gen, k, n)
    a = torch.randn(m, k, generator=gen, device=card).to(dtype)
    out = quantized_matmul_cuda(a, q, s)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    # fp32 arithmetic in both; only the order of the scale multiply differs
    _close(out, quantized_matmul_plain(a, q, s), torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantized_matmul_row_independence(card, dtype):
    """A row's result does not depend on how many rows share the call, so
    B=1 static and B=4 continuous prefill agree bit for bit."""
    gen = torch.Generator(device=card).manual_seed(3)
    q, s = _int8_weight(card, gen, 96, 300)
    a = torch.randn(70, 96, generator=gen, device=card).to(dtype)
    full = quantized_matmul_cuda(a, q, s)
    assert torch.equal(quantized_matmul_cuda(a[:3].contiguous(), q, s),
                       full[:3])
    assert torch.equal(quantized_matmul_cuda(a[64:].contiguous(), q, s),
                       full[64:])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n", [(16384, 2048), (2048, 16384)],
                         ids=["down-proj", "up-proj"])
def test_quantized_matmul_rows_independent_of_m_at_split_shapes(card, dtype,
                                                                k, n):
    """At gemma's split (K=16384 N=2048) and unsplit widest (K=2048
    N=16384) shapes, rows 0-2 and 64-69 of a 70-row call equal, bit for
    bit, the same rows called alone, and a rerun gives the same bits."""
    from repro_torch.kernels.matmul import matmul as mm
    gen = torch.Generator(device=card).manual_seed(k + n)
    q, s = _int8_weight(card, gen, k, n)
    a = torch.randn(70, k, generator=gen, device=card).to(dtype)
    full = quantized_matmul_cuda(a, q, s)
    _close(full, quantized_matmul_plain(a, q, s), torch.float32)
    assert torch.equal(quantized_matmul_cuda(a, q, s), full)
    assert torch.equal(quantized_matmul_cuda(a[:3].contiguous(), q, s),
                       full[:3])
    assert torch.equal(quantized_matmul_cuda(a[64:].contiguous(), q, s),
                       full[64:])
    assert (mm.quantized_split_plan(k, n, dtype)[0] > 1) == (k == 16384)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(70, 200, 130), (5, 1000, 72),
                                   (33, 4100, 2048), (4, 2052, 300),
                                   (70, 2048, 256)])
def test_quantized_matmul_masked_path(card, dtype, m, k, n):
    """Strides that are not 16-byte multiples (N % 16, K % 8 in bf16) and
    K that is not a multiple of 64 take the masked copy of the tile (the
    kernel's own path, split or not): within fp32 tolerance of the plain
    version, and A starting off a 16-byte boundary gives the bits of the
    aligned call (at 2048 x 256 a TMA call against the masked copy)."""
    gen = torch.Generator(device=card).manual_seed(m + k + n)
    q, s = _int8_weight(card, gen, k, n)
    a = torch.randn(m, k, generator=gen, device=card).to(dtype)
    want = quantized_matmul_cuda(a, q, s)
    _close(want, quantized_matmul_plain(a, q, s), torch.float32)
    assert torch.equal(quantized_matmul_cuda(_misaligned(a), q, s), want)


def _pools(dtype, card, *, slots, h, hkv, hd, page, n_pages, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    pool = 1 + slots * n_pages
    kp = torch.randn(pool, page, hkv, hd, generator=gen, device=card)
    vp = torch.randn(pool, page, hkv, hd, generator=gen, device=card)
    perm = torch.randperm(pool - 1, generator=gen, device=card) + 1
    table = perm[:slots * n_pages].reshape(slots, n_pages).int()
    return gen, kp.to(dtype), vp.to(dtype), table


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grp", [1, 4, 8])
@pytest.mark.parametrize("window", [0, 5])
def test_decode_kernel_matches_plain(card, dtype, grp, window):
    hkv, hd, page, n_pages = 2, 32, 4, 9
    gen, kp, vp, table = _pools(dtype, card, slots=4, h=grp * hkv, hkv=hkv,
                                hd=hd, page=page, n_pages=n_pages)
    q = torch.randn(4, grp * hkv, hd, generator=gen, device=card).to(dtype)
    lengths = torch.tensor([0, 1, 17, 36], dtype=torch.int32, device=card)
    out = decode_attention_cuda(q, kp, vp, table, lengths, window=window)
    _close(out, decode_attention_plain(q, kp, vp, table, lengths,
                                       window=window), dtype)
    assert torch.count_nonzero(out[0]) == 0          # lengths == 0 -> 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grp", [1, 4, 8])
@pytest.mark.parametrize("window", [0, 6])
def test_prefill_kernel_matches_plain(card, dtype, grp, window):
    hkv, hd, page, n_pages, c = 2, 32, 8, 6, 8
    gen, kp, vp, table = _pools(dtype, card, slots=3, h=grp * hkv, hkv=hkv,
                                hd=hd, page=page, n_pages=n_pages)
    q = torch.randn(3, c, grp * hkv, hd, generator=gen,
                    device=card).to(dtype)
    starts = torch.tensor([0, 8, 40], dtype=torch.int32, device=card)
    out = prefill_attention_cuda(q, kp, vp, table, starts, window=window)
    _close(out, prefill_attention_plain(q, kp, vp, table, starts,
                                        window=window), dtype)


def _int8(kp, vp):
    kq, ks = quant.quantize_pages(kp.float())
    vq, vs = quant.quantize_pages(vp.float())
    return kq, vq, ks, vs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grp", [1, 4, 8])
@pytest.mark.parametrize("window", [0, 5])
def test_decode_int8_kernel_matches_plain(card, dtype, grp, window):
    hkv, hd, page, n_pages = 2, 32, 4, 9
    gen, kp, vp, table = _pools(torch.float32, card, slots=4, h=grp * hkv,
                                hkv=hkv, hd=hd, page=page, n_pages=n_pages)
    kq, vq, ks, vs = _int8(kp, vp)
    q = torch.randn(4, grp * hkv, hd, generator=gen, device=card).to(dtype)
    lengths = torch.tensor([0, 1, 17, 36], dtype=torch.int32, device=card)
    out = decode_attention_int8_cuda(q, kq, vq, table, lengths, ks, vs,
                                     window=window)
    _close(out, decode_attention_plain(q, kq, vq, table, lengths, ks, vs,
                                       window=window), torch.float32)
    assert torch.count_nonzero(out[0]) == 0          # lengths == 0 -> 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grp", [1, 4, 8])
@pytest.mark.parametrize("window", [0, 6])
def test_prefill_int8_kernel_matches_plain(card, dtype, grp, window):
    hkv, hd, page, n_pages, c = 2, 32, 8, 6, 8
    gen, kp, vp, table = _pools(torch.float32, card, slots=3, h=grp * hkv,
                                hkv=hkv, hd=hd, page=page, n_pages=n_pages)
    kq, vq, ks, vs = _int8(kp, vp)
    q = torch.randn(3, c, grp * hkv, hd, generator=gen,
                    device=card).to(dtype)
    starts = torch.tensor([0, 8, 40], dtype=torch.int32, device=card)
    out = prefill_attention_int8_cuda(q, kq, vq, table, starts, ks, vs,
                                      window=window)
    _close(out, prefill_attention_plain(q, kq, vq, table, starts, ks, vs,
                                        window=window), torch.float32)


# wgmma-route prefill shapes (hd, grp, hkv, page, n_pages): gemma-2b's heads
# (grp 8 over one kv head, hd 256, page 64), codeqwen1.5-7b-like grp 1 at
# hd 128 over 4 kv heads, hd 64 with pages of 16 (four boxes a 64-key
# tile), pages of 4 (copied, not boxes: not a multiple of 8) and of 128
# (two tiles a page); each table long enough for several splits
PREFILL_WGMMA_SHAPES = [(256, 8, 1, 64, 40), (128, 1, 4, 64, 40),
                        (64, 4, 2, 16, 160), (64, 8, 1, 4, 600),
                        (128, 2, 2, 128, 20)]


def _wgmma_prefill(card, int8, shape, *, c=64, seed=4):
    """bf16 prefill on the wgmma route over 5 slots whose starts cross the
    split plan's boundaries: 0, one split, one page past it, a ragged start
    just before it, and the table's last chunk.  Returns the call's
    arguments, the wrapper and the tolerance's dtype."""
    from repro_torch.kernels.attention.prefill import (prefill_route,
                                                       prefill_split_plan)
    hd, grp, hkv, page, n_pages = shape
    assert prefill_route(torch.bfloat16, hd, grp) == "wgmma"
    gen, kp, vp, table = _pools(torch.float32 if int8 else torch.bfloat16,
                                card, slots=5, h=grp * hkv, hkv=hkv, hd=hd,
                                page=page, n_pages=n_pages, seed=seed)
    q = torch.randn(5, c, grp * hkv, hd, generator=gen,
                    device=card).to(torch.bfloat16)
    keys, splits = prefill_split_plan(n_pages, page, hkv, grp, c, hd)
    assert splits > 1
    starts = torch.tensor([0, keys, keys + page, keys - 37,
                           n_pages * page - c], dtype=torch.int32,
                          device=card)
    if int8:
        kq, vq, ks, vs = _int8(kp, vp)
        return (q, kq, vq, table, starts, ks, vs), \
            prefill_attention_int8_cuda, torch.float32
    return (q, kp, vp, table, starts), prefill_attention_cuda, torch.bfloat16


@pytest.mark.parametrize("shape", PREFILL_WGMMA_SHAPES,
                         ids=lambda s: "hd{}-grp{}-hkv{}-page{}".format(*s))
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("window", [0, 200])
def test_prefill_wgmma_route_matches_plain(card, shape, int8, window):
    """The wgmma route (float pools: P rounded to bf16; int8 pools: P as
    bf16 hi + lo) against the plain version, absolutely and slot by slot
    (each slot's max |err| within 1e-2 of its max |output|); the call
    counts one launch, on the wgmma route."""
    args, kernel, tol = _wgmma_prefill(card, int8, shape)
    before = dict(kernel.routes)
    out = kernel(*args, window=window)
    want = prefill_attention_plain(*args, window=window)
    _close(out, want, tol)
    _slots_close(out, want)
    assert kernel.routes == {"wgmma": before["wgmma"] + 1,
                             "simt": before["simt"]}


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_prefill_wgmma_route_is_batch_invariant_and_deterministic(card,
                                                                  int8):
    """At gemma-2b's heads: a slot's output equals, bit for bit, its row in
    the batch, alone and in another order; a rerun gives the same bits."""
    args, kernel, _ = _wgmma_prefill(card, int8, PREFILL_WGMMA_SHAPES[0])
    for window in (0, 200):
        out = kernel(*args, window=window)
        assert torch.equal(kernel(*args, window=window), out)
        for i in range(5):
            assert torch.equal(kernel(*_slot(args, slice(i, i + 1)),
                                      window=window), out[i:i + 1])
        order = torch.tensor([4, 2, 0, 3, 1], device=card)
        assert torch.equal(kernel(*_slot(args, order), window=window),
                           out[order])


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_prefill_small_shapes_take_the_simt_route(card, int8):
    """The small-shape tests' heads (hd 32) and fp32 q take the simt route;
    bf16 at gemma's heads the wgmma route; one launch a call either way."""
    kernel = prefill_attention_int8_cuda if int8 else prefill_attention_cuda
    for dtype, hd, route in ((torch.bfloat16, 32, "simt"),
                             (torch.float32, 256, "simt"),
                             (torch.bfloat16, 256, "wgmma")):
        gen, kp, vp, table = _pools(torch.float32 if int8 else dtype, card,
                                    slots=2, h=8, hkv=1, hd=hd, page=8,
                                    n_pages=6)
        q = torch.randn(2, 8, 8, hd, generator=gen, device=card).to(dtype)
        starts = torch.tensor([0, 40], dtype=torch.int32, device=card)
        args = (q, kp, vp, table, starts)
        tol = dtype
        if int8:
            kq, vq, ks, vs = _int8(kp, vp)
            args, tol = (q, kq, vq, table, starts, ks, vs), torch.float32
        dispatch.reset_launch_counts()
        out = kernel(*args)
        _close(out, prefill_attention_plain(*args), tol)
        assert kernel.launches == 1
        assert kernel.routes == {route: 1,
                                 "simt" if route == "wgmma" else "wgmma": 0}


def test_prefill_wgmma_route_rejects_misaligned_inputs(card):
    """q or a pool whose data does not start on a 16-byte boundary (what
    TMA reads) raises on the wgmma route before any launch."""
    args, kernel, _ = _wgmma_prefill(card, False, PREFILL_WGMMA_SHAPES[0])
    q, kp, vp, table, starts = args
    before = kernel.launches
    for bad in ((_misaligned(q), kp, vp), (q, _misaligned(kp), vp)):
        with pytest.raises(ValueError, match="16-byte"):
            kernel(*bad, table, starts)
    assert kernel.launches == before


def _gemma_decode(card, dtype, int8, *, seed=3, n_pages=10):
    """gemma-2b's decode heads (grp 8 over one kv head, hd 256, page 64)
    over 6 slots whose lengths cross the split plan's boundaries: 0, 1,
    exactly one split, one key past it, a ragged length, the full table.
    Returns the call's arguments, the wrapper and the tolerance's dtype."""
    hkv, grp, hd, page = 1, 8, 256, 64
    gen, kp, vp, table = _pools(torch.float32 if int8 else dtype, card,
                                slots=6, h=grp * hkv, hkv=hkv, hd=hd,
                                page=page, n_pages=n_pages, seed=seed)
    q = torch.randn(6, grp * hkv, hd, generator=gen, device=card).to(dtype)
    keys, splits = decode_split_plan(n_pages, page, hkv)
    assert splits > 3
    lengths = torch.tensor([0, 1, keys, keys + 1, 2 * keys + 37,
                            n_pages * page], dtype=torch.int32, device=card)
    if int8:
        kq, vq, ks, vs = _int8(kp, vp)
        return (q, kq, vq, table, lengths, ks, vs), \
            decode_attention_int8_cuda, torch.float32
    return (q, kp, vp, table, lengths), decode_attention_cuda, dtype


def _slots_close(got, want, limit=1e-2):
    """Each slot's max |got - want| within ``limit`` of its max |want|:
    an output averaged over hundreds of keys is a few hundredths, where
    bf16's absolute 5e-2 would pass a dropped split."""
    err = (got - want).abs().flatten(1).amax(1)
    ref = want.abs().flatten(1).amax(1)
    live = ref > 0
    assert torch.equal(got[~live], want[~live])
    assert bool((err[live] <= limit * ref[live]).all()), \
        (err[live] / ref[live]).max().item()


def _slot(args, i):
    """The inputs of slot(s) ``i`` alone: q, table and lengths rows; the
    pools and scales as they are."""
    q, kp, vp, table, lengths, *scales = args
    return (q[i].contiguous(), kp, vp, table[i].contiguous(),
            lengths[i].contiguous(), *scales)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("window", [0, 200])
def test_decode_split_kernel_matches_plain_at_full_width(card, dtype, int8,
                                                         window):
    args, kernel, tol = _gemma_decode(card, dtype, int8)
    out = kernel(*args, window=window)
    want = decode_attention_plain(*args, window=window)
    _close(out, want, tol)
    _slots_close(out, want)
    assert torch.count_nonzero(out[0]) == 0          # lengths == 0 -> 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("window", [0, 200])
def test_decode_kernel_returns_the_plain_log_sum_exp(card, dtype, int8,
                                                     window):
    """``return_lse``: the same output bits as without it, and each row's
    log-sum-exp within 1e-5 relative of the plain version's (the scores
    are fp32 in both), -inf for the empty slot; one launch counted."""
    args, kernel, _ = _gemma_decode(card, dtype, int8)
    before = kernel.launches
    out, lse = kernel(*args, window=window, return_lse=True)
    assert kernel.launches == before + 1
    assert torch.equal(out, kernel(*args, window=window))
    _, want = decode_attention_plain(*args, window=window, return_lse=True)
    assert lse.shape == want.shape and lse.dtype == torch.float32
    assert bool(torch.isinf(lse[0]).all()) and bool((lse[0] < 0).all())
    torch.testing.assert_close(lse[1:], want[1:], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_decode_split_kernel_is_batch_invariant_and_deterministic(
        card, dtype, int8):
    """A slot's output equals, bit for bit, its row in a batch with other
    slots at other lengths, in any order; a rerun gives the same bits; a
    call counts one launch whatever kernels it runs."""
    args, kernel, _ = _gemma_decode(card, dtype, int8)
    for window in (0, 200):
        before = kernel.launches
        out = kernel(*args, window=window)
        assert kernel.launches == before + 1
        assert torch.equal(kernel(*args, window=window), out)
        for i in range(6):
            assert torch.equal(kernel(*_slot(args, slice(i, i + 1)),
                                      window=window), out[i:i + 1])
        order = torch.tensor([5, 2, 0, 4, 1, 3], device=card)
        assert torch.equal(kernel(*_slot(args, order), window=window),
                           out[order])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("hd,grp,misaligned", [
    (36, 3, False), (32, 4, True), (512, 2, False), (880, 1, False),
    (640, 3, False)])
def test_decode_kernel_takes_odd_rows_and_wide_heads(card, dtype, int8, hd,
                                                     grp, misaligned):
    """Rows that are not whole 16-byte pieces (hd 36, or pools one element
    off a 16-byte boundary) load element by element; heads up to the old
    kernel's widest take more columns a lane, and more than one group of
    query heads a block (grp 3 at hd 640)."""
    hkv, page, n_pages = 2, 4, 40
    gen, kp, vp, table = _pools(torch.float32 if int8 else dtype, card,
                                slots=3, h=grp * hkv, hkv=hkv, hd=hd,
                                page=page, n_pages=n_pages)
    q = torch.randn(3, grp * hkv, hd, generator=gen, device=card).to(dtype)
    lengths = torch.tensor([0, 131, 160], dtype=torch.int32, device=card)
    if int8:
        kq, vq, ks, vs = _int8(kp, vp)
        if misaligned:
            kq, vq = _misaligned(kq), _misaligned(vq)
        args, kernel, tol = (q, kq, vq, table, lengths, ks, vs), \
            decode_attention_int8_cuda, torch.float32
    else:
        if misaligned:
            kp, vp = _misaligned(kp), _misaligned(vp)
        args, kernel, tol = (q, kp, vp, table, lengths), \
            decode_attention_cuda, dtype
    for window in (0, 50):
        _close(kernel(*args, window=window),
               decode_attention_plain(*args, window=window), tol)


def test_decode_kernel_refuses_heads_past_its_registers(card):
    """A row of more than 1024 columns does not fit 32 a lane: the wrapper
    raises before anything launches."""
    gen, kp, vp, table = _pools(torch.float32, card, slots=1, h=1, hkv=1,
                                hd=1032, page=4, n_pages=2)
    q = torch.randn(1, 1, 1032, generator=gen, device=card)
    lengths = torch.tensor([5], dtype=torch.int32, device=card)
    before = decode_attention_cuda.launches
    with pytest.raises(ValueError, match="head width"):
        decode_attention_cuda(q, kp, vp, table, lengths)
    assert decode_attention_cuda.launches == before


def test_int8_wrappers_count_launches_and_reject_bad_inputs(card):
    gen, kp, vp, table = _pools(torch.float32, card, slots=2, h=4, hkv=2,
                                hd=8, page=4, n_pages=2)
    kq, vq, ks, vs = _int8(kp, vp)
    q = torch.randn(2, 4, 8, generator=gen, device=card)
    lengths = torch.tensor([3, 8], dtype=torch.int32, device=card)
    before = dispatch.launch_counts()
    with dispatch.stats_scope() as stats:
        dispatch.decode_attention(q, kq, vq, table, lengths, ks, vs)
        dispatch.prefill_attention(q[:, None], kq, vq, table, lengths, ks, vs)
        w, sc = _int8_weight(card, gen, 8, 5)
        dispatch.quantized_matmul(q, w, sc)
        assert stats() == {("decode_attention_int8", "kernel"): 1,
                           ("prefill_attention_int8", "kernel"): 1,
                           ("quantized_matmul", "kernel"): 1}
    after = dispatch.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "matmul": 0, "grouped_matmul": 0, "decode_attention": 0,
        "prefill_attention": 0, "decode_attention_int8": 1,
        "prefill_attention_int8": 1,
        "quantized_matmul": 1, "flash_attention": 0,
        "flash_attention_bwd": 0, "wkv": 0, "wkv_bwd": 0, "stencil": 0,
        "nbody": 0, "histogram": 0}
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_int8_cuda(q, kq, vq, table, lengths, ks.cpu(), vs)
    with pytest.raises(TypeError):             # float pools with scales
        decode_attention_int8_cuda(q, kp, vp, table, lengths, ks, vs)
    with pytest.raises(ValueError):            # scales of the wrong shape
        prefill_attention_int8_cuda(q[:, None], kq, vq, table, lengths,
                                    ks[:1], vs)
    with pytest.raises(TypeError):             # float weights
        quantized_matmul_cuda(q[0], w.float(), sc)
    assert dispatch.launch_counts() == after


def test_wrappers_count_launches_and_reject_cpu_tensors(card):
    a = torch.ones(2, 3, device=card)
    before = matmul_cuda.launches
    matmul_cuda(a, a.T.contiguous())
    assert matmul_cuda.launches == before + 1
    with pytest.raises(ValueError):
        matmul_cuda(a, torch.ones(3, 2))
    with pytest.raises(TypeError):
        matmul_cuda(a, torch.ones(3, 2, device=card, dtype=torch.bfloat16))
    with dispatch.stats_scope() as stats:
        dispatch.matmul(a, a.T)
        assert stats() == {("matmul", "kernel"): 1}


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("layout", ["prefix", "scan"])
def test_paged_model_kernels_match_plain(card, layout, int8):
    """A small paged model on the card, once through the kernels and once
    through the plain versions (device routing overridden for the second
    run): prefill of a padded partial page, then ragged decode steps."""
    import dataclasses
    from unittest import mock

    from repro_torch.configs import get_arch
    from repro_torch.core.memory import F32_POLICY
    from repro_torch.models.transformer import Model
    cfg = get_arch("gemma-2b").smoke()
    if layout == "scan":
        cfg = dataclasses.replace(cfg, n_layers=5, prefix=(("attn", "mlp"),),
                                  pattern=(("attn", "mlp"),) * 2)
    if int8:
        cfg = dataclasses.replace(cfg, kv_dtype="int8", weights_dtype="int8")
    model = Model(cfg, dt=F32_POLICY, device=card)
    params = model.bind_params(model.init(seed=0))
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=card)  # noqa

    def run():
        cache = model.init_paged_cache(2, 32, 4)
        table = i32([[1, 2, 3, 4, 5, 6, 7, 8], [0] * 8])
        out = [model.prefill_step_paged(params, cache, i32([[5, 9, 2, 7]]),
                                        i32([0]), table[:1], i32([3])),
               model.prefill_step_paged(params, cache, i32([[3, 1, 0, 0]]),
                                        i32([4]), table[:1], i32([1]))]
        for step, tok in enumerate((11, 12, 13)):
            out.append(model.decode_step(
                params, cache, i32([[tok], [0]]),
                paged=(i32([6 + step, 0]), table))[:1])
        return torch.cat(out)

    kernel = run()
    with mock.patch.object(dispatch, "_on_card", lambda op, t: False):
        plain = run()
    torch.testing.assert_close(kernel, plain, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ B6 / B7
def _bhsd(card, dtype, seed, b=2, h=3, s=37, hd=40):
    gen = torch.Generator(device=card).manual_seed(seed)
    q, k, v = (torch.randn(b, h, s, hd, generator=gen, device=card)
               .to(dtype) for _ in range(3))
    do = torch.randn(b, h, s, hd, generator=gen, device=card)
    return q, k, v, do


FLASH_MASKS = [(True, 0), (True, 7), (False, 0), (False, 9)]
# the wgmma backward splits the fp32 dO into bf16 halves (hi + lo, ~2^-16
# relative): ||got - plain|| / ||plain|| of each gradient, well above the
# kernel's readings and well below a build that loses a lo product
# (chip_smoke.py's BWD_SPLIT_LIMIT)
BWD_SPLIT_LIMIT = {"dq": 6e-4, "dk": 6e-4, "dv": 1e-4}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
@pytest.mark.parametrize("s,hd", [(37, 40), (64, 256), (1, 16), (500, 64),
                                  (500, 128), (200, 256)])
def test_flash_kernels_match_plain(card, dtype, causal, window, s, hd):
    """Forward (o, lse) and backward (dq, dk, dv) at ragged lengths, a
    full tile multiple at gemma's head width, and a single row; in bf16
    at hd 64, 128 and 256 on the wgmma route, whose gradients are also
    held to the precision of dO's hi/lo split, else on the simt route."""
    from repro_torch.kernels.attention import (flash_attention_bwd_cuda,
                                               flash_attention_bwd_plain,
                                               flash_attention_cuda,
                                               flash_attention_plain)
    from repro_torch.kernels.attention.flash import flash_route
    q, k, v, do = _bhsd(card, dtype, s * hd + window, s=s, hd=hd)
    o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                  return_lse=True)
    o_p, lse_p = flash_attention_plain(q, k, v, causal=causal,
                                       window=window, return_lse=True)
    assert o.dtype == lse.dtype == torch.float32
    _close(o, o_p, dtype)
    _close(lse, lse_p, torch.float32)
    got = flash_attention_bwd_cuda(q, k, v, o_p, lse_p, do, causal=causal,
                                   window=window)
    want = flash_attention_bwd_plain(q, k, v, o_p, lse_p, do, causal=causal,
                                     window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        _close(g, w, dtype)
        if flash_route(dtype, hd) == "wgmma":
            assert ((g - w).norm() / w.norm()).item() <= BWD_SPLIT_LIMIT[name]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 13])
@pytest.mark.parametrize("sq,sk,offset,hd", [(37, 100, 63, 64),
                                             (64, 256, 100, 256),
                                             (1, 50, 49, 128),
                                             (200, 512, 0, 128),
                                             (96, 96, 0, 40)])
def test_flash_kernels_at_a_query_offset(card, dtype, window, sq, sk, offset,
                                         hd):
    """q's Sq rows at key positions offset .. offset + Sq - 1 of Sk keys
    (one rank's block of a sequence-striped layer): o, lse and the
    gradients (dk, dv this block's part) against the plain versions at
    the same offset, on both routes."""
    from repro_torch.kernels.attention import (flash_attention_bwd_cuda,
                                               flash_attention_bwd_plain,
                                               flash_attention_cuda,
                                               flash_attention_plain)
    gen = torch.Generator(device=card).manual_seed(sq + sk + window)
    q = torch.randn(2, 3, sq, hd, generator=gen, device=card).to(dtype)
    k, v = (torch.randn(2, 3, sk, hd, generator=gen, device=card).to(dtype)
            for _ in range(2))
    do = torch.randn(2, 3, sq, hd, generator=gen, device=card)
    kw = dict(causal=True, window=window, q_offset=offset)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    o_p, lse_p = flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert o.shape == (2, 3, sq, hd) and lse.shape == (2, 3, sq)
    _close(o, o_p, dtype)
    _close(lse, lse_p, torch.float32)
    got = flash_attention_bwd_cuda(q, k, v, o_p, lse_p, do, **kw)
    want = flash_attention_bwd_plain(q, k, v, o_p, lse_p, do, **kw)
    assert got[1].shape == got[2].shape == (2, 3, sk, hd)
    for g, w in zip(got, want):
        _close(g, w, dtype)
    with pytest.raises(ValueError, match="do not lie"):
        flash_attention_cuda(q, k, v, causal=True, q_offset=sk - sq + 1)


@pytest.mark.parametrize("m,k,n", [(3, 64, 70), (1024, 8192, 2048),
                                   (256, 1024, 512)])
def test_matmul_f32_out_keeps_bf16_operands_sums(card, m, k, n):
    """B1 with ``out_dtype=torch.float32`` on bf16 operands: the fp32 sums
    of the plain version (within fp32's limit), at a split and without
    one; rounding them gives B1's bf16 output."""
    gen = torch.Generator(device=card).manual_seed(m + k)
    a = torch.randn(m, k, generator=gen, device=card).to(torch.bfloat16)
    # weights at a layer's scale: outputs of order one, whose fp32 sums
    # over K = 8192 the order of addition moves by less than the limit
    b = (torch.randn(k, n, generator=gen, device=card)
         / k ** 0.5).to(torch.bfloat16)
    got = matmul_cuda(a, b, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    _close(got, matmul_plain(a, b, out_dtype=torch.float32), torch.float32)
    _close(got.to(torch.bfloat16), matmul_cuda(a, b), torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [96, 512])
def test_flash_backward_is_deterministic(card, dtype, s):
    """No atomics: two runs of the backward give the same bits, on both
    routes at gemma's head width (bf16: wgmma, fp32: simt)."""
    from repro_torch.kernels.attention import (flash_attention_bwd_cuda,
                                               flash_attention_cuda)
    q, k, v, do = _bhsd(card, dtype, 5, s=s, hd=256)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    first = flash_attention_bwd_cuda(q, k, v, o, lse, do)
    second = flash_attention_bwd_cuda(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 40, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 256, "simt")])
def test_flash_calls_take_the_route_of_dtype_and_head_width(card, dtype, hd,
                                                            route):
    """Each call counts one launch on the route (dtype, hd) names, in the
    forward and in the backward, and none on the other."""
    from repro_torch.kernels.attention import (flash_attention_bwd_cuda,
                                               flash_attention_cuda)
    q, k, v, do = _bhsd(card, dtype, hd, s=70, hd=hd)
    dispatch.reset_launch_counts()
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    flash_attention_bwd_cuda(q, k, v, o, lse, do)
    other = "simt" if route == "wgmma" else "wgmma"
    assert dispatch.route_counts() == {
        f"flash_attention/{route}": 1, f"flash_attention/{other}": 0,
        f"flash_attention_bwd/{route}": 1,
        f"flash_attention_bwd/{other}": 0,
        **{f"{op}/{r}": 0 for op in ("prefill_attention",
                                     "prefill_attention_int8")
           for r in ("wgmma", "simt")},
        "wkv/mma": 0, "wkv/simt": 0, "wkv_bwd/mma": 0,
        "grouped_matmul/wgmma": 0, "grouped_matmul/wgmma_short": 0,
        "grouped_matmul/simt": 0}
    assert dispatch.launch_counts()["flash_attention"] == 1
    assert dispatch.launch_counts()["flash_attention_bwd"] == 1


def test_flash_wgmma_route_rejects_misaligned_inputs(card):
    """A bf16 view whose data does not start on a 16-byte boundary (what
    TMA and the dO split's 16-byte loads read) raises on the wgmma route,
    before any launch; the aligned call runs."""
    from repro_torch.kernels.attention import (flash_attention_bwd_cuda,
                                               flash_attention_cuda)
    q, k, v, do = _bhsd(card, torch.bfloat16, 3, b=1, h=1, s=64, hd=64)
    q_odd, do_odd = _misaligned(q), _misaligned(do)
    assert q_odd.data_ptr() % 16 and q_odd.is_contiguous()
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    before = (flash_attention_cuda.launches,
              flash_attention_bwd_cuda.launches)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_cuda(q_odd, k, v)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd_cuda(q_odd, k, v, o, lse, do)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd_cuda(q, k, v, o, lse, do_odd)
    assert (flash_attention_cuda.launches,
            flash_attention_bwd_cuda.launches) == before


def test_flash_wrappers_count_launches_and_reject_bad_inputs(card):
    from repro_torch.kernels.attention import (flash_attention_bwd_cuda,
                                               flash_attention_cuda)
    q, k, v, do = _bhsd(card, torch.float32, 6)
    before = (flash_attention_cuda.launches,
              flash_attention_bwd_cuda.launches)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    flash_attention_bwd_cuda(q, k, v, o, lse, do)
    assert (flash_attention_cuda.launches,
            flash_attention_bwd_cuda.launches) == (before[0] + 1,
                                                    before[1] + 1)
    with pytest.raises(ValueError):
        flash_attention_cuda(q.cpu(), k, v)
    with pytest.raises(ValueError):
        flash_attention_cuda(q.transpose(1, 2), k, v)
    with pytest.raises(TypeError):
        flash_attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        flash_attention_cuda(q[..., :8].contiguous(), k, v)
    with pytest.raises(TypeError):
        flash_attention_bwd_cuda(q, k, v, o, lse, do.bfloat16())
    with pytest.raises(ValueError):
        flash_attention_cuda(torch.zeros(1, 1, 4, 512, device=card),
                             torch.zeros(1, 1, 4, 512, device=card),
                             torch.zeros(1, 1, 4, 512, device=card))


@pytest.mark.parametrize("dtype", DTYPES)
def test_dispatch_gradients_on_card_match_the_cpu_route(card, dtype):
    """``dispatch.matmul`` and ``dispatch.attention`` forward and backward
    through the kernels against the same calls on CPU copies (the plain
    route), at a GQA-expanded, windowed geometry."""
    from repro_torch.models.layers import _expand_kv
    gen = torch.Generator(device="cpu").manual_seed(8)
    b, s, h, hkv, hd, d = 2, 40, 4, 2, 32, 48
    x = torch.randn(b, s, d, generator=gen)
    w = torch.randn(d, h, hd, generator=gen) / d ** 0.5
    kv = torch.randn(b, s, hkv, hd, generator=gen)
    cot = torch.randn(b, s, h * hd, generator=gen)

    def run(device):
        leaves = [t.to(device=device, dtype=dtype).requires_grad_(True)
                  for t in (x, w, kv)]
        x_, w_, kv_ = leaves
        q = dispatch.matmul(x_, w_)
        kk = _expand_kv(kv_, h)
        out = dispatch.attention(q, kk, kk * 0.5, causal=True, window=9,
                                 out_dtype=torch.float32)
        loss = (out.reshape(b, s, h * hd) * cot.to(device)).sum()
        with dispatch.stats_scope() as stats:
            grads = torch.autograd.grad(loss, leaves)
            routes = stats()
        return [out] + list(grads), routes

    got, routes = run(card)
    assert routes == {("attention_bwd", "kernel"): 1,
                      ("matmul_bwd", "kernel"): 2}, routes
    want, _ = run("cpu")
    for g_, w_ in zip(got, want):
        _close(g_.float().cpu(), w_.float(), dtype)


# ------------------------------------------------------------ B8-B11
def _rel_err(got, want):
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


def _wkv_inputs(card, dtype, b, s, h, hd, seed, strong=False):
    gen = torch.Generator(device=card).manual_seed(seed)
    r, k, v = (torch.randn(b, s, h, hd, generator=gen, device=card)
               .to(dtype) for _ in range(3))
    if strong:      # [-50, -20] on a grid of 1/4: exact fp32 cumsums
        lw = -torch.randint(80, 201, (b, s, h, hd), generator=gen,
                            device=card).float() / 4
    else:
        lw = -torch.exp(torch.randn(b, s, h, hd, generator=gen, device=card)
                        - 2)
    u = torch.randn(h, hd, generator=gen, device=card)
    return r, k, v, lw, u


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,chunk", [
    ((2, 64, 3, 16), 32), ((1, 48, 2, 32), 32), ((1, 128, 2, 64), 64),
    ((2, 17, 1, 8), 64), ((1, 12, 1, 64), 128)])
def test_wkv_kernel_matches_plain(card, dtype, shape, chunk):
    """Ragged chunk lengths (48 -> 16, 17 -> 17, 12 -> 12), head widths
    8..64, error within 1e-4 of max |o| (both compute in fp32)."""
    from repro_torch.kernels.wkv import wkv_cuda, wkv_plain
    args = _wkv_inputs(card, dtype, *shape, seed=sum(shape) + chunk)
    got = wkv_cuda(*args, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == shape
    assert _rel_err(got, wkv_plain(*args, chunk=chunk)) <= 1e-4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,chunk", [
    ((2, 128, 2, 128), 64), ((1, 128, 2, 256), 64), ((1, 512, 2, 64), 256),
    ((1, 300, 1, 100), 150), ((1, 64, 1, 600), 64)])
def test_wkv_kernel_takes_wide_heads_and_long_chunks(card, dtype, shape,
                                                     chunk):
    """Head widths past 64 (value-column blocks, key-side pieces), a chunk
    of 256 rows at hd 64 (row pieces), ragged pieces of both (hd 100,
    chunk 150) and a head wide enough for column blocks of 32 (hd 600),
    within 1e-4 of max |o|."""
    from repro_torch.kernels.wkv import wkv_cuda, wkv_plain
    args = _wkv_inputs(card, dtype, *shape, seed=sum(shape) + chunk)
    got = wkv_cuda(*args, chunk=chunk)
    assert got.shape == shape
    assert _rel_err(got, wkv_plain(*args, chunk=chunk)) <= 1e-4


@pytest.mark.parametrize("shape,chunk", [((2, 128, 2, 64), 64),
                                         ((1, 512, 2, 64), 256)])
def test_wkv_kernel_strong_decay(card, shape, chunk):
    """Decays in [-50, -20]; the mma route clamps at e^-60 only inside
    its sub-chunks (the TPU kernel's form) and a chunk of 256 rows goes
    in pieces of 64, the state carried between them, so weights across
    sub-chunks are not clamped as the plain version's are: the gap stays
    within 1e-4 of max |o|."""
    from repro_torch.kernels.wkv import wkv_cuda, wkv_plain
    args = _wkv_inputs(card, torch.float32, *shape, seed=3, strong=True)
    assert _rel_err(wkv_cuda(*args, chunk=chunk),
                    wkv_plain(*args, chunk=chunk)) <= 1e-4


def test_wkv_wrapper_rejects_bad_inputs(card):
    from repro_torch.kernels.wkv import wkv_cuda
    r, k, v, lw, u = _wkv_inputs(card, torch.float32, 1, 8, 1, 16, seed=0)
    with pytest.raises(TypeError):
        wkv_cuda(r, k.bfloat16(), v, lw, u)
    with pytest.raises(TypeError):
        wkv_cuda(r, k, v, lw.bfloat16(), u)
    with pytest.raises(ValueError):
        wkv_cuda(r, k, v, lw, u[:, :8])
    with pytest.raises(ValueError):
        wkv_cuda(r, k, v, lw[:, :4], u)
    with pytest.raises(ValueError):
        wkv_cuda(r, k, v, lw, u, chunk=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [16, 64, 100, 128, 256])
def test_wkv_routes_match_plain_over_chunks_and_subchunks(card, dtype, hd):
    """Chunks of 16 to 256 rows and sub-chunks of 8, 16 and 32 at head
    widths on both routes (``wkv_route``: the mma route at hd 64 and 128,
    but not fp32 at 128): within 1e-4 of max |o|, a rerun bit-equal, the
    launch counted on its route; also under strong decay."""
    from repro_torch.kernels.wkv import wkv_cuda, wkv_plain
    from repro_torch.kernels.wkv.wkv import subchunk_len, wkv_route
    for chunk in (16, 32, 64, 128, 256):
        for subchunk in (8, 16, 32):
            for strong in (False, True):
                args = _wkv_inputs(card, dtype, 1, 512, 2, hd,
                                   seed=hd + chunk + subchunk, strong=strong)
                route = wkv_route(chunk, subchunk_len(chunk, subchunk), hd,
                                  dtype)
                assert route == ("mma" if hd in (64, 128) and not (
                    hd == 128 and dtype == torch.float32) else "simt")
                before = dict(wkv_cuda.routes)
                got = wkv_cuda(*args, chunk=chunk, subchunk=subchunk)
                assert wkv_cuda.routes[route] == before[route] + 1
                err = _rel_err(got, wkv_plain(*args, chunk=chunk))
                assert err <= 1e-4, (chunk, subchunk, strong, err)
                assert torch.equal(got, wkv_cuda(*args, chunk=chunk,
                                                 subchunk=subchunk))


def test_wkv_mma_route_rejects_misaligned_inputs(card):
    from repro_torch.kernels.wkv import wkv_cuda
    r, k, v, lw, u = _wkv_inputs(card, torch.bfloat16, 1, 64, 1, 64, seed=1)
    flat = torch.zeros(1 + r.numel(), dtype=r.dtype, device=card)
    odd = flat[1:].view(r.shape)
    odd.copy_(r)
    with pytest.raises(ValueError, match="16-byte"):
        wkv_cuda(odd, k, v, lw, u)


def _wkv_bwd_check(card, dtype, shape, *, strong=False, seed=0):
    """The backward kernel against the autograd of the plain version and
    against the chunked oracle (the kernel's decomposition), both on the
    same inputs run in fp64: each gradient within the dtype's tolerance
    of its max |grad|, one launch on the mma route, and a rerun
    bit-equal.  (In fp32 the plain version's dlw is the difference of
    O(1) terms, whose rounding is most of a strong decay's dlw of e^-20
    size.)"""
    from repro_torch.kernels.wkv import (wkv_bwd_chunked, wkv_bwd_cuda,
                                         wkv_bwd_plain)
    from repro_torch.kernels.wkv.wkv import bwd_chunk
    args = _wkv_inputs(card, dtype, *shape, seed=seed, strong=strong)
    gen = torch.Generator(device=card).manual_seed(seed + 1)
    do = torch.randn(shape, generator=gen, device=card)
    before = wkv_bwd_cuda.launches, wkv_bwd_cuda.routes["mma"]
    got = wkv_bwd_cuda(*args, do)
    assert (wkv_bwd_cuda.launches, wkv_bwd_cuda.routes["mma"]) == (
        before[0] + 1, before[1] + 1)
    wide = [t.double() for t in (*args, do)]
    for want in (wkv_bwd_plain(*wide[:5], wide[5], chunk=64),
                 wkv_bwd_chunked(*wide, chunk=bwd_chunk(shape[3]))):
        for name, g, w in zip(("dr", "dk", "dv", "dlw", "du"), got, want):
            assert g.dtype == torch.float32 and g.shape == w.shape, name
            err = _rel_err(g.double(), w)
            assert err <= TOLS[dtype], (name, shape, strong, err)
    again = wkv_bwd_cuda(*args, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 128, 3, 64), (1, 100, 2, 64),
                                   (2, 130, 2, 128), (1, 7, 2, 128),
                                   (3, 64, 1, 32), (1, 1024, 2, 64),
                                   (2, 193, 1, 64), (1, 193, 2, 32)])
def test_wkv_bwd_kernel_matches_plain(card, dtype, shape):
    """Head widths 32, 64 and 128, whole chunks (64 rows, 32 at hd 128)
    and S not a multiple of them (100, 130, 7, 193 = 3 * 64 + 1), many
    chunks (1024), batches summed into du."""
    _wkv_bwd_check(card, dtype, shape, seed=sum(shape))


@pytest.mark.parametrize("shape", [(2, 256, 2, 64), (1, 200, 2, 128)])
def test_wkv_bwd_kernel_strong_decay(card, shape):
    """Decays in [-50, -20] (fp32): the plain version's e^-60 clamp and
    the kernel's exact products differ by less than e^-60 of a term."""
    _wkv_bwd_check(card, torch.float32, shape, strong=True, seed=5)


def test_wkv_bwd_wrapper_rejects_bad_inputs(card):
    from repro_torch.kernels.wkv import wkv_bwd_cuda
    r, k, v, lw, u = _wkv_inputs(card, torch.float32, 1, 8, 1, 64, seed=0)
    do = torch.zeros_like(lw)
    before = wkv_bwd_cuda.launches
    with pytest.raises(TypeError):
        wkv_bwd_cuda(r, k.bfloat16(), v, lw, u, do)
    with pytest.raises(TypeError):
        wkv_bwd_cuda(r, k, v, lw, u, do.bfloat16())
    with pytest.raises(ValueError):
        wkv_bwd_cuda(r, k, v, lw, u[:, :8], do)
    with pytest.raises(ValueError):
        wkv_bwd_cuda(r, k, v, lw, u, do[:, :4])
    with pytest.raises(ValueError, match="head width"):
        wkv_bwd_cuda(*(t[..., :48].contiguous() for t in (r, k, v, lw, u,
                                                           do)))
    strided = torch.zeros(1, 8, 1, 128, device=card)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        wkv_bwd_cuda(r, k, v, lw, u, strided)
    with pytest.raises(ValueError, match="CUDA"):
        wkv_bwd_cuda(r.cpu(), k, v, lw, u, do)
    odd = torch.zeros(8 * 64 + 1, device=card)[1:].view(1, 8, 1, 64)
    with pytest.raises(ValueError, match="16-byte"):
        wkv_bwd_cuda(r, k, v, lw, u, odd)
    assert wkv_bwd_cuda.launches == before


@pytest.mark.parametrize("dtype", DTYPES)
def test_dispatch_wkv_gradients_on_card_match_the_cpu_route(card, dtype):
    """The model's WKV op: forward on B8, backward on the backward kernel
    (one launch each, kernel routes: B8 and its backward on mma), against
    the CPU route (the chunked form and its autograd) on the same
    inputs."""
    shape = (2, 96, 2, 64)
    args = _wkv_inputs(card, dtype, *shape, seed=11)
    do = torch.randn(shape, generator=torch.Generator(device=card)
                     .manual_seed(12), device=card)
    results = []
    for dev in (card, "cpu"):
        leaves = [t.detach().to(dev).requires_grad_(True) for t in args]
        dispatch.reset_launch_counts()
        with dispatch.stats_scope() as stats:
            out = dispatch.wkv(*leaves, chunk=64, subchunk=16)
            grads = torch.autograd.grad(out, leaves, do.to(dev))
            routes = stats()
        route = "kernel" if dev == card else "plain"
        assert routes == {("wkv", route): 1, ("wkv_bwd", route): 1}
        if dev == card:
            counts = dispatch.route_counts()
            assert (counts["wkv/mma"], counts["wkv_bwd/mma"]) == (1, 1)
        assert [g.dtype for g in grads] == [t.dtype for t in args]
        results.append((out, grads))
    (out_k, grads_k), (out_p, grads_p) = results
    assert _rel_err(out_k, out_p.to(card)) <= 1e-4
    for g, w in zip(grads_k, grads_p):
        assert _rel_err(g.float(), w.to(card).float()) <= TOLS[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (2, 5), (3, 3), (33, 65),
                                   (130, 67), (64, 128)])
@pytest.mark.parametrize("steps", [0, 1, 2, 3])
def test_stencil_kernel_equals_plain(card, dtype, shape, steps):
    """Both add in fp32 in one order and round once: equal bits."""
    from repro_torch.kernels.stencil import jacobi4_cuda, jacobi4_plain
    gen = torch.Generator(device=card).manual_seed(shape[0] + steps)
    x = torch.randn(*shape, generator=gen, device=card).to(dtype)
    before = jacobi4_cuda.launches
    got = jacobi4_cuda(x, steps=steps)
    assert jacobi4_cuda.launches == before + steps
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got,
                                              jacobi4_plain(x, steps=steps))


@pytest.mark.parametrize("n", [1, 127, 129, 16128, 65537])
def test_nbody_split_kernel_matches_plain_and_reruns_bit_equal(card, n):
    """The split source range (``nbody_split_plan``: 21 splits at 16128,
    33 at 65537) and a single split, within 1e-4 of max |a|; a rerun gives
    the same bits (partials summed in rank order, no atomics) and counts
    one launch."""
    from repro_torch.kernels.nbody import nbody_accel_cuda, nbody_accel_plain
    gen = torch.Generator(device=card).manual_seed(n)
    pos = torch.randn(3, n, generator=gen, device=card)
    mass = torch.rand(n, generator=gen, device=card) + 0.1
    before = nbody_accel_cuda.launches
    got = nbody_accel_cuda(pos, mass)
    assert nbody_accel_cuda.launches == before + 1
    assert torch.equal(got, nbody_accel_cuda(pos, mass))
    if n > 1:
        assert _rel_err(got, nbody_accel_plain(pos, mass)) <= 1e-4


@pytest.mark.parametrize("n", [1, 2, 127, 128, 129, 1000])
def test_nbody_kernel_matches_plain(card, n):
    from repro_torch.kernels.nbody import nbody_accel_cuda, nbody_accel_plain
    gen = torch.Generator(device=card).manual_seed(n)
    pos = torch.randn(3, n, generator=gen, device=card)
    mass = torch.rand(n, generator=gen, device=card) + 0.1
    for eps in (1e-3, 0.5):
        got = nbody_accel_cuda(pos, mass, eps=eps)
        want = nbody_accel_plain(pos, mass, eps=eps)
        if n == 1:                           # only the self-interaction
            assert torch.equal(got, torch.zeros_like(got))
        else:
            assert _rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("n,n_bins,kind", [
    (100_000, 256, "uniform"), (100_000, 256, "one bin"),
    (13, 8, "out of range"), (70_001, 50_000, "uniform"), (1, 1, "uniform"),
    (300_000, 100_000, "uniform"), (100_000, 100_000, "one bin"),
    (1 << 20, 1 << 20, "uniform"), (100_000, 1 << 20, "one bin"),
    (5000, 200_000, "out of range")])
def test_histogram_kernel_equals_plain(card, n, n_bins, kind):
    """Exact counts, any N, bins past 48 KB of shared memory and past one
    block's shared memory (the one-pass route), and values outside
    [0, n_bins) dropped."""
    from repro_torch.kernels.histogram import histogram_cuda, histogram_plain
    gen = torch.Generator(device=card).manual_seed(n)
    if kind == "uniform":
        vals = torch.randint(0, n_bins, (n,), generator=gen, device=card)
    elif kind == "one bin":      # past one window: a bin of the last one
        vals = torch.full((n,), 7 if n_bins <= 58_112 else n_bins - 7,
                          device=card)
    else:
        vals = torch.randint(-5, 2 * n_bins, (n,), generator=gen, device=card)
    vals = vals.to(torch.int32)
    got = histogram_cuda(vals, n_bins)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert torch.equal(got, histogram_plain(vals, n_bins))


@pytest.mark.parametrize("n_bins", [100_000, 1 << 20])
@pytest.mark.parametrize("kind", ["uniform", "one bin", "out of range",
                                  "runs"])
def test_histogram_global_route_equals_plain(card, n_bins, kind):
    """Past one block's shared memory the kernel takes its one-pass route
    (an atomic per run of equal values into the output): exact counts for
    uniform values, all in one bin, values out of range both ways, and
    runs of equal values; N is not a multiple of 4 and the values start
    off a 16-byte boundary in a second call (the tail loop alone)."""
    from repro_torch.kernels.histogram import histogram_cuda, histogram_plain
    from repro_torch.kernels.histogram.histogram import histogram_route
    assert histogram_route(n_bins) == "global"
    gen = torch.Generator(device=card).manual_seed(n_bins)
    n = 1_000_003
    if kind == "uniform":
        vals = torch.randint(0, n_bins, (n,), generator=gen, device=card)
    elif kind == "one bin":
        vals = torch.full((n,), n_bins - 3, device=card)
    elif kind == "out of range":
        vals = torch.randint(-n_bins, 2 * n_bins, (n,), generator=gen,
                             device=card)
    else:       # sorted: long runs along each lane's share
        vals = torch.randint(0, n_bins, (n,), generator=gen,
                             device=card).sort().values
    vals = vals.to(torch.int32)
    want = histogram_plain(vals, n_bins)
    assert torch.equal(histogram_cuda(vals, n_bins), want)
    off = torch.empty(n + 1, dtype=torch.int32, device=card)[1:]
    off.copy_(vals)
    assert torch.equal(histogram_cuda(off, n_bins), want)


def test_histogram_wrapper_rejects_bad_inputs(card):
    from repro_torch.kernels.histogram import histogram_cuda
    vals = torch.zeros(8, dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        histogram_cuda(vals.long())
    with pytest.raises(ValueError):
        histogram_cuda(vals[None])
    with pytest.raises(ValueError):
        histogram_cuda(vals, 0)


def test_library_ops_route_to_the_kernels(card):
    """The public ops on CUDA tensors: kernel routes only, one launch per
    call (the stencil one per sweep)."""
    from repro_torch.kernels.histogram import histogram
    from repro_torch.kernels.nbody import nbody_accel
    from repro_torch.kernels.stencil import jacobi4
    from repro_torch.kernels.wkv import wkv
    args = _wkv_inputs(card, torch.bfloat16, 1, 32, 2, 16, seed=1)
    before = dispatch.launch_counts()
    with dispatch.stats_scope() as stats:
        wkv(*args, chunk=16, subchunk=4)
        jacobi4(torch.ones(9, 9, device=card), steps=3)
        nbody_accel(torch.ones(3, 5, device=card), torch.ones(5, device=card))
        histogram(torch.zeros(5, dtype=torch.int32, device=card), 4)
        assert stats() == {("wkv", "kernel"): 1, ("stencil", "kernel"): 1,
                           ("nbody", "kernel"): 1, ("histogram", "kernel"): 1}
    after = dispatch.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {"wkv": 1, "stencil": 3, "nbody": 1, "histogram": 1}


# ------------------------------------------------- the library ops' inputs
def _lib_tol():
    """chip_smoke.LIB_TOL, read from the script beside the tests."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.LIB_TOL


def test_library_ops_take_views_offsets_and_int64(card):
    """The public ops take what their plain routes take: transposed and
    strided views, contiguous views at an odd offset (off a 16-byte
    boundary), and int64 histogram values, including values at and past
    2^32 that a bare cast to int32 would wrap into range.  Results equal
    the plain route exactly (stencil, histogram) or within
    ``chip_smoke.LIB_TOL`` of max |plain output| (WKV, N-body); every call
    launches its kernel, WKV on its mma route."""
    from repro_torch.kernels.histogram import histogram, histogram_plain
    from repro_torch.kernels.nbody import nbody_accel, nbody_accel_plain
    from repro_torch.kernels.stencil import jacobi4, jacobi4_plain
    from repro_torch.kernels.wkv import wkv, wkv_cuda, wkv_plain
    tol = _lib_tol()
    gen = torch.Generator(device=card).manual_seed(17)
    dispatch.reset_launch_counts()

    def rel_ok(got, want):
        torch.cuda.synchronize()
        return ((got - want).abs().max() / want.abs().max()).item() <= tol

    # WKV: r transposed from (B, H, S, hd), k at an odd offset, v strided
    b, s, h, hd = 2, 96, 2, 64
    r = torch.randn(b, h, s, hd, generator=gen,
                    device=card).bfloat16().transpose(1, 2)
    k = _misaligned(torch.randn(b, s, h, hd, generator=gen,
                                device=card).bfloat16())
    v = torch.randn(b, s, h, 2 * hd, generator=gen,
                    device=card).bfloat16()[..., ::2]
    lw = -torch.rand(b, s, h, hd, generator=gen, device=card) * 0.5
    u = torch.randn(h, hd, generator=gen, device=card)[:, :]
    assert not r.is_contiguous() and not v.is_contiguous()
    assert k.data_ptr() % 16
    got = wkv(r, k, v, lw.transpose(0, 1).contiguous().transpose(0, 1), u,
              chunk=32, subchunk=16)
    assert rel_ok(got, wkv_plain(r, k, v, lw, u, chunk=32))
    assert wkv_cuda.routes["mma"] == 1

    # stencil: a transposed grid, a sub-grid, an odd-offset copy
    grid = torch.randn(67, 45, generator=gen, device=card)
    for x in (grid.T, grid[3:-2, 5:-4], _misaligned(grid)):
        for steps in (1, 2):
            assert torch.equal(jacobi4(x, steps=steps),
                               jacobi4_plain(x, steps=steps))

    # N-body: positions kept as (N, 3), masses strided and at an offset
    n = 1000
    pos_n3 = torch.randn(n, 3, generator=gen, device=card)
    mass = torch.rand(2 * n, generator=gen, device=card)[::2] + 0.5
    for pos, m in ((pos_n3.T, mass), (_misaligned(pos_n3.T.contiguous()),
                                      _misaligned(mass.contiguous()))):
        assert rel_ok(nbody_accel(pos, m), nbody_accel_plain(pos, m))

    # histogram: int64 with values past int32, negatives, a strided view,
    # an odd-offset int32 view
    bins = 300
    vals = torch.randint(-50, bins + 50, (40_001,), generator=gen,
                         device=card)
    vals[::7] += 1 << 32                       # wraps to vals[::7] in int32
    vals[1::11] = (1 << 33) + 5
    vals[2::13] = -(1 << 32) + 3
    for x in (vals, vals[::3], _misaligned(vals[5::2].int())):
        want = histogram_plain(x, bins)
        assert torch.equal(histogram(x, bins), want)
    assert torch.equal(histogram(vals, bins),
                       histogram_plain(vals.cpu(), bins).to(card))
    assert histogram(vals, bins).sum().item() \
        == int(((vals >= 0) & (vals < bins)).sum())
    counts = dispatch.launch_counts()
    assert (counts["wkv"], counts["stencil"], counts["nbody"],
            counts["histogram"]) == (1, 3 * 3, 2, 5)


# ----------------------- dense decode, verify windows, the drafter forward
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cap", [1024, 2048])
def test_decode_kernel_over_a_dense_cache_view(card, dtype, cap):
    """``layers.attention_decode``'s call at gemma3-4b's heads (8 query
    heads over 4 kv heads, hd 256): the (B, cap, Hkv, hd) cache viewed as
    pages, each slot's own run of pages as its table, every length
    min(pos + 1, cap) at a position past the window (the local layers'
    buffer has wrapped; the global one holds pos + 1 keys)."""
    from repro_torch.models.layers import dense_page
    b, h, hkv, hd, pos = 2, 8, 4, 256, 1500
    gen = torch.Generator(device=card).manual_seed(cap)
    kc = torch.randn(b, cap, hkv, hd, generator=gen, device=card).to(dtype)
    vc = torch.randn(b, cap, hkv, hd, generator=gen, device=card).to(dtype)
    q = torch.randn(b, h, hd, generator=gen, device=card).to(dtype)
    page = dense_page(cap)
    n_pages = cap // page
    table = torch.arange(b * n_pages, dtype=torch.int32,
                         device=card).view(b, n_pages)
    lengths = torch.full((b,), min(pos + 1, cap), dtype=torch.int32,
                         device=card)
    args = (q, kc.view(-1, page, hkv, hd), vc.view(-1, page, hkv, hd),
            table, lengths)
    out = decode_attention_cuda(*args)
    want = decode_attention_plain(*args)
    _close(out, want, dtype)
    _slots_close(out, want)
    # the same as attention over the dense prefix of each slot's buffer
    keys = int(lengths[0])
    ref = torch.softmax(torch.einsum(
        "bhd,bshd->bhs", q.float(),
        kc[:, :keys].float().repeat_interleave(h // hkv, 2)) / hd ** 0.5,
        -1)
    ref = torch.einsum("bhs,bshd->bhd", ref.to(dtype).float(),
                       vc[:, :keys].float().repeat_interleave(h // hkv, 2))
    _close(out, ref, dtype)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_verify_window_through_prefill_kernels(card, int8):
    """One verify window (W = 4) at gemma-2b's heads on the wgmma route:
    starts mid-page and across a page edge, and a slot at 0, through B3 /
    B4b against the plain version."""
    from repro_torch.kernels.attention.prefill import prefill_route
    hd, grp, hkv, page, n_pages = 256, 8, 1, 64, 4
    assert prefill_route(torch.bfloat16, hd, grp) == "wgmma"
    gen, kp, vp, table = _pools(torch.float32 if int8 else torch.bfloat16,
                                card, slots=4, h=grp * hkv, hkv=hkv, hd=hd,
                                page=page, n_pages=n_pages, seed=21)
    q = torch.randn(4, 4, grp * hkv, hd, generator=gen,
                    device=card).to(torch.bfloat16)
    starts = torch.tensor([17, 62, 0, 130], dtype=torch.int32, device=card)
    kernel = prefill_attention_int8_cuda if int8 else prefill_attention_cuda
    args = (q, kp, vp, table, starts)
    tol = torch.bfloat16
    if int8:
        kq, vq, ks, vs = _int8(kp, vp)
        args, tol = (q, kq, vq, table, starts, ks, vs), torch.float32
    before = dict(kernel.routes)
    out = kernel(*args)
    want = prefill_attention_plain(*args)
    _close(out, want, tol)
    _slots_close(out, want)
    assert kernel.routes["wgmma"] == before["wgmma"] + 1
    for window in (0, 100):
        assert torch.equal(kernel(*args, window=window),
                           kernel(*args, window=window))


def test_flash_forward_takes_the_drafter_tail(card):
    """The model drafter's forward: S = max_len 256 + 3 drafts = 259, not
    a multiple of 64, at gemma-2b's heads in bf16 on the wgmma route."""
    from repro_torch.kernels.attention import (flash_attention_cuda,
                                               flash_attention_plain)
    q, k, v, _ = _bhsd(card, torch.bfloat16, 259, b=4, h=8, s=259, hd=256)
    before = dict(flash_attention_cuda.routes)
    o, lse = flash_attention_cuda(q, k, v, causal=True, return_lse=True)
    o_p, lse_p = flash_attention_plain(q, k, v, causal=True, return_lse=True)
    _close(o, o_p, torch.bfloat16)
    _close(lse, lse_p, torch.float32)
    assert flash_attention_cuda.routes["wgmma"] == before["wgmma"] + 1


@pytest.mark.parametrize("weights", ["", "int8"])
def test_dense_model_kernels_match_plain(card, weights):
    """A small dense-cache model on the card (gemma3-4b smoke: window-16
    buffers wrap by position 20), once through the kernels and once
    through the plain versions: teacher-forced decode steps at one shared
    position, two slots."""
    import dataclasses
    from unittest import mock

    from repro_torch.configs import get_arch
    from repro_torch.core.memory import F32_POLICY
    from repro_torch.models.transformer import Model
    cfg = dataclasses.replace(get_arch("gemma3-4b").smoke(),
                              weights_dtype=weights)
    model = Model(cfg, dt=F32_POLICY, device=card)
    params = model.bind_params(model.init(seed=0))
    toks = torch.randint(0, cfg.vocab_size, (24, 2, 1), dtype=torch.int32,
                         generator=torch.Generator(device=card).manual_seed(1),
                         device=card)

    def run():
        cache = model.init_cache(2, 40)
        return torch.stack([model.decode_step(params, cache, t, pos=i)
                            for i, t in enumerate(toks)])

    dispatch.reset_launch_counts()
    kernel = run()
    assert dispatch.launch_counts()["decode_attention"] == 24 * 3
    with mock.patch.object(dispatch, "_on_card", lambda op, t: False):
        plain = run()
    torch.testing.assert_close(kernel, plain, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen2-vl-2b"])
def test_train_step_kernels_match_plain(card, arch):
    """One fp32 train step (remat, 4 xent chunks, clipped AdamW) of a
    smoke config on the card, through the kernels and through the plain
    versions: the MoE experts on the grouped route and its VJP, and
    qwen2-vl's embeddings with three different M-RoPE position streams.
    The loss, the gradient norm and every gradient leaf the step hands
    AdamW (within 1e-3 of the leaf's max |grad|, as chip_smoke.py's
    parity phases) agree; the kernel run takes no plain route.  (The
    params after the step are not compared: Adam's first step moves an
    entry by lr g / (|g| + eps), so a bias whose gradient nearly cancels
    moves by a share of lr on a gradient ulp.)"""
    from unittest import mock

    from repro_torch.configs import get_arch
    from repro_torch.core import tree
    from repro_torch.core.memory import F32_POLICY
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.transformer import ExecOptions, Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import steps
    cfg = get_arch(arch).smoke()
    model = Model(cfg, dt=F32_POLICY, device=card,
                  opts=ExecOptions(xent_chunks=4))
    ts = steps.TrainStepConfig(opt=AdamWConfig(lr=1e-2, warmup_steps=1))
    step = steps.make_train_step(model, ts)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=2, input_mode=cfg.input_mode,
                                  d_model=cfg.d_model))
    batch = {k: torch.from_numpy(v).to(card)
             for k, v in data.batch_at(0).items()}
    if cfg.mrope_sections:
        gen = torch.Generator(device=card).manual_seed(3)
        streams = [torch.arange(16, device=card).expand(2, 16)] + [
            torch.stack([torch.randperm(16, generator=gen, device=card)
                         for _ in range(2)]) for _ in range(2)]
        batch["positions"] = torch.stack(streams, -1).to(torch.int32)
    update = steps.adamw_update
    results = []
    for route in ("kernel", "plain"):
        params, opt = steps.init_train_state(model, ts, seed=0)
        handed = []

        def capture(grads, *args):
            handed.append([g.clone() for g in tree.leaves(grads)])
            return update(grads, *args)
        with mock.patch.object(steps, "adamw_update", capture), \
                dispatch.stats_scope() as stats:
            if route == "kernel":
                _, _, metrics = step(params, opt, batch)
            else:
                with _plain_routes():
                    _, _, metrics = step(params, opt, batch)
            routes = stats()
        results.append((handed[0], metrics))
        if route == "kernel":
            assert routes and all(r == "kernel" for _, r in routes)
            assert (("grouped_matmul_bwd", "kernel") in routes) \
                == bool(cfg.n_experts)
    (gk, mk), (gp, mp) = results
    assert math.isclose(float(mk["loss"]), float(mp["loss"]), rel_tol=1e-5)
    assert math.isclose(float(mk["grad_norm"]), float(mp["grad_norm"]),
                        rel_tol=1e-4)
    assert len(gk) == len(gp)
    for got, want in zip(gk, gp):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-3 * scale


@pytest.mark.parametrize("arch, weights", [("rwkv6-7b", ""),
                                           ("recurrentgemma-9b", ""),
                                           ("recurrentgemma-9b", "int8")])
def test_recurrent_decode_kernels_match_plain(card, arch, weights):
    """The recurrent archs' dense decode at smoke width on the card: 20
    teacher-forced steps of two slots (recurrentgemma's local layer at
    max_len 12 wraps its buffer), once through the kernels and once
    through the plain versions.  The kernel run launches exactly the
    head (rwkv6-7b) or the head, the local layer's 4 projections, 3
    GEMMs an MLP and one decode attention a step (recurrentgemma; B5 for
    the projections and MLPs on int8 weights), takes no plain route and
    reruns bit-equal; logits and every cache leaf agree with the plain
    run."""
    import dataclasses
    from unittest import mock

    from repro_torch.configs import get_arch
    from repro_torch.core.memory import F32_POLICY
    from repro_torch.models.transformer import Model
    cfg = dataclasses.replace(get_arch(arch).smoke(), weights_dtype=weights)
    model = Model(cfg, dt=F32_POLICY, device=card)
    params = model.bind_params(model.init(seed=0))
    steps = 20
    toks = torch.randint(0, cfg.vocab_size, (steps, 2, 1), dtype=torch.int32,
                         generator=torch.Generator(device=card).manual_seed(1),
                         device=card)

    def run():
        cache = model.init_cache(2, 12)
        logits = torch.stack([model.decode_step(params, cache, t, pos=i)
                              for i, t in enumerate(toks)])
        return logits, cache

    dispatch.reset_launch_counts()
    with dispatch.stats_scope() as stats:
        kernel, kcache = run()
        torch.cuda.synchronize()
        routes = stats()
    launches = {op: n for op, n in dispatch.launch_counts().items() if n}
    if arch == "rwkv6-7b":
        want = {"matmul": steps}
    elif weights:
        want = {"matmul": steps, "quantized_matmul": 13 * steps,
                "decode_attention": steps}
    else:
        want = {"matmul": 14 * steps, "decode_attention": steps}
    assert launches == want
    assert routes and all(route == "kernel" for _, route in routes)
    again, _ = run()
    assert torch.equal(kernel, again)
    with mock.patch.object(dispatch, "_on_card", lambda op, t: False):
        plain, pcache = run()
    torch.testing.assert_close(kernel, plain, rtol=1e-4, atol=1e-4)
    for mine, ref in zip(kcache["prefix"], pcache["prefix"]):
        for k in ref:
            torch.testing.assert_close(mine[k], ref[k], rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_mrope_embedding_decode_kernels_match_plain(card, layout):
    """qwen2-vl smoke's decode step on the card, fed embeddings and three
    different M-RoPE position streams, over a dense cache or page pools:
    kernels against plain versions, B1 7 a layer plus the head and B2
    once a layer a step."""
    from unittest import mock

    from repro_torch.configs import get_arch
    from repro_torch.core.memory import F32_POLICY
    from repro_torch.models.transformer import Model
    cfg = get_arch("qwen2-vl-2b").smoke()
    model = Model(cfg, dt=F32_POLICY, device=card)
    params = model.init(seed=0)
    gen = torch.Generator(device=card).manual_seed(2)
    steps, b = 6, 2
    emb = torch.randn(steps, b, 1, cfg.d_model, generator=gen, device=card)
    pos = torch.randint(0, 30, (steps, b, 1, 3), generator=gen, device=card,
                        dtype=torch.int32)
    table = torch.arange(1, 1 + 2 * b, dtype=torch.int32,
                         device=card).view(b, 2)

    def run():
        out = []
        if layout == "dense":
            cache = model.init_cache(b, 8)
        else:
            cache = model.init_paged_cache(b, 8, 4)
        for i in range(steps):
            kw = ({"pos": i} if layout == "dense" else
                  {"paged": (torch.full((b,), i, dtype=torch.int32,
                                        device=card), table)})
            out.append(model.decode_step(params, cache, embeddings=emb[i],
                                         positions=pos[i], **kw))
        return torch.stack(out)

    dispatch.reset_launch_counts()
    kernel = run()
    torch.cuda.synchronize()
    launches = {op: n for op, n in dispatch.launch_counts().items() if n}
    n = cfg.n_layers
    assert launches == {"matmul": steps * (7 * n + 1),
                        "decode_attention": steps * n}
    with mock.patch.object(dispatch, "_on_card", lambda op, t: False):
        plain = run()
    torch.testing.assert_close(kernel, plain, rtol=1e-4, atol=1e-4)


# tensor-parallel serving's shard shapes at tp = 2 (runtime/tp.py):
# gemma-2b's column-parallel wq (N = 4 heads of 256) and up projections
# (N = 8192), its row-parallel wd (K = 8192); codeqwen1.5-7b's wq (N = 16
# heads of 128), up projections (N = 6720) and wd (K = 6720)
TP_SHARD_SHAPES = [(2048, 1024), (2048, 8192), (8192, 2048), (4096, 2048),
                   (4096, 6720), (6720, 4096)]


@pytest.mark.parametrize("k,n", TP_SHARD_SHAPES,
                         ids=lambda v: str(v))
def test_matmul_at_tp_shard_shapes(card, k, n):
    """B1 (bf16) at the shards' weight shapes: rows equal to the plain
    version, a decode-sized call's rows equal to a prefill-sized call's,
    a rerun the same bits."""
    gen = torch.Generator(device=card).manual_seed(k + n)
    a, b = _gemma_operands(card, torch.bfloat16, gen, 256, k, n, False)
    full = matmul_cuda(a, b)
    _close(full, matmul_plain(a, b), torch.bfloat16)
    assert torch.equal(matmul_cuda(a, b), full)
    assert torch.equal(matmul_cuda(a[:4].contiguous(), b), full[:4])


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantized_matmul_at_the_row_parallel_shard(card, dtype):
    """B5 at gemma-2b's row-parallel wd shard (K = 8192 of 16384, N =
    2048), its int8 weight and scales quantized from that K slice alone
    (as a rank quantizes its shard): equal to the plain version, rows
    independent of M, and the two shards' partial sums equal to the
    plain sum of the two."""
    from repro_torch.kernels.matmul import matmul as mm
    gen = torch.Generator(device=card).manual_seed(8192)
    w = torch.randn(16384, 2048, generator=gen, device=card) / 128.0
    a = torch.randn(70, 16384, generator=gen, device=card).to(dtype)
    parts = []
    for r in range(2):
        q, s = quant.quantize_channelwise(w[r * 8192:(r + 1) * 8192])
        x = a[:, r * 8192:(r + 1) * 8192].contiguous()
        out = quantized_matmul_cuda(x, q, s)
        want = quantized_matmul_plain(x, q, s)
        _close(out, want, torch.float32)
        assert torch.equal(quantized_matmul_cuda(x[:4].contiguous(), q, s),
                           out[:4])
        parts.append((out, want))
    _close(parts[0][0] + parts[1][0], parts[0][1] + parts[1][1],
           torch.float32)
    assert mm.quantized_split_plan(8192, 2048, dtype)[0] > 1


# the shards' heads: gemma-2b's 4 q heads over its one kv head (hd 256)
# and codeqwen1.5-7b's 16 over 16 (hd 128), on pages of 64
TP_SHARD_HEADS = [(4, 1, 256), (16, 16, 128)]


@pytest.mark.parametrize("h,hkv,hd", TP_SHARD_HEADS,
                         ids=lambda v: str(v))
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_attention_at_tp_shard_heads(card, h, hkv, hd, int8):
    """B2/B4a and B3/B4b (bf16 q) at the shards' heads against their plain
    versions, slot by slot; the prefill on its wgmma route."""
    from repro_torch.kernels.attention.prefill import prefill_route
    dtype = torch.bfloat16
    gen, kp, vp, table = _pools(torch.float32 if int8 else dtype, card,
                                slots=4, h=h, hkv=hkv, hd=hd, page=64,
                                n_pages=4)
    scales = ()
    if int8:
        kp, vp, ks, vs = _int8(kp, vp)
        scales = (ks, vs)
    dec = decode_attention_int8_cuda if int8 else decode_attention_cuda
    pre = prefill_attention_int8_cuda if int8 else prefill_attention_cuda
    tol = torch.float32 if int8 else dtype
    q = torch.randn(4, h, hd, generator=gen, device=card).to(dtype)
    lengths = torch.tensor([0, 65, 117, 256], dtype=torch.int32, device=card)
    out = dec(q, kp, vp, table, lengths, *scales)
    want = decode_attention_plain(q, kp, vp, table, lengths, *scales)
    _close(out, want, tol)
    _slots_close(out, want)
    q = torch.randn(4, 64, h, hd, generator=gen, device=card).to(dtype)
    starts = torch.tensor([0, 64, 128, 192], dtype=torch.int32, device=card)
    assert prefill_route(dtype, hd, h // hkv) == "wgmma"
    before = pre.routes["wgmma"]
    out = pre(q, kp, vp, table, starts, *scales)
    assert pre.routes["wgmma"] == before + 1
    want = prefill_attention_plain(q, kp, vp, table, starts, *scales)
    _close(out, want, tol)
    _slots_close(out, want)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)], ids=str)
def test_sharded_train_step_on_two_ranks_launches_as_one_process(
        card, tmp_path, shape):
    """Two ranks sharing the card over gloo run a sharded train step of a
    2-layer smoke gemma-2b (each leaf gathered at its use): each rank
    launches B1, B6 and B7 exactly as often as one process does, and no
    op takes a plain route."""
    import _torch_ranks as ranks
    want = ranks.card_train_step()
    got = ranks.spawn(ranks.card_train_worker, 2, tmp_path, shape)
    assert not want["plain"]
    for r in got:
        assert r["launches"] == want["launches"] and not r["plain"], r
        assert math.isfinite(r["loss"])
        assert abs(r["loss"] - want["loss"]) <= 5e-2 * abs(want["loss"])


# ------------------------------------------------- tuned plans (the tune path)
# small cells of every tunable op (kernels/registry.py): each plan of its
# space reaches the kernel (one launch) and stays within tolerance of the
# plain version; the int8-weight GEMM and the int8 attention branches
# compute in fp32 and are held at 2e-4
TUNE_CELLS = [
    ("matmul", (5, 4096, 256), torch.bfloat16),
    ("matmul", (5, 4096, 256), torch.float32),
    ("grouped_matmul", (3, 4, 2048, 96), torch.bfloat16),
    ("grouped_matmul", (3, 4, 2048, 96), torch.float32),
    ("quantized_matmul", (5, 4096, 256), torch.bfloat16),
    ("quantized_matmul", (5, 4096, 256), torch.float32),
    ("decode_attention", (3, 8, 2, 128, 16, 40), torch.bfloat16),
    ("decode_attention", (3, 8, 2, 128, 16, 40), torch.float32),
    ("decode_attention_int8", (3, 8, 2, 128, 16, 40), torch.bfloat16),
    ("prefill_attention", (2, 16, 8, 2, 128, 64, 12), torch.bfloat16),
    ("prefill_attention_int8", (2, 16, 8, 2, 128, 64, 12), torch.bfloat16),
    ("flash_attention", (2, 2, 130, 64), torch.bfloat16),
    ("flash_attention_bwd", (2, 2, 130, 64), torch.bfloat16),
    ("stencil", (130, 250), torch.float32),
    ("nbody", (3000,), torch.float32),
    ("histogram", (100_000, 300), torch.int32),
]


def _tune_tol(op, dtype):
    if op in ("quantized_matmul", "nbody") or "int8" in op:
        return 2e-4
    return TOLS.get(dtype, 0.0)


@pytest.mark.parametrize("op, cell, dtype", TUNE_CELLS,
                         ids=[f"{o}-{c}-{str(d)[6:]}"
                              for o, c, d in TUNE_CELLS])
def test_every_plan_of_a_space_reaches_its_kernel(card, op, cell, dtype):
    from repro_torch.kernels import registry
    spec = registry.get(op)
    args = spec.tune.make_inputs(cell, dtype, card)
    key, key_dtype = spec.key(*args)
    want = spec.plain(*args)
    want = want[0] if isinstance(want, tuple) else want
    tol = _tune_tol(op, dtype)
    space = spec.tune.space(key, key_dtype)
    assert len(space) > (op not in ("flash_attention", "flash_attention_bwd",
                                    "stencil"))
    for plan in space:
        before = spec.kernel.launches
        out = spec.tune.call(args, plan)
        out = out[0] if isinstance(out, tuple) else out
        assert spec.kernel.launches == before + 1, plan
        if dtype == torch.int32:
            assert torch.equal(out, want), plan
        elif op == "nbody":
            torch.cuda.synchronize()
            assert (out - want).abs().max() <= tol * want.abs().max(), plan
        else:
            _close(out, want, torch.float32 if tol == 2e-4 else dtype)


@pytest.mark.parametrize("op, cell, dtype", TUNE_CELLS,
                         ids=[f"{o}-{c}-{str(d)[6:]}"
                              for o, c, d in TUNE_CELLS])
def test_the_heuristic_plan_gives_the_heuristics_bits(card, op, cell, dtype):
    """Candidate 0 passed as a plan runs what no plan runs, bit for bit."""
    from repro_torch.kernels import registry
    spec = registry.get(op)
    args = spec.tune.make_inputs(cell, dtype, card)
    key, key_dtype = spec.key(*args)
    heuristic = spec.tune.space(key, key_dtype)[0]
    got, want = spec.tune.call(args, heuristic), spec.tune.call(args, None)
    for g, w in zip(*(t if isinstance(t, tuple) else (t,)
                      for t in (got, want))):
        assert torch.equal(g, w)


def test_a_cards_cache_refuses_the_plain_level(card, tmp_path):
    from repro_torch.tune import PlanCache
    cache = PlanCache(tmp_path / "plans.json")
    name = torch.cuda.get_device_name()
    with pytest.raises(ValueError, match="level 1"):
        cache.put("matmul", (2048, 1024), torch.bfloat16,
                  {"level": 1, "split": 2})
    key = cache.put("matmul", (2048, 1024), torch.bfloat16, {"split": 2})
    assert key.endswith("|" + name)
