"""The plain PyTorch version beside each CUDA kernel is held to the JAX
package's Pallas kernel (run in interpret mode on the CPU, as the JAX
package's own tests run it) and to its ``ref.py`` oracle, in fp32 at
rtol = atol = 2e-4 (tests/test_paged_decode.py's fp32 tolerance).

Inputs are drawn from seeded numpy and handed to both sides.  The CUDA
kernels themselves run only on the card (tests/test_torch_cuda.py); here
the wrappers must refuse CPU tensors and dispatch must route CPU tensors
to the plain versions.
"""
import math
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.scaling import TilePlan
from repro.kernels.attention import ref as jax_ref
from repro.kernels.attention.decode import decode_attention_pallas
from repro.kernels.attention.prefill import prefill_attention_pallas
from repro.kernels.matmul import ref as jax_mm_ref
from repro.kernels.matmul.matmul import (matmul_pallas,
                                         quantized_matmul_pallas)
from repro_torch.core import quant
from repro_torch.kernels import cuda, dispatch
from repro_torch.kernels.attention import (decode_attention_cuda,
                                           decode_attention_int8_cuda,
                                           decode_attention_plain,
                                           prefill_attention_cuda,
                                           prefill_attention_int8_cuda,
                                           prefill_attention_plain)
from repro_torch.kernels.matmul import (matmul_cuda, matmul_plain,
                                        quantized_matmul_cuda,
                                        quantized_matmul_plain)

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-4)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- matmul
def test_matmul_plain_matches_pallas_kernel():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((16, 32), np.float32)
    b = rng.standard_normal((32, 24), np.float32)
    plan = TilePlan(8, 8, 16, 0, (2, 3, 2), 0.0, 0.0)   # 2 K steps
    want = matmul_pallas(jnp.asarray(a), jnp.asarray(b), plan,
                         interpret=True)
    _close(matmul_plain(_t(a), _t(b)), want)


@pytest.mark.parametrize("m,k,n", [(5, 37, 70), (1, 130, 3), (65, 16, 257)])
def test_matmul_plain_matches_ref_on_ragged_shapes(m, k, n):
    """Ragged M/N/K: the CUDA kernel masks these edges (the Pallas kernel
    asserts divisibility, so the oracle here is ``ref.matmul_ref``)."""
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k), np.float32)
    b = rng.standard_normal((k, n), np.float32)
    want = jax_mm_ref.matmul_ref(jnp.asarray(a), jnp.asarray(b))
    _close(matmul_plain(_t(a), _t(b)), want)
    # the tied head's transposed operand gives the same product
    _close(matmul_plain(_t(a), _t(b.T.copy()).T), want)


def test_dispatch_matmul_routes_cpu_tensors_to_plain():
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((2, 3, 8), np.float32))
    w = _t(rng.standard_normal((8, 4, 5), np.float32))
    with dispatch.stats_scope() as stats:
        out = dispatch.matmul(x, w)
        assert stats() == {("matmul", "plain"): 1}
    assert out.shape == (2, 3, 4, 5)
    want = np.einsum("bsk,khd->bshd", x.numpy(), w.numpy())
    _close(out, want)


# the (K, N) pairs of gemma-2b's GEMMs: the serving and forward weights,
# the tied head, and the gradient GEMMs' (K, N) in training
GEMMA_KN = [(2048, 2048), (2048, 256), (2048, 16384), (16384, 2048),
            (2048, 256000), (256000, 2048), (1024, 2048), (1024, 256),
            (1024, 16384), (256, 2048), (128, 256000), (37, 67), (1, 1)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n", GEMMA_KN)
def test_split_plan_partitions_k_in_one_cluster(dtype, k, n):
    """The K slices of B1's split tile K exactly, in order, none empty,
    with at most 8 blocks on one output tile, each slice a whole number of
    K units but the last."""
    from repro_torch.kernels.matmul import matmul as mm
    split, per = mm.split_plan(k, n, dtype)
    assert 1 <= split <= mm.MAX_SPLIT == 8
    unit = per * mm.TILE_K[dtype]          # rank r's K range, as csrc reads it
    slices = [(min(k, r * unit), min(k, (r + 1) * unit))
              for r in range(split)]
    assert len(slices) == split
    assert slices[0][0] == 0 and slices[-1][1] == k
    for (lo, hi), (nxt, _) in zip(slices, slices[1:]):
        assert hi == nxt and hi - lo == per * mm.TILE_K[dtype]
    assert all(hi > lo for lo, hi in slices) or k == 0
    if split > 1:        # split only while N's tiles leave SMs idle
        assert split * -(-n // mm.TILE_N) <= mm.SMS
        assert all(hi - lo >= mm.MIN_SLICE or hi == k for lo, hi in slices)


def test_split_plan_depends_on_k_n_and_dtype_only():
    """The plan takes no M (so a row's K order cannot depend on how many
    rows share the call) and splits where gemma's grids are small."""
    import inspect

    from repro_torch.kernels.matmul import matmul as mm
    assert list(inspect.signature(mm.split_plan).parameters) == [
        "k", "n", "dtype", "groups"]
    bf16, f32 = torch.bfloat16, torch.float32
    assert mm.split_plan(16384, 2048, bf16) == (4, 64)     # decode wd
    assert mm.split_plan(2048, 16384, bf16) == (1, 32)     # wg / wu
    assert mm.split_plan(2048, 256000, bf16) == (1, 32)    # tied head
    assert mm.split_plan(256000, 2048, f32) == (8, 1000)   # head dx
    assert mm.split_plan(1024, 2048, f32) == (1, 32)       # dw, M=16384
    assert mm.split_plan(0, 5, f32) == (1, 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n", GEMMA_KN)
def test_quantized_split_plan_partitions_k(dtype, k, n):
    """B5's K slices tile K exactly, in order, none empty, each a whole
    number of K units but the last, with at most Q_MAX_SPLIT blocks on one
    output tile, splitting only while N's tiles leave SMs idle."""
    from repro_torch.kernels.matmul import matmul as mm
    split, per = mm.quantized_split_plan(k, n, dtype)
    assert 1 <= split <= mm.Q_MAX_SPLIT == 16
    unit = per * mm.Q_TILE_K            # rank r's K range, as csrc reads it
    slices = [(min(k, r * unit), min(k, (r + 1) * unit))
              for r in range(split)]
    assert slices[0][0] == 0 and slices[-1][1] == k
    for (lo, hi), (nxt, _) in zip(slices, slices[1:]):
        assert hi == nxt and hi - lo == unit
    assert all(hi > lo for lo, hi in slices) or k == 0
    if split > 1:
        assert split * -(-n // mm.Q_TILE_N[dtype]) <= mm.SMS
        assert all(hi - lo >= mm.Q_MIN_SLICE or hi == k for lo, hi in slices)


def test_quantized_split_plan_depends_on_k_n_and_dtype_only():
    """B5's plan takes no M (a row's K order cannot depend on how many rows
    share the call, so static and continuous serving emit the same
    streams); pinned at gemma-2b's four serving weight shapes."""
    import inspect

    from repro_torch.kernels.matmul import matmul as mm
    assert list(inspect.signature(mm.quantized_split_plan).parameters) == [
        "k", "n", "dtype"]
    bf16, f32 = torch.bfloat16, torch.float32
    assert mm.quantized_split_plan(2048, 2048, bf16) == (4, 8)     # wq, wo
    assert mm.quantized_split_plan(2048, 256, bf16) == (4, 8)      # wk, wv
    assert mm.quantized_split_plan(2048, 16384, bf16) == (1, 32)   # wg, wu
    assert mm.quantized_split_plan(16384, 2048, bf16) == (8, 32)   # wd
    assert mm.quantized_split_plan(2048, 2048, f32) == (4, 8)
    assert mm.quantized_split_plan(2048, 256, f32) == (4, 8)
    assert mm.quantized_split_plan(2048, 16384, f32) == (1, 32)
    assert mm.quantized_split_plan(16384, 2048, f32) == (4, 64)
    assert mm.quantized_split_plan(0, 5, f32) == (1, 0)


# the (n_pages, page) of decode attention's tables: the serve runs' 256-key
# table, gemma-2b's 8192-token context, the card tests' small pools, and
# ragged, long, tiny and empty tables
DECODE_TABLES = [(4, 64), (128, 64), (9, 4), (10, 64), (40, 4), (1000, 16),
                 (5, 300), (3, 1), (0, 64), (1, 64), (2048, 4)]


@pytest.mark.parametrize("hkv", [1, 4, 32])
@pytest.mark.parametrize("n_pages,page", DECODE_TABLES)
def test_decode_split_plan_covers_the_table_in_whole_pages(hkv, n_pages,
                                                           page):
    """B2/B4a's splits tile the table's keys in order, each a whole number
    of pages, none of them empty, and the last one reaching the end, with
    few kv heads (gemma-2b's 1, gemma3-4b's 4) and many (codeqwen1.5-7b's
    32)."""
    from repro_torch.kernels.attention import decode as dec
    keys, splits = dec.decode_split_plan(n_pages, page, hkv)
    assert splits >= 1 and keys > 0 and keys % page == 0
    # whole pages, at most one page past the longest split wanted
    assert keys - page < dec.MAX_SPLIT_KEYS
    total = n_pages * page
    spans = [(r * keys, min(total, (r + 1) * keys)) for r in range(splits)]
    assert spans[-1][1] == total
    assert all(lo < hi for lo, hi in spans) or total == 0
    for (_, hi), (lo, _) in zip(spans, spans[1:]):
        assert hi == lo


def test_decode_split_plan_depends_on_shapes_only():
    """The plan takes the table's and the pools' shapes and nothing of the
    batch or the lengths; pinned at the serving table, gemma-2b's long
    context, and deepseek-67b's 8 and codeqwen1.5-7b's 32 kv heads there
    (the values PERF.md measured); 8 kv heads on the serving table."""
    import inspect

    from repro_torch.kernels.attention import decode as dec
    assert list(inspect.signature(dec.decode_split_plan).parameters) == [
        "n_pages", "page", "hkv"]
    assert dec.decode_split_plan(4, 64, 1) == (64, 4)
    assert dec.decode_split_plan(128, 64, 1) == (128, 64)
    assert dec.decode_split_plan(128, 64, 8) == (1024, 8)
    assert dec.decode_split_plan(128, 64, 32) == (1024, 8)
    assert dec.decode_split_plan(4, 64, 8) == (64, 4)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_decode_split_plan_is_one_for_static_and_continuous_serving(
        monkeypatch, int8):
    """The serve run's tables are (slots, max_len / page) under either
    schedule, so every decode call of both runs takes one plan and a slot's
    bits cannot depend on which slots share its batch."""
    from repro_torch.kernels.attention import decode as dec
    from repro_torch.launch import serve
    plain, plans = dispatch.decode_attention_plain, set()

    def recording(q, k_pages, v_pages, table, lengths, *scales, window=0):
        plans.add(dec.decode_split_plan(table.shape[1], k_pages.shape[1],
                                        k_pages.shape[2]))
        return plain(q, k_pages, v_pages, table, lengths, *scales,
                     window=window)

    monkeypatch.setattr(dispatch, "decode_attention_plain", recording)
    extra = ["--kv-dtype", "int8", "--weights-dtype", "int8"] if int8 else []
    seen = {}
    for schedule in ("static", "continuous"):
        plans.clear()
        serve.main(["--arch", "gemma-2b", "--smoke", "--cache", "paged",
                    "--slots", "2", "--requests", "3", "--prompt-len", "6",
                    "--max-new", "3", "--max-len", "160", "--page-size",
                    "4", "--schedule", schedule, "--clock", "tick",
                    "--device", "cpu", *extra])
        seen[schedule] = set(plans)
    assert seen["static"] == seen["continuous"] == {(64, 3)}


@pytest.mark.parametrize("n_pages,page,hkv,grp,c,hd", [
    (4, 64, 1, 8, 64, 256), (128, 64, 1, 8, 64, 256),
    (128, 64, 32, 1, 64, 128), (160, 16, 2, 4, 64, 64),
    (600, 4, 1, 8, 64, 64), (20, 128, 2, 2, 64, 128), (7, 100, 2, 4, 16, 128),
    (1, 8, 1, 1, 8, 256), (0, 64, 1, 8, 64, 256), (3000, 3, 4, 16, 32, 128),
    (300000, 1, 1, 1, 64, 256), (5000, 2, 1, 2, 16, 64)])
def test_prefill_split_plan_covers_the_table_in_whole_pages(
        n_pages, page, hkv, grp, c, hd):
    """B3/B4b's splits on the wgmma route tile the table's keys in order,
    each a whole number of pages and of 64-key tiles, none of them empty,
    and the last one reaching the end."""
    from repro_torch.kernels.attention import prefill as pre
    keys, splits = pre.prefill_split_plan(n_pages, page, hkv, grp, c, hd)
    assert splits >= 1 and keys > 0 and keys % page == 0 and keys % 64 == 0
    # whole pages and tiles, at most one unit past the longest split
    # wanted, and a page list that fits beside the tiles
    assert keys - math.lcm(page, 64) < pre.MAX_SPLIT_KEYS
    assert keys - math.lcm(page, 64) < pre.MAX_SPLIT_PAGES * page
    total = n_pages * page
    spans = [(r * keys, min(total, (r + 1) * keys)) for r in range(splits)]
    assert spans[-1][1] == total or (total == 0 and splits == 1)
    assert all(lo < hi for lo, hi in spans) or total == 0
    for (_, hi), (lo, _) in zip(spans, spans[1:]):
        assert hi == lo


def test_prefill_split_plan_depends_on_shapes_only():
    """The plan takes the table's, the pools' and the chunk's shapes and
    nothing of the batch or the starts; pinned at the serving table (one
    split), gemma-2b's 8192-token context and codeqwen1.5-7b's 32 kv heads
    there (the values PERF.md measured)."""
    import inspect

    from repro_torch.kernels.attention import prefill as pre
    assert list(inspect.signature(pre.prefill_split_plan).parameters) == [
        "n_pages", "page", "hkv", "grp", "c", "hd"]
    assert pre.prefill_split_plan(4, 64, 1, 8, 64, 256) == (512, 1)
    assert pre.prefill_split_plan(128, 64, 1, 8, 64, 256) == (512, 16)
    assert pre.prefill_split_plan(128, 64, 32, 1, 64, 128) == (4096, 2)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_prefill_split_plan_is_one_for_static_and_continuous_serving(
        monkeypatch, int8):
    """The serve run's prefill calls take (B, page) chunks over (B,
    max_len / page) tables under either schedule (B = 1 static, up to the
    slots continuous), so every prefill call of both runs takes one plan
    and a slot's bits cannot depend on which slots share its call."""
    from repro_torch.kernels.attention import prefill as pre
    from repro_torch.launch import serve
    plain, plans, batches = dispatch.prefill_attention_plain, set(), set()

    def recording(q, k_pages, v_pages, table, starts, *scales, window=0):
        b, c, h, hd = q.shape
        hkv = k_pages.shape[2]
        plans.add(pre.prefill_split_plan(table.shape[1], k_pages.shape[1],
                                         hkv, h // hkv, c, hd))
        batches.add(b)
        return plain(q, k_pages, v_pages, table, starts, *scales,
                     window=window)

    monkeypatch.setattr(dispatch, "prefill_attention_plain", recording)
    extra = ["--kv-dtype", "int8", "--weights-dtype", "int8"] if int8 else []
    seen = {}
    for schedule in ("static", "continuous"):
        plans.clear()
        serve.main(["--arch", "gemma-2b", "--smoke", "--cache", "paged",
                    "--slots", "2", "--requests", "3", "--prompt-len", "6",
                    "--max-new", "3", "--max-len", "160", "--page-size",
                    "4", "--schedule", schedule, "--clock", "tick",
                    "--device", "cpu", *extra])
        seen[schedule] = set(plans)
    assert len(seen["static"]) == 1 and seen["static"] == seen["continuous"]
    assert batches == {1, 2}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [32, 64, 96, 128, 256, 512])
@pytest.mark.parametrize("grp", [1, 2, 3, 4, 8, 16, 64, 128])
def test_prefill_route_is_wgmma_exactly_for_bf16_tiles(dtype, hd, grp):
    """The wgmma route takes bf16 q at the head widths it is built for
    (64, 128, 256) where 64-row tiles hold whole tokens (grp divides 64);
    everything else runs on the simt route."""
    from repro_torch.kernels.attention.prefill import prefill_route
    want = dtype == torch.bfloat16 and hd in (64, 128, 256) and 64 % grp == 0
    assert prefill_route(dtype, hd, grp) == ("wgmma" if want else "simt")


def test_matmul_operand_checks():
    from repro_torch.kernels.matmul import matmul as mm
    a = torch.zeros(4, 8)
    mm.check_operands(a, torch.zeros(8, 3))
    mm.check_operands(a, torch.zeros(3, 8).T)              # K-contiguous
    with pytest.raises(ValueError, match="unit stride"):
        mm.check_operands(a, torch.zeros(16, 6)[::2, ::2])
    with pytest.raises(ValueError, match="contiguous"):
        mm.check_operands(torch.zeros(8, 4).T, torch.zeros(8, 3))
    with pytest.raises(ValueError, match="want"):
        mm.check_operands(a, torch.zeros(7, 3))
    with pytest.raises(TypeError):
        mm.check_operands(a, torch.zeros(8, 3, dtype=torch.bfloat16))


def test_row_tile_limits():
    """B1's grid holds 65535 row tiles of 128, B5's of 64."""
    from repro_torch.kernels.matmul import matmul as mm
    mm._check_rows("matmul", 65535 * 128, mm.TILE_M)
    with pytest.raises(ValueError, match="row tiles of 128"):
        mm._check_rows("matmul", 65535 * 128 + 1, mm.TILE_M)
    with pytest.raises(ValueError, match="row tiles of 64"):
        mm._check_rows("quantized_matmul", 65535 * 64 + 1, 64)


# ------------------------------------------------------ quantized matmul
def _int8_weight(rng, k, n):
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    q, s = quant.quantize_channelwise(_t(w))
    return q, s


def test_quantized_matmul_plain_matches_pallas_kernel():
    """B5's plain version (dequantize, then an fp32 product) against the
    TPU kernel (scale applied once at the K flush), in interpret mode,
    with bf16 and fp32 activations."""
    rng = np.random.default_rng(20)
    q, s = _int8_weight(rng, 32, 24)
    plan = TilePlan(8, 8, 16, 0, (2, 3, 2), 0.0, 0.0)   # 2 K steps
    for dtype in (torch.float32, torch.bfloat16):
        a = _t(rng.standard_normal((16, 32)).astype(np.float32)).to(dtype)
        ja = jnp.asarray(a.float().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
        want = quantized_matmul_pallas(ja, jnp.asarray(q.numpy()),
                                       jnp.asarray(s.numpy()), plan,
                                       interpret=True)
        got = quantized_matmul_plain(a, q, s)
        assert got.dtype == torch.float32
        _close(got, want)


@pytest.mark.parametrize("m,k,n", [(5, 37, 70), (1, 130, 3), (65, 16, 257)])
def test_quantized_matmul_plain_matches_ref_on_ragged_shapes(m, k, n):
    rng = np.random.default_rng(m + k + n + 1)
    q, s = _int8_weight(rng, k, n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    want = jax_mm_ref.quantized_matmul_ref(
        jnp.asarray(a), jnp.asarray(q.numpy()), jnp.asarray(s.numpy()))
    _close(quantized_matmul_plain(_t(a), q, s), want)


def test_dispatch_quantized_matmul_routes_cpu_tensors_to_plain():
    rng = np.random.default_rng(21)
    q, s = _int8_weight(rng, 8, 20)
    x = _t(rng.standard_normal((2, 3, 8)).astype(np.float32))
    with dispatch.stats_scope() as stats:
        out = dispatch.quantized_matmul(x, q, s)
        assert stats() == {("quantized_matmul", "plain"): 1}
    assert out.shape == (2, 3, 20) and out.dtype == torch.float32
    _close(out, np.einsum("bsk,kn->bsn", x.numpy(),
                          quant.dequantize(q, s).numpy()))


# ------------------------------------------------------------ attention
def _paged(rng, *, slots, h, hkv, hd, page, n_pages):
    pool = 1 + slots * n_pages
    kp = (0.5 * rng.standard_normal((pool, page, hkv, hd))).astype(
        np.float32)
    vp = (0.5 * rng.standard_normal((pool, page, hkv, hd))).astype(
        np.float32)
    table = (1 + rng.permutation(pool - 1)[:slots * n_pages]).reshape(
        slots, n_pages).astype(np.int32)
    return kp, vp, table


# (grp, window): GQA groups 1/4/8, with and without a sliding window
CASES = [(1, 0), (4, 0), (8, 0), (4, 6)]


@pytest.mark.parametrize("grp,window", CASES)
def test_decode_plain_matches_pallas_and_ref(grp, window):
    """Ragged lengths incl. an inactive slot (0 -> zeros), one token, a
    page boundary and a full table; pages_per_tile=3 does not divide the
    4 logical pages, so the Pallas kernel pads its table."""
    rng = np.random.default_rng(grp * 10 + window)
    hkv, hd, page, n_pages = 2, 16, 4, 4
    kp, vp, table = _paged(rng, slots=4, h=grp * hkv, hkv=hkv, hd=hd,
                           page=page, n_pages=n_pages)
    q = (0.5 * rng.standard_normal((4, grp * hkv, hd))).astype(np.float32)
    lengths = np.asarray([0, 1, 9, 16], np.int32)
    ours = decode_attention_plain(_t(q), _t(kp), _t(vp), _t(table),
                                  _t(lengths), window=window)
    args = tuple(map(jnp.asarray, (q, kp, vp, table, lengths)))
    _close(ours, decode_attention_pallas(*args, window=window,
                                         pages_per_tile=3, interpret=True))
    _close(ours, jax_ref.decode_attention_ref(*args, window=window))
    assert float(ours[0].abs().max()) == 0.0


@pytest.mark.parametrize("grp,window", CASES)
def test_prefill_plain_matches_pallas_and_ref(grp, window):
    """Chunks at a fresh start, behind one page of history and behind
    two (the causal mask kpos <= start + row // grp), with
    pages_per_tile=3 not dividing the 4 logical pages."""
    rng = np.random.default_rng(100 + grp * 10 + window)
    hkv, hd, page, n_pages = 2, 16, 4, 4
    kp, vp, table = _paged(rng, slots=3, h=grp * hkv, hkv=hkv, hd=hd,
                           page=page, n_pages=n_pages)
    q = (0.5 * rng.standard_normal((3, page, grp * hkv, hd))).astype(
        np.float32)
    starts = np.asarray([0, 4, 8], np.int32)
    ours = prefill_attention_plain(_t(q), _t(kp), _t(vp), _t(table),
                                   _t(starts), window=window)
    args = tuple(map(jnp.asarray, (q, kp, vp, table, starts)))
    _close(ours, prefill_attention_pallas(*args, window=window,
                                          pages_per_tile=3, interpret=True))
    _close(ours, jax_ref.prefill_attention_ref(*args, window=window))


# Quantization noise bound of the int8 pools against the fp32 oracle
# (tests/test_paged_decode.py's INT8_KV_MAX_ABS_ERR)
INT8_KV_MAX_ABS_ERR = 5e-2


def _int8_pools(kp, vp):
    kq, ks = quant.quantize_pages(_t(kp))
    vq, vs = quant.quantize_pages(_t(vp))
    return kq, vq, ks, vs


@pytest.mark.parametrize("grp,window", CASES)
def test_decode_int8_plain_matches_pallas_and_ref(grp, window):
    """int8 pools with their scales: the plain version dequantizes at
    gather time, the TPU kernel at tile load (interpret mode); both agree
    at fp32 tolerance and stay within the quantization bound of the fp32
    oracle."""
    rng = np.random.default_rng(200 + grp * 10 + window)
    hkv, hd, page, n_pages = 2, 16, 4, 4
    kp, vp, table = _paged(rng, slots=4, h=grp * hkv, hkv=hkv, hd=hd,
                           page=page, n_pages=n_pages)
    kq, vq, ks, vs = _int8_pools(kp, vp)
    q = (0.5 * rng.standard_normal((4, grp * hkv, hd))).astype(np.float32)
    lengths = np.asarray([0, 1, 9, 16], np.int32)
    ours = decode_attention_plain(_t(q), kq, vq, _t(table), _t(lengths),
                                  ks, vs, window=window)
    jargs = tuple(map(jnp.asarray, (q, kq.numpy(), vq.numpy(), table,
                                    lengths, ks.numpy(), vs.numpy())))
    _close(ours, decode_attention_pallas(*jargs, window=window,
                                         pages_per_tile=3, interpret=True))
    _close(ours, jax_ref.decode_attention_ref(*jargs, window=window))
    full = decode_attention_plain(_t(q), _t(kp), _t(vp), _t(table),
                                  _t(lengths), window=window)
    assert float((ours - full).abs().max()) < INT8_KV_MAX_ABS_ERR
    assert float(ours[0].abs().max()) == 0.0


@pytest.mark.parametrize("grp,window", CASES)
def test_prefill_int8_plain_matches_pallas_and_ref(grp, window):
    rng = np.random.default_rng(300 + grp * 10 + window)
    hkv, hd, page, n_pages = 2, 16, 4, 4
    kp, vp, table = _paged(rng, slots=3, h=grp * hkv, hkv=hkv, hd=hd,
                           page=page, n_pages=n_pages)
    kq, vq, ks, vs = _int8_pools(kp, vp)
    q = (0.5 * rng.standard_normal((3, page, grp * hkv, hd))).astype(
        np.float32)
    starts = np.asarray([0, 4, 8], np.int32)
    ours = prefill_attention_plain(_t(q), kq, vq, _t(table), _t(starts),
                                   ks, vs, window=window)
    jargs = tuple(map(jnp.asarray, (q, kq.numpy(), vq.numpy(), table,
                                    starts, ks.numpy(), vs.numpy())))
    _close(ours, prefill_attention_pallas(*jargs, window=window,
                                          pages_per_tile=3, interpret=True))
    _close(ours, jax_ref.prefill_attention_ref(*jargs, window=window))
    full = prefill_attention_plain(_t(q), _t(kp), _t(vp), _t(table),
                                   _t(starts), window=window)
    assert float((ours - full).abs().max()) < INT8_KV_MAX_ABS_ERR


def test_int8_attention_keeps_p_in_fp32_for_bf16_queries():
    """With int8 pools V is fp32 after dequantization, so P is not rounded
    to bf16 before P @ V even when q is bf16: the result equals the fp32
    computation on the bf16-rounded q."""
    rng = np.random.default_rng(8)
    kp, vp, table = _paged(rng, slots=2, h=8, hkv=1, hd=16, page=4,
                           n_pages=3)
    kq, vq, ks, vs = _int8_pools(kp, vp)
    q = _t((0.5 * rng.standard_normal((2, 8, 16))).astype(np.float32))
    lengths = _t(np.asarray([5, 12], np.int32))
    got = decode_attention_plain(q.to(torch.bfloat16), kq, vq, _t(table),
                                 lengths, ks, vs)
    want = decode_attention_plain(q.to(torch.bfloat16).float(), kq, vq,
                                  _t(table), lengths, ks, vs)
    assert torch.equal(got, want)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: no quiet CPU fallback."""
    q = torch.zeros(1, 2, 8)
    pools = torch.zeros(3, 4, 1, 8)
    table = torch.ones(1, 2, dtype=torch.int32)
    ones = torch.ones(1, dtype=torch.int32)
    before = dispatch.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        matmul_cuda(torch.zeros(2, 3), torch.zeros(3, 4))
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(q, pools, pools, table, ones)
    with pytest.raises(ValueError, match="CUDA"):
        prefill_attention_cuda(q[:, None], pools, pools, table, ones)
    pools8 = torch.zeros(3, 4, 1, 8, dtype=torch.int8)
    scales = torch.zeros(3, 1)
    with pytest.raises(ValueError, match="CUDA"):
        quantized_matmul_cuda(torch.zeros(2, 3), torch.zeros(
            3, 4, dtype=torch.int8), torch.zeros(4))
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_int8_cuda(q, pools8, pools8, table, ones, scales,
                                   scales)
    with pytest.raises(ValueError, match="CUDA"):
        prefill_attention_int8_cuda(q[:, None], pools8, pools8, table, ones,
                                    scales, scales)
    from repro_torch.kernels.attention import (flash_attention_bwd_cuda,
                                               flash_attention_cuda)
    bhsd = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(bhsd, bhsd, bhsd)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(bhsd, bhsd, bhsd, bhsd, bhsd[..., 0], bhsd)
    from repro_torch.kernels.histogram import histogram_cuda
    from repro_torch.kernels.nbody import nbody_accel_cuda
    from repro_torch.kernels.stencil import jacobi4_cuda
    from repro_torch.kernels.wkv import wkv_cuda
    bshd = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        wkv_cuda(bshd, bshd, bshd, bshd, torch.zeros(2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        jacobi4_cuda(torch.zeros(4, 5))
    with pytest.raises(ValueError, match="CUDA"):
        nbody_accel_cuda(torch.zeros(3, 6), torch.zeros(6))
    with pytest.raises(ValueError, match="CUDA"):
        histogram_cuda(torch.zeros(6, dtype=torch.int32))
    from repro_torch.kernels.matmul import grouped_matmul_cuda
    with pytest.raises(ValueError, match="CUDA"):
        grouped_matmul_cuda(torch.zeros(2, 3, 4), torch.zeros(2, 4, 5))
    assert dispatch.launch_counts() == before
    assert set(before) == {"matmul", "grouped_matmul", "quantized_matmul",
                           "decode_attention", "decode_attention_int8",
                           "prefill_attention", "prefill_attention_int8",
                           "flash_attention", "flash_attention_bwd", "wkv",
                           "wkv_bwd", "stencil", "nbody", "histogram"}


def test_dispatch_attention_routes_by_device():
    rng = np.random.default_rng(7)
    kp, vp, table = _paged(rng, slots=2, h=4, hkv=2, hd=8, page=4,
                           n_pages=2)
    q = _t(rng.standard_normal((2, 4, 8)).astype(np.float32))
    lengths = _t(np.asarray([3, 8], np.int32))
    with dispatch.stats_scope() as stats:
        out = dispatch.decode_attention(q, _t(kp), _t(vp), _t(table),
                                        lengths, out_dtype=torch.bfloat16)
        pre = dispatch.prefill_attention(q[:, None], _t(kp), _t(vp),
                                         _t(table), lengths)
        assert stats() == {("decode_attention", "plain"): 1,
                           ("prefill_attention", "plain"): 1}
    assert out.dtype == torch.bfloat16 and pre.dtype == torch.float32
    # int8 pools with scales take the int8 branch, counted under its name
    kq, vq, ks, vs = _int8_pools(kp, vp)
    with dispatch.stats_scope() as stats:
        out8 = dispatch.decode_attention(q, kq, vq, _t(table), lengths,
                                         ks, vs)
        dispatch.prefill_attention(q[:, None], kq, vq, _t(table), lengths,
                                   ks, vs)
        assert stats() == {("decode_attention_int8", "plain"): 1,
                           ("prefill_attention_int8", "plain"): 1}
    assert float((out8 - out.float()).abs().max()) < INT8_KV_MAX_ABS_ERR


# ----------------------------------------------------------------- build
def test_library_path_follows_sources(tmp_path, monkeypatch):
    """The build directory is named by a hash of the sources: an edited
    source rebuilds, an unchanged one reuses the library."""
    src = tmp_path / "csrc"
    shutil.copytree(cuda.CSRC, src)
    monkeypatch.setattr(cuda, "CSRC", src)
    monkeypatch.setattr(cuda, "BUILD_ROOT", tmp_path / "build")
    first = cuda.library_path()
    assert first == cuda.library_path()
    assert first.parent.parent == tmp_path / "build"
    (src / "matmul.cu").write_text((src / "matmul.cu").read_text() + "\n")
    assert cuda.library_path() != first


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(cuda.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda.build()


def test_c_int_arguments_are_range_checked():
    assert cuda.c_ints("k", 0, 2 ** 31 - 1) == (0, 2 ** 31 - 1)
    for bad in (-1, 2 ** 31):
        with pytest.raises(ValueError, match="C int"):
            cuda.c_ints("k", bad)


# ------------------------------------------------------------ tile plans
@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 40, "simt"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 512, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 256, "simt")])
def test_flash_route_follows_dtype_and_head_width(dtype, hd, route):
    from repro_torch.kernels.attention.flash import flash_route
    assert flash_route(dtype, hd) == route


def test_flash_simt_route_limits_match_shared_memory():
    """The simt route's tiles fit up to hd 445 (forward) and 291
    (backward); the wgmma route has no such limit at its widths."""
    from repro_torch.kernels.attention.flash import (check_route,
                                                     simt_smem_bytes)
    assert simt_smem_bytes(445) <= cuda.MAX_SMEM_BYTES < simt_smem_bytes(446)
    assert (simt_smem_bytes(291, bwd=True) <= cuda.MAX_SMEM_BYTES
            < simt_smem_bytes(292, bwd=True))
    assert check_route("f", torch.bfloat16, 256, bwd=True) == "wgmma"
    assert check_route("f", torch.float32, 256, bwd=True) == "simt"
    with pytest.raises(ValueError, match="simt"):
        check_route("f", torch.float32, 300, bwd=True)
    with pytest.raises(ValueError, match="simt"):
        check_route("f", torch.bfloat16, 512)


def test_flash_alignment_check_refuses_misaligned_data():
    """The wgmma route's TMA and 16-byte loads read only from 16-byte
    aligned data: an aligned tensor passes, a view one element past the
    boundary raises."""
    from repro_torch.kernels.attention.flash import check_aligned16
    flat = torch.zeros(1 + 4 * 64, dtype=torch.bfloat16)
    aligned = torch.zeros(4, 64, dtype=torch.bfloat16)
    check_aligned16("f", aligned, aligned)
    odd = flat[1:].view(4, 64)     # PyTorch aligns allocations to 64 bytes
    assert odd.data_ptr() % 16 and odd.is_contiguous()
    with pytest.raises(ValueError, match="16-byte"):
        check_aligned16("f", aligned, odd)


@pytest.mark.parametrize("c,hd,want", [
    (64, 64, (64, 64)), (64, 128, (64, 64)), (64, 256, (64, 64)),
    (256, 64, (64, 64)), (12, 64, (12, 64)), (17, 8, (17, 8)),
    (64, 565, (64, 64)), (64, 566, (64, 32)), (64, 4096, (64, 4)),
    (64, 13781, (64, 1))])
def test_wkv_tiles_fit_shared_memory(c, hd, want):
    """Row pieces of min(c, 64); value-column blocks of min(hd, 64),
    halved only where the state's columns do not fit; rwkv6-7b's case
    (c = hd = 64) keeps the 100 KB block that puts two on an SM."""
    from repro_torch.kernels.wkv.wkv import smem_bytes, wkv_tiles
    assert wkv_tiles(c, hd) == want
    assert smem_bytes(*want, hd) <= cuda.MAX_SMEM_BYTES
    if c == hd == 64:
        assert 2 * smem_bytes(*want, hd) <= 228 * 1024 - 2 * 1024


def test_wkv_tiles_raise_only_past_one_state_column():
    from repro_torch.kernels.wkv.wkv import wkv_tiles
    with pytest.raises(ValueError, match="head width"):
        wkv_tiles(64, 13782)


@pytest.mark.parametrize("s", [12, 64, 96, 300, 4096])
def test_wkv_subchunk_and_route_follow_wkv_pallas(monkeypatch, s):
    """Over chunks and sub-chunks, the chunk and sub-chunk lengths the
    port resolves are the ones ``wkv_pallas`` builds its kernel with
    (repro/kernels/wkv/wkv.py:106-111, read off its kernel's arguments
    with ``pallas_call`` stubbed), and the mma route takes a shape only
    where its pieces are whole sub-chunks of 8-row multiples that divide
    the chunk."""
    import importlib
    from repro_torch.kernels.wkv.wkv import (MMA_HEAD_DIMS, subchunk_len,
                                             wkv_piece, wkv_route)
    from repro_torch.models.rwkv import chunk_len
    # the module; the package's attribute of that name is the op
    jax_wkv = importlib.import_module("repro.kernels.wkv.wkv")
    seen = {}

    def pallas_call(kernel, **_):
        seen.update(kernel.keywords)
        return lambda *args: None
    monkeypatch.setattr(jax_wkv.pl, "pallas_call", pallas_call)
    x = np.zeros((1, s, 64), np.float32)
    for chunk in (1, 16, 32, 64, 100, 128, 150, 256):
        for subchunk in (1, 3, 8, 16, 32, 64):
            jax_wkv.wkv_pallas(x, x, x, x, x[:, :1], chunk=chunk,
                               subchunk=subchunk)
            c = chunk_len(s, chunk)
            assert (seen["c"], seen["sc"]) == (c, subchunk_len(c, subchunk))
            sc = seen["sc"]
            piece = wkv_piece(c, sc)
            if piece:
                assert c % piece == 0 and piece % sc == 0
            for hd in (16, 32, 64, 100, 128, 256):
                for dtype in (torch.float32, torch.bfloat16):
                    route = wkv_route(c, sc, hd, dtype)
                    assert route == ("mma" if (
                        hd in MMA_HEAD_DIMS and sc % 8 == 0 and piece
                        and not (hd == 128 and dtype == torch.float32))
                        else "simt"), (c, sc, hd, dtype)


def test_wkv_rejects_subchunk_below_one_on_either_route():
    from repro_torch.kernels.wkv import wkv
    from repro_torch.kernels.wkv.wkv import subchunk_len
    bshd = torch.zeros(1, 4, 2, 8)
    with dispatch.stats_scope() as stats:
        with pytest.raises(ValueError, match="subchunk"):
            wkv(bshd, bshd, bshd, bshd, torch.zeros(2, 8), subchunk=0)
        assert stats() == {}
    with pytest.raises(ValueError, match="subchunk"):
        subchunk_len(64, 0)


@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, 1000, 16128, 65536,
                               65537, 1 << 20])
def test_nbody_split_plan_covers_every_source_once(n):
    """Split s takes sources [s * per, min(N, (s + 1) * per)): every
    source in exactly one split, whole tiles a split, the plan a function
    of N alone, and N = 16128 spread over at least 4 blocks an SM's worth
    of splits."""
    from repro_torch.kernels.nbody.nbody import (SOURCE_TILE,
                                                 TARGETS_PER_BLOCK,
                                                 nbody_split_plan)
    splits, per = nbody_split_plan(n)
    assert (splits, per) == nbody_split_plan(n)
    assert per % SOURCE_TILE == 0 and splits >= 1
    seen = np.zeros(n, np.int64)
    for s_ in range(splits):
        seen[s_ * per:min(n, (s_ + 1) * per)] += 1
    assert (seen == 1).all()
    assert (splits - 1) * per < n <= splits * per
    if n == 16128:                    # at least 4 blocks an SM of 132
        assert -(-n // TARGETS_PER_BLOCK) * splits >= 4 * 132


@pytest.mark.parametrize("n_bins,window,windows", [
    (1, 1, 1), (256, 256, 1), (58_112, 58_112, 1), (58_113, 58_112, 2),
    (100_000, 58_112, 2), (1 << 20, 58_112, 19)])
def test_histogram_bin_windows(n_bins, window, windows):
    """One window of all the bins while they fit a block's shared memory
    (the shared route takes them), else as many as fit: 2^20 bins span 19
    such windows, which the one-pass route reads the values once for."""
    from repro_torch.kernels.histogram.histogram import bin_window
    assert bin_window(n_bins) == window
    assert 4 * window <= cuda.MAX_SMEM_BYTES
    assert -(-n_bins // window) == windows


@pytest.mark.parametrize("n_bins,route", [
    (1, "shared"), (256, "shared"), (58_112, "shared"), (58_113, "global"),
    (100_000, "global"), (1 << 20, "global")])
def test_histogram_route_follows_n_bins(n_bins, route):
    """B11's route is a function of n_bins alone, never of the data: the
    shared-memory histogram while every bin fits one block, else the
    one-pass route into the output."""
    import inspect

    from repro_torch.kernels.histogram.histogram import (ROUTES,
                                                         histogram_route)
    assert list(inspect.signature(histogram_route).parameters) == ["n_bins"]
    assert histogram_route(n_bins) == route
    assert set(ROUTES) == {"shared", "global"}
    with pytest.raises(ValueError):
        histogram_route(0)


def test_c_signatures_match_the_sources():
    """Every C entry point of the kernel sources is declared to ctypes with
    its own arity and argument kinds (pointers, ints, floats): a missing
    or extra argument would only show as a launch on the card."""
    import ctypes
    import re
    found = {}
    for source in sorted(cuda.CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (repro_\w+)\(([^)]*)\)',
                                       source.read_text(), re.S):
            found[name] = [
                ctypes.c_void_p if "*" in prm
                else ctypes.c_float if prm.split()[0] == "float"
                else ctypes.c_int for prm in params.split(",")]
    assert found == cuda.SIGNATURES


def test_kernel_variant_edits_match_the_sources():
    """tools/kernel_variants.py builds B5 and B11 variants by exact text
    edits of the kernel sources; each edit matches the shipped source
    once, so the measurements PERF.md cites can be made again."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / "kernel_variants.py"
    spec = importlib.util.spec_from_file_location("kernel_variants", path)
    variants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(variants)
    for name, (source, edits) in variants.VARIANTS.items():
        assert (cuda.CSRC / source).exists(), name
        texts = {}
        for file, old, new in edits:
            text = texts.get(file, (cuda.CSRC / file).read_text())
            assert text.count(old) == 1, (name, file)
            texts[file] = text.replace(old, new)


def test_route_counts_reset_with_the_launch_counts():
    from repro_torch.kernels.attention import (flash_attention_bwd_cuda,
                                               flash_attention_cuda)
    flash_attention_cuda.routes["wgmma"] += 2
    flash_attention_bwd_cuda.routes["simt"] += 1
    assert dispatch.route_counts()["flash_attention/wgmma"] >= 2
    dispatch.reset_launch_counts()
    assert dispatch.route_counts() == {
        **{f"{op}/{route}": 0 for op in ("prefill_attention",
                                         "prefill_attention_int8",
                                         "flash_attention",
                                         "flash_attention_bwd")
           for route in ("wgmma", "simt")},
        "wkv/mma": 0, "wkv/simt": 0, "wkv_bwd/mma": 0,
        "grouped_matmul/wgmma": 0, "grouped_matmul/wgmma_short": 0,
        "grouped_matmul/simt": 0}
