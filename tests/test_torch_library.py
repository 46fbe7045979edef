"""The kernel library's four public ops -- WKV, the Jacobi stencil,
N-body and the histogram -- on the CPU (their plain PyTorch versions)
against the JAX package's public ops, run with ``interpret=True`` as
``tests/test_kernels.py`` and ``tests/test_kernels_wkv.py`` run them.

Inputs are drawn from seeded numpy and handed to both sides.
Tolerances are the JAX tests' own: wkv rtol = atol = 1e-4
(test_kernels_wkv.py), the stencil 1e-5 in fp32 (test_kernels.py),
N-body 2e-4, the histogram exact.  The CUDA kernels run only on the card
(tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.histogram import histogram as jax_histogram
from repro.kernels.histogram.histogram import histogram_pallas
from repro.kernels.histogram.ref import histogram_ref
from repro.kernels.nbody import nbody_accel as jax_nbody_accel
from repro.kernels.stencil import jacobi4 as jax_jacobi4
from repro.kernels.wkv import wkv as jax_wkv
from repro.models import rwkv as jax_rwkv
from repro_torch.kernels import dispatch
from repro_torch.kernels.histogram import histogram
from repro_torch.kernels.nbody import nbody_accel
from repro_torch.kernels.stencil import jacobi4
from repro_torch.kernels.wkv import wkv
from repro_torch.models import rwkv

torch.set_num_threads(1)


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


def _j(x, dtype=None):
    a = jnp.asarray(x)
    return a if dtype is None else a.astype(dtype)


def _wkv_inputs(seed, b, s, h, hd, decay_shift=-2.0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    lw = -np.exp(rng.standard_normal((b, s, h, hd)) + decay_shift) \
        .astype(np.float32)
    u = rng.standard_normal((h, hd)).astype(np.float32)
    return r, k, v, lw, u


# ------------------------------------------------------------------ wkv
@pytest.mark.parametrize("shape,chunk,sub,dtype", [
    ((2, 64, 2, 16), 32, 8, "float32"),
    ((1, 48, 3, 32), 32, 16, "float32"),     # S % chunk != 0: c = 16
    ((1, 64, 2, 64), 64, 16, "float32"),     # rwkv6-7b's head width
    ((2, 32, 2, 16), 16, 8, "bfloat16"),
    ((1, 64, 2, 128), 32, 16, "float32"),    # wider than one column block
])
def test_wkv_matches_jax_op(shape, chunk, sub, dtype):
    r, k, v, lw, u = _wkv_inputs(sum(shape), *shape)
    want = jax_wkv(*(_j(x, dtype) for x in (r, k, v)), _j(lw), _j(u),
                   chunk=chunk, subchunk=sub, interpret=True)
    with dispatch.stats_scope() as stats:
        got = wkv(*(_t(x, getattr(torch, dtype)) for x in (r, k, v)),
                  _t(lw), _t(u), chunk=chunk, subchunk=sub)
        assert stats() == {("wkv", "plain"): 1}
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("case", ["constant", "random"])
def test_wkv_strong_decay_matches_jax_op(case):
    """Strong decay (tests/test_kernels_wkv.py:48): cum reaches -1440 in
    a chunk, where exp(-cum) would overflow; every exponent must stay
    <= 0.  The random case draws decays in [-50, -20] on a grid of 1/4,
    so every cumsum is exact in fp32: at |cum| ~ 1000 one rounding of the
    cumsum (1.2e-4, and jnp.cumsum and torch.cumsum round differently)
    moves the weight of the previous token by that much, which is fp32's
    conditioning, not the algorithm."""
    shape = (1, 64, 1, 16)
    if case == "constant":
        r = k = v = np.ones(shape, np.float32)
        lw = np.full(shape, -45.0, np.float32)
        u = np.zeros((1, 16), np.float32)
    else:
        r, k, v, _, u = _wkv_inputs(3, *shape)
        lw = -np.random.default_rng(4).integers(80, 201, shape) \
            .astype(np.float32) / 4
    want = jax_wkv(_j(r), _j(k), _j(v), _j(lw), _j(u), chunk=32,
                   subchunk=8, interpret=True)
    got = wkv(_t(r), _t(k), _t(v), _t(lw), _t(u), chunk=32, subchunk=8)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("intra", ["direct", "matmul"])
def test_wkv_chunked_final_state_matches_jax(intra):
    """The port's ``wkv_chunked`` against JAX's, from a nonzero initial
    state: outputs and final state, with both intra-chunk forms."""
    b, s, h, hd = 2, 40, 2, 8                # c = 20: sub-chunks of 4
    r, k, v, lw, u = _wkv_inputs(11, b, s, h, hd)
    state = np.random.default_rng(12).standard_normal(
        (b, h, hd, hd)).astype(np.float32)
    want_o, want_s = jax_rwkv.wkv_chunked(
        _j(r), _j(k), _j(v), _j(lw), _j(u), chunk=32, state=_j(state),
        intra=intra, subchunk=4)
    got_o, got_s = rwkv.wkv_chunked(
        _t(r), _t(k), _t(v), _t(lw), _t(u), chunk=32, state=_t(state),
        intra=intra, subchunk=4)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-4, atol=1e-4)


def test_wkv_chunked_forms_agree_and_chunk_len_halves():
    r, k, v, lw, u = (_t(x) for x in _wkv_inputs(5, 1, 96, 2, 16))
    direct = rwkv.wkv_chunked(r, k, v, lw, u, chunk=64)
    matmul = rwkv.wkv_chunked(r, k, v, lw, u, chunk=64, intra="matmul",
                              subchunk=16)
    for a, b in zip(direct, matmul):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    assert [rwkv.chunk_len(s, c) for s, c in ((96, 64), (4096, 64),
                                              (17, 16), (8, 64))] \
        == [32, 64, 1, 8]
    with pytest.raises(ValueError, match="intra"):
        rwkv.wkv_chunked(r, k, v, lw, u, chunk=64, intra="scan")


# -------------------------------------------------------------- stencil
def _jax_jacobi4(x, steps):
    """The JAX op with an explicit block_rows (as test_kernels.py passes
    it): its TilePlanner finds no VMEM tiling for some small grids."""
    rows = x.shape[0]
    return jax_jacobi4(x, steps=steps, interpret=True,
                       block_rows=16 if rows % 16 == 0 else rows)


@pytest.mark.parametrize("shape", [(130, 67), (2, 5), (64, 128), (1, 7)])
@pytest.mark.parametrize("steps", [1, 3])
def test_stencil_matches_jax_op(shape, steps):
    x = np.random.default_rng(shape[0] * 100 + steps) \
        .standard_normal(shape).astype(np.float32)
    want = _jax_jacobi4(_j(x), steps)
    with dispatch.stats_scope() as stats:
        got = jacobi4(_t(x), steps=steps)
        assert stats() == {("stencil", "plain"): 1}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got[[0, -1]].numpy(), x[[0, -1]])
    np.testing.assert_array_equal(got[:, [0, -1]].numpy(), x[:, [0, -1]])


def test_stencil_bf16_matches_jax_op():
    """bf16: the port adds in fp32 and rounds once per sweep, JAX's kernel
    rounds each bf16 add, so they agree to bf16's rounding (2^-8 of a
    value, a few roundings over 3 sweeps: 2e-2)."""
    x = np.random.default_rng(9).standard_normal((66, 40)).astype(np.float32)
    want = _jax_jacobi4(_j(x, jnp.bfloat16), 3)
    got = jacobi4(_t(x, torch.bfloat16), steps=3)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_stencil_zero_steps_and_input_untouched():
    x = _t(np.arange(20, dtype=np.float32).reshape(4, 5))
    before = x.clone()
    out = jacobi4(x, steps=0)
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    jacobi4(x, steps=2)
    assert torch.equal(x, before)


# ---------------------------------------------------------------- nbody
@pytest.mark.parametrize("n,eps", [(96, None), (200, None), (300, 0.1)])
def test_nbody_matches_jax_op(n, eps):
    rng = np.random.default_rng(n)
    pos = rng.standard_normal((3, n)).astype(np.float32)
    mass = (rng.uniform(size=n) + 0.1).astype(np.float32)
    kw = {} if eps is None else {"eps": eps}
    if eps is not None:       # the JAX op has no eps: its oracle's arithmetic
        from repro.kernels.nbody.ref import nbody_accel_ref
        want = nbody_accel_ref(_j(pos), _j(mass), eps=eps)
    else:
        want = jax_nbody_accel(_j(pos), _j(mass), interpret=True)
    with dispatch.stats_scope() as stats:
        got = nbody_accel(_t(pos), _t(mass), **kw)
        assert stats() == {("nbody", "plain"): 1}
    assert got.shape == (3, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_nbody_plain_blocks_targets(monkeypatch):
    """The plain version's target blocks change only what it holds at
    once, not the result."""
    from repro_torch.kernels.nbody import nbody as mod
    rng = np.random.default_rng(4)
    pos = _t(rng.standard_normal((3, 50)).astype(np.float32))
    mass = _t((rng.uniform(size=50) + 0.1).astype(np.float32))
    whole = mod.nbody_accel_plain(pos, mass)
    monkeypatch.setattr(mod, "_PLAIN_BLOCK_ELEMS", 3 * 50 * 7)  # 7 targets
    torch.testing.assert_close(mod.nbody_accel_plain(pos, mass), whole,
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ histogram
@pytest.mark.parametrize("n,n_bins", [(4096, 256), (1024, 64)])
def test_histogram_matches_jax_op(n, n_bins):
    vals = np.random.default_rng(n + n_bins).integers(
        0, n_bins, n).astype(np.int32)
    want = jax_histogram(_j(vals), n_bins, interpret=True)
    with dispatch.stats_scope() as stats:
        got = histogram(_t(vals), n_bins)
        assert stats() == {("histogram", "plain"): 1}
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_histogram_out_of_range_follows_the_kernel():
    """Values outside [0, n_bins) are dropped, negative ones included, as
    ``histogram_pallas``'s one-hot compare drops them; ``histogram_ref``
    (jnp.bincount) counts the negatives into bin 0 and is not followed."""
    vals = np.asarray([0, 1, 255, 256, 300, -1, -5, 3] * 4, np.int32)
    pallas = np.asarray(histogram_pallas(_j(vals), 256, block=32,
                                         interpret=True))
    public = np.asarray(jax_histogram(_j(vals), 256, interpret=True))
    got = histogram(_t(vals), 256).numpy()
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, public)
    assert got.sum() == 16 and got[0] == 4
    assert int(np.asarray(histogram_ref(_j(vals), 256)).sum()) == 24


def test_histogram_any_length_and_bins():
    """Any N (the JAX op wants a multiple of 8) and n_bins >= 1."""
    vals = np.asarray([2, 2, 0, 7, -3, 1, 2, 9, 3, 3, 8, 0, 1], np.int32)
    got = histogram(_t(vals), 8).numpy()
    want = np.bincount(vals[(vals >= 0) & (vals < 8)], minlength=8)
    np.testing.assert_array_equal(got, want)
    assert histogram(_t(np.zeros(0, np.int32)), 3).tolist() == [0, 0, 0]
    with pytest.raises(ValueError, match="n_bins"):
        histogram(_t(vals), 0)
