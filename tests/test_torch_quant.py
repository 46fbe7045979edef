"""The port's int8 quantization helpers against ``repro.core.quant``.

The same seeded numpy inputs go through both; the int8 tensors must be
exactly equal and the f32 scales bit for bit.  Cases: ordinary pages,
all-zero pages (the zero-scale guard), values that land exactly on .5 in
quantized units (both frameworks round half to even), and a reset page
whose stale payload the first append wipes (ratio 0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro_torch.core import quant

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _ties(shape, rng):
    """Values k + 0.5 (k integer, |.| < 127) times a scale of 1, with one
    element pinned at 127 so the abs-max scale is exactly 1."""
    x = (rng.integers(-120, 120, shape) + 0.5).astype(np.float32)
    x.reshape(-1)[0] = 127.0
    return x


@pytest.mark.parametrize("case", ["normal", "zeros", "ties"])
def test_quantize_pages_matches_jax(case):
    rng = np.random.default_rng(0)
    shape = (3, 4, 2, 8)                  # (B, page, Hkv, hd)
    if case == "normal":
        x = (0.7 * rng.standard_normal(shape)).astype(np.float32)
    elif case == "zeros":
        x = (0.7 * rng.standard_normal(shape)).astype(np.float32)
        x[1] = 0.0                        # a whole page of zeros
        x[2, :, 1] = 0.0                  # one kv head of a page
    else:
        x = _ties(shape, rng)
    q, s = quant.quantize_pages(_t(x))
    jq, js = jquant.quantize_pages(jnp.asarray(x))
    _same(q, jq)
    _same(s, js)
    if case == "zeros":
        assert float(s[1].abs().max()) == 0.0
        assert int(q[1].abs().max()) == 0


@pytest.mark.parametrize("case", ["normal", "ties", "reset"])
def test_append_token_quantized_matches_jax(case):
    rng = np.random.default_rng(1)
    b, page, hkv, hd = 3, 4, 2, 8
    pages = rng.integers(-127, 128, (b, page, hkv, hd)).astype(np.int8)
    scales = rng.uniform(0.001, 0.02, (b, hkv)).astype(np.float32)
    if case == "ties":
        tok = _ties((b, hkv, hd), rng) * scales[:, :, None]
    else:
        tok = (rng.standard_normal((b, hkv, hd))).astype(np.float32)
    if case == "reset":
        scales[1] = 0.0                   # a freshly reset page ...
        tok[2] *= 1e-4                    # ... and one that keeps its scale
    off = np.asarray([0, 3, 1], np.int32)
    q, s = quant.append_token_quantized(_t(pages), _t(scales), _t(tok),
                                        _t(off))
    jq, js = jquant.append_token_quantized(
        jnp.asarray(pages), jnp.asarray(scales), jnp.asarray(tok),
        jnp.asarray(off))
    _same(q, jq)
    _same(s, js)
    if case == "reset":
        # ratio 0 wiped the stale payload: only the appended token remains
        rest = np.delete(q[1].numpy(), 3, axis=0)
        assert not rest.any()
        assert q[1, 3].abs().max() == 127
        np.testing.assert_array_equal(s[2].numpy(), scales[2])


@pytest.mark.parametrize("case", ["normal", "zeros", "ties"])
def test_quantize_channelwise_matches_jax(case):
    rng = np.random.default_rng(2)
    if case == "ties":
        w = _ties((24, 10), rng)
        w[0, :] = 127.0                   # every column's scale is 1
    else:
        w = (rng.standard_normal((24, 10)) / 5).astype(np.float32)
    if case == "zeros":
        w[:, 3] = 0.0                     # an all-zero output channel
    q, s = quant.quantize_channelwise(_t(w))
    jq, js = jquant.quantize_channelwise(jnp.asarray(w))
    _same(q, jq)
    _same(s, js)
    # bf16 weights, as the serving path quantizes them
    wb = torch.tensor(w).to(torch.bfloat16)
    q, s = quant.quantize_channelwise(wb)
    jq, js = jquant.quantize_channelwise(
        jnp.asarray(wb.float().numpy()).astype(jnp.bfloat16))
    _same(q, jq)
    _same(s, js)
    # a leading (period) axis quantizes each slice on its own
    stacked = np.stack([w, 3 * w])
    q, s = quant.quantize_channelwise(_t(stacked))
    for i in range(2):
        jq, js = jquant.quantize_channelwise(jnp.asarray(stacked[i]))
        _same(q[i], jq)
        _same(s[i], js)


def test_dequantize_and_kv_dtype_of():
    rng = np.random.default_rng(3)
    q = rng.integers(-127, 128, (5, 6)).astype(np.int8)
    s = rng.uniform(0.01, 0.1, (6,)).astype(np.float32)
    _same(quant.dequantize(_t(q), _t(s)),
          jquant.dequantize(jnp.asarray(q), jnp.asarray(s)))
    assert quant.kv_dtype_of("int8", torch.bfloat16) == torch.int8
    assert quant.kv_dtype_of("", torch.bfloat16) == torch.bfloat16
    assert quant.kv_dtype_of("bf16", torch.float32) == torch.bfloat16
    with pytest.raises(ValueError, match="kv_dtype"):
        quant.kv_dtype_of("fp8", torch.float32)
