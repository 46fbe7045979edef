"""Layers of the paged path against the JAX package's, in fp32.

Each test draws its inputs from seeded numpy, runs the JAX layer (with
``dispatch="reference"`` passed explicitly, so no tuned-plan state is
read) and the port's layer on the CPU, and compares outputs -- and, for
the paged attention layers, the pools they write, excluding the trash
page 0 (duplicate writes land there).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.memory import DtypePolicy as JaxPolicy
from repro.models import layers as jl
from repro.tune import cache as tune_cache
from repro_torch.core.memory import DtypePolicy
from repro_torch.models import layers as tl

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-4)
JDT = JaxPolicy(compute=jnp.float32)
TDT = DtypePolicy(compute=torch.float32)


@pytest.fixture(autouse=True)
def empty_plan_cache(tmp_path, monkeypatch):
    """The JAX side reads no tuned-plan state left by other tests."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "empty.json"))
    tune_cache.preload()
    yield
    monkeypatch.undo()
    tune_cache.preload()


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tree(rng, shapes):
    return {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for k, s in shapes.items()}


def test_rmsnorm_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    _close(tl.rmsnorm({"scale": _t(scale)}, _t(x)),
           jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    _close(tl.apply_rope(_t(x), _t(pos), theta=theta),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=theta))


@pytest.mark.parametrize("activation", ["geglu", "swiglu", "gelu"])
def test_mlp_apply_matches(activation):
    rng = np.random.default_rng(2)
    d, ff = 32, 48
    shapes = ({"wg": (d, ff), "wu": (d, ff), "wd": (ff, d)}
              if activation.endswith("glu")
              else {"wi": (d, ff), "wd": (ff, d)})
    p = _tree(rng, shapes)
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    want = jl.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), activation, JDT, policy="reference")
    got = tl.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), activation,
                       TDT)
    _close(got, want)


@pytest.mark.parametrize("hkv,window,qkv_bias", [(1, 0, False),
                                                 (2, 5, True)])
def test_paged_attention_layers_match(hkv, window, qkv_bias):
    """Chunked prefill of two slots (one with a page of history), then a
    ragged decode step with an inactive slot: outputs and pool writes."""
    rng = np.random.default_rng(3 + hkv)
    d, h, hd, page, slots, n_pages = 32, 4, 8, 4, 3, 4
    shapes = {"wq": (d, h, hd), "wk": (d, hkv, hd), "wv": (d, hkv, hd),
              "wo": (h, hd, d)}
    if qkv_bias:
        shapes.update(bq=(h, hd), bk=(hkv, hd), bv=(hkv, hd))
    p = _tree(rng, shapes)
    jspec = jl.AttnSpec(d_model=d, n_heads=h, n_kv_heads=hkv, head_dim=hd,
                        window=window, qkv_bias=qkv_bias,
                        dispatch="reference")
    tspec = tl.AttnSpec(d_model=d, n_heads=h, n_kv_heads=hkv, head_dim=hd,
                        window=window, qkv_bias=qkv_bias)
    pool = 1 + slots * n_pages
    kp = rng.standard_normal((pool, page, hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((pool, page, hkv, hd)).astype(np.float32)
    table = (1 + np.arange(slots * n_pages)).reshape(slots, n_pages) \
        .astype(np.int32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = _t(kp.copy()), _t(vp.copy())

    x = rng.standard_normal((2, page, d)).astype(np.float32)
    starts = np.asarray([0, 4], np.int32)
    want, jk, jv, _, _ = jl.attention_prefill_paged(
        jp, jspec, jnp.asarray(x), jnp.asarray(starts),
        jnp.asarray(table[:2]), jk, jv, JDT)
    got = tl.attention_prefill_paged(tp, tspec, _t(x), _t(starts),
                                     _t(table[:2]), tk, tv, TDT)
    _close(got, want)
    _close(tk[1:], jk[1:])
    _close(tv[1:], jv[1:])

    xd = rng.standard_normal((slots, 1, d)).astype(np.float32)
    lengths = np.asarray([4, 8, 0], np.int32)
    dtable = table.copy()
    dtable[2] = 0                        # inactive slot -> trash page
    want, jk, jv, _, _ = jl.attention_decode_paged(
        jp, jspec, jnp.asarray(xd), jnp.asarray(lengths),
        jnp.asarray(dtable), jk, jv, JDT)
    got = tl.attention_decode_paged(tp, tspec, _t(xd), _t(lengths),
                                    _t(dtable), tk, tv, TDT)
    _close(got[:2], want[:2])            # slot 2's output is discarded
    _close(tk[1:], jk[1:])
    _close(tv[1:], jv[1:])


def test_initializers_are_seeded_and_shaped():
    gen = torch.Generator().manual_seed(0)
    w = tl.dense_init(gen, (3, 64, 16), 64)
    assert w.shape == (3, 64, 16) and w.dtype == torch.float32
    assert float(w.abs().max()) <= 2.0 / 8.0 + 1e-6      # |z| <= 2, 1/sqrt(64)
    again = tl.dense_init(torch.Generator().manual_seed(0), (3, 64, 16), 64)
    assert torch.equal(w, again)
    e = tl.embed_init(gen, (100, 8))
    assert 0.8 < float(e.std()) < 1.2
