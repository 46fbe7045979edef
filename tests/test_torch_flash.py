"""The plain versions of the flash forward (B6) and its fused recompute
backward (B7) against the JAX package's Pallas kernels.

The same numpy inputs go through ``repro.kernels.attention``'s
``flash_attention(..., return_residuals=True)`` and
``flash_attention_bwd`` (Pallas in interpret mode on the CPU, with small
blocks so that several tiles, and the structural tile skip, are
exercised) and through ``flash_attention_plain`` /
``flash_attention_bwd_plain``.  Each side runs its backward on its own
forward's o and lse.  Tolerances are tests/test_flash_backward.py's:
5e-4 in fp32, 8e-2 in bf16 (rtol = atol).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import flash_attention, flash_attention_bwd
from repro.tune import cache as tune_cache
from repro_torch.kernels.attention import (flash_attention_bwd_plain,
                                           flash_attention_plain)

torch.set_num_threads(1)
B, H, S, HD = 1, 2, 32, 16
PLAN = {"level": 3, "block_q": 8, "block_kv": 16}
TOLS = {"float32": 5e-4, "bfloat16": 8e-2}
MASKS = {"causal": (True, 0), "window": (True, 12), "full": (False, 0)}


@pytest.fixture(autouse=True)
def empty_plan_cache(tmp_path, monkeypatch):
    """The JAX side reads no tuned-plan state left by other tests."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "empty.json"))
    tune_cache.preload()
    yield
    monkeypatch.undo()
    tune_cache.preload()


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, S, HD)).astype(np.float32)
               for _ in range(3))
    do = rng.standard_normal((B, H, S, HD)).astype(np.float32)
    return q, k, v, do


def _close(got, want, dtype_name, what):
    tol = TOLS[dtype_name]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("mask_name", sorted(MASKS))
@pytest.mark.parametrize("dtype_name", sorted(TOLS))
def test_flash_forward_and_backward_match_pallas(dtype_name, mask_name):
    causal, window = MASKS[mask_name]
    q, k, v, do = _inputs(len(mask_name) + 7 * len(dtype_name))
    jdt, tdt = getattr(jnp, dtype_name), getattr(torch, dtype_name)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    o_j, lse_j = flash_attention(jq, jk, jv, causal=causal, window=window,
                                 plan=PLAN, return_residuals=True)
    grads_j = flash_attention_bwd(jq, jk, jv, o_j, lse_j, jnp.asarray(do),
                                  causal=causal, window=window, plan=PLAN)

    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    o_t, lse_t = flash_attention_plain(tq, tk, tv, causal=causal,
                                       window=window, return_lse=True)
    assert o_t.dtype == lse_t.dtype == torch.float32
    assert o_t.shape == (B, H, S, HD) and lse_t.shape == (B, H, S)
    grads_t = flash_attention_bwd_plain(tq, tk, tv, o_t, lse_t,
                                        torch.from_numpy(do), causal=causal,
                                        window=window)

    _close(o_t, o_j, dtype_name, "o")
    _close(lse_t, lse_j, dtype_name, "lse")
    for name, got, want in zip(("dq", "dk", "dv"), grads_t, grads_j):
        assert got.dtype == torch.float32
        _close(got, want, dtype_name, name)


def test_plain_forward_without_lse_is_the_same_output():
    q, k, v, _ = _inputs(3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, _ = flash_attention_plain(tq, tk, tv, causal=True, window=5,
                                 return_lse=True)
    assert torch.equal(flash_attention_plain(tq, tk, tv, causal=True,
                                             window=5), o)
