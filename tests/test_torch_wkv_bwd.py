"""The WKV backward's chunked oracle (``kernels/wkv/wkv.py::
wkv_bwd_chunked``, the decomposition ``csrc/wkv_bwd.cu`` computes on the
card) against the JAX package, on the CPU.

* against ``jax.vjp`` of JAX's ``wkv_chunked`` (``repro/models/rwkv.py``)
  in fp32 at the init decays: head widths 32, 64 and 128 at one or two
  heads, 40 and 130 tokens, chunks of 16 and 64 (the last chunk ragged),
  every gradient within ``GRAD_TOL``;
* under strong decays (lw in [-50, -20] on a grid of 1/4, exact fp32
  cumsums) against the fp64 autograd of the port's ``wkv_chunked``, run
  in fp32: each gradient within 2e-4 of its own max |grad|, dlw
  included.  There the true dlw_t carries w_t <= e^-20, and a form that
  takes it as a difference of O(1) running sums (as the fp32 autograd
  does) leaves rounding noise; the oracle's sums hold no such pair.

Inputs are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as jax_rwkv
from repro_torch.kernels.wkv import wkv_bwd_chunked, wkv_bwd_plain

torch.set_num_threads(1)
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
STRONG_TOL = 2e-4        # of each gradient's max |grad|
NAMES = ("dr", "dk", "dv", "dlw", "du")


def _inputs(seed, shape, strong=False):
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(4))
    if strong:      # [-50, -20] on a grid of 1/4: exact fp32 cumsums
        lw = -rng.integers(80, 201, shape).astype(np.float32) / 4
    else:
        lw = -np.exp(rng.standard_normal(shape) - 1).astype(np.float32)
    u = rng.standard_normal(shape[2:]).astype(np.float32)
    return (r, k, v, lw, u), do


@pytest.mark.parametrize("hd,heads", [(32, 2), (64, 2), (128, 1)])
@pytest.mark.parametrize("s", [40, 130])
@pytest.mark.parametrize("chunk", [16, 64])
def test_chunked_backward_matches_jax_vjp(hd, heads, s, chunk):
    args, do = _inputs(hd + s + chunk, (2, s, heads, hd))
    _, vjp = jax.vjp(
        lambda *a: jax_rwkv.wkv_chunked(*a, chunk=chunk)[0],
        *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(do))
    got = wkv_bwd_chunked(*(torch.from_numpy(a) for a in args),
                          torch.from_numpy(do), chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("hd,heads", [(32, 2), (64, 2), (128, 1)])
@pytest.mark.parametrize("chunk,subchunk", [(16, 16), (64, 16), (32, 8)])
def test_chunked_backward_holds_dlw_under_strong_decay(hd, heads, chunk,
                                                       subchunk):
    args, do = _inputs(7 + hd + chunk, (1, 130, heads, hd), strong=True)
    t32 = [torch.from_numpy(a) for a in (*args, do)]
    want = wkv_bwd_plain(*(t.double() for t in t32[:5]), t32[5].double(),
                         chunk=64)
    got = wkv_bwd_chunked(*t32, chunk=chunk, subchunk=subchunk)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32, name
        assert bool(torch.isfinite(g).all()), name
        err = (g.double() - w).abs().max() / w.abs().max()
        assert err <= STRONG_TOL, (name, err.item())


def test_chunked_backward_is_the_exact_gradient_in_fp64():
    """In fp64 the oracle is the exact recurrence's gradient: the autograd
    of a step-by-step recurrence, to rounding, at strong and init decays
    and a ragged last chunk."""
    for strong in (False, True):
        args, do = _inputs(3 + strong, (2, 37, 2, 8), strong=strong)
        leaves = [torch.from_numpy(a).double().requires_grad_(True)
                  for a in args]
        r, k, v, lw, u = leaves
        state = torch.zeros(2, 2, 8, 8, dtype=torch.float64)
        outs = []
        for t in range(37):
            rt, kt, vt = r[:, t], k[:, t], v[:, t]
            outs.append(torch.einsum("bhi,bhij->bhj", rt, state)
                        + (rt * u * kt).sum(-1, keepdim=True) * vt)
            state = (lw[:, t].exp()[..., None] * state
                     + kt[..., None] * vt[..., None, :])
        want = torch.autograd.grad(torch.stack(outs, 1), leaves,
                                   torch.from_numpy(do).double())
        got = wkv_bwd_chunked(*(x.detach() for x in leaves),
                              torch.from_numpy(do).double(), chunk=16,
                              subchunk=4)
        for name, g, w in zip(NAMES, got, want):
            err = (g - w).abs().max() / w.abs().max()
            assert err <= 1e-12, (name, strong, err.item())
