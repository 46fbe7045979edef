"""The grouped VJP's route by operand dtype, on the CPU.

``dispatch._GroupedMatmul``'s backward passes bf16 x, w and g to B1's
grouped route as they are (on the card: the short tile, reading w^T for
dx = g @ w^T and x^T for dw = x^T @ g through their strides), and
upcasts to fp32 otherwise, as the JAX VJP
(``repro/kernels/matmul/ops.py::_grouped_vjp_bwd``) does.  A product of
two bf16 values is exact in fp32, so both give the JAX function; on the
CPU the plain route gives the bits it gave before the bf16 route existed.

* the rule: bf16 operands reach the grouped GEMMs only when x, w and g
  are all bf16, for every mix of the three dtypes, and the gradients
  equal the fp32 upcast path (written out inline) bit for bit;
* bf16 primals through ``dispatch.grouped_matmul``: gradients equal to
  the upcast path, and within one bf16 rounding of ``jax.vjp`` of the
  JAX op on its kernel route (per-group Pallas matmuls in interpret
  mode), at G = 4, C in {8, 88} (a decode step's and a training step's
  expert capacity), ragged K and N;
* the qwen2-moe smoke model's bf16 loss gradients equal, leaf by leaf,
  those of the same step with the upcast backward;
* ``grouped_route``: which CUDA route a call takes, by dtype and layout.

JAX runs with ``dispatch`` passed explicitly and an empty tuned-plan
cache.
"""
import dataclasses
import itertools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jax_dispatch
from repro.tune import cache as tune_cache
from repro_torch.configs import ARCHS
from repro_torch.core import tree
from repro_torch.core.memory import BF16_POLICY
from repro_torch.kernels import dispatch
from repro_torch.kernels.matmul import grouped_matmul_plain
from repro_torch.kernels.matmul.matmul import grouped_route
from repro_torch.models.transformer import ExecOptions, Model

torch.set_num_threads(1)
BF16, F32 = torch.bfloat16, torch.float32
# (G, C, K, N): a decode step's capacity and a training step's (2 x 512
# tokens, top 4 of 60 experts, factor 1.25: C = 88), K and N ragged
SHAPES = [(4, 8, 130, 67), (4, 88, 72, 40), (4, 88, 130, 67)]


@pytest.fixture(autouse=True)
def empty_plan_cache(tmp_path, monkeypatch):
    """The JAX side reads no tuned-plan state left by other tests."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "empty.json"))
    tune_cache.preload()
    yield
    monkeypatch.undo()
    tune_cache.preload()


def _inputs(shape, seed):
    g, c, k, n = shape
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((g, c, k), (g, k, n), (g, c, n)))


def _upcast_grads(x, w, g):
    """The fp32 route as it is written for every dtype: both GEMMs on fp32
    copies, each gradient cast once to its primal's dtype."""
    dx = grouped_matmul_plain(g.float(), w.float().transpose(1, 2))
    dw = grouped_matmul_plain(x.float().transpose(1, 2).contiguous(),
                              g.float())
    return dx.to(x.dtype), dw.to(w.dtype)


class _Ctx:
    needs_input_grad = (True, True)

    def __init__(self, x, w):
        self.saved_tensors = (x, w)


@pytest.mark.parametrize("dtypes", list(itertools.product((BF16, F32),
                                                          repeat=3)),
                         ids=lambda d: "-".join(str(t)[6:] for t in d))
@pytest.mark.parametrize("shape", SHAPES[:2], ids=["C8", "C88"])
def test_backward_operands_are_bf16_only_when_all_three_are(dtypes, shape):
    """The backward's two GEMMs get bf16 operands exactly when x, w and g
    are all bf16 (else fp32 copies); either way the gradients have the
    primals' dtypes and equal the upcast path's bits."""
    x, w, g = (torch.from_numpy(a).to(dt)
               for a, dt in zip(_inputs(shape, 1), dtypes))
    seen = []

    def recording(a, b):
        seen.append((a.dtype, b.dtype))
        return grouped_matmul_plain(a, b)

    with mock.patch.object(dispatch, "grouped_matmul_plain", recording), \
            dispatch.stats_scope() as stats:
        dx, dw = dispatch._GroupedMatmul.backward(_Ctx(x, w), g)
        routes = stats()
    want = BF16 if dtypes == (BF16, BF16, BF16) else F32
    assert seen == [(want, want)] * 2
    assert routes == {("grouped_matmul_bwd", "plain"): 2}
    assert (dx.dtype, dw.dtype) == (x.dtype, w.dtype)
    want_dx, want_dw = _upcast_grads(x, w, g)
    assert torch.equal(dx, want_dx)
    assert torch.equal(dw, want_dw)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16_backward_matches_the_upcast_path_and_jax(shape):
    """bf16 primals through ``dispatch.grouped_matmul``: gradients equal to
    the upcast path bit for bit, and within one bf16 rounding of JAX's:
    each side rounds an fp32 sum once, so they differ by at most one bf16
    step (2^-7 of the value) where a rounding boundary falls between two
    sums that differ in their fp32 order, or by that difference itself
    near zero (1e-5 of the largest |gradient|)."""
    x, w, cot = _inputs(shape, 2)
    bx, bw, bcot = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, cot))
    with jax_dispatch.stats_scope() as jstats:
        jout, vjp = jax.vjp(lambda a, b: jax_dispatch.grouped_matmul(
            a, b, policy="kernels"), bx, bw)
        jdx, jdw = vjp(bcot)
        assert jstats()[("grouped_matmul", "kernel")] == 1
    tx, tw, tcot = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                    .to(BF16) for a in (bx, bw, bcot))
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    with dispatch.stats_scope() as stats:
        out = dispatch.grouped_matmul(tx, tw)
        dx, dw = torch.autograd.grad(out, (tx, tw), tcot)
        routes = stats()
    assert routes == {("grouped_matmul", "plain"): 1,
                      ("grouped_matmul_bwd", "plain"): 2}
    assert (out.dtype, dx.dtype, dw.dtype) == (BF16, BF16, BF16)
    want_dx, want_dw = _upcast_grads(tx.detach(), tw.detach(), tcot)
    assert torch.equal(dx, want_dx)
    assert torch.equal(dw, want_dw)
    for got, want in ((out.detach(), jout), (dx, jdx), (dw, jdw)):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(
            got.float().numpy(), want, rtol=2 ** -7,
            atol=1e-5 * float(np.abs(want).max()))


def _upcast_backward(ctx, g):
    """The grouped VJP with every dtype upcast, as the fp32 route runs."""
    x, w = ctx.saved_tensors
    return _upcast_grads(x, w, g)


def test_bf16_moe_loss_gradients_equal_the_upcast_backward():
    """The qwen2-moe smoke model's loss under the bf16 policy on the CPU:
    every gradient leaf equals, bit for bit, that of the same step whose
    grouped VJP upcasts to fp32; every layer's three expert contractions
    run twice (remat) and backward twice each."""
    cfg = dataclasses.replace(ARCHS["qwen2-moe-a2.7b"].smoke(), n_layers=2)
    model = Model(cfg, dt=BF16_POLICY, device="cpu",
                  opts=ExecOptions(block_q=8, block_kv=8, xent_chunks=4))
    flat, rebuild = tree.flatten(model.init(seed=3))
    for t in flat:
        t.requires_grad_(True)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 17))
    batch = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}
    runs, seen = [], []

    def recording(a, b):
        seen.append((a.dtype, b.dtype))
        return grouped_matmul_plain(a, b)

    for backward in (None, _upcast_backward):
        with mock.patch.object(
                dispatch._GroupedMatmul, "backward",
                staticmethod(backward or dispatch._GroupedMatmul.backward)), \
                mock.patch.object(dispatch, "grouped_matmul_plain",
                                  recording), \
                dispatch.stats_scope() as stats:
            loss, _ = model.loss_fn(rebuild(flat), batch)
            runs.append((loss.detach(), torch.autograd.grad(loss, flat),
                         stats()))
            if backward is None:      # forward, recompute, dx and dw
                assert seen == [(BF16, BF16)] * 4 * 3 * cfg.n_layers
    (loss, grads, routes), (loss_up, grads_up, _) = runs
    assert torch.isfinite(loss) and torch.equal(loss, loss_up)
    for i, (got, want) in enumerate(zip(grads, grads_up)):
        assert torch.equal(got, want), i
    assert routes[("grouped_matmul", "plain")] == 2 * 3 * cfg.n_layers
    assert routes[("grouped_matmul_bwd", "plain")] == 2 * 3 * cfg.n_layers


@pytest.mark.parametrize("dtype,x_kmajor,w_kmajor,route", [
    (F32, True, False, "simt"), (F32, True, True, "simt"),
    (F32, False, False, "simt"), (F32, False, True, "simt"),
    (BF16, True, False, "wgmma"), (BF16, False, False, "wgmma_short"),
    (BF16, True, True, "wgmma_short")])
def test_grouped_route(dtype, x_kmajor, w_kmajor, route):
    """fp32 takes the FMA tile whatever the layouts; bf16 B1's tile for
    the forward's layout (x contiguous, w N-contiguous) and the short
    tile for the backward's two: x^T read C-major over an N-contiguous g
    (dw), g over w^T read K-contiguous (dx)."""
    assert grouped_route(dtype, x_kmajor, w_kmajor) == route


def test_grouped_route_refuses_a_layout_no_call_sends():
    """A bf16 x read C-major with a K-contiguous w: no route takes it."""
    with pytest.raises(ValueError, match="C-major"):
        grouped_route(BF16, False, True)
