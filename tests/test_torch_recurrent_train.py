"""The recurrent archs' whole-sequence forward and training against the
JAX package's, on the CPU at smoke widths in fp32.

rwkv6-7b (RWKV6 time mix over the WKV recurrence, channel mix) and
recurrentgemma-9b (two RG-LRU blocks to one local-attention layer), from
JAX ``Model.init`` params carried across by ``params_from_jax``:

* the pieces: ``time_mix_apply`` over a few chunks and at a length whose
  chunk halves to 4 (both intra-chunk forms), ``rglru_scan`` with and
  without ``h0`` (its log-depth recursion at odd and even lengths),
  ``rglru_block_apply`` and ``layer_apply`` of each recurrent kind:
  outputs within 1e-5 of their max |value|, gradients within
  ``GRAD_TOL`` of ``jax.grad``;
* the model's WKV op (``dispatch.wkv``): its CPU backward against
  ``jax.vjp`` of ``wkv_chunked``, and ``torch.autograd.gradcheck`` in
  fp64;
* ``Model.forward`` and ``prefill`` logits within 1e-5 of max |logit|,
  ``loss_fn`` within 1e-5 relative and every gradient leaf within
  ``GRAD_TOL``, on the smoke layouts and on stacked ones (the published
  patterns);
* the train CLI on the CPU with exact routes.

Every input is made with numpy from a seed; JAX runs with ``dispatch``
passed explicitly and an empty tuned-plan cache.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import ARCHS as JAX_ARCHS
from repro.core.memory import DtypePolicy as JaxPolicy
from repro.models import griffin as jax_griffin
from repro.models import rwkv as jax_rwkv
from repro.models import transformer as jax_transformer
from repro.models.transformer import ExecOptions as JaxExecOptions
from repro.models.transformer import Model as JaxModel
from repro.tune import cache as tune_cache
from repro_torch.configs import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.core import tree
from repro_torch.core.memory import F32_POLICY
from repro_torch.kernels import dispatch
from repro_torch.launch import train as train_cli
from repro_torch.models import griffin, rwkv, transformer
from repro_torch.models.transformer import ExecOptions, Model

torch.set_num_threads(1)
TOL = 1e-5              # outputs: max |err| over the output's max |value|
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
F32 = torch.float32
JAX_F32 = JaxPolicy(compute=jnp.float32)
B, S = 2, 16
# the smoke layouts (rwkv: 2 layers; recurrentgemma: rglru, swa, rglru)
# and the published patterns stacked (rwkv 3 periods of 1;
# recurrentgemma 1 period of 3 and a tail of 2)
LOSS_CASES = {
    "rwkv6-7b": ("rwkv6-7b", {}),
    "recurrentgemma-9b": ("recurrentgemma-9b", {}),
    "rwkv6-7b-stacked": ("rwkv6-7b", dict(
        n_layers=3, prefix=(), pattern=(("rwkv", "rwkv_cm"),))),
    "recurrentgemma-9b-stacked": ("recurrentgemma-9b", dict(
        n_layers=5, prefix=(), pattern=(("rglru", "mlp"), ("rglru", "mlp"),
                                        ("swa", "mlp")))),
}


@pytest.fixture(autouse=True)
def empty_plan_cache(tmp_path, monkeypatch):
    """The JAX side reads no tuned-plan state left by other tests."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "empty.json"))
    tune_cache.preload()
    yield
    monkeypatch.undo()
    tune_cache.preload()


def _t(a, dtype=F32):
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype)


def _close(got, want, what):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    assert scale > 0, what
    err = np.abs(got - want).max()
    assert err <= TOL * scale, f"{what}: max |err| {err:.3e} of {scale:.3e}"


def _sorted_np(tree_):
    """A JAX tree as numpy with dicts in sorted order (``core.tree``'s)."""
    if isinstance(tree_, dict):
        return {k: _sorted_np(tree_[k]) for k in sorted(tree_)}
    if isinstance(tree_, (list, tuple)):
        return [_sorted_np(v) for v in tree_]
    return np.asarray(tree_, np.float32)


def _assert_tree_close(got, want, what):
    flat_g, flat_w = tree.leaves(got), tree.leaves(_sorted_np(want))
    assert len(flat_g) == len(flat_w)
    for i, (g, w) in enumerate(zip(flat_g, flat_w)):
        np.testing.assert_allclose(g.detach().numpy(), w,
                                   err_msg=f"{what} leaf {i}", **GRAD_TOL)


def _grads_of(fn, params, x, cot):
    """d(sum(fn(params, x) * cot)) / d(params, x) through autograd, with
    the params in ``core.tree``'s order; returns (out, param grads tree,
    dx)."""
    flat, rebuild = tree.flatten(params)
    leaves = [t.clone().requires_grad_(True) for t in flat]
    tx = x.clone().requires_grad_(True)
    out = fn(rebuild(leaves), tx)
    grads = torch.autograd.grad((out * cot).sum(), leaves + [tx])
    return out, rebuild(list(grads[:-1])), grads[-1]


def _jax_grads_of(fn, params, x, cot):
    out = fn(params, jnp.asarray(x))
    grads = jax.grad(lambda p_, x_: jnp.sum(fn(p_, x_) * cot),
                     argnums=(0, 1))(params, jnp.asarray(x))
    return out, jax.device_get(grads[0]), np.asarray(grads[1])


# ------------------------------------------------------------ time mix
RWKV = dict(d_model=128, head_dim=32, chunk=16, d_ff=256)


def _time_mix_params(seed):
    """JAX init with a random bonus and per-channel base decays from
    -exp(-2) to -exp(1) a step, so the WKV's every term matters."""
    p = jax_rwkv.time_mix_init(jax.random.key(seed),
                               jax_rwkv.RwkvSpec(**RWKV))
    rng = np.random.default_rng(seed)
    p = dict(p, u=jnp.asarray(rng.standard_normal(p["u"].shape), jnp.float32),
             w0=jnp.asarray(rng.uniform(-2, 1, p["w0"].shape), jnp.float32))
    return p


@pytest.mark.parametrize("intra", ["direct", "matmul"])
@pytest.mark.parametrize("seq", [48, 20])
def test_time_mix_apply_matches_jax(seq, intra):
    """48 tokens: three chunks of 16 (sub-chunks of 16: the matmul form
    is direct at one sub-chunk, so chunks of 16 and sub-chunks of 8 for
    "matmul"); 20 tokens: the chunk halves to 4."""
    sub = 8 if intra == "matmul" else 16
    jspec = jax_rwkv.RwkvSpec(**RWKV, intra=intra, subchunk=sub)
    tspec = rwkv.RwkvSpec(**RWKV, intra=intra, subchunk=sub)
    assert rwkv.chunk_len(seq, 16) == (16 if seq == 48 else 4)
    p = _time_mix_params(seq)
    rng = np.random.default_rng(seq + 1)
    x = (0.5 * rng.standard_normal((B, seq, 128))).astype(np.float32)
    cot = rng.standard_normal((B, seq, 128)).astype(np.float32)
    want, jgrads, jdx = _jax_grads_of(
        lambda p_, x_: jax_rwkv.time_mix_apply(p_, jspec, x_, JAX_F32),
        p, x, cot)
    with dispatch.stats_scope() as stats:
        got, grads, dx = _grads_of(
            lambda p_, x_: rwkv.time_mix_apply(p_, tspec, x_, F32),
            params_from_jax(jax.device_get(p), "cpu", F32), _t(x), _t(cot))
        assert stats() == {("wkv", "plain"): 1, ("wkv_bwd", "plain"): 1}
    _close(got, want, "time mix")
    _assert_tree_close(grads, jgrads, "time mix params")
    np.testing.assert_allclose(dx.numpy(), jdx, **GRAD_TOL)


def test_channel_mix_over_whole_sequences_matches_jax():
    """The whole-sequence channel mix shifts against zeros, as JAX's."""
    jspec = jax_rwkv.RwkvSpec(**RWKV)
    p = jax_rwkv.channel_mix_init(jax.random.key(4), jspec)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 24, 128)).astype(np.float32)
    cot = rng.standard_normal((B, 24, 128)).astype(np.float32)
    want, jgrads, jdx = _jax_grads_of(
        lambda p_, x_: jax_rwkv.channel_mix_apply(p_, jspec, x_, JAX_F32),
        p, x, cot)
    got, grads, dx = _grads_of(
        lambda p_, x_: rwkv.channel_mix_apply(p_, rwkv.RwkvSpec(**RWKV), x_,
                                              F32),
        params_from_jax(jax.device_get(p), "cpu", F32), _t(x), _t(cot))
    _close(got, want, "channel mix")
    _assert_tree_close(grads, jgrads, "channel mix params")
    np.testing.assert_allclose(dx.numpy(), jdx, **GRAD_TOL)


# ------------------------------------------------------------ WKV op
def _wkv_np(seed, shape, strong=False):
    rng = np.random.default_rng(seed)
    r, k, v, cot = (rng.standard_normal(shape).astype(np.float32)
                    for _ in range(4))
    if strong:      # [-50, -20] on a grid of 1/4: exact fp32 cumsums
        lw = -rng.integers(80, 201, shape).astype(np.float32) / 4
    else:
        lw = -np.exp(rng.standard_normal(shape) - 1).astype(np.float32)
    u = rng.standard_normal(shape[2:]).astype(np.float32)
    return (r, k, v, lw, u), cot


@pytest.mark.parametrize("intra,strong", [("direct", False),
                                          ("matmul", False),
                                          ("direct", True),
                                          ("matmul", True)])
def test_wkv_op_backward_matches_jax_vjp(intra, strong):
    """``dispatch.wkv`` on the CPU (``wkv_chunked`` and the autograd of
    its recompute) against ``jax.vjp`` of JAX's ``wkv_chunked``: 40
    tokens in chunks of 8 (16 halved), sub-chunks of 4 for "matmul".
    Output within 1e-5 of max |o|, gradients within GRAD_TOL.  Strong
    decays put exponents of hundreds above the diagonal of the
    intra-chunk weights: masked before the exponential, they leave no
    nan in the gradients.  (There dlw is ~1e-5, the difference of O(1)
    terms in both packages' fp32 autodiff, so it is held to GRAD_TOL's
    absolute part, not to its own max.)"""
    args, cot = _wkv_np(7 + strong, (2, 40, 2, 8), strong)
    kw = dict(chunk=16, intra=intra, subchunk=4)
    want, vjp = jax.vjp(
        lambda *a: jax_rwkv.wkv_chunked(*a, **kw)[0],
        *(jnp.asarray(a) for a in args))
    want_grads = vjp(jnp.asarray(cot))
    leaves = [_t(a).requires_grad_(True) for a in args]
    with dispatch.stats_scope() as stats:
        out = dispatch.wkv(*leaves, **kw)
        grads = torch.autograd.grad(out, leaves, _t(cot))
        assert stats() == {("wkv", "plain"): 1, ("wkv_bwd", "plain"): 1}
    _close(out, want, "wkv")
    for name, g, w in zip(("dr", "dk", "dv", "dlw", "du"), grads,
                          want_grads):
        assert bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **GRAD_TOL)


def test_wkv_op_gradcheck_in_fp64():
    """The Function's backward is the derivative of its forward: fp64
    inputs stay fp64 on the CPU route; decays of about -0.1 to -3 a step,
    4 chunks of 2 tokens."""
    (r, k, v, lw, u), _ = _wkv_np(3, (1, 8, 2, 3))
    args = [torch.from_numpy(a.astype(np.float64)).requires_grad_(True)
            for a in (r, k, v, lw, u)]
    assert dispatch.wkv(*args, chunk=2).dtype == torch.float64
    assert torch.autograd.gradcheck(
        lambda *a: dispatch.wkv(*a, chunk=2, intra="direct"), args)


# ------------------------------------------------------------ RG-LRU
@pytest.mark.parametrize("seq", [1, 2, 7, 16, 33])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_jax(seq, with_h0):
    """The pairwise recursion at odd and even lengths, with and without a
    carried state folded into the first step; its gradient in a, b and
    h0."""
    rng = np.random.default_rng(seq)
    a = rng.uniform(0.5, 1.0, (B, seq, 12)).astype(np.float32)
    b = rng.standard_normal((B, seq, 12)).astype(np.float32)
    h0 = rng.standard_normal((B, 12)).astype(np.float32)
    cot = rng.standard_normal((B, seq, 12)).astype(np.float32)
    inputs = [a, b] + ([h0] if with_h0 else [])

    def jfn(*xs):
        return jnp.sum(jax_griffin.rglru_scan(*xs) * cot)
    want = jax_griffin.rglru_scan(*(jnp.asarray(x) for x in inputs))
    want_grads = jax.grad(jfn, argnums=tuple(range(len(inputs))))(
        *(jnp.asarray(x) for x in inputs))
    leaves = [_t(x).requires_grad_(True) for x in inputs]
    got = griffin.rglru_scan(*leaves)
    _close(got, want, "scan")
    # one token: a is unused, and its gradient zero
    grads = torch.autograd.grad((got * _t(cot)).sum(), leaves,
                                allow_unused=True, materialize_grads=True)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_rglru_scan_is_log_depth():
    """No loop over the sequence: the recursion halves it at every level,
    log2(S) levels deep (512 tokens: 9)."""
    depth = []
    real = griffin._scan

    def counting(a, b):
        depth.append(a.shape[1])
        return real(a, b)
    a = torch.full((1, 512, 4), 0.9)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(griffin, "_scan", counting)
        griffin.rglru_scan(a, torch.ones(1, 512, 4))
    assert depth == [512, 256, 128, 64, 32, 16, 8, 4, 2, 1]


def test_rglru_block_apply_matches_jax():
    jspec = jax_griffin.GriffinSpec(d_model=128, lru_width=128,
                                    block_width=64)
    tspec = griffin.GriffinSpec(d_model=128, lru_width=128, block_width=64)
    p = jax_griffin.rglru_block_init(jax.random.key(5), jspec)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 24, 128)).astype(np.float32)
    cot = rng.standard_normal((B, 24, 128)).astype(np.float32)
    want, jgrads, jdx = _jax_grads_of(
        lambda p_, x_: jax_griffin.rglru_block_apply(p_, jspec, x_, JAX_F32),
        p, x, cot)
    got, grads, dx = _grads_of(
        lambda p_, x_: griffin.rglru_block_apply(p_, tspec, x_, F32),
        params_from_jax(jax.device_get(p), "cpu", F32), _t(x), _t(cot))
    _close(got, want, "rglru block")
    _assert_tree_close(grads, jgrads, "rglru params")
    np.testing.assert_allclose(dx.numpy(), jdx, **GRAD_TOL)


# ------------------------------------------------------------ layers
@pytest.mark.parametrize("arch,kind", [
    ("rwkv6-7b", ("rwkv", "rwkv_cm")),
    ("recurrentgemma-9b", ("rglru", "mlp")),
    ("recurrentgemma-9b", ("swa", "mlp"))])
def test_layer_apply_matches_jax(arch, kind):
    jcfg = dataclasses.replace(JAX_ARCHS[arch].smoke(), dispatch="reference")
    tcfg = ARCHS[arch].smoke()
    p = jax_transformer.layer_init(jax.random.key(6), jcfg, kind)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, 24, 128)).astype(np.float32)
    cot = rng.standard_normal((B, 24, 128)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24)[None], (B, 24)).astype(np.int32)
    jopts = JaxExecOptions(mode="run", block_q=8, block_kv=8)

    def jfn(p_, x_):
        return jax_transformer.layer_apply(p_, jcfg, kind, x_,
                                           jnp.asarray(pos), JAX_F32,
                                           jopts)[0]

    def tfn(p_, x_):
        out, aux = transformer.layer_apply(
            p_, tcfg, kind, x_, torch.from_numpy(pos), F32_POLICY,
            ExecOptions(block_q=8, block_kv=8))
        assert aux is None
        return out
    want, jgrads, jdx = _jax_grads_of(jfn, p, x, cot)
    got, grads, dx = _grads_of(
        tfn, params_from_jax(jax.device_get(p), "cpu", F32), _t(x),
        _t(cot))
    _close(got, want, f"{kind} layer")
    _assert_tree_close(grads, jgrads, f"{kind} layer params")
    np.testing.assert_allclose(dx.numpy(), jdx, **GRAD_TOL)


# ------------------------------------------------------------ the model
_JAX = {}


def _jax_case(case):
    """A case's JAX params, batch, loss, gradients and logits, computed
    once per module."""
    if case not in _JAX:
        arch, overrides = LOSS_CASES[case]
        jcfg = dataclasses.replace(JAX_ARCHS[arch].smoke(),
                                   dispatch="reference", **overrides)
        model = JaxModel(jcfg, dt=JAX_F32,
                         opts=JaxExecOptions(mode="run", block_q=8,
                                             block_kv=8, xent_chunks=4))
        params = model.init(jax.random.key(1))
        rng = np.random.default_rng(3)
        toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        (loss, _), grads = jax.jit(jax.value_and_grad(
            model.loss_fn, has_aux=True))(
                params, {k: jnp.asarray(v) for k, v in batch.items()})
        logits = jax.jit(model.forward)(
            params, {"tokens": jnp.asarray(batch["tokens"])})
        _JAX[case] = (jax.device_get(params), batch, float(loss),
                      jax.device_get(grads), np.asarray(logits))
    return _JAX[case]


def _port(case, **opts):
    arch, overrides = LOSS_CASES[case]
    tcfg = dataclasses.replace(ARCHS[arch].smoke(), **overrides)
    return Model(tcfg, dt=F32_POLICY, device="cpu",
                 opts=ExecOptions(block_q=8, block_kv=8, xent_chunks=4,
                                  **opts))


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_gradients_match_jax(case):
    """Loss within 1e-5 relative, every gradient leaf within GRAD_TOL, and
    the routes: every layer recomputed once (remat), so the WKV runs
    twice a layer forward and once backward; recurrentgemma smoke's GEMMs
    are 3 an MLP, 4 an attention layer's projections, and the head's 4
    xent chunks."""
    params_np, batch, loss_j, grads_j, _ = _jax_case(case)
    model = _port(case)
    params = params_from_jax(params_np, "cpu", F32)
    flat, rebuild = tree.flatten(params)
    for t in flat:
        t.requires_grad_(True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with dispatch.stats_scope() as stats:
        loss, metrics = model.loss_fn(rebuild(flat), tbatch)
        grads = torch.autograd.grad(loss, flat)
        routes = stats()
    loss = float(loss.detach())
    assert math.isclose(loss, loss_j, rel_tol=1e-5), (loss, loss_j)
    assert float(metrics["aux"]) == 0.0
    _assert_tree_close(rebuild(list(grads)), grads_j, case)
    kinds = model.cfg.layer_kinds()
    mixers = [m for m, _ in kinds]
    gemms = 4 + sum(3 + 4 * (m == "swa") for m, f in kinds if f == "mlp")
    want = {("matmul", "plain"): 2 * gemms, ("matmul_bwd", "plain"): 2 * gemms}
    if "rwkv" in mixers:
        want.update({("wkv", "plain"): 2 * mixers.count("rwkv"),
                     ("wkv_bwd", "plain"): mixers.count("rwkv")})
    if "swa" in mixers:
        want.update({("attention", "plain"): 2 * mixers.count("swa"),
                     ("attention_bwd", "plain"): mixers.count("swa")})
    assert routes == want


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_forward_and_prefill_match_jax(case):
    """Logits within 1e-5 of max |logit|; ``prefill`` gives the last
    position's (and, with ``last_idx``, each row's chosen position's)."""
    params_np, batch, _, _, logits_j = _jax_case(case)
    model = _port(case, remat=False)
    params = params_from_jax(params_np, "cpu", F32)
    toks = {"tokens": torch.from_numpy(batch["tokens"])}
    with torch.no_grad():
        logits = model.forward(params, toks)
        last = model.prefill(params, toks)
        picked = model.prefill(params, toks,
                               last_idx=torch.tensor([3, S - 1]))
    _close(logits, logits_j, case)
    torch.testing.assert_close(last, logits[:, -1])
    torch.testing.assert_close(picked, torch.stack([logits[0, 3],
                                                    logits[1, -1]]))


# ------------------------------------------------------------ CLI
# per step, remat doubling every forward: rwkv6-7b smoke (2 layers) runs
# the WKV twice a layer and its backward once, and only the head on B1;
# recurrentgemma-9b smoke (rglru, swa, rglru, GeGLU MLPs) 13 layer GEMMs,
# one local attention
CLI_ROUTES = {
    "rwkv6-7b": {("wkv", "plain"): 4, ("wkv_bwd", "plain"): 2,
                 ("matmul", "plain"): 16, ("matmul_bwd", "plain"): 16},
    "recurrentgemma-9b": {("attention", "plain"): 2,
                          ("attention_bwd", "plain"): 1,
                          ("matmul", "plain"): 2 * (13 + 8),
                          ("matmul_bwd", "plain"): 2 * (13 + 8)},
}


@pytest.mark.parametrize("arch", sorted(CLI_ROUTES))
def test_train_cli_on_the_cpu(arch, tmp_path, capsys):
    """3 steps of the smoke config (8 xent chunks), each layer and chunk
    recomputed once in the backward: exact routes."""
    report = {}
    losses = train_cli.main(
        ["--arch", arch, "--smoke", "--steps", "3", "--batch", "2",
         "--seq", "16", "--log-every", "1", "--device", "cpu", "--ckpt-dir",
         str(tmp_path / "ck")], report=report)
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "done: 3 steps" in out and "[dispatch] routes:" in out
    assert report["routes"] == {k: 3 * n for k, n in CLI_ROUTES[arch].items()}
    assert report["aux"] == [0.0, 0.0, 0.0]
    assert report["checkpoint_bytes"] > 0
