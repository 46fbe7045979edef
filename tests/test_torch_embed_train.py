"""Training of the embedding-input archs against the JAX package, on the
CPU at smoke width: musicgen-large (frame embeddings in, a non-gated GELU
MLP, an untied head, an ``embed`` the loss never reads) and qwen2-vl-2b
(embeddings in, qkv biases, GQA, a tied head, M-RoPE positions).

* ``layers.apply_rope`` with M-RoPE sections and three distinct position
  streams against ``repro.models.layers.apply_rope`` within 1e-6;
* ``Model.loss_fn`` loss within 1e-5 relative and every gradient leaf
  within ``GRAD_TOL`` of ``jax.value_and_grad(model.loss_fn)`` on the
  same params (``convert.params_from_jax``), musicgen's unused ``embed``
  an all-zero gradient on both sides, and the routes of one loss and
  backward pinned;
* ``forward`` and ``prefill`` against JAX's;
* one whole train step (clipped AdamW, weight decay) of musicgen against
  JAX's ``make_train_step``: the zero gradient of ``embed`` decays it;
* the serving entry points refuse an embedding arch, as JAX's CLI does.

Every input is made with numpy from a seed; JAX runs with ``dispatch``
passed explicitly and an empty tuned-plan cache, one model per arch for
the module.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, strategies as st
from repro.configs.archs import ARCHS as JAX_ARCHS
from repro.core.memory import DtypePolicy as JaxPolicy
from repro.launch import serve as jax_serve
from repro.models import layers as jax_layers
from repro.models.transformer import ExecOptions as JaxExecOptions
from repro.models.transformer import Model as JaxModel
from repro.optim import adamw as jax_adamw
from repro.train import steps as jax_steps
from repro.tune import cache as tune_cache
from repro_torch.configs import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.core import tree
from repro_torch.core.memory import F32_POLICY
from repro_torch.kernels import dispatch
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.models.transformer import ExecOptions, Model
from repro_torch.optim import adamw
from repro_torch.train.steps import TrainStepConfig, make_train_step

torch.set_num_threads(1)
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)    # tests/test_torch_train.py's
B, S, CHUNKS = 2, 16, 4
# per arch: JAX's dispatch route, and the GEMMs of one layer (q, k, v, o
# and the MLP's: musicgen's non-gated wi/wd, qwen2-vl's wg/wu/wd)
EMBED_ARCHS = {"musicgen-large": ("reference", 6),
               "qwen2-vl-2b": ("kernels", 7)}
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=4)


@pytest.fixture(autouse=True)
def empty_plan_cache(tmp_path, monkeypatch):
    """The JAX side reads no tuned-plan state left by other tests."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "empty.json"))
    tune_cache.preload()
    yield
    monkeypatch.undo()
    tune_cache.preload()


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a).copy()).to(dtype)


def _sorted_np(tree_):
    """A JAX tree as numpy with dicts in sorted order (``core.tree``'s)."""
    if isinstance(tree_, dict):
        return {k: _sorted_np(tree_[k]) for k in sorted(tree_)}
    if isinstance(tree_, (list, tuple)):
        return [_sorted_np(v) for v in tree_]
    return np.asarray(tree_, np.float32)


def _assert_tree_close(got, want, what, **tol):
    flat_g, flat_w = tree.leaves(got), tree.leaves(want)
    assert len(flat_g) == len(flat_w)
    for i, (g, w) in enumerate(zip(flat_g, flat_w)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=f"{what} leaf {i}", **tol)


def mrope_positions(rng, b, s, n_sections):
    """Three different position streams: the text position and a seeded
    permutation of it per row for each further section (JAX's own
    training positions repeat the text position, which makes M-RoPE plain
    RoPE)."""
    streams = [np.broadcast_to(np.arange(s), (b, s))]
    streams += [np.stack([rng.permutation(s) for _ in range(b)])
                for _ in range(n_sections - 1)]
    return np.stack(streams, axis=-1).astype(np.int32)


def embed_batch(cfg, seed):
    """Frame embeddings (B, S, d), labels and, for an M-RoPE arch, three
    distinct position streams."""
    rng = np.random.default_rng(seed)
    batch = {"embeddings": rng.standard_normal(
                 (B, S, cfg.d_model)).astype(np.float32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32)}
    if cfg.mrope_sections:
        batch["positions"] = mrope_positions(rng, B, S,
                                             len(cfg.mrope_sections))
    return batch


def _configs(arch):
    jcfg = dataclasses.replace(JAX_ARCHS[arch].smoke(),
                               dispatch=EMBED_ARCHS[arch][0])
    return jcfg, ARCHS[arch].smoke()


def _jax_model(jcfg):
    return JaxModel(jcfg, dt=JaxPolicy(compute=jnp.float32),
                    opts=JaxExecOptions(mode="run", block_q=8, block_kv=8,
                                        xent_chunks=CHUNKS))


def _torch_model(tcfg, **opts):
    return Model(tcfg, dt=F32_POLICY, device="cpu",
                 opts=ExecOptions(block_q=8, block_kv=8, xent_chunks=CHUNKS,
                                  **opts))


# ------------------------------------------------------------ M-RoPE
@pytest.mark.parametrize("sections,hd", [((16, 24, 24), 128),
                                         ((4, 6, 6), 32)],
                         ids=["qwen2-vl-2b", "smoke"])
def test_mrope_matches_jax(sections, hd):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((B, S, 3, hd)).astype(np.float32)
    pos = mrope_positions(rng, B, S, len(sections)) * 37   # long angles
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                 theta=1e6, mrope_sections=sections)
    got = layers.apply_rope(_t(x), torch.from_numpy(pos), theta=1e6,
                            mrope_sections=sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # one stream in every section is plain RoPE
    same = np.repeat(pos[..., :1], len(sections), axis=-1)
    np.testing.assert_array_equal(
        layers.apply_rope(_t(x), torch.from_numpy(same), theta=1e6,
                          mrope_sections=sections).numpy(),
        layers.apply_rope(_t(x), torch.from_numpy(same[..., 0]),
                          theta=1e6).numpy())


@settings(max_examples=12, deadline=None)
@given(st.integers(1, 7), st.integers(1, 7), st.integers(0, 2 ** 31 - 1))
def test_mrope_any_sections_match_jax(first, second, seed):
    """Any split of hd/2 = 16 slots into three sections."""
    sections = (first, second, 16 - first - second)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 5, 2, 32)).astype(np.float32)
    pos = rng.integers(0, 4096, (1, 5, 3)).astype(np.int32)
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                 mrope_sections=sections)
    got = layers.apply_rope(_t(x), torch.from_numpy(pos),
                            mrope_sections=sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_mrope_refuses_mismatched_positions():
    x = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="M-RoPE"):
        layers.apply_rope(x, torch.zeros(1, 4, dtype=torch.int32),
                          mrope_sections=(4, 6, 6))
    with pytest.raises(ValueError, match="M-RoPE"):
        layers.apply_rope(x, torch.zeros(1, 4, 3, dtype=torch.int32),
                          mrope_sections=(4, 6, 4))


# ------------------------------------------------------------ loss_fn
@pytest.fixture(scope="module")
def jax_runs():
    """Per arch: JAX's params, batch, loss, gradients, logits and prefill
    logits, computed once for the module."""
    out = {}
    for arch in EMBED_ARCHS:
        jcfg, _ = _configs(arch)
        model = _jax_model(jcfg)
        params = model.init(jax.random.key(1))
        batch = embed_batch(jcfg, seed=len(arch))
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, _), grads = jax.jit(jax.value_and_grad(
            model.loss_fn, has_aux=True))(params, jbatch)
        inputs = {k: v for k, v in jbatch.items() if k != "labels"}
        logits = jax.jit(model.forward)(params, inputs)
        last = jax.jit(model.prefill)(params, inputs)
        out[arch] = (jax.device_get(params), batch, float(loss),
                     jax.device_get(grads), np.asarray(logits),
                     np.asarray(last))
    return out


def _tbatch(batch, keys=None):
    return {k: torch.from_numpy(v) for k, v in batch.items()
            if keys is None or k in keys}


@pytest.mark.parametrize("arch", sorted(EMBED_ARCHS))
def test_loss_and_gradients_match_jax(arch, jax_runs):
    params_np, batch, loss_j, grads_j, _, _ = jax_runs[arch]
    _, tcfg = _configs(arch)
    model = _torch_model(tcfg)
    params = params_from_jax(params_np, "cpu", torch.float32)
    flat, rebuild = tree.flatten(params)
    for t in flat:
        t.requires_grad_(True)
    with dispatch.stats_scope() as stats:
        loss, metrics = model.loss_fn(rebuild(flat), _tbatch(batch))
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        routes = stats()
    loss = float(loss.detach())
    assert math.isclose(loss, loss_j, rel_tol=1e-5), (loss, loss_j)
    assert float(metrics["aux"]) == 0.0
    grads = rebuild([torch.zeros_like(t) if g is None else g
                     for t, g in zip(flat, grads)])
    want = _sorted_np(grads_j)
    if tcfg.tie_embeddings:     # the tied head reads embed
        assert "head" not in grads
        assert float(grads["embed"].abs().max()) > 0
    else:                       # nothing reads musicgen's embed
        assert not np.any(want["embed"])
        assert not bool(grads["embed"].any())
    _assert_tree_close(grads, want, arch, **GRAD_TOL)
    # every layer and xent chunk runs twice (remat), each backward once
    n, gemms = tcfg.n_layers, EMBED_ARCHS[arch][1]
    assert routes == {("attention", "plain"): 2 * n,
                      ("attention_bwd", "plain"): n,
                      ("matmul", "plain"): 2 * (gemms * n + CHUNKS),
                      ("matmul_bwd", "plain"): 2 * (gemms * n + CHUNKS)}


@pytest.mark.parametrize("arch", sorted(EMBED_ARCHS))
def test_forward_and_prefill_match_jax(arch, jax_runs):
    params_np, batch, _, _, logits_j, last_j = jax_runs[arch]
    _, tcfg = _configs(arch)
    model = _torch_model(tcfg, remat=False)
    params = params_from_jax(params_np, "cpu", torch.float32)
    inputs = _tbatch(batch, ("embeddings", "positions"))
    with torch.no_grad():
        logits = model.forward(params, inputs)
        last = model.prefill(params, inputs)
    np.testing.assert_allclose(logits.numpy(), logits_j, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(last.numpy(), last_j, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(last, logits[:, -1])


@pytest.mark.parametrize("arch", sorted(EMBED_ARCHS))
def test_params_from_jax_carries_the_embedding_archs(arch, jax_runs):
    """The converted tree has the port's own init structure: musicgen's
    unused ``embed`` beside its untied ``head``; qwen2-vl's tied head (no
    ``head`` leaf) and qkv biases."""
    params_np = jax_runs[arch][0]
    _, tcfg = _configs(arch)
    got = params_from_jax(params_np, "cpu", torch.float32)
    mine = _torch_model(tcfg).init(0)
    assert sorted(got) == sorted(mine)
    assert [tuple(t.shape) for t in tree.leaves(got)] == \
        [tuple(t.shape) for t in tree.leaves(mine)]
    assert ("head" in got) == (not tcfg.tie_embeddings)
    attn = (got["prefix"] or got["stack"])[0]["attn"]
    assert ({"bq", "bk", "bv"} <= set(attn)) == tcfg.qkv_bias


# ------------------------------------------------------------ train step
def test_train_step_matches_jax_and_decays_the_unused_embed(jax_runs):
    """One clipped AdamW step of musicgen on the same params and batch:
    ``embed`` gets a zero gradient and only its weight decay."""
    arch = "musicgen-large"
    params_np, batch, _, _, _, _ = jax_runs[arch]
    jcfg, tcfg = _configs(arch)
    jts = jax_steps.TrainStepConfig(opt=jax_adamw.AdamWConfig(**OPT))
    jparams = jax.tree.map(jnp.asarray, params_np)
    jp, _, jm = jax.jit(jax_steps.make_train_step(_jax_model(jcfg), jts))(
        jparams, jax_adamw.adamw_init(jparams, jts.opt),
        {k: jnp.asarray(v) for k, v in batch.items()})
    ts = TrainStepConfig(opt=adamw.AdamWConfig(**OPT))
    params = params_from_jax(params_np, "cpu", torch.float32)
    embed0 = params["embed"].clone()
    tp, _, tm = make_train_step(_torch_model(tcfg), ts)(
        params, adamw.adamw_init(params, ts.opt), _tbatch(batch))
    assert math.isclose(float(tm["loss"]), float(jm["loss"]), rel_tol=1e-5)
    assert math.isclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                        rel_tol=1e-4)
    lr = float(tm["lr"])
    assert lr > 0
    torch.testing.assert_close(tp["embed"],
                               embed0 * (1 - lr * ts.opt.weight_decay),
                               rtol=1e-6, atol=0)
    # Adam's first step moves an entry by lr g / (|g| + eps): where |g| is
    # near eps, a gradient ulp moves it by a share of lr, so the absolute
    # limit is 1% of lr
    _assert_tree_close(tp, _sorted_np(jax.device_get(jp)), "params",
                       rtol=1e-5, atol=1e-2 * lr)


# ------------------------------------------------------------ serving
@pytest.mark.parametrize("arch", sorted(EMBED_ARCHS))
def test_serving_refuses_embedding_archs(arch):
    argv = ["--arch", arch, "--smoke", "--device", "cpu"]
    with pytest.raises(SystemExit) as mine:
        serve.main(argv)
    with pytest.raises(SystemExit) as theirs:
        jax_serve.main(argv[:3])
    assert str(mine.value) == str(theirs.value) \
        == "serving demo drives token-mode archs"
    # the model's decode step takes embeddings (and M-RoPE positions) on
    # both cache layouts; the paged prefill and verify forwards embed
    # tokens, as the JAX package's do, so they refuse
    model = Model(ARCHS[arch].smoke(), device="cpu")
    params = model.init(0)
    one = torch.zeros((1, 1), dtype=torch.int32)
    emb = torch.zeros((1, 1, model.cfg.d_model))
    cache = model.init_cache(1, 8)
    pools = model.init_paged_cache(1, 8, 4)
    assert model.decode_step(params, cache, embeddings=emb, pos=0).shape \
        == (1, model.cfg.vocab_size)
    assert model.decode_step(params, pools, embeddings=emb,
                             paged=(one[0], one + 1)).shape \
        == (1, model.cfg.vocab_size)
    calls = {
        "decode_step": lambda: model.decode_step(params, cache, one, pos=0),
        "prefill_step_paged": lambda: model.prefill_step_paged(
            params, pools, one, one[0], one, one[0]),
        "verify_step_paged": lambda: model.verify_step_paged(
            params, pools, one, one[0], one)}
    for name, call in calls.items():
        with pytest.raises(ValueError, match=f"{name}: arch"):
            call()
