"""The port's training stack against the JAX package's, on the CPU at
smoke widths.

* attention gradients: ``dispatch.attention`` and
  ``layers.attention_blockwise`` (the flash forward and fused backward
  routes) against JAX's kernel route (Pallas in interpret mode) for the
  gemma-2b (GQA 4:1), gemma3-4b (sliding window) and codeqwen1.5-7b (qkv
  bias) smoke geometries, at 5e-4 (tests/test_flash_backward.py's fp32
  tolerance);
* ``Model.loss_fn`` loss and gradients against
  ``jax.value_and_grad(model.loss_fn)`` on the same params
  (``convert.params_from_jax``), fp32 policy: loss within 1e-5, every
  gradient leaf within 5e-4, with JAX on its "reference" route for a
  stacked (scan) layout and a windowed arch, and once on "kernels";
* ``adamw_update`` (fp32 and int8 moments), ``lr_schedule``,
  ``clip_by_global_norm`` and ``SyntheticLM`` against the JAX package's;
* checkpoints, the supervisor's replay, and the CLI on the CPU.

Every input is made with numpy from a seed; JAX runs with ``dispatch``
passed explicitly and an empty tuned-plan cache.
"""
import dataclasses
import gc
import math
import weakref
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import ARCHS as JAX_ARCHS
from repro.core.memory import DtypePolicy as JaxPolicy
from repro.core.memory import dequantize_block as jax_dequantize_block
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.kernels import dispatch as jax_dispatch
from repro.models import layers as jax_layers
from repro.models.transformer import ExecOptions as JaxExecOptions
from repro.models.transformer import Model as JaxModel
from repro.models.transformer import _attn_spec as jax_attn_spec
from repro.optim import adamw as jax_adamw
from repro.tune import cache as tune_cache
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.core import tree
from repro_torch.core.memory import F32_POLICY, dequantize_block
from repro_torch.data.pipeline import DataConfig, SyntheticLM, make_pipeline
from repro_torch.kernels import dispatch
from repro_torch.launch import train as train_cli
from repro_torch.models import layers
from repro_torch.models.transformer import ExecOptions, Model, _attn_spec
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import FailureInjector, Supervisor
from repro_torch.train.steps import (TrainStepConfig, init_train_state,
                                     make_train_step)

torch.set_num_threads(1)
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
B, S = 2, 16
GEOMETRIES = {"gemma-2b": {}, "gemma3-4b": {"window": 5},
              "codeqwen1.5-7b": {}}
SCAN = dict(n_layers=3, prefix=(("attn", "mlp"),),
            pattern=(("attn", "mlp"),))
LOSS_CASES = {
    "gemma-2b-scan-reference": ("gemma-2b", SCAN, "reference"),
    "gemma3-4b-window-reference": ("gemma3-4b", {"window": 5},
                                   "reference"),
    "gemma-2b-scan-kernels": ("gemma-2b", SCAN, "kernels"),
}


@pytest.fixture(autouse=True)
def empty_plan_cache(tmp_path, monkeypatch):
    """The JAX side reads no tuned-plan state left by other tests."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "empty.json"))
    tune_cache.preload()
    yield
    monkeypatch.undo()
    tune_cache.preload()


def _configs(arch, overrides, route):
    jcfg = dataclasses.replace(JAX_ARCHS[arch].smoke(), dispatch=route,
                               **overrides)
    tcfg = dataclasses.replace(ARCHS[arch].smoke(), **overrides)
    return jcfg, tcfg


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype)


def _assert_tree_close(got, want, what, **tol):
    flat_g, flat_w = tree.leaves(got), tree.leaves(want)
    assert len(flat_g) == len(flat_w)
    for i, (g, w) in enumerate(zip(flat_g, flat_w)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=f"{what} leaf {i}", **tol)


def _sorted_np(tree_):
    """A JAX tree as numpy with dicts in sorted order (``core.tree``'s)."""
    if isinstance(tree_, dict):
        return {k: _sorted_np(tree_[k]) for k in sorted(tree_)}
    if isinstance(tree_, (list, tuple)):
        return [_sorted_np(v) for v in tree_]
    return np.asarray(tree_, np.float32)


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("arch", sorted(GEOMETRIES))
def test_dispatch_attention_gradients_match_jax(arch):
    jcfg, tcfg = _configs(arch, GEOMETRIES[arch], "kernels")
    h, hd = tcfg.n_heads, tcfg.head_dim
    rng = np.random.default_rng(len(arch))
    q, k, v, cot = (rng.standard_normal((B, S, h, hd)).astype(np.float32)
                    for _ in range(4))
    window = tcfg.window

    def jloss(q_, k_, v_):
        out = jax_dispatch.attention(q_, k_, v_, causal=True, window=window,
                                     out_dtype=jnp.float32,
                                     policy="kernels")
        return jnp.sum(out * cot)
    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))

    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    with dispatch.stats_scope() as stats:
        out = dispatch.attention(*leaves, causal=True, window=window,
                                 out_dtype=torch.float32)
        got = torch.autograd.grad((out * _t(cot)).sum(), leaves)
        routes = stats()
    assert routes == {("attention", "plain"): 1,
                      ("attention_bwd", "plain"): 1}
    _assert_tree_close(list(got), list(want), arch, **GRAD_TOL)


@pytest.mark.parametrize("arch", sorted(GEOMETRIES))
def test_attention_blockwise_gradients_match_jax(arch):
    """d(sum(out * cot)) / d(params, x) of one attention block: covers
    the projections' matmul backward, RoPE, and the GQA reduction of
    dK/dV through ``_expand_kv``."""
    jcfg, tcfg = _configs(arch, GEOMETRIES[arch], "kernels")
    mixer = "swa" if tcfg.window else "attn"
    jspec, tspec = jax_attn_spec(jcfg, mixer), _attn_spec(tcfg, mixer)
    p = jax_layers.attention_init(jax.random.key(0), jspec)
    if tcfg.qkv_bias:               # non-zero biases, so their grads bind
        p = {k_: (v_ + 0.1 if k_.startswith("b") else v_)
             for k_, v_ in p.items()}
    rng = np.random.default_rng(7)
    x = (0.2 * rng.standard_normal((B, S, tcfg.d_model))).astype(np.float32)
    cot = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    jdt = JaxPolicy(compute=jnp.float32)

    def jloss(p_, x_):
        out = jax_layers.attention_blockwise(p_, jspec, x_, jnp.asarray(pos),
                                             jdt)
        return jnp.sum(out * cot)
    want = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))

    tp = params_from_jax(jax.device_get(p), "cpu", torch.float32)
    flat, rebuild = tree.flatten(tp)
    tx = _t(x).requires_grad_(True)
    for t in flat:
        t.requires_grad_(True)
    out = layers.attention_blockwise(rebuild(flat), tspec, tx,
                                     torch.from_numpy(pos), F32_POLICY)
    grads = torch.autograd.grad((out * _t(cot)).sum(), flat + [tx])
    _assert_tree_close(rebuild(list(grads[:-1])),
                       _sorted_np(jax.device_get(want[0])), arch,
                       **GRAD_TOL)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(want[1]),
                               **GRAD_TOL)


# ------------------------------------------------------------ loss_fn
@pytest.fixture(scope="module")
def jax_losses():
    """Each loss case's JAX params, batch, loss and gradients, computed
    once for the module."""
    out = {}
    for name, (arch, overrides, route) in LOSS_CASES.items():
        jcfg, _ = _configs(arch, overrides, route)
        model = JaxModel(jcfg, dt=JaxPolicy(compute=jnp.float32),
                         opts=JaxExecOptions(mode="run", block_q=8,
                                             block_kv=8, xent_chunks=4))
        params = model.init(jax.random.key(1))
        rng = np.random.default_rng(3)
        toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        (loss, _), grads = jax.jit(jax.value_and_grad(
            model.loss_fn, has_aux=True))(
                params, {k: jnp.asarray(v) for k, v in batch.items()})
        logits = jax.jit(model.forward)(params,
                                        {"tokens": jnp.asarray(batch[
                                            "tokens"])})
        out[name] = (jax.device_get(params), batch, float(loss),
                     jax.device_get(grads), np.asarray(logits))
    return out


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_gradients_match_jax(case, jax_losses):
    arch, overrides, _ = LOSS_CASES[case]
    params_np, batch, loss_j, grads_j, _ = jax_losses[case]
    _, tcfg = _configs(arch, overrides, "")
    model = Model(tcfg, dt=F32_POLICY, device="cpu",
                  opts=ExecOptions(block_q=8, block_kv=8, xent_chunks=4))
    params = params_from_jax(params_np, "cpu", torch.float32)
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
    assert float(metrics["xent"].detach()) == loss
    _assert_tree_close(rebuild(list(grads)), _sorted_np(grads_j), case,
                       **GRAD_TOL)
    # every layer and xent chunk runs twice (remat), each backward once
    n_layers, chunks = tcfg.n_layers, 4
    assert routes == {("attention", "plain"): 2 * n_layers,
                      ("attention_bwd", "plain"): n_layers,
                      ("matmul", "plain"): 2 * (7 * n_layers + chunks),
                      ("matmul_bwd", "plain"): 2 * (7 * n_layers + chunks)}


def test_forward_and_prefill_match_jax(jax_losses):
    arch, overrides, _ = LOSS_CASES["gemma-2b-scan-reference"]
    params_np, batch, _, _, logits_j = jax_losses["gemma-2b-scan-reference"]
    _, tcfg = _configs(arch, overrides, "")
    model = Model(tcfg, dt=F32_POLICY, device="cpu",
                  opts=ExecOptions(remat=False))
    params = params_from_jax(params_np, "cpu", torch.float32)
    toks = {"tokens": torch.from_numpy(batch["tokens"])}
    with torch.no_grad():
        logits = model.forward(params, toks)
        last = model.prefill(params, toks)
    np.testing.assert_allclose(logits.numpy(), logits_j, rtol=1e-3,
                               atol=1e-3)
    torch.testing.assert_close(last, logits[:, -1])


def test_unported_remat_policy_raises():
    """A policy the port does not have is refused; "dots" is ported
    (tests/test_torch_remat_dots.py holds it to "full" and to JAX)."""
    cfg = ARCHS["gemma-2b"].smoke()
    with pytest.raises(ValueError, match="remat_policy"):
        Model(cfg, device="cpu", opts=ExecOptions(remat_policy="offload"))
    model = Model(cfg, device="cpu", opts=ExecOptions(remat_policy="dots"))
    params = model.init(0)
    toks = torch.zeros((1, 4), dtype=torch.int64)
    loss, _ = model.loss_fn(params, {"tokens": toks, "labels": toks})
    assert torch.isfinite(loss)


# ------------------------------------------------------------ optimizer
def _grad_trees(n_steps):
    rng = np.random.default_rng(11)
    return [{"w": rng.standard_normal((3, 200)).astype(np.float32),
             "b": {"s": 0.01 * rng.standard_normal((5,)).astype(
                 np.float32)}} for _ in range(n_steps)]


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_adamw_update_matches_jax(int8):
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=5.0,
               int8_moments=int8)
    jcfg, tcfg = jax_adamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    rng = np.random.default_rng(12)
    p0 = {"w": rng.standard_normal((3, 200)).astype(np.float32),
          "b": {"s": rng.standard_normal((5,)).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, p0)
    js = jax_adamw.adamw_init(jp, jcfg)
    tp = {"w": _t(p0["w"]), "b": {"s": _t(p0["b"]["s"])}}
    ts = adamw.adamw_init(tp, tcfg)
    for g in _grad_trees(4):
        jp, js, jm = jax_adamw.adamw_update(jax.tree.map(jnp.asarray, g),
                                            js, jp, jcfg)
        tg = {"w": _t(g["w"]), "b": {"s": _t(g["b"]["s"])}}
        tp, ts, tm = adamw.adamw_update(tg, ts, tp, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(ts.count) == int(js.count) == 4
    _assert_tree_close(tp, _sorted_np(jp), "params", rtol=1e-5, atol=1e-6)
    for t_mom, j_mom in ((ts.m, js.m), (ts.v, js.v)):
        if int8:
            for tq, jq in zip(tree.leaves(t_mom, adamw._is_qb),
                              jax.tree.leaves(j_mom, is_leaf=lambda x: (
                                  hasattr(x, "block")))):
                # an int8 code may land one step apart on an fp32 tie
                diff = np.abs(tq.q.numpy().astype(int)
                              - np.asarray(jq.q).astype(int))
                assert diff.max() <= 1
                np.testing.assert_allclose(
                    dequantize_block(tq).numpy(),
                    np.asarray(jax_dequantize_block(jq)), rtol=2e-2,
                    atol=2e-2 * float(np.abs(np.asarray(jq.scale)).max()))
        else:
            _assert_tree_close(t_mom, _sorted_np(j_mom), "moments",
                               rtol=1e-5, atol=1e-7)


def test_lr_schedule_and_clipping_match_jax():
    cfg = dict(lr=3e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.2)
    jcfg, tcfg = jax_adamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(
            float(adamw.lr_schedule(tcfg, step)),
            float(jax_adamw.lr_schedule(jcfg, jnp.int32(step))), rtol=1e-6)
    g = _grad_trees(1)[0]
    for max_norm in (0.5, 1e3):
        jg, jn = jax_adamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                               max_norm)
        tg, tn = adamw.clip_by_global_norm(
            {"w": _t(g["w"]), "b": {"s": _t(g["b"]["s"])}}, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _assert_tree_close(tg, _sorted_np(jg), "clipped", rtol=1e-6,
                           atol=1e-7)


def test_synthetic_batches_are_bit_equal_to_jax():
    for kw in (dict(vocab_size=512, seq_len=16, global_batch=4, seed=3),
               dict(vocab_size=50, seq_len=9, global_batch=4, n_hosts=2,
                    host_id=1),
               dict(vocab_size=64, seq_len=8, global_batch=2, seed=5,
                    input_mode="embeddings", d_model=24)):
        jdata, tdata = JaxSyntheticLM(JaxDataConfig(**kw)), \
            SyntheticLM(DataConfig(**kw))
        for step in (0, 1, 17):
            jb, tb = jdata.batch_at(step), tdata.batch_at(step)
            assert sorted(jb) == sorted(tb)
            for key in jb:
                assert tb[key].dtype == jb[key].dtype
                np.testing.assert_array_equal(tb[key], jb[key])


def test_pipeline_prefetches_the_synthetic_stream():
    cfg = DataConfig(vocab_size=100, seq_len=8, global_batch=2, seed=5)
    it = make_pipeline(cfg, start_step=3)
    for step in (3, 4, 5):
        got, want = next(it), SyntheticLM(cfg).batch_at(step)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    it.close()


# ------------------------------------------------------------ state trees
def test_flatten_holds_no_leaf_past_its_caller():
    """``tree.flatten``'s walk once reached itself through its closure:
    the cycle held the leaves (a step's gradients, a run's params and
    moments) until the cycle collector ran, so a second run in the
    process (and each step's peak) carried the previous one's."""
    leaf = torch.zeros(3)
    probe = weakref.ref(leaf)
    state = adamw.AdamWState(torch.zeros(()), {"w": leaf}, [leaf])
    enabled = gc.isenabled()
    gc.disable()
    try:
        flat, rebuild = tree.flatten({"a": [leaf], "b": state})
        assert len(flat) == 4
        assert float(tree.tree_map(lambda t: t + 1, state).m["w"][0]) == 1
        del flat, rebuild, state, leaf
        assert probe() is None
    finally:
        if enabled:
            gc.enable()


def test_train_cli_frees_its_state_on_return(tmp_path):
    """The run's params and moments die with ``train.main``'s frames, not
    at the next cycle collection.  (The first ``torch.utils.checkpoint``
    call in a process imports torch._dynamo, whose import frames hold
    the caller's stack until a collection: one call is made first.)"""
    x = torch.ones(2, requires_grad=True)
    torch.utils.checkpoint.checkpoint(torch.sin, x, use_reentrant=False)
    probes = []
    real = train_cli.init_train_state

    def recording(*args, **kwargs):
        params, opt = real(*args, **kwargs)
        probes.extend(weakref.ref(t) for t in tree.leaves((params, opt)))
        return params, opt
    enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        with mock.patch.object(train_cli, "init_train_state", recording):
            train_cli.main(["--arch", "qwen2-moe-a2.7b", "--smoke",
                            "--steps", "2", "--batch", "2", "--seq", "16",
                            "--log-every", "5", "--device", "cpu",
                            "--ckpt-dir", str(tmp_path / "ck")])
        assert probes and not [p for p in probes if p() is not None]
    finally:
        if enabled:
            gc.enable()


# ------------------------------------------------------------ checkpoints
def _state():
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(4, 130, generator=gen),
              "stack": [{"a": torch.randn(2, 3, generator=gen)
                         .to(torch.bfloat16)}]}
    opt = adamw.adamw_init(params, adamw.AdamWConfig(int8_moments=True))
    return params, opt


def _equal_trees(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_checkpoint_roundtrip_keep_and_torn_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = _state()
    for step in (1, 2, 3):
        mgr.save(step, state, extra={"step": step})
    assert mgr.steps() == [2, 3]
    assert mgr.last_bytes > 0
    # a torn save: a .tmp directory and a step directory without manifest
    (tmp_path / "step_00000009.tmp").mkdir()
    (tmp_path / "step_00000007").mkdir()
    assert mgr.latest_step() == 3
    restored, step, extra = mgr.restore(_state())
    assert step == 3 and extra == {"step": 3}
    assert _equal_trees(restored, state)
    assert isinstance(restored[1], adamw.AdamWState)
    with pytest.raises(ValueError):
        mgr.restore({"only": torch.zeros(1)})


def test_checkpoint_async_copies_before_returning(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    params, opt = _state()
    want = {k: v for k, v in tree.flatten(params)[1](
        [t.clone() for t in tree.leaves(params)]).items()}
    mgr.save(5, (params, opt))
    params["w"].add_(1.0)          # an in-place update right after
    mgr.wait()
    restored, step, _ = mgr.restore((params, opt))
    assert step == 5
    assert _equal_trees(restored[0], want)


# ------------------------------------------------------------ supervisor
def _tiny_training(tmp_path, name, fail_steps):
    cfg = dataclasses.replace(ARCHS["gemma-2b"].smoke(), d_model=32,
                              n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64,
                              vocab_size=64)
    model = Model(cfg, device="cpu", opts=ExecOptions(xent_chunks=2))
    ts = TrainStepConfig(opt=adamw.AdamWConfig(lr=1e-2, warmup_steps=1))
    step_fn = make_train_step(model, ts)
    data = SyntheticLM(DataConfig(vocab_size=64, seq_len=8, global_batch=2))

    def one(state, step):
        batch = {k: torch.from_numpy(v)
                 for k, v in data.batch_at(step).items()}
        params, opt, metrics = step_fn(*state, batch)
        return (params, opt), metrics

    sup = Supervisor(CheckpointManager(str(tmp_path / name)), save_every=1,
                     injector=FailureInjector(fail_steps))
    state, final = sup.run(init_train_state(model, ts, seed=0), one, 4)
    return state, final, sup.restarts


def test_microbatches_accumulate_to_the_full_batch_step():
    """Two microbatches of 2 average to the gradient of the batch of 4
    (the loss is a mean over equal-sized halves)."""
    cfg = dataclasses.replace(ARCHS["gemma-2b"].smoke(), d_model=32,
                              n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64,
                              vocab_size=64)
    model = Model(cfg, dt=F32_POLICY, device="cpu",
                  opts=ExecOptions(xent_chunks=2))
    data = SyntheticLM(DataConfig(vocab_size=64, seq_len=8, global_batch=4))
    batch = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
    results = []
    for mb in (1, 2):
        ts = TrainStepConfig(opt=adamw.AdamWConfig(lr=1e-2, warmup_steps=1),
                             microbatches=mb)
        params, opt, metrics = make_train_step(model, ts)(
            *init_train_state(model, ts, seed=0), batch)
        results.append((params, float(metrics["loss"]),
                        float(metrics["grad_norm"])))
    (p1, loss1, g1), (p2, loss2, g2) = results
    assert math.isclose(loss1, loss2, rel_tol=1e-5)
    assert math.isclose(g1, g2, rel_tol=1e-4)
    _assert_tree_close(p2, tree.tree_map(lambda t: t.numpy(), p1),
                       "params", rtol=1e-5, atol=1e-6)


def test_supervisor_replay_reaches_the_clean_params(tmp_path):
    clean, final, restarts = _tiny_training(tmp_path, "clean", ())
    assert (final, restarts) == (4, 0)
    faulty, final, restarts = _tiny_training(tmp_path, "faulty", (1, 3))
    assert (final, restarts) == (4, 2)
    assert _equal_trees(faulty, clean)


# ------------------------------------------------------------ CLI
# per arch: the GEMMs of one smoke layer (q, k, v, o and the MLP's three;
# MoE: the router and the shared MLP's three) and its expert contractions
CLI_ARCHS = {"gemma-2b": (7, 0), "qwen2-moe-a2.7b": (8, 3),
             "qwen2-vl-2b": (7, 0)}


@pytest.mark.parametrize("arch", sorted(CLI_ARCHS))
def test_train_cli_on_the_cpu(arch, tmp_path, capsys):
    """3 steps of the smoke config (2 layers, 8 xent chunks), each layer
    and chunk recomputed once in the backward: exact routes per arch
    (qwen2-vl-2b takes embeddings and M-RoPE positions)."""
    report = {}
    losses = train_cli.main(
        ["--arch", arch, "--smoke", "--steps", "3", "--batch", "2",
         "--seq", "16", "--log-every", "1", "--device", "cpu", "--ckpt-dir",
         str(tmp_path / "ck"), "--int8-moments", "--compress-grads"],
        report=report)
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "done: 3 steps" in out and "[dispatch] routes:" in out
    gemms, experts = CLI_ARCHS[arch]
    calls = 3 * 2 * (gemms * 2 + 8)
    want = {("attention", "plain"): 3 * 2 * 2,
            ("attention_bwd", "plain"): 3 * 2,
            ("matmul", "plain"): calls, ("matmul_bwd", "plain"): calls}
    if experts:
        want.update({("grouped_matmul", "plain"): 3 * 2 * 2 * experts,
                     ("grouped_matmul_bwd", "plain"): 3 * 2 * 2 * experts})
    routes = report["routes"]
    assert routes == want
    assert all(a > 0 for a in report["aux"]) == bool(experts)
    assert len(report["step_seconds"]) == 3
    assert report["checkpoint_bytes"] > 0
    assert CheckpointManager(str(tmp_path / "ck")).steps() == [3]
