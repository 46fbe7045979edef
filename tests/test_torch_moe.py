"""MoE in the port against the JAX package's, on the CPU at smoke width.

Every case runs the qwen2-moe-a2.7b smoke config (8 experts, top 2, a
64-wide fused shared MLP; fp32) on params made by the JAX package
(``params_from_jax``) and inputs made with numpy from a seed:

* ``moe_apply``: output and aux loss within 2e-4 (the fp32 ``TOLS`` of
  ``tests/test_dispatch_differential.py``) and the same expert choice, at
  top-k 1 and 2, a capacity that drops, no shared expert, and the
  swiglu, geglu and relu FFNs; routing ties go to the lower expert id, as
  ``jax.lax.top_k`` breaks them;
* ``dispatch.grouped_matmul`` forward and VJP against ``jax.vjp`` of the
  JAX op on its kernel route (per-expert Pallas matmuls in interpret
  mode), within 2e-4;
* ``Model.loss_fn`` (xent + aux) within 1e-5 relative and every gradient
  leaf within 1e-3 of its max |grad|, over a stacked-period layout;
* paged streams (static and continuous, float and int8 KV + int8 weights
  + prefix cache), dense ``Server`` streams and speculative streams and
  counters (n-gram and model drafters) equal to the JAX package's under
  the same schedule (MoE capacity depends on the batch's shape, so
  schedules may legitimately differ from each other);
* ``bind_params`` leaves the MoE layers float under int8 weights;
  ``params_from_jax`` carries the ``moe`` subtree, period axis included.

JAX runs with ``dispatch`` passed explicitly and an empty tuned-plan
cache; each JAX model is built once per module.
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
from repro.kernels import dispatch as jax_dispatch
from repro.launch import engine as jax_engine
from repro.launch import serve as jax_serve
from repro.launch import speculative as jax_spec
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tfm
from repro.tune import cache as tune_cache
from repro_torch.configs import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.core import tree
from repro_torch.core.memory import F32_POLICY, DtypePolicy
from repro_torch.kernels import dispatch
from repro_torch.kernels.matmul import (grouped_matmul_cuda,
                                        grouped_matmul_plain)
from repro_torch.kernels.matmul.matmul import split_plan
from repro_torch.launch import engine, serve
from repro_torch.launch.loadgen import Request, poisson_stream, trace_stream
from repro_torch.launch.speculative import NgramDrafter, make_drafter
from repro_torch.models import moe
from repro_torch.models.transformer import ExecOptions, Model, _moe_spec

torch.set_num_threads(1)
ARCH = "qwen2-moe-a2.7b"
TOL = dict(rtol=2e-4, atol=2e-4)
JF32 = JaxPolicy(compute=jnp.float32)
F32 = DtypePolicy(compute=torch.float32)
SCAN = dict(n_layers=3, prefix=(("attn", "moe"),),
            pattern=(("attn", "moe"),))
SLOTS, MAX_LEN, PAGE, TOTAL_PAGES = 2, 16, 4, 8
COUNTERS = ("prefill_tokens", "decode_steps", "decode_tokens", "rejected",
            "truncated", "shared_tokens_total", "cow_copies")
SPEC_COUNTERS = ("verify_steps", "spec_drafted", "spec_accepted",
                 "spec_emitted", "prefill_tokens", "truncated", "rejected")


@pytest.fixture(autouse=True)
def empty_plan_cache(tmp_path, monkeypatch):
    """The JAX side reads no tuned-plan state left by other tests."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "empty.json"))
    tune_cache.preload()
    yield
    monkeypatch.undo()
    tune_cache.preload()


def _cfgs(**overrides):
    jcfg = dataclasses.replace(JAX_ARCHS[ARCH].smoke(), dispatch="reference",
                               **overrides)
    tcfg = dataclasses.replace(ARCHS[ARCH].smoke(), **overrides)
    return jcfg, tcfg


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _streams(done):
    return {r.rid: list(r.out) for r in done}


# ------------------------------------------------------------ the layer
MOE_CASES = {
    "top2": {},
    "top1": dict(top_k=1),
    "capacity-drops": dict(capacity_factor=0.5),
    "no-shared": dict(n_shared_experts=0, shared_d_expert=0),
    "geglu": dict(activation="geglu"),
    "relu": dict(activation="relu"),
}


def _jax_choice(jp, jspec, tokens):
    """The JAX layer's expert ids (``moe.py:99-103``)."""
    logits = jax_dispatch.matmul(jnp.asarray(tokens),
                                 jp["router"].astype(jnp.float32),
                                 policy="reference")
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                    jspec.top_k)[1])


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_jax(case):
    jcfg, tcfg = _cfgs(**MOE_CASES[case])
    jspec, tspec = jax_tfm._moe_spec(jcfg), _moe_spec(tcfg)
    jp = jax_moe.moe_init(jax.random.key(3), jspec)
    tp = params_from_jax(jax.device_get(jp), "cpu", torch.float32)
    rng = np.random.default_rng(11)
    b, s = 2, 16
    x = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    jout, jaux = jax_moe.moe_apply(jp, jspec, jnp.asarray(x), JF32)
    with dispatch.stats_scope() as stats:
        tout, taux = moe.moe_apply(tp, tspec, _t(x), F32)
        routes = stats()
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    tokens = x.reshape(b * s, -1)
    eidx = moe.route(tp, tspec, _t(tokens))[1].numpy()
    np.testing.assert_array_equal(eidx, _jax_choice(jp, jspec, tokens))
    glu = tspec.activation in ("swiglu", "geglu")
    assert routes[("grouped_matmul", "plain")] == (3 if glu else 2)
    assert routes[("matmul", "plain")] == 1 + (
        (3 if glu else 2) if tspec.n_shared_experts else 0)
    if case == "capacity-drops":   # some expert is over its capacity
        load = np.bincount(eidx.reshape(-1), minlength=tspec.e_pad)
        assert load.max() > tspec.capacity(b * s)
    # the combine has a fixed order: a rerun gives the same bits
    again, _ = moe.moe_apply(tp, tspec, _t(x), F32)
    assert torch.equal(again, tout)


def test_moe_spec_and_counts_match_jax():
    jcfg, tcfg = _cfgs()
    jspec, tspec = jax_tfm._moe_spec(jcfg), _moe_spec(tcfg)
    fields = {f.name for f in dataclasses.fields(tspec)}
    assert fields == {f.name for f in dataclasses.fields(jspec)} \
        - {"dispatch"}
    assert all(getattr(tspec, f) == getattr(jspec, f) for f in fields)
    assert tspec.e_pad == jspec.e_pad
    assert [tspec.capacity(n) for n in range(1, 600, 7)] \
        == [jspec.capacity(n) for n in range(1, 600, 7)]
    full_j = jax_tfm._moe_spec(JAX_ARCHS[ARCH])
    full_t = _moe_spec(ARCHS[ARCH])
    assert moe.moe_param_count(full_t) == jax_moe.moe_param_count(full_j)
    # qwen2-moe's decode (4 slots) and prefill-chunk (4 x 64) capacities
    assert (full_t.capacity(4), full_t.capacity(256)) == (8, 24)


@pytest.mark.parametrize("top_k", [1, 2])
def test_routing_ties_go_to_the_lower_expert(top_k):
    """Equal probabilities: all eight (a zero router), and experts 3 and
    6 tied on top.  ``jax.lax.top_k`` returns the lower index first; so
    does the port's routing."""
    _, tcfg = _cfgs(top_k=top_k)
    spec = _moe_spec(tcfg)
    rng = np.random.default_rng(2)
    x = np.abs(rng.standard_normal((5, spec.d_model))).astype(np.float32)
    tied = np.zeros((spec.d_model, spec.e_pad), np.float32)
    tied[:, 3] = tied[:, 6] = 0.5
    for router, want in ((np.zeros_like(tied), [0, 1]), (tied, [3, 6])):
        got = moe.route({"router": _t(router)}, spec, _t(x))[1].numpy()
        jgot = np.asarray(jax.lax.top_k(jax.nn.softmax(
            jnp.asarray(x) @ jnp.asarray(router), axis=-1), top_k)[1])
        np.testing.assert_array_equal(got, jgot)
        assert (got == np.array(want[:top_k])).all()


# ------------------------------------------------------- the grouped op
@pytest.mark.parametrize("shape", [(3, 5, 24, 10), (1, 8, 16, 8)])
def test_grouped_matmul_and_vjp_match_jax(shape):
    """Forward and both gradients against ``jax.vjp`` of the JAX op on its
    kernel route (per-group Pallas matmuls in interpret mode)."""
    g, c, k, n = shape
    rng = np.random.default_rng(4)
    x, w, cot = (rng.standard_normal(s).astype(np.float32)
                 for s in ((g, c, k), (g, k, n), (g, c, n)))
    with jax_dispatch.stats_scope() as jstats:
        jout, vjp = jax.vjp(lambda a, b: jax_dispatch.grouped_matmul(
            a, b, policy="kernels"), jnp.asarray(x), jnp.asarray(w))
        jdx, jdw = vjp(jnp.asarray(cot))
        assert jstats()[("grouped_matmul", "kernel")] == 1
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    with dispatch.stats_scope() as stats:
        out = dispatch.grouped_matmul(tx, tw)
        dx, dw = torch.autograd.grad((out * _t(cot)).sum(), (tx, tw))
        routes = stats()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), **TOL)
    assert routes == {("grouped_matmul", "plain"): 1,
                      ("grouped_matmul_bwd", "plain"): 2}


def test_grouped_matmul_plain_and_plan():
    """The plain version's promoted dtype and fp32 accumulation; the split
    plan is a function of (G, K, N, dtype), B1's rule over all groups'
    tiles (one group: B1's own plan), and no split at qwen2-moe's
    expert shapes; the CUDA wrapper refuses CPU tensors."""
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((2, 3, 8))).to(torch.bfloat16)
    w = _t(rng.standard_normal((2, 8, 4))).to(torch.bfloat16)
    out = grouped_matmul_plain(x, w)
    assert out.dtype == torch.bfloat16
    want = torch.stack([(x[i].float() @ w[i].float()).to(torch.bfloat16)
                        for i in range(2)])
    assert torch.equal(out, want)
    for dt in (torch.bfloat16, torch.float32):
        for k, n in ((16384, 256), (2048, 16384), (100000, 60)):
            assert split_plan(k, n, dt, groups=1) == split_plan(k, n, dt)
        steps = {torch.bfloat16: 64, torch.float32: 32}[dt]
        assert split_plan(2048, 1408, dt, groups=60) \
            == (1, -(-2048 // steps))
        assert split_plan(1408, 2048, dt, groups=60) \
            == (1, -(-1408 // steps))
    with pytest.raises(ValueError, match="CUDA"):
        grouped_matmul_cuda(x, w)


# ------------------------------------------------------------ the model
@pytest.fixture(scope="module")
def jax_loss():
    """The JAX model's params, batch, loss terms and gradients over a
    stacked-period MoE layout, computed once."""
    jcfg, _ = _cfgs(**SCAN)
    model = jax_tfm.Model(jcfg, dt=JF32, opts=jax_tfm.ExecOptions(
        mode="run", block_q=8, block_kv=8, xent_chunks=4))
    params = model.init(jax.random.key(1))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        model.loss_fn, has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    return (jax.device_get(params), batch, float(loss),
            {k: float(v) for k, v in metrics.items()}, jax.device_get(grads))


def _sorted_np(tree_):
    if isinstance(tree_, dict):
        return {k: _sorted_np(tree_[k]) for k in sorted(tree_)}
    if isinstance(tree_, (list, tuple)):
        return [_sorted_np(v) for v in tree_]
    return np.asarray(tree_, np.float32)


def test_loss_and_gradients_match_jax(jax_loss):
    params_np, batch, loss_j, metrics_j, grads_j = jax_loss
    _, tcfg = _cfgs(**SCAN)
    model = Model(tcfg, dt=F32_POLICY, device="cpu",
                  opts=ExecOptions(block_q=8, block_kv=8, xent_chunks=4))
    assert model.layout.n_periods == 2
    flat, rebuild = tree.flatten(params_from_jax(params_np, "cpu",
                                                 torch.float32))
    for t in flat:
        t.requires_grad_(True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with dispatch.stats_scope() as stats:
        loss, metrics = model.loss_fn(rebuild(flat), tbatch)
        grads = torch.autograd.grad(loss, flat)
        routes = stats()
    loss = float(loss.detach())
    assert math.isclose(loss, loss_j, rel_tol=1e-5)
    assert math.isclose(float(metrics["aux"]), metrics_j["aux"],
                        rel_tol=1e-5)
    assert metrics_j["aux"] > 0
    assert math.isclose(float(metrics["xent"]) + float(metrics["aux"]),
                        loss, rel_tol=1e-6)
    want = tree.leaves(_sorted_np(grads_j))
    got = tree.leaves(rebuild(list(grads)))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-3 * scale, i
    # every layer runs twice (remat): three expert contractions each, and
    # two fp32 gradient contractions per expert contraction
    n = tcfg.n_layers
    assert routes[("grouped_matmul", "plain")] == 2 * 3 * n
    assert routes[("grouped_matmul_bwd", "plain")] == 2 * 3 * n


def test_params_from_jax_carries_the_moe_subtree():
    """The converted tree has the port's own init structure (keys and
    shapes, period axis included) and the JAX values; int8 binding
    quantizes attention only."""
    jcfg, tcfg = _cfgs(**SCAN)
    jparams = jax.device_get(jax_tfm.Model(jcfg, dt=JF32).init(
        jax.random.key(0)))
    converted = params_from_jax(jparams, "cpu", torch.float32)
    own = Model(tcfg, dt=F32_POLICY, device="cpu").init(seed=0)

    def shapes(t):
        return jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(converted) == shapes(own)
    stacked = converted["stack"][0]["moe"]
    assert set(stacked) == {"router", "wg", "wu", "wd", "shared"}
    assert stacked["wg"].shape == (2, 8, 128, 64)
    np.testing.assert_array_equal(
        stacked["shared"]["wd"].numpy(),
        np.asarray(jparams["stack"][0]["moe"]["shared"]["wd"]))
    model8 = Model(dataclasses.replace(tcfg, weights_dtype="int8"),
                   dt=F32_POLICY, device="cpu")
    bound = model8.bind_params(converted)
    for group in ("prefix", "stack"):
        layer = bound[group][0]
        assert isinstance(layer["attn"]["wq"], dict)
        assert all(torch.is_tensor(v) and v.dtype == torch.float32
                   for v in tree.leaves(layer["moe"]))
        assert layer["moe"]["wg"] is converted[group][0]["moe"]["wg"]


def test_decode_step_launches_per_layer(monkeypatch):
    """One decode forward routes every MoE layer's three expert
    contractions and its router and shared MLP through the GEMM ops: per
    layer 3 grouped calls and q, k, v, o, router and 3 shared GEMMs, plus
    the head (the launches ``chip_smoke.py`` asserts on the card)."""
    _, tcfg = _cfgs()
    model = Model(tcfg, dt=F32, device="cpu")
    params = model.init(seed=0)
    cache = model.init_paged_cache(2, 8, 4)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    with dispatch.stats_scope() as stats:
        model.decode_step(params, cache, torch.tensor([[5], [7]]),
                          paged=(torch.tensor([3, 0], dtype=torch.int32),
                                 table))
        routes = stats()
    n = tcfg.n_layers
    assert routes == {("grouped_matmul", "plain"): 3 * n,
                      ("matmul", "plain"): 8 * n + 1,
                      ("decode_attention", "plain"): n}


# ----------------------------------------------------------- serving
_BUILT = {}


def _pair(**overrides):
    """(JAX model, JAX params, port model, port params) for the smoke
    config with ``overrides``, built once per module."""
    key = tuple(sorted(overrides.items()))
    if key not in _BUILT:
        jcfg, tcfg = _cfgs(**overrides)
        jmodel = jax_tfm.Model(jcfg, dt=JF32,
                               opts=jax_tfm.ExecOptions(mode="run"))
        jparams = jmodel.init(jax.random.key(0))
        tmodel = Model(tcfg, dt=F32, device="cpu")
        tparams = params_from_jax(jax.device_get(jparams), "cpu",
                                  torch.float32)
        _BUILT[key] = (jmodel, jparams, tmodel, tparams)
    return _BUILT[key]


INT8 = dict(kv_dtype="int8", weights_dtype="int8")


def _schedulers(overrides, **extra):
    jmodel, jparams, tmodel, tparams = _pair(**overrides)
    kw = dict(slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
              total_pages=TOTAL_PAGES, log=None)
    kw.update(extra)
    return (jax_serve.PagedScheduler(jmodel, jparams, **kw),
            serve.PagedScheduler(tmodel, tparams, **kw))


def _stream():
    reqs = poisson_stream(6, rate=2.0, vocab_size=512, prompt_len=8,
                          max_new=6, seed=7, prompt_jitter=6)
    reqs.append(Request(99, np.arange(20) % 512, 3, arrival=1.5))
    return reqs


def _prefix_stream():
    """A publisher, a repeat, a page-aligned overlap and cold prompts."""
    rng = np.random.default_rng(21)
    base = [int(t) for t in rng.integers(0, 512, 12)]

    def cold(n):
        return [int(t) for t in rng.integers(0, 512, n)]
    events = [(0.0, base), (3.0, base), (3.0, base[:8] + cold(4)),
              (4.0, cold(11)), (6.0, base[:10]), (9.0, base)]
    return trace_stream([{"t": t, "tokens": toks, "max_new": 3}
                         for t, toks in events], vocab_size=512)


def _counters(sched):
    return {k: getattr(sched, k) for k in COUNTERS}


@pytest.mark.parametrize("variant", ["float", "int8-prefix"])
def test_paged_streams_match_jax(variant):
    """Static and continuous schedules, each against the JAX package's
    same schedule: streams, counters and the engine's metrics."""
    overrides, extra, stream = (({}, {}, _stream) if variant == "float"
                                else (INT8, dict(prefix_cache=True),
                                      _prefix_stream))
    jsched, tsched = _schedulers(overrides, **extra)
    jdone, tdone = jsched.run(stream()), tsched.run(stream())
    assert _streams(tdone) == _streams(jdone)
    assert _counters(tsched) == _counters(jsched)
    tsched.check_page_accounting()
    jsched, tsched = _schedulers(overrides, **extra)
    jeng = jax_engine.ContinuousEngine(jsched, clock="tick", log=None)
    teng = engine.ContinuousEngine(tsched, clock="tick", log=None)
    got, want = _streams(teng.run(stream())), _streams(jeng.run(stream()))
    assert got == want
    assert len({t for out in got.values() for t in out}) > 4
    assert teng.metrics.summary() == jeng.metrics.summary()
    assert teng.iterations == jeng.iterations
    assert _counters(tsched) == _counters(jsched)
    if variant == "int8-prefix":
        assert tsched.prefix.hits >= 2 and tsched.prefix.hits \
            == jsched.prefix.hits
    tsched.check_page_accounting()


def test_dense_server_streams_match_jax():
    jmodel, jparams, tmodel, tparams = _pair()
    kw = dict(slots=2, max_len=24, log=None)
    jsrv = jax_serve.Server(jmodel, jparams, **kw)
    tsrv = serve.Server(tmodel, tparams, **kw)

    def stream():
        return poisson_stream(5, rate=0.0, vocab_size=512, prompt_len=5,
                              max_new=6, seed=3, prompt_jitter=6)
    tdone, jdone = tsrv.run(stream()), jsrv.run(stream())
    assert _streams(tdone) == _streams(jdone)
    assert (tsrv.truncated, tsrv.rejected, tsrv.pos) \
        == (jsrv.truncated, jsrv.rejected, jsrv.pos)


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, rng.integers(3, 9)) for _ in range(n)]


def _reqs(prompts, max_new):
    return [Request(i, np.array(p), max_new) for i, p in enumerate(prompts)]


@pytest.mark.parametrize("kind", ["ngram", "model"])
def test_speculative_streams_and_counters_match_jax(kind):
    """Static ``run_speculative`` and the continuous engine, each against
    the JAX package's same run: streams and the verify counters."""
    jmodel, _, tmodel, tparams = _pair()
    if kind == "ngram":
        def drafters():
            return (jax_spec.NgramDrafter(max_draft=3),
                    NgramDrafter(max_draft=3))
    else:
        dkw = dict(max_draft=2, pad_to=34, batch_pad=2)

        def drafters():
            return (jax_spec.make_drafter("model", jmodel.cfg, dt=JF32,
                                          rng_key=jax.random.key(0), **dkw),
                    make_drafter("model", tmodel.cfg, target=tmodel,
                                 target_params=tparams, **dkw))
    kw = dict(max_len=32, total_pages=0)
    prompts = _prompts(4, 13)
    jd, td = drafters()
    jsched, tsched = _schedulers({}, **kw)
    jdone = jsched.run_speculative(_reqs(prompts, 5), jd)
    tdone = tsched.run_speculative(_reqs(prompts, 5), td)
    assert _streams(tdone) == _streams(jdone)
    spec = {k: getattr(tsched, k) for k in SPEC_COUNTERS}
    assert spec == {k: getattr(jsched, k) for k in SPEC_COUNTERS}
    assert spec["verify_steps"] > 0
    tsched.check_page_accounting()

    jd, td = drafters()
    jsched, tsched = _schedulers({}, **kw)
    jeng = jax_engine.ContinuousEngine(jsched, clock="tick", drafter=jd,
                                       log=None)
    teng = engine.ContinuousEngine(tsched, clock="tick", drafter=td,
                                   log=None)
    assert _streams(teng.run(_reqs(prompts, 5))) \
        == _streams(jeng.run(_reqs(prompts, 5)))
    assert teng.metrics.summary() == jeng.metrics.summary()
    assert {k: getattr(tsched, k) for k in SPEC_COUNTERS} \
        == {k: getattr(jsched, k) for k in SPEC_COUNTERS}
