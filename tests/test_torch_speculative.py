"""Speculative decoding in the port against the JAX package's.

The checks of ``tests/test_speculative.py`` on the port, plus parity:

1. units -- ``accept_longest_prefix``, the ``NgramDrafter``,
   ``make_draft_config`` and ``make_drafter``'s refusals, as in the JAX
   package; the model drafter's params are the target's leading layers,
   equal to the JAX package's draft params (``draft_params`` across a
   prefix + stacked-period layout);
2. differential -- greedy speculative streams equal the port's
   non-speculative streams and the JAX package's speculative streams, with
   the JAX package's ``verify_steps`` / ``spec_*`` counters, for both
   drafters on the static ``run_speculative`` path and the continuous
   engine;
3. runtime -- verify runs the ragged prefill attention op and no other
   attention; host rollback keeps ``check_page_accounting`` under an
   oversubscribed pool with prefix sharing, int8 KV and window
   reclamation; ``prepare_verify`` copies shared pages before the
   window's writes; and ``verify_step_paged``'s logits match the JAX
   package's within 1e-3 (the tolerance of ``tests/test_torch_model.py``
   and of the JAX package's paged-vs-dense check).

Both packages run the tiny config of ``tests/test_speculative.py`` on the
same params (``params_from_jax``), fp32, with the JAX side on its
reference dispatch and one JAX model per configuration.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import ARCHS as JAX_ARCHS
from repro.core.memory import DtypePolicy as JaxPolicy
from repro.launch import engine as jax_engine
from repro.launch import serve as jax_serve
from repro.launch import speculative as jax_spec
from repro.models.transformer import ExecOptions, Model as JaxModel
from repro.tune import cache as tune_cache
from repro_torch.configs import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.core.memory import DtypePolicy
from repro_torch.kernels import dispatch
from repro_torch.launch import engine, serve
from repro_torch.launch.loadgen import Request
from repro_torch.launch.speculative import (NgramDrafter,
                                            accept_longest_prefix,
                                            draft_params, make_draft_config,
                                            make_drafter)
from repro_torch.models.transformer import Model

torch.set_num_threads(1)
TINY = dict(d_model=32, n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64,
            vocab_size=128)
SPEC_COUNTERS = ("verify_steps", "spec_drafted", "spec_accepted",
                 "spec_emitted", "prefill_tokens", "truncated", "rejected",
                 "shared_tokens_total", "cow_copies", "pages_reclaimed")
F32 = DtypePolicy(compute=torch.float32)
JF32 = JaxPolicy(compute=jnp.float32)


@pytest.fixture(autouse=True)
def empty_plan_cache(tmp_path, monkeypatch):
    """The JAX side reads no tuned-plan state left by other tests."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "empty.json"))
    tune_cache.preload()
    yield
    monkeypatch.undo()
    tune_cache.preload()


def _tiny(archs, name, layers=None, **overrides):
    cfg = dataclasses.replace(archs[name].smoke(), **dict(TINY, **overrides))
    return cfg.with_layers(layers) if layers else cfg


CONFIGS = {
    "gemma-2b": ("gemma-2b", None, {}),
    # every layer windowed (reclamation on), int8 KV pages
    "swa-int8": ("gemma3-4b", (("swa", "mlp"),) * 2, dict(kv_dtype="int8")),
}
_BUILT = {}


def _pair(name):
    """(JAX model, JAX params, port model, port params) of a config, built
    once per module so the JAX side's compiled steps are reused."""
    if name not in _BUILT:
        arch, layers, overrides = CONFIGS[name]
        jcfg = _tiny(JAX_ARCHS, arch, layers, dispatch="reference",
                     **overrides)
        tcfg = _tiny(ARCHS, arch, layers, **overrides)
        jmodel = JaxModel(jcfg, dt=JF32, opts=ExecOptions(mode="run"))
        jparams = jmodel.init(jax.random.key(0))
        tmodel = Model(tcfg, dt=F32, device="cpu")
        tparams = params_from_jax(jax.device_get(jparams), "cpu",
                                  torch.float32)
        _BUILT[name] = (jmodel, jparams, tmodel, tparams)
    return _BUILT[name]


def _schedulers(name="gemma-2b", *, slots=2, max_len=32, page=4,
                total_pages=0, prefix_cache=False):
    jmodel, jparams, tmodel, tparams = _pair(name)
    kw = dict(slots=slots, max_len=max_len, page_size=page,
              total_pages=total_pages, prefix_cache=prefix_cache, log=None)
    return (jax_serve.PagedScheduler(jmodel, jparams, **kw),
            serve.PagedScheduler(tmodel, tparams, **kw))


def _drafters(kind, name="gemma-2b", **kw):
    """The JAX drafter and the port's, the port's model drafter built
    from the port target's params (``draft_params``)."""
    jmodel, _, tmodel, tparams = _pair(name)
    if kind == "ngram":
        return (jax_spec.NgramDrafter(max_draft=kw["max_draft"]),
                NgramDrafter(max_draft=kw["max_draft"]))
    jd = jax_spec.make_drafter("model", jmodel.cfg, dt=JF32,
                               rng_key=jax.random.key(0), **kw)
    td = make_drafter("model", tmodel.cfg, target=tmodel,
                      target_params=tparams, **kw)
    return jd, td


def _prompts(n, rng_seed=5, lo=3, hi=9):
    rng = np.random.default_rng(rng_seed)
    return [rng.integers(0, 128, rng.integers(lo, hi)) for _ in range(n)]


def _reqs(prompts, max_new):
    return [Request(i, np.array(p), max_new) for i, p in enumerate(prompts)]


def _streams(done):
    return {r.rid: list(r.out) for r in done}


def _counters(sched):
    return {k: getattr(sched, k) for k in SPEC_COUNTERS}


# ------------------------------------------------------------------- units
def test_accept_longest_prefix_semantics():
    assert accept_longest_prefix([], np.array([7])) == [7]
    assert accept_longest_prefix([1, 2], np.array([1, 2, 9])) == [1, 2, 9]
    assert accept_longest_prefix([1, 5], np.array([1, 2, 9])) == [1, 2]
    assert accept_longest_prefix([4, 5], np.array([1, 2, 3])) == [1]
    rng = np.random.default_rng(0)
    for _ in range(50):
        drafts = list(rng.integers(0, 3, rng.integers(0, 4)))
        preds = rng.integers(0, 3, len(drafts) + 1)
        assert accept_longest_prefix(drafts, preds) \
            == jax_spec.accept_longest_prefix(drafts, preds)


def test_ngram_drafter_replays_most_recent_suffix_match():
    d = NgramDrafter(max_draft=3, n=3)
    assert d.propose([[1, 2, 3, 9, 1, 2, 3]]) == [[9, 1, 2]]
    assert d.propose([[5, 6, 5]]) == [[6, 5]]
    assert d.propose([[1, 2, 3, 4]]) == [[]]
    assert d.propose([[], [7]]) == [[], []]
    with pytest.raises(ValueError, match="max_draft"):
        NgramDrafter(max_draft=-1)
    hists = [list(h) for h in _prompts(20, rng_seed=2, lo=1, hi=30)]
    for n, min_n in ((3, 1), (2, 2), (4, 1)):
        assert NgramDrafter(max_draft=4, n=n, min_n=min_n).propose(hists) \
            == jax_spec.NgramDrafter(max_draft=4, n=n,
                                     min_n=min_n).propose(hists)


def test_make_draft_config_truncates_leading_layers():
    cfg = _tiny(ARCHS, "gemma3-4b")               # 3-layer smoke stack
    kinds = cfg.layer_kinds()
    half = make_draft_config(cfg)
    assert half.layer_kinds() == kinds[:max(1, len(kinds) // 2)]
    assert half.name == cfg.name + "-draft"
    assert half.vocab_size == cfg.vocab_size
    two = make_draft_config(cfg, n_layers=2)
    assert two.layer_kinds() == kinds[:2]
    jcfg = _tiny(JAX_ARCHS, "gemma3-4b")
    for n in (0, 1, 2, 3):
        assert make_draft_config(cfg, n).layer_kinds() \
            == jax_spec.make_draft_config(jcfg, n).layer_kinds()


def test_make_drafter_rejects_unknown_kind_and_vocab_mismatch():
    cfg = _tiny(ARCHS, "gemma-2b")
    with pytest.raises(ValueError, match="unknown drafter"):
        make_drafter("medusa", cfg)
    other = Model(_tiny(ARCHS, "gemma-2b", vocab_size=64), dt=F32,
                  device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        make_drafter("model", cfg, model=other, params=other.init(seed=0))
    with pytest.raises(ValueError, match="target"):
        make_drafter("model", cfg)


def test_draft_params_are_the_targets_leading_layers():
    """Across a prefix + stacked-period + tail layout, the port's draft
    takes the target's layers by execution index: the JAX package's draft
    params (initialized from the target's key) to the bit."""
    kinds = (("swa", "mlp"), ("attn", "mlp"))
    layout = dict(n_layers=6, prefix=(("attn", "mlp"),), pattern=kinds)
    jcfg = dataclasses.replace(_tiny(JAX_ARCHS, "gemma3-4b"), **layout,
                               dispatch="reference")
    tcfg = dataclasses.replace(_tiny(ARCHS, "gemma3-4b"), **layout)
    jmodel = JaxModel(jcfg, dt=JF32, opts=ExecOptions(mode="run"))
    tmodel = Model(tcfg, dt=F32, device="cpu")
    assert tmodel.layout.n_periods == 2 and len(tmodel.layout.tail) == 1
    tparams = params_from_jax(jax.device_get(jmodel.init(jax.random.key(0))),
                              "cpu", torch.float32)
    for n in (4, 6):             # into the second period; through the tail
        dcfg = jax_spec.make_draft_config(jcfg, n)
        jdraft = JaxModel(dcfg, dt=JF32, opts=ExecOptions(mode="run"))
        want = params_from_jax(jax.device_get(jdraft.init(jax.random.key(0))),
                               "cpu", torch.float32)
        got = draft_params(tmodel, tparams, n)
        flat_w, flat_g = [], []
        jax.tree.map(flat_w.append, want)
        jax.tree.map(flat_g.append, got)
        assert len(flat_g) == len(flat_w)
        assert all(torch.equal(g, w) for g, w in zip(flat_g, flat_w))
    with pytest.raises(ValueError, match="layers"):
        draft_params(tmodel, tparams, 7)


# ----------------------------------------------------------- differentials
def _static_parity(kind, prompts, max_new, **dkw):
    base = _schedulers()[1]
    want = _streams(base.run(_reqs(prompts, max_new)))
    jsched, tsched = _schedulers()
    jd, td = _drafters(kind, **dkw)
    jdone = jsched.run_speculative(_reqs(prompts, max_new), jd)
    tdone = tsched.run_speculative(_reqs(prompts, max_new), td)
    got = _streams(tdone)
    assert got == want == _streams(jdone)
    assert _counters(tsched) == _counters(jsched)
    assert tsched.verify_steps > 0
    assert tsched.spec_emitted >= tsched.verify_steps
    # prefill emits each request's first token; verify emits the rest
    assert tsched.spec_emitted == sum(len(o) - 1 for o in got.values())
    tsched.check_page_accounting()
    return tsched


def test_static_ngram_speculative_matches_baseline_and_jax():
    _static_parity("ngram", _prompts(5), 6, max_draft=3)


def test_static_model_drafter_matches_baseline_and_jax():
    """A full-depth draft is the target itself, so drafts agree with the
    verify and acceptance is exercised; the streams stay the baseline's
    by the acceptance rule alone."""
    n_layers = len(_pair("gemma-2b")[2].cfg.layer_kinds())
    sched = _static_parity("model", _prompts(4, rng_seed=8), 5, max_draft=2,
                           draft_layers=n_layers, pad_to=34, batch_pad=2)
    assert sched.spec_drafted > 0 and sched.spec_accepted > 0


@pytest.mark.parametrize("kind", ["ngram", "model"])
def test_engine_speculative_matches_baseline_and_jax(kind):
    prompts = _prompts(4, rng_seed=13)

    def serve_port(drafter):
        _, tsched = _schedulers()
        eng = engine.ContinuousEngine(tsched, clock="tick", drafter=drafter,
                                      log=None)
        return _streams(eng.run(_reqs(prompts, 5))), eng

    want, plain = serve_port(None)
    assert plain.metrics.summary()["spec_accept_rate"] is None
    dkw = (dict(max_draft=3) if kind == "ngram"
           else dict(max_draft=2, pad_to=34, batch_pad=2))
    jd, td = _drafters(kind, **dkw)
    got, eng = serve_port(td)
    jsched, _ = _schedulers()
    jeng = jax_engine.ContinuousEngine(jsched, clock="tick", drafter=jd,
                                       log=None)
    jgot = _streams(jeng.run(_reqs(prompts, 5)))
    assert got == want == jgot, f"{kind} stream diverged"
    s = eng.metrics.summary()
    assert s == jeng.metrics.summary()
    assert s["spec_tokens_per_step"] >= 1.0   # >= 1 token per verify
    assert _counters(eng.sched) == _counters(jsched)
    assert eng.iterations == jeng.iterations
    assert eng.sched.verify_steps > 0


# ------------------------------------------------------ runtime properties
def test_verify_routes_through_prefill_attention():
    """The verify forward is the ragged prefill op: no other attention
    runs in a speculative static run (the route counters are the
    proof), one call per layer per verify step besides prefill."""
    _, sched = _schedulers(slots=1)
    with dispatch.stats_scope() as stats:
        done = sched.run_speculative(
            [Request(0, np.arange(6) % 128, 4)], NgramDrafter(max_draft=2))
        counts = stats()
    assert len(done) == 1 and done[0].done
    n_layers = len(sched.model.cfg.layer_kinds())
    assert set(k[0] for k in counts) == {"matmul", "prefill_attention"}
    # one prefill chunk per page of the 6-token prompt, then the verifies
    assert counts[("prefill_attention", "plain")] \
        == n_layers * (2 + sched.verify_steps)


def test_rollback_accounting_oversubscribed_int8_prefix_sharing():
    """The stress composition of the JAX package's test: all-swa stack
    (window reclamation live), int8 KV, prefix-sharing copy-on-write and
    an oversubscribed pool.  ``check_page_accounting`` asserts inside
    every scheduler mutation, post-rollback included; streams match the
    non-speculative scheduler and the JAX package's speculative run, and
    the counters match the JAX package's."""
    rng = np.random.default_rng(21)
    base_prompt = rng.integers(0, 128, 16)
    prompts = [base_prompt, base_prompt.copy(),          # sharers
               rng.integers(0, 128, 12), rng.integers(0, 128, 8),
               base_prompt.copy(), rng.integers(0, 128, 10)]
    kw = dict(slots=3, max_len=32, page=4, total_pages=15,
              prefix_cache=True)
    ref = _schedulers("swa-int8", **kw)[1]
    assert ref.window > 0, "all-swa stack should enable reclamation"
    want = _streams(ref.run(_reqs(prompts, 6)))

    jsched, spec = _schedulers("swa-int8", **kw)
    done = spec.run_speculative(_reqs(prompts, 6), NgramDrafter(max_draft=3))
    jdone = jsched.run_speculative(_reqs(prompts, 6),
                                   jax_spec.NgramDrafter(max_draft=3))
    got = _streams(done)
    assert got == want == _streams(jdone)
    assert _counters(spec) == _counters(jsched)
    assert len(done) == len(prompts) and all(r.done for r in done)
    spec.check_page_accounting()               # final post-rollback state
    assert spec.pages_reclaimed > 0            # window reclaim interleaved
    assert spec.shared_tokens_total > 0        # prefix hits interleaved
    assert all(r is None for r in spec.active)


def test_speculative_cow_through_prepare_verify():
    """A fully-covered sharer's verify window appends into published
    pages: prepare_verify copies them before the batched write, keeping
    both the sharer's stream and the published pages."""
    rng = np.random.default_rng(3)
    base_prompt = rng.integers(0, 128, 16)
    kw = dict(slots=2, max_len=32, page=4, prefix_cache=True)
    ref = _schedulers(**kw)[1]
    want = _streams(ref.run([Request(0, base_prompt, 4),
                             Request(1, base_prompt.copy(), 4)]))

    jsched, spec = _schedulers(**kw)
    out, jout = {}, {}
    for rid in (0, 1):
        done = spec.run_speculative(
            [Request(rid, base_prompt.copy(), 4)], NgramDrafter(max_draft=3))
        out[rid] = list(done[0].out)
        jdone = jsched.run_speculative(
            [Request(rid, base_prompt.copy(), 4)],
            jax_spec.NgramDrafter(max_draft=3))
        jout[rid] = list(jdone[0].out)
    assert out == want == jout
    assert spec.shared_tokens_total == 16      # repeat fully covered
    assert spec.cow_copies >= 1                # divergence copied
    assert _counters(spec) == _counters(jsched)
    spec.check_page_accounting()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_verify_step_paged_logits_match_jax(name):
    """One verify window (W = 4) per slot from mid-page lengths, one
    crossing a page edge and one slot inactive on the trash page, after a
    prefill: logits at every row within 1e-3, and the live pages (page 0
    excluded) within 1e-3 (float) or one int8 step."""
    jmodel, jparams, tmodel, tparams = _pair(name)
    page, slots, n_pages = 4, 3, 4
    rng = np.random.default_rng(5)
    total = 1 + slots * n_pages
    jcache = jmodel.init_paged_cache(slots, page * n_pages, page,
                                     total_pages=total)
    tcache = tmodel.init_paged_cache(slots, page * n_pages, page,
                                     total_pages=total)
    table = np.arange(1, total, dtype=np.int32).reshape(slots, n_pages)
    prompt = rng.integers(0, 128, (2, page)).astype(np.int32)
    _, jcache = jax.jit(jmodel.prefill_step_paged)(
        jparams, jcache, jnp.asarray(prompt), jnp.zeros(2, jnp.int32),
        jnp.asarray(table[:2]), jnp.full(2, page - 1, jnp.int32))
    i32 = torch.from_numpy
    tmodel.prefill_step_paged(tparams, tcache, i32(prompt),
                              torch.zeros(2, dtype=torch.int32),
                              i32(table[:2].copy()),
                              torch.full((2,), page - 1, dtype=torch.int32))
    lengths = np.array([3, 2, 0], np.int32)      # slot 0 crosses page 0->1
    view = table.copy()
    view[2] = 0                                  # inactive: trash page
    toks = rng.integers(0, 128, (slots, 4)).astype(np.int32)
    want, jcache = jax.jit(jmodel.verify_step_paged)(
        jparams, jcache, jnp.asarray(toks), jnp.asarray(lengths),
        jnp.asarray(view))
    got = tmodel.verify_step_paged(tparams, tcache, i32(toks), i32(lengths),
                                   i32(view))
    want = np.asarray(want)
    assert got.shape == want.shape == (slots, 4, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)
    jflat = [c for g in ("prefix", "stack", "tail")
             for c in jax.device_get(jcache)[g]]
    tflat = [c for g in ("prefix", "stack", "tail") for c in tcache[g]]
    for jc, tc in zip(jflat, tflat):
        for key in ("k_pages", "v_pages"):
            w = np.asarray(jc[key], np.float32)[1:]
            g = tc[key][1:].float().numpy()
            tol = 1.0 if tc[key].dtype == torch.int8 else 1e-3
            assert np.abs(g - w).max() <= tol, key
