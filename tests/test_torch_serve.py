"""The port's serving runtime against the JAX package's, end to end.

One tiny gemma-2b config (its head untied: with the tied, sqrt(d)-scaled
embedding, random weights just echo the last prompt token, and the streams
would carry no information), the JAX ``Model.init`` params converted for
the port, and one seeded request stream (Poisson arrivals with ragged
prompts, a pool small enough that admission waits for pages, prompts
long enough to hit the context wall, and one request that can never be
admitted).  The continuous engine on a tick clock and the static
scheduler must give the JAX package's token streams, admission order,
``ServeMetrics.summary()`` and scheduler counters exactly, with the page
accounting invariant holding throughout.

With the prefix cache on, a second stream shares a prompt prefix: a
publisher, a full repeat and a mid-page prefix (both fully covered, so
their first decode copies the shared page), a page-aligned partial
overlap and cold prompts, through a pool small enough that the trie
evicts.  Streams, admission order, metrics, scheduler counters and the
prefix counters (hits, misses, evictions, shared tokens, copies) must be
the JAX package's exactly.  ``tests/test_torch_serve_int8.py`` runs the
same checks with int8 KV pages and int8 weights.
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
from repro.models.transformer import ExecOptions, Model as JaxModel
from repro.tune import cache as tune_cache
from repro_torch.configs import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.core.memory import DtypePolicy
from repro_torch.launch import engine, serve
from repro_torch.launch.loadgen import Request, poisson_stream, trace_stream
from repro_torch.models.transformer import Model

torch.set_num_threads(1)
SLOTS, MAX_LEN, PAGE, TOTAL_PAGES = 2, 16, 4, 8
COUNTERS = ("prefill_tokens", "decode_steps", "decode_tokens", "rejected",
            "truncated")


@pytest.fixture(autouse=True)
def empty_plan_cache(tmp_path, monkeypatch):
    """The JAX side reads no tuned-plan state left by other tests."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "empty.json"))
    tune_cache.preload()
    yield
    monkeypatch.undo()
    tune_cache.preload()


@pytest.fixture(scope="module")
def models():
    """One JAX model (its jitted steps are reused by every scheduler) and
    the port's model holding the same params."""
    cfg = dataclasses.replace(JAX_ARCHS["gemma-2b"].smoke(),
                              dispatch="reference", tie_embeddings=False)
    jmodel = JaxModel(cfg, dt=JaxPolicy(compute=jnp.float32),
                      opts=ExecOptions(mode="run"))
    jparams = jmodel.init(jax.random.key(0))
    tcfg = dataclasses.replace(ARCHS["gemma-2b"].smoke(),
                               dispatch="reference", tie_embeddings=False)
    tmodel = Model(tcfg, dt=DtypePolicy(compute=torch.float32),
                   device="cpu")
    tparams = params_from_jax(jax.device_get(jparams), "cpu", torch.float32)
    return (jmodel, jparams), (tmodel, tparams)


def _stream():
    reqs = poisson_stream(6, rate=2.0, vocab_size=512, prompt_len=8,
                          max_new=6, seed=7, prompt_jitter=6)
    # a prompt >= max_len can never be admitted: counted, not served
    reqs.append(Request(99, np.arange(20) % 512, 3, arrival=1.5))
    return reqs


def _schedulers(models, **extra):
    (jmodel, jparams), (tmodel, tparams) = models
    kw = dict(slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
              total_pages=TOTAL_PAGES, log=None, **extra)
    return (jax_serve.PagedScheduler(jmodel, jparams, **kw),
            serve.PagedScheduler(tmodel, tparams, **kw))


def _prefix_stream():
    """Shared-prefix traffic on the arrival clock (page 4): a publisher,
    a full repeat and a 10-token prefix of it (fully covered: the first
    decode lands in a shared page), a page-aligned 8-token overlap and
    cold prompts, more than the 7-page pool holds at once."""
    rng = np.random.default_rng(21)
    base = [int(t) for t in rng.integers(0, 512, 12)]

    def cold(n):
        return [int(t) for t in rng.integers(0, 512, n)]
    events = [(0.0, base), (3.0, base), (3.0, base[:8] + cold(4)),
              (4.0, cold(11)), (6.0, base[:10]), (7.0, cold(9)),
              (9.0, base), (9.0, cold(12)), (12.0, base[:8] + cold(3))]
    return trace_stream([{"t": t, "tokens": toks, "max_new": 3}
                         for t, toks in events], vocab_size=512)


PREFIX_COUNTERS = COUNTERS + ("shared_tokens_total", "cow_copies")


def _prefix_counters(sched):
    out = {k: getattr(sched, k) for k in PREFIX_COUNTERS}
    out.update(hits=sched.prefix.hits, misses=sched.prefix.misses,
               evictions=sched.prefix.evictions,
               cached_pages=sched.prefix.n_pages())
    return out


def _check_prefix_parity(models):
    """The prefix-sharing engine and static scheduler against the JAX
    package's, on ``_prefix_stream``; returns the port's schedulers and
    engine for further checks."""
    jsched, tsched = _schedulers(models, prefix_cache=True)
    jeng = jax_engine.ContinuousEngine(jsched, clock="tick", log=None)
    teng = engine.ContinuousEngine(tsched, clock="tick", log=None)
    jdone = jeng.run(_prefix_stream())
    tdone = teng.run(_prefix_stream())
    assert _streams(tdone) == _streams(jdone) and len(tdone) == 9
    assert teng.admission_order == jeng.admission_order
    assert teng.metrics.summary() == jeng.metrics.summary()
    assert teng.iterations == jeng.iterations
    assert teng.max_resident_kv_bytes == jeng.max_resident_kv_bytes
    assert _prefix_counters(tsched) == _prefix_counters(jsched)

    jstat, tstat = _schedulers(models, prefix_cache=True)
    jsdone = jstat.run(_prefix_stream())
    tsdone = tstat.run(_prefix_stream())
    assert _streams(tsdone) == _streams(jsdone) and len(tsdone) == 9
    assert _prefix_counters(tstat) == _prefix_counters(jstat)
    for sched in (tsched, tstat):
        # sharing, full coverage and eviction all happened
        assert sched.prefix.hits >= 3 and sched.cow_copies >= 1
        assert sched.prefix.evictions >= 1
        sched.check_page_accounting()
        assert sched.alloc.available() \
            == TOTAL_PAGES - 1 - sched.prefix.n_pages()
    return tsched, tstat, teng


def _streams(done):
    return {r.rid: list(r.out) for r in done}


def _counters(sched):
    return {k: getattr(sched, k) for k in COUNTERS}


def test_continuous_engine_matches_jax(models):
    jsched, tsched = _schedulers(models)
    jeng = jax_engine.ContinuousEngine(jsched, clock="tick", log=None)
    teng = engine.ContinuousEngine(tsched, clock="tick", log=None)
    jdone = jeng.run(_stream())
    tdone = teng.run(_stream())
    assert _streams(tdone) == _streams(jdone)
    assert len(tdone) == 6 and tsched.rejected == 1
    assert len({t for out in _streams(tdone).values() for t in out}) > 6
    assert teng.admission_order == jeng.admission_order
    assert teng.metrics.summary() == jeng.metrics.summary()
    assert teng.iterations == jeng.iterations
    assert teng.executor.max_prefill_batch == jeng.executor.max_prefill_batch
    assert _counters(tsched) == _counters(jsched)
    assert tsched.truncated > 0          # the context wall was reached
    tsched.check_page_accounting()
    assert tsched.alloc.available() == TOTAL_PAGES - 1


def test_static_schedule_matches_jax_and_continuous(models):
    jsched, tsched = _schedulers(models)
    jdone = jsched.run(_stream())
    tdone = tsched.run(_stream())
    assert _streams(tdone) == _streams(jdone)
    assert _counters(tsched) == _counters(jsched)
    tsched.check_page_accounting()
    assert tsched.alloc.available() == TOTAL_PAGES - 1
    # the engine's interleaved prefill + masked decode is invisible to
    # results: a burst through the engine emits the static streams
    _, tsched2 = _schedulers(models)
    burst = [dataclasses.replace(r, arrival=0.0, out=[])
             for r in _stream()]
    cont = engine.ContinuousEngine(tsched2, clock="tick", log=None)
    assert _streams(cont.run(burst)) == _streams(tdone)


def test_prefix_sharing_matches_jax(models):
    tsched, tstat, _ = _check_prefix_parity(models)
    # sharing changes no token: the same stream without the cache
    _, plain = _schedulers(models)
    assert _streams(plain.run(_prefix_stream())) == \
        _streams(_schedulers(models, prefix_cache=True)[1].run(
            _prefix_stream()))
    assert tstat.prefill_tokens < plain.prefill_tokens


def test_page_allocator_refcounts():
    alloc = serve.PageAllocator(6)
    assert alloc.available() == 5 and alloc.held() == 0
    got = alloc.alloc(3)
    assert got == [1, 2, 3] and alloc.held() == 3
    with pytest.raises(RuntimeError, match="exhausted"):
        alloc.alloc(3)
    alloc.release(got)
    assert alloc.available() == 5
    with pytest.raises(AssertionError, match="double free"):
        alloc.release([2])
    # the JAX allocator hands out the same pages in the same order
    jalloc = jax_serve.PageAllocator(6)
    assert jalloc.alloc(3) == alloc.alloc(3)
    # share adds a holder: a shared page returns only with its last one,
    # and on_alloc sees every page handed out
    seen = []
    alloc.on_alloc = seen.extend
    (p,) = alloc.alloc(1)
    alloc.share(p)
    alloc.release([p])
    assert alloc.ref[p] == 1 and p not in alloc._free
    alloc.release([p])
    assert alloc.ref[p] == 0 and seen == [p]
    with pytest.raises(AssertionError, match="free page"):
        alloc.share(p)


def test_serve_main_on_cpu_reports_plain_routes(capsys):
    rep = serve.main(["--arch", "gemma-2b", "--smoke", "--cache", "paged",
                      "--slots", "2", "--requests", "3", "--prompt-len",
                      "6", "--max-new", "3", "--max-len", "16",
                      "--page-size", "4",
                      "--schedule", "continuous", "--clock", "tick",
                      "--device", "cpu"])
    assert len(rep["done"]) == 3 and rep["new_tokens"] == 9
    assert rep["ttft_p50"] is not None
    assert set(rep["routes"]) == {("matmul", "plain"),
                                  ("decode_attention", "plain"),
                                  ("prefill_attention", "plain")}
    assert "[dispatch]" in capsys.readouterr().out
    assert rep["prefix"] is None and rep["max_resident_kv_bytes"] > 0


@pytest.mark.parametrize("schedule", ["static", "continuous"])
def test_serve_main_int8_prefix_on_cpu(capsys, schedule):
    """The int8 + prefix-sharing configuration through the entry point:
    every projection takes the int8 GEMM, attention its int8 branch, and
    shared prompts hit the prefix cache."""
    rep = serve.main(["--arch", "gemma-2b", "--smoke", "--cache", "paged",
                      "--slots", "2", "--requests", "4", "--prompt-len",
                      "10", "--max-new", "3", "--max-len", "16",
                      "--page-size", "4",
                      "--kv-dtype", "int8", "--weights-dtype", "int8",
                      "--prefix-cache", "--shared-prefix-len", "8",
                      "--shared-frac", "1.0", "--schedule", schedule,
                      "--clock", "tick", "--device", "cpu"])
    assert len(rep["done"]) == 4 and rep["new_tokens"] == 12
    assert set(rep["routes"]) == {("matmul", "plain"),
                                  ("quantized_matmul", "plain"),
                                  ("decode_attention_int8", "plain"),
                                  ("prefill_attention_int8", "plain")}
    assert rep["prefix"]["hits"] > 0
    assert "[prefix] hits=" in capsys.readouterr().out
