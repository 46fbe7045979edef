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
from repro_torch.launch.loadgen import Request, poisson_stream
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


def _schedulers(models):
    (jmodel, jparams), (tmodel, tparams) = models
    kw = dict(slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
              total_pages=TOTAL_PAGES, log=None)
    return (jax_serve.PagedScheduler(jmodel, jparams, **kw),
            serve.PagedScheduler(tmodel, tparams, **kw))


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


def test_serve_main_on_cpu_reports_plain_routes(capsys):
    rep = serve.main(["--arch", "gemma-2b", "--smoke", "--slots", "2",
                      "--requests", "3", "--prompt-len", "6", "--max-new",
                      "3", "--max-len", "16", "--page-size", "4",
                      "--schedule", "continuous", "--clock", "tick",
                      "--device", "cpu"])
    assert len(rep["done"]) == 3 and rep["new_tokens"] == 9
    assert rep["ttft_p50"] is not None
    assert set(rep["routes"]) == {("matmul", "plain"),
                                  ("decode_attention", "plain"),
                                  ("prefill_attention", "plain")}
    assert "[dispatch]" in capsys.readouterr().out
