"""The port's serving runtime with int8 KV pages and int8 weights against
the JAX package's, end to end.

The untied gemma-2b smoke config of ``tests/test_torch_serve.py`` with
``kv_dtype="int8"`` and ``weights_dtype="int8"``, the JAX ``Model.init``
params converted for the port (whose scheduler quantizes the weights once
when it binds them).  Continuous and static schedules, without and with
the prefix cache, must give the JAX package's token streams, admission
order, ``ServeMetrics.summary()`` and counters exactly.  Port-only
checks: int8 KV streams equal the fp32 streams, and the scale rows live
and die with their pages (lockstep, reset on reuse, byte residency
draining to zero).
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
from repro.models.transformer import ExecOptions, Model as JaxModel
from repro.tune import cache as tune_cache
from repro_torch.configs import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.core.memory import DtypePolicy
from repro_torch.launch import engine, serve
from repro_torch.launch.loadgen import poisson_stream
from repro_torch.models.transformer import Model
from test_torch_serve import (_check_prefix_parity, _counters, _schedulers,
                              _stream, _streams)

torch.set_num_threads(1)
INT8 = dict(kv_dtype="int8", weights_dtype="int8")


@pytest.fixture(autouse=True)
def empty_plan_cache(tmp_path, monkeypatch):
    """The JAX side reads no tuned-plan state left by other tests."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "empty.json"))
    tune_cache.preload()
    yield
    monkeypatch.undo()
    tune_cache.preload()


def _port_cfg(**overrides):
    return dataclasses.replace(ARCHS["gemma-2b"].smoke(),
                               dispatch="reference", tie_embeddings=False,
                               **overrides)


@pytest.fixture(scope="module")
def models():
    """One int8 JAX model and the port's int8 model on the same params."""
    cfg = dataclasses.replace(JAX_ARCHS["gemma-2b"].smoke(),
                              dispatch="reference", tie_embeddings=False,
                              **INT8)
    jmodel = JaxModel(cfg, dt=JaxPolicy(compute=jnp.float32),
                      opts=ExecOptions(mode="run"))
    jparams = jmodel.init(jax.random.key(0))
    tmodel = Model(_port_cfg(**INT8), dt=DtypePolicy(compute=torch.float32),
                   device="cpu")
    tparams = params_from_jax(jax.device_get(jparams), "cpu", torch.float32)
    return (jmodel, jparams), (tmodel, tparams)


def test_int8_serving_matches_jax(models):
    jsched, tsched = _schedulers(models)
    jeng = jax_engine.ContinuousEngine(jsched, clock="tick", log=None)
    teng = engine.ContinuousEngine(tsched, clock="tick", log=None)
    assert _streams(teng.run(_stream())) == _streams(jeng.run(_stream()))
    assert teng.admission_order == jeng.admission_order
    assert teng.metrics.summary() == jeng.metrics.summary()
    assert _counters(tsched) == _counters(jsched)
    assert teng.max_resident_kv_bytes == jeng.max_resident_kv_bytes
    jstat, tstat = _schedulers(models)
    assert _streams(tstat.run(_stream())) == _streams(jstat.run(_stream()))
    assert _counters(tstat) == _counters(jstat)
    # the scheduler bound quantized weights: every projection is int8
    wq = tsched.params["prefix"][0]["attn"]["wq"]
    assert wq["q"].dtype == torch.int8 and wq["scale"].dtype == torch.float32


def test_int8_prefix_sharing_matches_jax(models):
    _check_prefix_parity(models)


def _port_scheduler(slots=2, **overrides):
    model = Model(_port_cfg(**overrides),
                  dt=DtypePolicy(compute=torch.float32), device="cpu")
    return serve.PagedScheduler(model, model.init(seed=0), slots=slots,
                                max_len=16, page_size=4, log=None)


def test_int8_kv_streams_match_fp32():
    """Quantization noise flips no greedy decision on the smoke arch:
    int8 pools emit the fp32 pools' streams, statically and through the
    engine (tests/test_paged_decode.py's gate)."""
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 512, rng.integers(3, 9)) for _ in range(4)]

    def run(kv_dtype):
        sched = _port_scheduler(kv_dtype=kv_dtype)
        done = sched.run([serve.Request(i, p, 5)
                          for i, p in enumerate(prompts)])
        eng = engine.ContinuousEngine(_port_scheduler(kv_dtype=kv_dtype),
                                      clock="tick", log=None)
        cont = eng.run(poisson_stream(4, rate=0.0, vocab_size=512,
                                      prompt_len=6, max_new=4, seed=13))
        return _streams(done), _streams(cont), eng.max_resident_kv_bytes

    static8, cont8, bytes8 = run("int8")
    static32, cont32, bytes32 = run("")
    assert static8 == static32 and cont8 == cont32
    assert 0 < bytes8 < bytes32


def test_int8_scale_lockstep_reset_and_residency():
    """Scale rows are allocated and recycled with their pages: the
    lockstep check holds through a serve, residency drains to zero, and
    reallocated pages come back with their scale rows reset."""
    sched8 = _port_scheduler(kv_dtype="int8")
    sched32 = _port_scheduler()
    assert sched8._page_bytes < sched32._page_bytes
    assert sched8.kv_bytes_resident() == 0
    rng = np.random.default_rng(9)
    done = sched8.run([serve.Request(i, rng.integers(0, 512, 6), 4)
                       for i in range(3)])
    assert len(done) == 3
    sched8.check_page_accounting()           # includes scale lockstep
    assert sched8.kv_bytes_resident() == 0

    scales = [leaf for name, leaf in serve._cache_leaves(sched8.cache)
              if name.endswith("_scale")]
    assert scales and any(float(s[1:].abs().max()) > 0 for s in scales)
    got = sched8.alloc.alloc(sched8.alloc.available())
    idx = torch.tensor(got)
    for s in scales:
        rows = s[:, idx] if s.dim() == 3 else s[idx]
        assert float(rows.abs().max()) == 0.0
    sched8.alloc.release(got)
    sched8.check_page_accounting()
    # a missing scale leaf breaks the lockstep invariant
    del sched8.cache["prefix"][0]["v_scale"]
    with pytest.raises(AssertionError, match="no companion v_scale"):
        sched8.check_page_accounting()


def test_int8_weights_need_binding():
    """A config asking for int8 weights never runs float weights: the
    forwards refuse unquantized params, and ``bind_params`` quantizes
    every projection and MLP weight (stacked ones per period) while the
    embedding and norms stay float."""
    cfg = dataclasses.replace(_port_cfg(**INT8), n_layers=3,
                              prefix=(("attn", "mlp"),),
                              pattern=(("attn", "mlp"),))
    model = Model(cfg, dt=DtypePolicy(compute=torch.float32), device="cpu")
    params = model.init(seed=0)
    cache = model.init_paged_cache(1, 8, 4)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    args = (cache, i32([[1, 2, 3, 4]]), i32([0]), i32([[1, 2]]), i32([3]))
    with pytest.raises(TypeError, match="bind_params"):
        model.prefill_step_paged(params, *args)
    bound = model.bind_params(params)
    assert model.prefill_step_paged(bound, *args).shape == (1, 512)
    stacked = bound["stack"][0]["mlp"]["wd"]
    assert stacked["q"].shape == params["stack"][0]["mlp"]["wd"].shape
    assert stacked["scale"].shape == (2, cfg.d_model)
    assert bound["embed"] is params["embed"]
    assert bound["stack"][0]["ln1"] is params["stack"][0]["ln1"]
    with pytest.raises(ValueError, match="weights_dtype"):
        Model(dataclasses.replace(cfg, weights_dtype="int4"), device="cpu")
