"""The M-RoPE branches of the serving forwards against the JAX package's.

qwen2-vl-2b smoke in fp32, JAX ``Model.init`` params carried across by
``params_from_jax``: ``decode_step`` fed ``embeddings`` (B, 1, d) and
three different ``positions`` streams (B, 1, 3) over a filled dense cache
and over filled page pools; the token-mode twin
(``input_mode="tokens"``) through ``prefill_step_paged``, ``decode_step``
and ``verify_step_paged``, whose positions the model derives from
``starts`` and ``lengths`` as the JAX package does, and through both
servers, whose decode positions are the slot's position on every axis;
and ``dense_cache_from_jax`` on a filled recurrent cache, both packages
decoding on from it.  Logits within 1e-5 of max |logit|, streams equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import ARCHS as JAX_ARCHS
from repro.core.memory import DtypePolicy as JaxPolicy
from repro.launch import serve as jax_serve
from repro.models.transformer import ExecOptions, Model as JaxModel
from repro.tune import cache as tune_cache
from repro_torch.configs import ARCHS
from repro_torch.convert import dense_cache_from_jax, params_from_jax
from repro_torch.core.memory import DtypePolicy
from repro_torch.launch import serve
from repro_torch.launch.loadgen import poisson_stream
from repro_torch.models.transformer import Model

torch.set_num_threads(1)
TOL = 1e-5              # fp32: max |err| over max |logit|
F32 = torch.float32
B, PAGE, MAX_LEN = 2, 4, 16


@pytest.fixture(autouse=True)
def empty_plan_cache(tmp_path, monkeypatch):
    """The JAX side reads no tuned-plan state left by other tests."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "empty.json"))
    tune_cache.preload()
    yield
    monkeypatch.undo()
    tune_cache.preload()


_BUILT = {}


def _models(arch, **overrides):
    """A JAX model and the port's on the same params, built once per
    module per configuration."""
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _BUILT:
        jcfg = dataclasses.replace(JAX_ARCHS[arch].smoke(),
                                   dispatch="reference", **overrides)
        jmodel = JaxModel(jcfg, dt=JaxPolicy(compute=jnp.float32),
                          opts=ExecOptions(mode="run"))
        jparams = jmodel.init(jax.random.key(0))
        tcfg = dataclasses.replace(ARCHS[arch].smoke(), **overrides)
        tmodel = Model(tcfg, dt=DtypePolicy(compute=F32), device="cpu")
        tparams = params_from_jax(jax.device_get(jparams), "cpu", F32)
        _BUILT[key] = (jmodel, jparams, tmodel, tparams)
    return _BUILT[key]


def _close(got, want, what):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= TOL * scale, f"{what}: max |err| {err:.3e} of {scale:.3e}"


def _filled(tree, rng):
    """Seeded normal values in every leaf of a JAX cache tree."""
    return jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), tree)


def _table():
    n = MAX_LEN // PAGE
    return np.arange(1, 1 + B * n, dtype=np.int32).reshape(B, n)


# ------------------------------------------------------------ embeddings
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decode_step_takes_embeddings_and_positions(layout):
    """4 steps from filled caches; the three position streams differ
    (temporal runs on, height and width jump), so every M-RoPE section
    counts."""
    jmodel, jparams, tmodel, tparams = _models("qwen2-vl-2b")
    rng = np.random.default_rng(1)
    d = tmodel.cfg.d_model
    if layout == "dense":
        jcache = _filled(jmodel.init_cache(B, MAX_LEN), rng)
        tcache = dense_cache_from_jax(jax.device_get(jcache), "cpu", F32)
    else:
        jcache = _filled(jmodel.init_paged_cache(B, MAX_LEN, PAGE), rng)
        tcache = params_from_jax(jax.device_get(jcache), "cpu", F32)
    table = _table()
    lengths = np.array([5, 9], np.int32)
    pos0 = 9
    for step in range(4):
        emb = rng.standard_normal((B, 1, d)).astype(np.float32)
        positions = np.stack([lengths + step if layout == "paged"
                              else np.full(B, pos0 + step),
                              rng.integers(0, 40, B),
                              rng.integers(0, 40, B)], -1)[:, None]
        positions = positions.astype(np.int32)
        batch = {"embeddings": jnp.asarray(emb),
                 "positions": jnp.asarray(positions)}
        kw = {}
        if layout == "paged":
            view = (lengths + step, table)
            want, jcache = jmodel.decode_step(
                jparams, jcache, batch, jnp.int32(0),
                paged=tuple(jnp.asarray(a) for a in view))
            kw["paged"] = tuple(torch.from_numpy(a) for a in view)
        else:
            want, jcache = jmodel.decode_step(jparams, jcache, batch,
                                              jnp.int32(pos0 + step))
            kw["pos"] = pos0 + step
        got = tmodel.decode_step(tparams, tcache,
                                 embeddings=torch.from_numpy(emb),
                                 positions=torch.from_numpy(positions), **kw)
        _close(got, want, f"{layout} step {step}")
    jleaves = jax.tree.leaves(jax.device_get(jcache))
    tleaves = [t for group in ("prefix", "stack", "tail")
               for layer in tcache[group] for _, t in sorted(layer.items())]
    assert len(jleaves) == len(tleaves)
    for got, want in zip(tleaves, jleaves):
        _close(got, want, "cache leaf")


def test_embedding_arch_decode_needs_embeddings():
    _, _, tmodel, tparams = _models("qwen2-vl-2b")
    cache = tmodel.init_cache(1, 8)
    with pytest.raises(ValueError, match="decode_step: arch .* takes "
                       "embeddings"):
        tmodel.decode_step(tparams, cache,
                           torch.zeros((1, 1), dtype=torch.int32), pos=0)


# ------------------------------------------------------------ tokens
def test_token_mode_prefill_decode_and_verify_match_jax():
    """The token-mode twin through the paged forwards: a prefill chunk
    each of two slots (starts 0 and 4), a decode step without explicit
    positions, and a verify window of 3 from a mid-page length.  JAX's
    forwards derive the M-RoPE positions from ``starts`` / ``lengths``;
    its scheduler feeds decode ``lengths`` on every axis."""
    jmodel, jparams, tmodel, tparams = _models("qwen2-vl-2b",
                                               input_mode="tokens")
    rng = np.random.default_rng(2)
    vocab = tmodel.cfg.vocab_size
    jcache = _filled(jmodel.init_paged_cache(B, MAX_LEN, PAGE), rng)
    tcache = params_from_jax(jax.device_get(jcache), "cpu", F32)
    table = _table()
    t = torch.from_numpy

    toks = rng.integers(0, vocab, (B, PAGE)).astype(np.int32)
    starts = np.array([0, 4], np.int32)
    last = np.array([3, 2], np.int32)
    want, jcache = jmodel.prefill_step_paged(jparams, jcache,
                                             jnp.asarray(toks), starts,
                                             table, last)
    got = tmodel.prefill_step_paged(tparams, tcache, t(toks), t(starts),
                                    t(table), t(last))
    _close(got, want, "prefill")

    lengths = np.array([4, 7], np.int32)
    tok = rng.integers(0, vocab, (B, 1)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tok), "positions": jnp.broadcast_to(
        jnp.asarray(lengths)[:, None, None], (B, 1, 3))}
    want, jcache = jmodel.decode_step(jparams, jcache, batch, jnp.int32(0),
                                      paged=(jnp.asarray(lengths), table))
    got = tmodel.decode_step(tparams, tcache, t(tok),
                             paged=(t(lengths), t(table)))
    _close(got, want, "decode")

    lengths = lengths + 1
    window = rng.integers(0, vocab, (B, 3)).astype(np.int32)
    want, jcache = jmodel.verify_step_paged(jparams, jcache,
                                            jnp.asarray(window), lengths,
                                            table)
    got = tmodel.verify_step_paged(tparams, tcache, t(window), t(lengths),
                                   t(table))
    _close(got, want, "verify")
    for name in ("k_pages", "v_pages"):
        _close(tcache["prefix"][0][name],
               jax.device_get(jcache)["prefix"][0][name], name)


def _stream(vocab):
    return poisson_stream(5, rate=0.0, vocab_size=vocab, prompt_len=5,
                          max_new=4, seed=4, prompt_jitter=4)


def _streams(done):
    return {r.rid: list(r.out) for r in done}


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_token_mode_servers_match_jax(layout):
    """Both servers on the token-mode twin: the JAX servers feed each
    decode step the slot's position on all three axes, which is what the
    port's ``decode_step`` takes when no positions are given."""
    jmodel, jparams, tmodel, tparams = _models(
        "qwen2-vl-2b", input_mode="tokens", tie_embeddings=False)
    kw = dict(slots=B, max_len=24, log=None)
    if layout == "paged":
        kw["page_size"] = PAGE
        jsrv = jax_serve.PagedScheduler(jmodel, jparams, **kw)
        tsrv = serve.PagedScheduler(tmodel, tparams, **kw)
    else:
        jsrv = jax_serve.Server(jmodel, jparams, **kw)
        tsrv = serve.Server(tmodel, tparams, **kw)
    vocab = tmodel.cfg.vocab_size
    tdone = _streams(tsrv.run(_stream(vocab)))
    assert tdone == _streams(jsrv.run(_stream(vocab)))
    assert len({tok for out in tdone.values() for tok in out}) > 4


# ------------------------------------------------------------ recurrent
@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-9b"])
def test_dense_cache_from_jax_decodes_on_from_a_filled_recurrent_cache(arch):
    """Every leaf of the JAX cache filled with seeded values (RWKV's WKV
    state and token shifts; the RG-LRU's h and conv buffer; the local
    layer's K/V, past its window), carried across, and 3 steps decoded
    on in both packages from position 20."""
    jmodel, jparams, tmodel, tparams = _models(arch)
    rng = np.random.default_rng(3)
    jcache = _filled(jmodel.init_cache(B, MAX_LEN), rng)
    tcache = dense_cache_from_jax(jax.device_get(jcache), "cpu", F32)
    for step in range(3):
        tok = rng.integers(0, tmodel.cfg.vocab_size, (B, 1)) \
            .astype(np.int32)
        want, jcache = jmodel.decode_step(jparams, jcache,
                                          {"tokens": jnp.asarray(tok)},
                                          jnp.int32(20 + step))
        got = tmodel.decode_step(tparams, tcache, torch.from_numpy(tok),
                                 pos=20 + step)
        _close(got, want, f"step {step}")
    for group in ("prefix", "stack", "tail"):
        for mine, theirs in zip(tcache[group],
                                jax.device_get(jcache)[group]):
            assert set(mine) == set(theirs)
            for k in theirs:
                _close(mine[k], theirs[k], k)
