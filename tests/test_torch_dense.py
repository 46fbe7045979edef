"""The port's dense serving path against the JAX package's.

The dense ``Server`` feeds every prompt through ``Model.decode_step`` one
token at a time at one shared position, over a rectangular cache (rolling
buffers for windowed layers).  The JAX package reads that cache through
its masked reference attention; the port reads the same valid prefix
through the ragged decode op (``layers.attention_decode``: the cache
viewed as pages, every length ``min(pos + 1, cap)``), whose plain version
runs here.  Three configurations, each started from JAX ``Model.init``
params carried across by ``params_from_jax``: gemma-2b smoke with its head
untied (the tied, sqrt(d)-scaled embedding of random weights echoes the
last token), the same with int8 weights, and gemma3-4b smoke at max_len
40, whose window-16 buffers wrap.  Streams and the ``truncated`` /
``rejected`` counts must be the JAX package's exactly.

One dense ``decode_step`` from a carried cache that has wrapped
(``dense_cache_from_jax``) must give the JAX logits within 1e-5 of max
|logit| (fp32).  ``serve.main`` serves with the dense cache by default, as
the JAX CLI does, and refuses ``--speculate`` and ``--schedule
continuous`` without ``--cache paged`` as the JAX CLI does.
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
from repro_torch.launch.loadgen import Request, poisson_stream
from repro_torch.models import layers
from repro_torch.models.layers import dense_page
from repro_torch.models.transformer import Model

torch.set_num_threads(1)
LOGIT_TOL = 1e-5        # fp32: max |err| over max |logit|
CASES = {
    "gemma-2b": ("gemma-2b", dict(tie_embeddings=False), 24),
    "gemma-2b-int8": ("gemma-2b", dict(tie_embeddings=False,
                                       weights_dtype="int8"), 24),
    "gemma3-4b-wrap": ("gemma3-4b", {}, 40),
}


@pytest.fixture(autouse=True)
def empty_plan_cache(tmp_path, monkeypatch):
    """The JAX side reads no tuned-plan state left by other tests."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "empty.json"))
    tune_cache.preload()
    yield
    monkeypatch.undo()
    tune_cache.preload()


_BUILT = {}


def _models(name):
    """One JAX model (its jitted decode is reused) and the port's model on
    the same params, per case, built once per module."""
    if name not in _BUILT:
        arch, overrides, max_len = CASES[name]
        jcfg = dataclasses.replace(JAX_ARCHS[arch].smoke(),
                                   dispatch="reference", **overrides)
        jmodel = JaxModel(jcfg, dt=JaxPolicy(compute=jnp.float32),
                          opts=ExecOptions(mode="run"))
        jparams = jmodel.init(jax.random.key(0))
        tcfg = dataclasses.replace(ARCHS[arch].smoke(), dispatch="reference",
                                   **overrides)
        tmodel = Model(tcfg, dt=DtypePolicy(compute=torch.float32),
                       device="cpu")
        tparams = params_from_jax(jax.device_get(jparams), "cpu",
                                  torch.float32)
        _BUILT[name] = (jmodel, jparams, tmodel, tparams, max_len)
    return _BUILT[name]


def _stream(vocab):
    # ragged prompts, more requests than slots (recycled slots), and a
    # context wall that catches work in flight and leaves some unadmitted
    return poisson_stream(7, rate=0.0, vocab_size=vocab, prompt_len=5,
                          max_new=6, seed=3, prompt_jitter=6)


def _streams(done):
    return {r.rid: list(r.out) for r in done}


@pytest.mark.parametrize("name", list(CASES))
def test_dense_server_matches_jax(name):
    jmodel, jparams, tmodel, tparams, max_len = _models(name)
    kw = dict(slots=2, max_len=max_len, log=None)
    jsrv = jax_serve.Server(jmodel, jparams, **kw)
    tsrv = serve.Server(tmodel, tparams, **kw)
    vocab = tmodel.cfg.vocab_size
    jdone = jsrv.run(_stream(vocab))
    tdone = tsrv.run(_stream(vocab))
    assert _streams(tdone) == _streams(jdone)
    assert [r.truncated for r in tdone] == [r.truncated for r in jdone]
    assert (tsrv.truncated, tsrv.rejected, tsrv.pos) \
        == (jsrv.truncated, jsrv.rejected, jsrv.pos)
    assert [r.rid for r in tsrv.rejected_requests] \
        == [r.rid for r in jsrv.rejected_requests]
    # the stream carries information, and the wall was reached
    assert len({t for out in _streams(tdone).values() for t in out}) > 4
    assert tsrv.truncated > 0
    if name == "gemma3-4b-wrap":
        caps = {c["k"].shape[1] for c in tsrv.cache["prefix"]}
        assert caps == {16, max_len} and tsrv.pos > 16   # buffers wrapped


def test_dense_wall_returns_flagged_requests_not_silence():
    """The port of ``test_serving_bugfixes.py``'s check: at the shared
    position's wall every request is finished, returned truncated or
    counted rejected; none vanish."""
    _, _, tmodel, tparams, _ = _models("gemma-2b")
    logs = []
    srv = serve.Server(tmodel, tparams, slots=2, max_len=12,
                       log=logs.append)
    rng = np.random.default_rng(1)
    reqs = [Request(i, rng.integers(0, 128, 6), 4) for i in range(5)]
    done = srv.run(list(reqs))

    assert len(done) + srv.rejected == 5           # nothing dropped
    assert all(r is None for r in srv.active)      # nothing left behind
    by_rid = {r.rid: r for r in done}
    # slots 0/1 finish inside the wall (6 prompt + 4 out = 10 <= 12)
    assert not by_rid[0].truncated and len(by_rid[0].out) == 4
    assert not by_rid[1].truncated and len(by_rid[1].out) == 4
    # the wall catches the second wave mid-prompt: flagged, not dropped
    wall = [r for r in done if r.truncated]
    assert wall and srv.truncated == len(wall)
    assert all(r.done for r in wall)
    # never-admitted requests are rejections, with done=False
    assert srv.rejected == len(srv.rejected_requests)
    assert all(not r.done for r in srv.rejected_requests)
    assert srv.rejected > 0
    assert any("truncating" in m for m in logs)
    assert any("rejecting" in m for m in logs)


def test_decode_step_from_wrapped_cache_matches_jax():
    """Both packages decode on from one filled cache: random K/V in every
    buffer, position 37 of max_len 40, so the window-16 layers' write
    slot is 5 and every rolling entry is valid."""
    jmodel, jparams, tmodel, tparams, max_len = _models("gemma3-4b-wrap")
    rng = np.random.default_rng(11)
    jcache = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
        jmodel.init_cache(2, max_len))
    tcache = dense_cache_from_jax(jax.device_get(jcache), "cpu",
                                  torch.float32)
    toks = np.array([[7], [301]], np.int32)
    pos = 37
    want, jcache = jmodel.decode_step(jparams, jcache,
                                      {"tokens": jnp.asarray(toks)},
                                      jnp.int32(pos))
    got = tmodel.decode_step(tparams, tcache, torch.from_numpy(toks),
                             pos=pos)
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= LOGIT_TOL * scale
    # the caches were written where the JAX package writes them
    for g, w in zip(tcache["prefix"], jax.device_get(jcache)["prefix"]):
        np.testing.assert_allclose(g["k"].numpy(), w["k"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g["v"].numpy(), w["v"], rtol=1e-5,
                                   atol=1e-5)


def test_dense_page_views_the_cache_in_whole_pages():
    assert [dense_page(c) for c in (2048, 1024, 256, 40, 16, 12, 7)] \
        == [64, 64, 64, 40, 16, 12, 7]
    assert dense_page(96) == 48 and dense_page(130) == 26
    for cap in (96, 130, 1000):
        page = dense_page(cap)
        assert cap % page == 0 and page <= 64
        assert not any(cap % d == 0 for d in range(page + 1, 65))


def test_dense_pages_built_once_a_cap_a_step(monkeypatch):
    """A dense step builds each cap's page table and lengths once and
    hands them to every layer of that cap (gemma3-4b smoke: the window-16
    buffers and the global ones)."""
    _, _, tmodel, tparams, max_len = _models("gemma3-4b-wrap")
    built = []
    real = layers.dense_pages

    def counted(batch, cap, pos, device):
        built.append((batch, cap, pos))
        return real(batch, cap, pos, device)
    monkeypatch.setattr(layers, "dense_pages", counted)
    cache = tmodel.init_cache(2, max_len)
    tmodel.decode_step(tparams, cache, torch.zeros(2, 1, dtype=torch.int32),
                       pos=20)
    caps = {c["k"].shape[-3] for part in cache.values() for c in part}
    assert sorted(built) == sorted((2, cap, 20) for cap in caps)
    assert len(caps) == 2
    table, lengths = real(2, 16, 20, "cpu")
    assert table.tolist() == [[0], [1]] and lengths.tolist() == [16, 16]
    table, lengths = real(2, 40, 20, "cpu")
    assert table.tolist() == [[0], [1]] and lengths.tolist() == [21, 21]


def test_decode_step_takes_pos_or_paged():
    _, _, tmodel, tparams, _ = _models("gemma-2b")
    cache = tmodel.init_cache(1, 8)
    tok = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="exactly one"):
        tmodel.decode_step(tparams, cache, tok)
    with pytest.raises(ValueError, match="exactly one"):
        tmodel.decode_step(tparams, cache, tok, pos=0,
                           paged=(torch.zeros(1, dtype=torch.int32),
                                  torch.zeros(1, 1, dtype=torch.int32)))


def test_serve_main_defaults_to_the_dense_cache(capsys):
    rep = serve.main(["--arch", "gemma-2b", "--smoke", "--slots", "2",
                      "--requests", "3", "--prompt-len", "4", "--max-new",
                      "4", "--max-len", "32", "--device", "cpu"])
    assert len(rep["done"]) == 3 and rep["new_tokens"] == 12
    assert set(rep["routes"]) == {("matmul", "plain"),
                                  ("decode_attention", "plain")}
    assert rep["dense"] == {"truncated": 0, "rejected": 0,
                            "pos": rep["phases"]["decode_steps"]}
    assert rep["spec"] is None and rep["prefix"] is None
    assert "[dense]" in capsys.readouterr().out
    rep = serve.main(["--arch", "gemma-2b", "--smoke", "--slots", "2",
                      "--requests", "2", "--prompt-len", "4", "--max-new",
                      "4", "--max-len", "32", "--weights-dtype", "int8",
                      "--device", "cpu"])
    assert set(rep["routes"]) == {("matmul", "plain"),
                                  ("quantized_matmul", "plain"),
                                  ("decode_attention", "plain")}


@pytest.mark.parametrize("extra, message", [
    (["--speculate", "ngram"], "--speculate requires --cache paged"),
    (["--schedule", "continuous"],
     "--schedule continuous requires --cache paged")])
def test_serve_main_refuses_paged_only_flags_on_the_dense_cache(extra,
                                                                message):
    argv = ["--arch", "gemma-2b", "--smoke"] + extra
    with pytest.raises(SystemExit, match=message):
        serve.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit, match=message):
        jax_serve.main(argv)
