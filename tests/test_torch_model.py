"""The port's paged model against the JAX package's paged model.

The JAX ``Model.init`` params are converted with
``repro_torch.convert.params_from_jax``; a 6-token prompt is chunk-
prefilled (page 4, so the second chunk is a padded partial page) and
then 4 teacher-forced tokens are decoded through the paged ragged path,
on both sides, with ``dispatch="reference"`` on the JAX side.  Logits
agree within 1e-3 -- the tolerance of the JAX package's own paged-vs-dense
check (tests/test_paged_decode.py), since the two sides reduce in
different orders over several layers.

Three layouts: gemma-2b smoke (unrolled prefix layers), a scan layout
(``pattern`` repeated so ``stack`` holds a leading period axis, the
layout full-width gemma-2b serves with), and gemma3-4b smoke with its
window cut to 4 so the sliding window binds within 10 positions.  The
prefix and scan layouts run again with int8 KV pages and int8 weights.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import ARCHS as JAX_ARCHS
from repro.core.memory import DtypePolicy as JaxPolicy
from repro.models.transformer import ExecOptions, Model as JaxModel
from repro.tune import cache as tune_cache
from repro_torch.configs import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.core.memory import DtypePolicy
from repro_torch.models.transformer import Model

torch.set_num_threads(1)
EQ_TOL = dict(rtol=1e-3, atol=1e-3)
PAGE, SLOTS, MAX_LEN, PROMPT = 4, 2, 32, 6
SCAN = dict(n_layers=5, prefix=(("attn", "mlp"),),
            pattern=(("attn", "mlp"), ("attn", "mlp")))
LAYOUTS = {
    "gemma-2b-prefix": ("gemma-2b", {}),
    "gemma-2b-scan": ("gemma-2b", SCAN),
    "gemma3-4b-window": ("gemma3-4b", {"window": 4}),
}


@pytest.fixture(autouse=True)
def empty_plan_cache(tmp_path, monkeypatch):
    """The JAX side reads no tuned-plan state left by other tests."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "empty.json"))
    tune_cache.preload()
    yield
    monkeypatch.undo()
    tune_cache.preload()


def _configs(name):
    arch, overrides = LAYOUTS[name]
    jcfg = dataclasses.replace(JAX_ARCHS[arch].smoke(), dispatch="reference",
                               **overrides)
    tcfg = dataclasses.replace(ARCHS[arch].smoke(), dispatch="reference",
                               **overrides)
    return jcfg, tcfg


def _run_jax(cfg, toks, forced, table):
    model = JaxModel(cfg, dt=JaxPolicy(compute=jnp.float32),
                     opts=ExecOptions(mode="run"))
    params = model.init(jax.random.key(0))
    cache = model.init_paged_cache(SLOTS, MAX_LEN, PAGE)
    prefill = jax.jit(model.prefill_step_paged)
    decode = jax.jit(model.decode_step)
    logits = []
    for t0 in range(0, PROMPT, PAGE):
        last = min(PROMPT, t0 + PAGE) - 1 - t0
        lg, cache = prefill(params, cache,
                            jnp.asarray(toks[None, t0:t0 + PAGE]),
                            jnp.int32(t0), jnp.asarray(table[0]),
                            jnp.int32(last))
    logits.append(np.asarray(lg[0]))
    lengths = np.asarray([PROMPT, 0], np.int32)
    for tok in forced:
        lg, cache = decode(params, cache,
                           {"tokens": jnp.asarray([[tok], [0]], jnp.int32)},
                           jnp.int32(0),
                           paged=(jnp.asarray(lengths), jnp.asarray(table)))
        logits.append(np.asarray(lg[0]))
        lengths[0] += 1
    return jax.device_get(params), np.stack(logits), jax.device_get(cache)


def _run_torch(cfg, params_np, toks, forced, table):
    model = Model(cfg, dt=DtypePolicy(compute=torch.float32), device="cpu")
    params = params_from_jax(params_np, "cpu", torch.float32)
    bound = model.bind_params(params)
    cache = model.init_paged_cache(SLOTS, MAX_LEN, PAGE)

    def i32(a):
        return torch.tensor(np.asarray(a), dtype=torch.int32)
    logits = []
    for t0 in range(0, PROMPT, PAGE):
        last = min(PROMPT, t0 + PAGE) - 1 - t0
        lg = model.prefill_step_paged(bound, cache,
                                      i32(toks[None, t0:t0 + PAGE]),
                                      i32([t0]), i32(table[:1]), i32([last]))
    logits.append(lg[0].numpy())
    lengths = np.asarray([PROMPT, 0], np.int32)
    for tok in forced:
        lg = model.decode_step(bound, cache, i32([[tok], [0]]),
                               paged=(i32(lengths), i32(table)))
        logits.append(lg[0].numpy())
        lengths[0] += 1
    return params, np.stack(logits), cache


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_paged_logits_match_jax(name):
    jcfg, tcfg = _configs(name)
    rng = np.random.default_rng(1)
    toks = np.zeros((-(-PROMPT // PAGE) * PAGE,), np.int32)
    toks[:PROMPT] = rng.integers(0, jcfg.vocab_size, PROMPT)
    forced = rng.integers(0, jcfg.vocab_size, 4)
    table = np.zeros((SLOTS, MAX_LEN // PAGE), np.int32)
    table[0] = np.arange(1, 1 + MAX_LEN // PAGE)

    params_np, want, jcache = _run_jax(jcfg, toks, forced, table)
    params, got, cache = _run_torch(tcfg, params_np, toks, forced, table)
    np.testing.assert_allclose(got, want, **EQ_TOL)

    # the converted tree is the JAX tree, leaf for leaf; the port's own
    # init builds the same shapes (its numbers differ: torch.Generator)
    ours = dict(_leaves(params))
    assert list(ours) == [k for k, _ in _leaves(params_np)]
    for k, v in _leaves(params_np):
        assert tuple(ours[k].shape) == np.shape(v), k
    own = dict(_leaves(Model(tcfg, device="cpu").init(seed=0)))
    assert {k: tuple(v.shape) for k, v in own.items()} \
        == {k: tuple(v.shape) for k, v in ours.items()}

    # the pools were written in place, in the JAX layout (page 0 aside)
    for (k, tv), (k2, jv) in zip(_leaves(cache), _leaves(jcache)):
        assert k == k2
        pool_axis = 1 if tv.dim() == 5 else 0
        np.testing.assert_allclose(
            tv.numpy().take(range(1, tv.shape[pool_axis]), axis=pool_axis),
            np.asarray(jv).take(range(1, tv.shape[pool_axis]),
                                axis=pool_axis), **EQ_TOL)


INT8 = dict(kv_dtype="int8", weights_dtype="int8")


@pytest.mark.parametrize("name", ["gemma-2b-prefix", "gemma-2b-scan"])
def test_paged_int8_logits_match_jax(name):
    """int8 KV pages and int8 projection/MLP weights: the port's logits
    match JAX's paged path at this file's 1e-3 tolerance (so also within
    1e-3 of max |logit|).  The weights are quantized once
    (``Model.bind_params``) to the ints JAX derives per call; the port's
    float logits on the same params miss that tolerance, so a port that
    ignored ``weights_dtype`` fails here."""
    jcfg, tcfg = _configs(name)
    jcfg = dataclasses.replace(jcfg, **INT8)
    tcfg8 = dataclasses.replace(tcfg, **INT8)
    rng = np.random.default_rng(2)
    toks = np.zeros((-(-PROMPT // PAGE) * PAGE,), np.int32)
    toks[:PROMPT] = rng.integers(0, jcfg.vocab_size, PROMPT)
    forced = rng.integers(0, jcfg.vocab_size, 4)
    table = np.zeros((SLOTS, MAX_LEN // PAGE), np.int32)
    table[0] = np.arange(1, 1 + MAX_LEN // PAGE)

    params_np, want, jcache = _run_jax(jcfg, toks, forced, table)
    _, got, cache = _run_torch(tcfg8, params_np, toks, forced, table)
    np.testing.assert_allclose(got, want, **EQ_TOL)
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
    _, float_logits, _ = _run_torch(tcfg, params_np, toks, forced, table)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(float_logits, want, **EQ_TOL)

    # int8 pools and their scale rows, in the JAX layout (page 0 aside):
    # dequantized, within one quantization step of JAX's
    leaves, jleaves = dict(_leaves(cache)), dict(_leaves(jcache))
    assert set(leaves) == set(jleaves)
    for k, v in leaves.items():
        if not k.endswith("_pages"):
            continue
        assert v.dtype == torch.int8
        scale = leaves[k[:-len("pages")] + "scale"].numpy()
        jscale = np.asarray(jleaves[k[:-len("pages")] + "scale"])
        pool_axis = 1 if v.dim() == 5 else 0
        sc = np.expand_dims(scale, (-3, -1))
        jsc = np.expand_dims(jscale, (-3, -1))
        deq = (v.numpy().astype(np.float32) * sc).take(
            range(1, v.shape[pool_axis]), axis=pool_axis)
        jdeq = (np.asarray(jleaves[k]).astype(np.float32) * jsc).take(
            range(1, v.shape[pool_axis]), axis=pool_axis)
        step = np.broadcast_to(np.maximum(sc, jsc), v.shape).take(
            range(1, v.shape[pool_axis]), axis=pool_axis)
        assert np.all(np.abs(deq - jdeq) <= 1.01 * step + 1e-6), k
