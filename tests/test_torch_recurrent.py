"""The recurrent archs' serving path against the JAX package's.

rwkv6-7b (RWKV6 time mix and channel mix over a carried fp32 state) and
recurrentgemma-9b (two RG-LRU blocks to one local-attention layer) serve
through ``Model.decode_step`` over the dense cache only, in JAX as in the
port: the dense ``Server`` teacher-forces each prompt one token at a
time.  At smoke width in fp32, from JAX ``Model.init`` params carried
across by ``params_from_jax``:

* the decode pieces (time mix, channel mix with its token shift, the
  per-head group norm, the RG-LRU block, the causal conv) within 1e-5 of
  each output's max |value|;
* 12 decode steps: logits within 1e-5 of max |logit| at every step, and
  every cache leaf after them;
* ``Server`` streams equal JAX's, 7 requests over 2 slots (a slot is
  recycled, its recurrent state carried over as JAX carries it), float
  and int8 weights;
* ``serve.main`` routes, and its paged, continuous and speculative
  refusals equal JAX's (the whole-sequence forwards and training are
  held to JAX in tests/test_torch_recurrent_train.py);
* the reference caveat: JAX's RWKV decode does not reproduce its own
  forward past position 0 (its channel mix shifts against the raw
  residual), and the port's decode follows JAX's decode.
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
from repro.models import griffin as jax_griffin
from repro.models import rwkv as jax_rwkv
from repro.models.transformer import ExecOptions, Model as JaxModel
from repro.tune import cache as tune_cache
from repro_torch.configs import ARCHS
from repro_torch.convert import dense_cache_from_jax, params_from_jax
from repro_torch.core.memory import DtypePolicy
from repro_torch.launch import serve
from repro_torch.launch.loadgen import poisson_stream
from repro_torch.models import griffin, rwkv
from repro_torch.models.transformer import Model

torch.set_num_threads(1)
TOL = 1e-5              # fp32: max |err| over the output's max |value|
F32 = torch.float32
JAX_F32 = JaxPolicy(compute=jnp.float32)
# recurrentgemma's tied, sqrt(d)-scaled embedding of random weights
# echoes the input token, so the served streams run on an untied head
CASES = {
    "rwkv6-7b": ("rwkv6-7b", {}),
    "recurrentgemma-9b": ("recurrentgemma-9b", {}),
    "recurrentgemma-9b-untied": ("recurrentgemma-9b",
                                 dict(tie_embeddings=False)),
    "recurrentgemma-9b-int8": ("recurrentgemma-9b",
                               dict(tie_embeddings=False,
                                    weights_dtype="int8")),
    # the published patterns, so the layers stack: rwkv 3 periods of 1;
    # recurrentgemma 1 period of 3 and a tail of 2
    "rwkv6-7b-stacked": ("rwkv6-7b", dict(
        n_layers=3, prefix=(), pattern=(("rwkv", "rwkv_cm"),))),
    "recurrentgemma-9b-stacked": ("recurrentgemma-9b", dict(
        n_layers=5, prefix=(), pattern=(("rglru", "mlp"), ("rglru", "mlp"),
                                        ("swa", "mlp")))),
}
SERVED = ["rwkv6-7b", "recurrentgemma-9b-untied", "recurrentgemma-9b-int8"]


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
    """A JAX model and the port's on the same params, per case, built
    once per module."""
    if name not in _BUILT:
        arch, overrides = CASES[name]
        jcfg = dataclasses.replace(JAX_ARCHS[arch].smoke(),
                                   dispatch="reference", **overrides)
        jmodel = JaxModel(jcfg, dt=JAX_F32, opts=ExecOptions(mode="run"))
        jparams = jmodel.init(jax.random.key(0))
        tcfg = dataclasses.replace(ARCHS[arch].smoke(), **overrides)
        tmodel = Model(tcfg, dt=DtypePolicy(compute=F32), device="cpu")
        tparams = params_from_jax(jax.device_get(jparams), "cpu", F32)
        _BUILT[name] = (jmodel, jparams, tmodel, tparams)
    return _BUILT[name]


def _close(got, want, what):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    assert scale > 0, what
    err = np.abs(got - want).max()
    assert err <= TOL * scale, f"{what}: max |err| {err:.3e} of {scale:.3e}"


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ------------------------------------------------------------ pieces
RWKV_SPEC = dict(d_model=128, head_dim=32, d_ff=256)


def _rwkv_pieces():
    s = jax_rwkv.RwkvSpec(**RWKV_SPEC)
    tm = jax_rwkv.time_mix_init(jax.random.key(1), s)
    cm = jax_rwkv.channel_mix_init(jax.random.key(2), s)
    # a nonzero bonus, norm and decay so every term counts
    rng = np.random.default_rng(0)
    tm = dict(tm, u=jnp.asarray(rng.standard_normal(tm["u"].shape),
                                jnp.float32),
              ln_scale=jnp.asarray(1 + 0.1 * rng.standard_normal(128),
                                   jnp.float32),
              ln_bias=jnp.asarray(0.1 * rng.standard_normal(128),
                                  jnp.float32),
              w0=jnp.asarray(rng.uniform(-3, 0, 128), jnp.float32))
    return s, rwkv.RwkvSpec(**RWKV_SPEC), tm, cm, rng


def test_time_mix_decode_matches_jax():
    js, ts, tm, _, rng = _rwkv_pieces()
    x = rng.standard_normal((3, 1, 128)).astype(np.float32)
    cache = {"state": rng.standard_normal((3, 4, 32, 32)).astype(np.float32),
             "xprev": rng.standard_normal((3, 128)).astype(np.float32)}
    want, want_cache = jax_rwkv.time_mix_decode(
        tm, js, jnp.asarray(x), jax.tree.map(jnp.asarray, cache), JAX_F32)
    tcache = {k: _t(v) for k, v in cache.items()}
    got = rwkv.time_mix_decode(params_from_jax(jax.device_get(tm), "cpu",
                                               F32), ts, _t(x), tcache, F32)
    _close(got, want, "time mix out")
    _close(tcache["state"], want_cache["state"], "state")
    _close(tcache["xprev"], want_cache["xprev"], "xprev")


@pytest.mark.parametrize("seq", [1, 5])
def test_channel_mix_with_x_prev_matches_jax(seq):
    js, ts, _, cm, rng = _rwkv_pieces()
    x = rng.standard_normal((2, seq, 128)).astype(np.float32)
    prev = rng.standard_normal((2, 128)).astype(np.float32)
    want = jax_rwkv.channel_mix_apply(cm, js, jnp.asarray(x), JAX_F32,
                                      x_prev=jnp.asarray(prev))
    tcm = params_from_jax(jax.device_get(cm), "cpu", F32)
    _close(rwkv.channel_mix_apply(tcm, ts, _t(x), F32, x_prev=_t(prev)),
           want, "channel mix")
    # no x_prev: the shift starts from zeros
    want = jax_rwkv.channel_mix_apply(cm, js, jnp.asarray(x), JAX_F32)
    _close(rwkv.channel_mix_apply(tcm, ts, _t(x), F32), want,
           "channel mix from zeros")


def test_group_norm_matches_jax_population_variance():
    js, ts, tm, _, rng = _rwkv_pieces()
    o = (3 + 2 * rng.standard_normal((2, 3, 4, 32))).astype(np.float32)
    want = jax_rwkv._group_norm(tm, jnp.asarray(o), js)
    got = rwkv._group_norm(params_from_jax(jax.device_get(tm), "cpu", F32),
                           _t(o), ts)
    _close(got, want, "group norm")


GRIFFIN_SPEC = dict(d_model=128, lru_width=512, conv_width=4,
                    block_width=256)


def _griffin_pieces():
    js = jax_griffin.GriffinSpec(**GRIFFIN_SPEC)
    p = jax_griffin.rglru_block_init(jax.random.key(3), js)
    rng = np.random.default_rng(4)
    # conv taps and gate biases large enough to matter
    p = dict(p, conv_w=jnp.asarray(0.5 * rng.standard_normal((4, 512)),
                                   jnp.float32),
             ba=jnp.asarray(rng.standard_normal(512), jnp.float32),
             conv_b=jnp.asarray(0.1 * rng.standard_normal(512), jnp.float32))
    return (js, griffin.GriffinSpec(**GRIFFIN_SPEC), p,
            params_from_jax(jax.device_get(p), "cpu", F32), rng)


def test_rglru_block_decode_matches_jax():
    js, ts, p, tp, rng = _griffin_pieces()
    x = rng.standard_normal((3, 1, 128)).astype(np.float32)
    cache = {"h": rng.standard_normal((3, 512)).astype(np.float32),
             "conv": rng.standard_normal((3, 3, 512)).astype(np.float32)}
    want, want_cache = jax_griffin.rglru_block_decode(
        p, js, jnp.asarray(x), jax.tree.map(jnp.asarray, cache), JAX_F32)
    tcache = {k: _t(v) for k, v in cache.items()}
    got = griffin.rglru_block_decode(tp, ts, _t(x), tcache, F32)
    _close(got, want, "rg-lru out")
    _close(tcache["h"], want_cache["h"], "h")
    _close(tcache["conv"], want_cache["conv"], "conv buffer")
    # the buffer took the pre-conv main branch
    main = _t(x) @ tp["w_main"]
    torch.testing.assert_close(tcache["conv"][:, -1], main[:, 0])


@pytest.mark.parametrize("seq", [1, 6])
def test_causal_conv_matches_jax(seq):
    _, _, p, tp, rng = _griffin_pieces()
    x = rng.standard_normal((2, seq, 512)).astype(np.float32)
    prev = rng.standard_normal((2, 3, 512)).astype(np.float32)
    want = jax_griffin._causal_conv(jnp.asarray(x), p["conv_w"],
                                    p["conv_b"], jnp.asarray(prev))
    got = griffin._causal_conv(_t(x), tp["conv_w"], tp["conv_b"], _t(prev))
    _close(got, want, "causal conv")


def test_softplus_is_logaddexp_without_a_threshold():
    x = torch.tensor([-30.0, -1.0, 0.0, 2.2, 5.5, 19.0, 21.0, 40.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(griffin._softplus(x).numpy(), want,
                               rtol=1e-6, atol=0)


# ------------------------------------------------------------ the model
STEPS = 12


def _decode_both(name, max_len):
    """12 decode steps of both packages from a zero cache: the port's
    logits and cache, JAX's logits and cache."""
    jmodel, jparams, tmodel, tparams = _models(name)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tmodel.cfg.vocab_size, (STEPS, 2, 1)) \
        .astype(np.int32)
    jcache = jmodel.init_cache(2, max_len)
    tcache = tmodel.init_cache(2, max_len)
    bound = tmodel.bind_params(tparams)
    decode = jax.jit(jmodel.decode_step)
    jl, tl = [], []
    for i in range(STEPS):
        logits, jcache = decode(
            jparams, jcache, {"tokens": jnp.asarray(toks[i])}, jnp.int32(i))
        jl.append(np.asarray(logits))
        tl.append(tmodel.decode_step(bound, tcache,
                                     torch.from_numpy(toks[i]), pos=i))
    return tl, tcache, jl, jax.device_get(jcache)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("name", list(CASES))
def test_decode_steps_match_jax(name):
    """12 steps; recurrentgemma's local layer at max_len 8 wraps its
    buffer.  Every cache leaf after the steps equals JAX's, in the dtype
    JAX keeps (fp32 state and h)."""
    tl, tcache, jl, jcache = _decode_both(name, max_len=8)
    for i, (got, want) in enumerate(zip(tl, jl)):
        _close(got, want, f"step {i} logits")
    got, want = dict(_leaves(tcache)), dict(_leaves(jcache))
    assert set(got) == set(want)
    for path in want:
        assert got[path].dtype == F32, path
        _close(got[path], want[path], path)
    kinds = {k for group in tcache.values() for layer in group
             for k in layer}
    assert kinds == ({"state", "xprev", "cm_xprev"} if "rwkv" in name
                     else {"h", "conv", "k", "v"})
    assert bool(tcache["stack"]) == name.endswith("-stacked")


def _stream(vocab):
    # ragged prompts, more requests than slots (recycled slots), and a
    # context wall that catches work in flight and leaves some unadmitted
    return poisson_stream(7, rate=0.0, vocab_size=vocab, prompt_len=5,
                          max_new=6, seed=3, prompt_jitter=6)


def _streams(done):
    return {r.rid: list(r.out) for r in done}


@pytest.mark.parametrize("name", SERVED)
def test_dense_server_matches_jax(name):
    jmodel, jparams, tmodel, tparams = _models(name)
    kw = dict(slots=2, max_len=24, log=None)
    jsrv = jax_serve.Server(jmodel, jparams, **kw)
    tsrv = serve.Server(tmodel, tparams, **kw)
    vocab = tmodel.cfg.vocab_size
    jdone = jsrv.run(_stream(vocab))
    tdone = tsrv.run(_stream(vocab))
    assert _streams(tdone) == _streams(jdone)
    assert [r.truncated for r in tdone] == [r.truncated for r in jdone]
    assert (tsrv.truncated, tsrv.rejected, tsrv.pos) \
        == (jsrv.truncated, jsrv.rejected, jsrv.pos)
    assert len({t for out in _streams(tdone).values() for t in out}) > 4
    assert tsrv.truncated > 0 and len(tdone) > 2     # a slot was recycled


def test_recycled_slot_keeps_the_previous_recurrent_state():
    """The dense ``Server`` resets nothing when it admits a request into a
    freed slot (JAX's does not either): the request decodes on from its
    predecessor's state.  After two requests in one slot, the port's
    rwkv6-7b state equals JAX's and differs from the state the second
    request leaves when it runs in a fresh slot at the same positions.
    (RWKV's decay starts near 1, exp(-exp(-6)) a step, so the state
    remembers; the RG-LRU's a_t = exp(-8 r_t softplus(lam)) starts near
    1e-4 at init, so its h forgets within a step or two.)"""
    jmodel, jparams, tmodel, tparams = _models("rwkv6-7b")
    reqs = _stream(tmodel.cfg.vocab_size)[:2]
    for r in reqs:
        r.prompt = r.prompt[:4]
    kw = dict(slots=1, max_len=24, log=None)

    def fresh(*rs):
        return [dataclasses.replace(r, out=[]) for r in rs]
    tsrv = serve.Server(tmodel, tparams, **kw)
    jsrv = jax_serve.Server(jmodel, jparams, **kw)
    assert _streams(tsrv.run(fresh(*reqs))) \
        == _streams(jsrv.run(fresh(*reqs)))
    recurrent = [(i, k) for i, layer in enumerate(tsrv.cache["prefix"])
                 for k in ("state", "xprev", "cm_xprev")]
    jcache = jax.device_get(jsrv.cache)
    for i, k in recurrent:
        _close(tsrv.cache["prefix"][i][k], jcache["prefix"][i][k],
               f"layer {i} {k}")
    # the second request alone, in a fresh slot at the same positions
    first = serve.Server(tmodel, tparams, **kw)
    first.run(fresh(reqs[0]))
    alone = serve.Server(tmodel, tparams, **kw)
    alone.pos = first.pos
    alone.run(fresh(reqs[1]))
    assert alone.pos == tsrv.pos
    for i, layer in enumerate(tsrv.cache["prefix"]):
        gap = (alone.cache["prefix"][i]["state"] - layer["state"]).abs()
        assert float(gap.max()) > 1e-3, i


def test_bind_params_quantizes_attention_and_mlp_only():
    """int8 weights: the local-attention projections and every MLP are
    quantized; the RG-LRU block and the RWKV mixes stay float, as the JAX
    package runs them."""
    _, _, tmodel, tparams = _models("recurrentgemma-9b-int8")
    bound = tmodel.bind_params(tparams)
    kinds = tmodel.cfg.layer_kinds()
    for layer, kind in zip(bound["prefix"], kinds):
        assert isinstance(layer["mlp"]["wg"], dict)
        if kind[0] == "swa":
            assert isinstance(layer["attn"]["wq"], dict)
        else:
            assert all(isinstance(w, torch.Tensor)
                       for w in layer["rec"].values())
    rcfg = dataclasses.replace(ARCHS["rwkv6-7b"].smoke(),
                               weights_dtype="int8")
    rmodel = Model(rcfg, dt=DtypePolicy(compute=F32), device="cpu")
    params = rmodel.init(0)
    bound = rmodel.bind_params(params)
    for layer, orig in zip(bound["prefix"], params["prefix"]):
        for block in ("tm", "cm"):
            assert all(layer[block][k] is orig[block][k]
                       for k in orig[block])


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-9b"])
def test_init_draws_the_jax_tree_and_constants(arch):
    """``Model.init`` builds the JAX tree's keys and shapes (a stacked
    period included) with JAX's constants: mu 0.5, w0 -6, u 0, lam from
    2.2 to 5.5, conv taps of scale 0.01."""
    cfg = dataclasses.replace(ARCHS[arch].smoke(), n_layers=7,
                              pattern=ARCHS[arch].pattern, prefix=())
    jcfg = dataclasses.replace(JAX_ARCHS[arch].smoke(), n_layers=7,
                               pattern=JAX_ARCHS[arch].pattern, prefix=())
    got = Model(cfg, device="cpu").init(0)
    want = jax.eval_shape(JaxModel(jcfg).init, jax.random.key(0))
    gl, wl = dict(_leaves(got)), dict(_leaves(want))
    assert set(gl) == set(wl)
    for path, leaf in wl.items():
        assert tuple(gl[path].shape) == tuple(leaf.shape), path
    layer = got["stack"][0]
    if arch == "rwkv6-7b":
        tm = layer["tm"]
        assert torch.all(tm["mu"] == 0.5) and torch.all(tm["w0"] == -6)
        assert torch.all(tm["u"] == 0) and torch.all(tm["ln_scale"] == 1)
        assert torch.all(layer["cm"]["mu"] == 0.5)
        # wb is 0.01 x a fan-in-scaled truncated normal
        assert float(tm["wb"].abs().max()) <= 0.01 * 2 / 64 ** 0.5 + 1e-7
    else:
        rec = layer["rec"]
        lam = torch.linspace(2.2, 5.5, cfg.lru_width)
        assert torch.equal(rec["lam"][0], lam)
        assert torch.equal(rec["lam"][1], lam)
        assert 0.005 < float(rec["conv_w"].std()) < 0.02
        assert torch.all(rec["conv_b"] == 0) and torch.all(rec["ba"] == 0)


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-9b"])
def test_paged_entry_points_refuse_in_the_jax_words(arch):
    _, _, tmodel, tparams = _models(arch)
    message = (f"arch {tmodel.cfg.name} has recurrent/stateful layers; "
               "paged serving requires attention-family stacks "
               r"\(use --cache dense\)")
    one = torch.zeros((1, 1), dtype=torch.int32)
    calls = (lambda: tmodel.init_paged_cache(1, 8, 4),
             lambda: tmodel.decode_step(tparams, None, one,
                                        paged=(one[0], one)),
             lambda: tmodel.prefill_step_paged(tparams, None, one, one[0],
                                               one, one[0]),
             lambda: tmodel.verify_step_paged(tparams, None, one, one[0],
                                              one))
    for call in calls:
        with pytest.raises(ValueError, match=message):
            call()


SERVE_ARGV = ["--smoke", "--slots", "2", "--requests", "3", "--prompt-len",
              "4", "--max-new", "4", "--max-len", "32"]


@pytest.mark.parametrize("arch, weights, routes", [
    ("rwkv6-7b", "", {"matmul"}),
    ("recurrentgemma-9b", "", {"matmul", "decode_attention"}),
    ("recurrentgemma-9b", "int8",
     {"matmul", "quantized_matmul", "decode_attention"})])
def test_serve_main_on_the_dense_cache(arch, weights, routes, capsys):
    """Per decode step: rwkv6-7b routes only its head through ``matmul``;
    recurrentgemma smoke (two RG-LRU layers, one local attention) routes
    4 projections, 3 GEMMs an MLP and the head, and one decode attention
    (with int8 weights the projections and MLPs go to
    ``quantized_matmul``)."""
    argv = ["--arch", arch] + SERVE_ARGV + ["--device", "cpu"]
    if weights:
        argv += ["--weights-dtype", weights]
    rep = serve.main(argv)
    assert len(rep["done"]) == 3 and rep["new_tokens"] == 12
    steps = rep["phases"]["decode_steps"]
    assert rep["dense"] == {"truncated": 0, "rejected": 0, "pos": steps}
    assert {op for op, _ in rep["routes"]} == routes
    assert all(route == "plain" for _, route in rep["routes"])
    counts = {op: n for (op, _), n in rep["routes"].items()}
    if arch == "rwkv6-7b":
        assert counts == {"matmul": steps}
    else:
        gemms = {"matmul": steps * (4 + 3 * 3 + 1)}
        if weights:
            gemms = {"matmul": steps, "quantized_matmul": steps * 13}
        assert counts == dict(gemms, decode_attention=steps)
    assert "[dense]" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [
    ["--cache", "paged"],
    ["--cache", "paged", "--schedule", "continuous"],
    ["--cache", "paged", "--speculate", "ngram"],
    ["--speculate", "ngram"],
    ["--schedule", "continuous"]],
    ids=["paged", "continuous", "speculate", "speculate-dense",
         "continuous-dense"])
@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-9b"])
def test_serve_main_refusals_equal_jax(arch, extra):
    argv = ["--arch", arch, "--smoke"] + extra
    caught = []
    for main, tail in ((serve.main, ["--device", "cpu"]),
                       (jax_serve.main, [])):
        with pytest.raises((ValueError, SystemExit)) as err:
            main(argv + tail)
        caught.append((type(err.value), str(err.value)))
    assert caught[0] == caught[1]
    assert ("paged" in caught[0][1]) or ("--cache dense" in caught[0][1])


# ------------------------------------------------------------ caveat
def test_jax_rwkv_decode_departs_from_its_forward_and_the_port_follows():
    """The reference caveat: JAX's RWKV ``layer_decode`` stores the raw
    residual as ``cm_xprev`` and shifts the next token's normed input
    against it, where its forward shifts normed against normed.  In fp32
    its decode logits leave its forward's past position 0 by more than
    1e-2 of max |logit|; the port's decode equals JAX's decode."""
    jmodel, jparams, tmodel, tparams = _models("rwkv6-7b")
    rng = np.random.default_rng(9)
    toks = rng.integers(0, tmodel.cfg.vocab_size, (1, STEPS)) \
        .astype(np.int32)
    forward = np.asarray(jmodel.forward(jparams,
                                        {"tokens": jnp.asarray(toks)}))[0]
    jcache = jmodel.init_cache(1, STEPS)
    tcache = tmodel.init_cache(1, STEPS)
    decode = jax.jit(jmodel.decode_step)
    jdec, tdec = [], []
    for i in range(STEPS):
        logits, jcache = decode(
            jparams, jcache, {"tokens": jnp.asarray(toks[:, i:i + 1])},
            jnp.int32(i))
        jdec.append(np.asarray(logits)[0])
        tdec.append(tmodel.decode_step(
            tparams, tcache, torch.from_numpy(toks[:, i:i + 1]),
            pos=i)[0].numpy())
    jdec, tdec = np.stack(jdec), np.stack(tdec)
    scale = np.abs(forward).max()
    gap = np.abs(jdec - forward).max(axis=-1)
    assert gap[0] <= TOL * scale
    assert gap[1:].max() > 1e-2 * scale
    _close(tdec, jdec, "port decode vs JAX decode")


def test_dense_cache_from_jax_keeps_recurrent_state_fp32():
    jmodel, _, _, _ = _models("recurrentgemma-9b")
    cache = dense_cache_from_jax(jax.device_get(jmodel.init_cache(2, 8)),
                                 "cpu", torch.bfloat16)
    dtypes = {k: v.dtype for layer in cache["prefix"]
              for k, v in layer.items()}
    assert dtypes == {"h": F32, "conv": torch.bfloat16,
                      "k": torch.bfloat16, "v": torch.bfloat16}
    with pytest.raises(ValueError, match="not a dense decode cache layer"):
        dense_cache_from_jax({"prefix": [{"h": np.zeros(2)}], "stack": [],
                              "tail": []}, "cpu", F32)
