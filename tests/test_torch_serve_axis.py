"""The serving steps on the model axis (``launch/dryrun.py``'s
``prefill_step`` and ``serve_step`` on real tensors over gloo ranks, at
smoke widths in fp32) against the JAX package's unsharded
``Model.prefill`` and ``make_serve_step``; B2's plain log-sum-exp and the
stripe merge; the split of the work, counted on ``meta`` at full width.

The sharded cases run in one spawn of four ranks (a (1, 2) case on ranks
0 and 1, the others idle) while this process computes JAX's steps.  Each
case prefills a prompt of 2 x 16 tokens and decodes 8 steps at
positions 12-19 from a filled dense cache of 32 positions (16 for a
sliding window: a rolling buffer that wraps at 16):

* gemma-2b (MQA) on (1, 2) and (1, 4): the cache striped over the
  sequence, decode crossing the ranks' blocks (and, on (1, 4), ranks
  with no live slot yet);
* codeqwen1.5-7b on (1, 2): kv heads over the axis, QKV bias;
* gemma3-4b with 8 heads on (1, 2): GQA over 4 kv heads, sliding
  windows, a wrapped rolling buffer;
* recurrentgemma-9b on (1, 2): the RG-LRU on the rank's channels, and its
  local attention's rolling buffer striped at one kv head;
* rwkv6-7b on (1, 2): decode on the rank's heads; the prefill under
  ``attn_prefer_seq``, its WKV on the rank's block of the sequence with
  the state carried in;
* qwen2-moe-a2.7b on (2, 2): the experts' shards, every model rank
  routing the same tokens.

Each is held to JAX within 1e-5 of max |logit| (prefill and every decode
step), its ranks bit-equal, no leaf gathered whole over ``model``, and
each rank's cache block of the shape JAX's ``MeshRules.cache_spec``
gives.
"""
import concurrent.futures
import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import logsumexp
from torch.utils.flop_counter import FlopCounterMode

import _torch_ranks as ranks
from repro.configs.archs import ARCHS as JAX_ARCHS
from repro.core.memory import DtypePolicy as JaxPolicy
from repro.kernels.attention import ref as jax_ref
from repro.models.transformer import ExecOptions as JaxOptions
from repro.models.transformer import Model as JaxModel
from repro.runtime.sharding import make_rules as jax_make_rules
from repro.tune import cache as tune_cache
from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import tree
from repro_torch.kernels.attention import decode_attention_plain
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.runtime import sharding
from repro_torch.runtime.model_axis import merge_stripes

torch.set_num_threads(1)
WORLD = 4
AXES = ("data", "model")
B, S, MAX_LEN, POS0, STEPS = 2, 16, 32, 12, 8
TOL = 1e-5              # fp32: max |err| over the step's max |logit|
# MoE capacity at which neither JAX's one-device layer nor the sharded
# one drops a token
MOE_CF = 8.0
CASES = {  # name: (arch, mesh, options)
    "gemma-2b-1x2": ("gemma-2b", (1, 2), {}),
    "gemma-2b-1x4": ("gemma-2b", (1, 4), {}),
    "codeqwen1.5-7b-1x2": ("codeqwen1.5-7b", (1, 2), {}),
    "gemma3-4b-1x2": ("gemma3-4b", (1, 2), {"over": {"n_heads": 8}}),
    "recurrentgemma-9b-1x2": ("recurrentgemma-9b", (1, 2), {}),
    "rwkv6-7b-1x2": ("rwkv6-7b", (1, 2), {"attn_seq": True}),
    "qwen2-moe-a2.7b-2x2": ("qwen2-moe-a2.7b", (2, 2), {}),
}
# cases that share another's inputs and JAX run
SHARED = {"gemma-2b-1x4": "gemma-2b-1x2"}


@pytest.fixture(scope="module", autouse=True)
def empty_plan_cache(tmp_path_factory):
    """The JAX side reads no tuned-plan state left by other tests."""
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_TUNE_CACHE",
              str(tmp_path_factory.mktemp("plans") / "empty.json"))
    tune_cache.preload()
    yield
    mp.undo()
    tune_cache.preload()


def _config(arch, jax_side, over):
    cfg = dataclasses.replace((JAX_ARCHS if jax_side else ARCHS)[arch]
                              .smoke(), **over)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=MOE_CF)
    return dataclasses.replace(cfg, dispatch="reference") if jax_side \
        else cfg


def case_inputs(spec, seed):
    """A case for the ranks -- JAX's params, a prompt, 8 decode tokens
    and a filled dense cache, as numpy -- and JAX's model."""
    arch, shape, opts = spec
    over = opts.get("over", {})
    jmodel = JaxModel(_config(arch, True, over),
                      dt=JaxPolicy(compute=jnp.float32),
                      opts=JaxOptions(mode="run", block_q=16, block_kv=16,
                                      remat=False))
    params = jax.device_get(jax.jit(jmodel.init)(jax.random.key(0)))
    rng = np.random.default_rng(seed)
    vocab = jmodel.cfg.vocab_size
    cache = jax.tree.map(
        lambda a: (0.5 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(jmodel.init_cache(B, MAX_LEN)))
    return dict(opts, cfg=_config(arch, False, over), shape=shape,
                axes=AXES, params=params, cache=cache, max_len=MAX_LEN,
                prompt=rng.integers(0, vocab, (B, S)).astype(np.int32),
                tokens=[rng.integers(0, vocab, (B, 1)).astype(np.int32)
                        for _ in range(STEPS)],
                positions=list(range(POS0, POS0 + STEPS))), jmodel


def jax_reference(jmodel, case):
    """JAX's unsharded prefill logits and each decode step's logits."""
    params = jax.tree.map(jnp.asarray, case["params"])
    prefill = np.asarray(jax.jit(jmodel.prefill)(
        params, {"tokens": jnp.asarray(case["prompt"])}))
    step = jax.jit(jmodel.decode_step)
    cache = jax.tree.map(jnp.asarray, case["cache"])
    decode = []
    for pos, t in zip(case["positions"], case["tokens"]):
        logits, cache = step(params, cache, {"tokens": jnp.asarray(t)},
                             jnp.int32(pos))
        decode.append(np.asarray(logits))
    return prefill, decode


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each case's inputs, JAX's results, every rank's results)."""
    inputs, models = {}, {}
    for i, (name, spec) in enumerate(CASES.items()):
        if name in SHARED:
            inputs[name] = dict(inputs[SHARED[name]], shape=spec[1],
                                **spec[2])
        else:
            inputs[name], models[name] = case_inputs(spec, seed=60 + i)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        out = tmp_path_factory.mktemp("serve_axis")
        got = pool.submit(ranks.spawn, ranks.serve_axis_worker, WORLD, out,
                          list(inputs.values()))
        want = {name: jax_reference(models[name], inputs[name])
                for name in models}
        for name, base in SHARED.items():
            want[name] = want[base]
        got = got.result()
    return inputs, want, got


def _outs(got, name):
    i = list(CASES).index(name)
    return [r[i] for r in got if r[i] is not None]


def _close(got, want, what):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert got.shape == want.shape and err <= TOL * scale, \
        f"{what}: max |err| {err:.3e} of {scale:.3e}"


@pytest.mark.parametrize("name", list(CASES))
def test_serving_steps_on_the_model_axis_match_jax(name, runs):
    """Each rank's logits are its data block's rows of JAX's, and the
    model axis's ranks of a data block hold the same bits."""
    inputs, want, got = runs
    outs = _outs(got, name)
    data, m = CASES[name][1]
    assert len(outs) == data * m
    prefill, decode = want[name]
    rows = B // data
    for r, out in enumerate(outs):
        block = slice(r // m * rows, (r // m + 1) * rows)
        _close(out["prefill"], prefill[block], f"{name} prefill")
        assert len(out["decode"]) == STEPS
        for i, (g, w) in enumerate(zip(out["decode"], decode)):
            _close(g, w[block], f"{name} decode step {i} (pos {POS0 + i})")
        first = outs[r // m * m]
        assert np.array_equal(out["prefill"], first["prefill"]), (name, r)
        assert all(np.array_equal(a, b) for a, b in zip(
            out["decode"], first["decode"])), (name, r)


@pytest.mark.parametrize("name", list(CASES))
def test_no_leaf_is_gathered_whole_over_model(name, runs):
    for out in _outs(runs[2], name):
        assert out["model_gathers"] == 0, name


def _jax_rules(shape):
    mesh = types.SimpleNamespace(axis_names=AXES,
                                 shape=dict(zip(AXES, shape)))
    return jax_make_rules(mesh, fsdp=True)


def _names(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_cache_spec_block(name, runs):
    """Each rank's cache leaf has the shape JAX's ``MeshRules.cache_spec``
    gives a block of the whole leaf."""
    inputs, _, got = runs
    mesh = CASES[name][1]
    rules = _jax_rules(mesh)
    whole = inputs[name]["cache"]
    sizes = dict(zip(AXES, mesh))
    want = {}
    for path, leaf in zip(sharding.leaf_paths(whole), tree.leaves(whole)):
        spec = rules.cache_spec(path, leaf.shape)
        want[path] = tuple(n // math.prod(sizes[a] for a in _names(e))
                           for n, e in zip(leaf.shape, tuple(spec)
                                           + (None,) * leaf.ndim))
    for out in _outs(got, name):
        assert out["cache_shapes"] == want, name


@pytest.mark.parametrize("name", [n for n in CASES if "rwkv" not in n])
def test_decode_attention_takes_the_cache_layout(name, runs):
    """B2 runs over the rank's block: its kv heads (``heads``), or with
    its log-sum-exp over its slots of every kv head (``seq``)."""
    inputs, _, got = runs
    cfg, (data, m) = inputs[name]["cfg"], CASES[name][1]
    striped = cfg.n_kv_heads % m != 0
    for out in _outs(got, name):
        assert out["decode_calls"], name
        for q, pool, lse in out["decode_calls"]:
            assert lse == striped, name
            if striped:
                assert q == (B // data, cfg.n_heads, cfg.head_dim)
                keys = pool[0] * pool[1]
                assert pool[2] == cfg.n_kv_heads and keys in (
                    B // data * MAX_LEN // m,
                    B // data * min(cfg.window, MAX_LEN) // m), name
            else:
                assert q == (B // data, cfg.n_heads // m, cfg.head_dim)
                assert pool[2] == cfg.n_kv_heads // m, name


# --------------------------------------------------------------------------
# B2's log-sum-exp and the stripe merge
# --------------------------------------------------------------------------

def _paged(seed, b=3, h=8, hkv=2, hd=16, page=4, n_pages=6):
    rng = np.random.default_rng(seed)
    pool = b * n_pages + 1
    k, v = (rng.standard_normal((pool, page, hkv, hd)).astype(np.float32)
            for _ in range(2))
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    table = (1 + rng.permutation(pool - 1)[:b * n_pages]).reshape(
        b, n_pages).astype(np.int32)
    return q, k, v, table


@pytest.mark.parametrize("window", [0, 5])
def test_plain_decode_lse_is_the_logsumexp_of_jax_s_scores(window):
    """``return_lse`` is the log-sum-exp of the live scores of JAX's
    ``decode_attention_ref`` (scaled, masked by length and window), -inf
    for a slot with no key; the output is JAX's."""
    q, k, v, table = _paged(window)
    lengths = np.array([17, 0, 24], np.int32)
    out, lse = decode_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v, table, lengths)),
        window=window, return_lse=True)
    jq, jk, jv, jt, jl = (jnp.asarray(a) for a in (q, k, v, table, lengths))
    want = jax_ref.decode_attention_ref(jq, jk, jv, jt, jl, window=window)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
    keys = jnp.repeat(jax_ref._gather_pages(jk, jt, None), 4, axis=2)
    scores = jnp.einsum("bhd,bshd->bhs", jq, keys) / math.sqrt(q.shape[-1])
    kpos = jnp.arange(keys.shape[1])[None, :]
    mask = kpos < jl[:, None]
    if window:
        mask &= kpos >= jl[:, None] - window
    want_lse = logsumexp(jnp.where(mask[:, None], scores, -jnp.inf),
                         axis=-1)
    np.testing.assert_allclose(lse, np.asarray(want_lse), rtol=1e-6)
    assert lse.dtype == torch.float32 and bool(torch.isinf(lse[1]).all())


@pytest.mark.parametrize("stripes", [2, 4])
def test_merged_stripes_equal_the_whole_cache(stripes):
    """A dense cache's key range split into ``stripes`` blocks, each
    attended alone with its log-sum-exp (a block past the valid prefix
    empty), merges to the whole cache's output and log-sum-exp."""
    q, k, v, _ = (torch.from_numpy(a) for a in _paged(7, b=2, n_pages=8))
    b, page = q.shape[0], k.shape[1]
    cap = 8 * page
    kc, vc = (t[1:].reshape(b, cap, *t.shape[2:]) for t in (k, v))
    live = 9                       # the valid prefix: blocks 2.. are empty

    def attend(lo, hi):
        n = hi - lo
        table = torch.arange(b * n // page, dtype=torch.int32).view(b, -1)
        lengths = torch.full((b,), min(max(live - lo, 0), n),
                             dtype=torch.int32)
        pools = (t[:, lo:hi].reshape(-1, page, *t.shape[2:])
                 for t in (kc, vc))
        return decode_attention_plain(q, *pools, table, lengths,
                                      return_lse=True)
    whole, whole_lse = attend(0, cap)
    n = cap // stripes
    parts = [attend(r * n, (r + 1) * n) for r in range(stripes)]
    assert bool(torch.isinf(parts[-1][1]).all())
    merged = merge_stripes(torch.stack([o for o, _ in parts]),
                           torch.stack([lse for _, lse in parts]))
    torch.testing.assert_close(merged, whole, rtol=1e-6, atol=1e-6)
    total = torch.logsumexp(torch.stack([lse for _, lse in parts]), 0)
    torch.testing.assert_close(total, whole_lse, rtol=1e-6, atol=0)


# --------------------------------------------------------------------------
# the split of the work, on meta at full width
# --------------------------------------------------------------------------

META_SHAPES = {"prefill": ShapeSpec("prefill_meta", 256, 4, "prefill"),
               "decode": ShapeSpec("decode_meta", 1024, 4, "decode")}
MATMULS = ("mm", "addmm", "bmm")


def _cell(cfg, shape, mesh):
    return dryrun.cell_step(cfg, shape, sharding.make_rules(
        AbstractMesh(mesh, AXES)), "cost")


def _matmul_flops(cfg, shape, mesh):
    """The matmul FLOPs of rank 0's serving step (one layer of each
    kind) on an abstract ``mesh``, with the dry run's model and hooks."""
    fn, args, _ = _cell(cfg, shape, mesh)
    sharding.reset_model_gathers()
    with FlopCounterMode(display=False) as flops:
        fn(*args)
    assert sharding.model_gathers() == 0
    return sum(n for op, n in flops.get_flop_counts()["Global"].items()
               if str(op).split(".")[1] in MATMULS)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["gemma-2b", "codeqwen1.5-7b", "rwkv6-7b",
                                  "recurrentgemma-9b"])
def test_each_rank_does_a_quarter_of_the_serving_matmuls(arch, kind):
    """On a (1, 4) mesh rank 0's matmul FLOPs (the decode attention's
    products among them) are a quarter of the unsplit step's, within 1%.
    What every rank still does alike: the rwkv decay LoRA's down product
    (replicated wa).  A MoE decode routes the same tokens on every model
    rank, as JAX's expert-parallel layer does, so it is left out."""
    cfg = get_arch(arch)
    cfg = cfg.with_layers(tuple(dict.fromkeys(cfg.layer_kinds())))
    whole = _matmul_flops(cfg, META_SHAPES[kind], (1, 1))
    part = _matmul_flops(cfg, META_SHAPES[kind], (1, 4))
    assert part * 4 == pytest.approx(whole, rel=0.01), (part * 4, whole)


def test_decode_cell_cache_bytes_a_rank_are_a_quarter():
    """gemma-2b's decode_32k cache (one kv head: striped over the
    sequence) holds a quarter of the whole cache's bytes a rank on
    (1, 4)."""
    cfg = get_arch("gemma-2b").with_layers((("attn", "mlp"),))

    def cache_bytes(mesh):
        _, (_, block, _), _ = _cell(cfg, SHAPES["decode_32k"], mesh)
        return sum(x.numel() * x.element_size() for x in tree.leaves(block))
    assert cache_bytes((1, 4)) * 4 == cache_bytes((1, 1))
