"""The model axis of the port's sharded train step (Megatron tensor
parallelism, ``runtime/model_axis.py``) against the JAX package's
one-device step, on gloo ranks on the CPU at smoke widths; the flash
plain versions at a query offset against JAX's whole attention; and the
split of the work, counted on ``meta`` at full width.

The sharded cases run in one spawn of four ranks (a (1, 2) case on
ranks 0 and 1, the others idle) while this process computes JAX's
steps; each is held to JAX's ``make_train_step`` by the gates of
``tests/_torch_sharded.py`` (two steps' losses within 1e-5, grad norms,
moments and params gathered, ranks bit-equal), gathers no leaf whole
over ``model``, and runs attention in the layout JAX's ``attn_hook``
names:

* codeqwen1.5-7b (QKV bias) on (1, 2): the residual replicated, striped
  over the sequence (``constrain``), and with ``attn_prefer_seq``;
* gemma-2b (MQA: k/v's head_dim gathered before RoPE; the tied embed
  and head vocab-parallel) on (1, 2) and (1, 4), striped;
* gemma3-4b (GQA, sliding windows at a query offset) on (1, 2) under
  ``attn_prefer_seq``;
* qwen2-moe-a2.7b on (2, 2), striped: the experts route each rank's
  own sequence block;
* qwen2-vl-2b (embeddings and M-RoPE positions in) on (1, 2), striped;
* gemma-2b with 6 heads on (1, 4): the heads do not divide the axis, so
  q falls back to the sequence (B6/B7 at an offset) and wo to head_dim;
* rwkv6-7b on (1, 2) under ``attn_prefer_seq``: the WKV runs on each
  rank's block of the sequence with every head, the state the earlier
  blocks carry in added across the ranks.
"""
import concurrent.futures
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import _torch_ranks as ranks
import _torch_sharded as ref
from repro.kernels.attention import flash_attention, flash_attention_bwd
from repro.tune import cache as tune_cache
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels.attention import (flash_attention_bwd_plain,
                                           flash_attention_plain)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.runtime.sharding import make_rules

torch.set_num_threads(1)
WORLD = 4
SEQ = {"constrain": True}
CASES = {  # name: (arch, mesh, options)
    "codeqwen1.5-7b-1x2": ("codeqwen1.5-7b", (1, 2), {}),
    "codeqwen1.5-7b-1x2-seq": ("codeqwen1.5-7b", (1, 2), SEQ),
    "codeqwen1.5-7b-1x2-attnseq": ("codeqwen1.5-7b", (1, 2),
                                   dict(SEQ, attn_seq=True)),
    "gemma-2b-1x2-seq": ("gemma-2b", (1, 2), SEQ),
    "gemma-2b-1x4-seq": ("gemma-2b", (1, 4), SEQ),
    "gemma3-4b-1x2-attnseq": ("gemma3-4b", (1, 2),
                              dict(SEQ, attn_seq=True)),
    "qwen2-moe-a2.7b-2x2-seq": ("qwen2-moe-a2.7b", (2, 2),
                                dict(SEQ, expert_pad=2)),
    "qwen2-vl-2b-1x2-seq": ("qwen2-vl-2b", (1, 2), SEQ),
    "gemma-2b-6heads-1x4-seq": ("gemma-2b", (1, 4),
                                dict(SEQ, over={"n_heads": 6})),
    "rwkv6-7b-1x2-attnseq": ("rwkv6-7b", (1, 2), dict(SEQ, attn_seq=True)),
}
# cases that share another's inputs and JAX run
SHARED = {"codeqwen1.5-7b-1x2-seq": "codeqwen1.5-7b-1x2",
          "codeqwen1.5-7b-1x2-attnseq": "codeqwen1.5-7b-1x2",
          "gemma-2b-1x4-seq": "gemma-2b-1x2-seq"}


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each case's inputs, JAX's results, every rank's results)."""
    inputs = {}
    for i, (name, spec) in enumerate(CASES.items()):
        if name in SHARED:
            _, shape, opts = spec
            inputs[name] = dict(inputs[SHARED[name]], shape=shape, **opts)
        else:
            inputs[name] = ref.case_inputs(spec, seed=40 + i)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        out = tmp_path_factory.mktemp("megatron")
        got = pool.submit(ranks.spawn, ranks.megatron_worker, WORLD, out,
                          list(inputs.values()))
        want = {name: ref.jax_reference(spec[0], inputs[name])
                for name, spec in CASES.items() if name not in SHARED}
        for name, base in SHARED.items():
            want[name] = want[base]
        got = got.result()
    return inputs, want, got


def _outs(got, name):
    i = list(CASES).index(name)
    return [r[i] for r in got if r[i] is not None]


@pytest.mark.parametrize("name", list(CASES))
def test_split_model_axis_step_matches_jax(name, runs):
    inputs, want, got = runs
    outs = _outs(got, name)
    assert len(outs) == math.prod(CASES[name][1])
    ref.check_ranks_agree(name, outs)
    ref.check_against_jax(name, inputs[name], outs[0], want[name])


@pytest.mark.parametrize("name", list(CASES))
def test_no_leaf_is_gathered_whole_over_model(name, runs):
    for out in _outs(runs[2], name):
        assert out["model_gathers"] == 0, name


@pytest.mark.parametrize("name", [n for n in CASES if "rwkv" not in n])
def test_attention_runs_in_the_hooks_layout(name, runs):
    """Each rank's attention calls take what ``attn_hook`` names: its H/m
    heads over the whole sequence, or its S/m rows of every head at
    offset rank x S/m over the whole keys."""
    inputs, _, got = runs
    cfg, shape = inputs[name]["cfg"], CASES[name][1]
    m = shape[1]
    rows = ref.B // shape[0]
    seq = inputs[name].get("attn_seq") or cfg.n_heads % m
    for r, out in enumerate(_outs(got, name)):
        assert out["attention"], name
        for q, k, offset in out["attention"]:
            if seq:
                assert q == (rows, ref.S // m, cfg.n_heads, cfg.head_dim)
                assert k[1] == ref.S and offset == (r % m) * ref.S // m
            else:
                assert q == (rows, ref.S, cfg.n_heads // m, cfg.head_dim)
                assert k == q and offset == 0


def test_rwkv_recurrence_runs_on_the_ranks_sequence_block(runs):
    """Under ``attn_prefer_seq`` each rank's WKV calls take its S/m rows of
    every head: no r/k/v gathered whole."""
    inputs, _, got = runs
    name = "rwkv6-7b-1x2-attnseq"
    cfg, (data, m) = inputs[name]["cfg"], CASES[name][1]
    heads = cfg.d_model // cfg.rwkv_head_dim
    for out in _outs(got, name):
        assert out["wkv"], name
        assert all(shape == (ref.B // data, ref.S // m, heads,
                             cfg.rwkv_head_dim) for shape in out["wkv"])


# --------------------------------------------------------------------------
# B6/B7's plain versions at a query offset
# --------------------------------------------------------------------------

B, H, SK, HD = 1, 2, 32, 16
PLAN = {"level": 3, "block_q": 8, "block_kv": 16}
TOL = 5e-4


@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("window", [0, 12])
def test_flash_plain_at_an_offset_is_a_block_of_jax_attention(blocks,
                                                              window):
    """Each query block at its offset gives those rows of JAX's whole
    attention (o, lse, dq); its dk/dv are parts, which summed over the
    blocks are JAX's whole gradient."""
    rng = np.random.default_rng(blocks + window)
    q, k, v, do = (rng.standard_normal((B, H, SK, HD)).astype(np.float32)
                   for _ in range(4))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    o_j, lse_j = flash_attention(jq, jk, jv, causal=True, window=window,
                                 plan=PLAN, return_residuals=True)
    dq_j, dk_j, dv_j = flash_attention_bwd(jq, jk, jv, o_j, lse_j,
                                           jnp.asarray(do), causal=True,
                                           window=window, plan=PLAN)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    n = SK // blocks
    dk = torch.zeros(B, H, SK, HD)
    dv = torch.zeros(B, H, SK, HD)
    for i in range(blocks):
        rows = slice(i * n, (i + 1) * n)
        tq = torch.from_numpy(q[:, :, rows].copy())
        o, lse = flash_attention_plain(tq, tk, tv, causal=True,
                                       window=window, return_lse=True,
                                       q_offset=i * n)
        assert o.shape == (B, H, n, HD) and lse.shape == (B, H, n)
        np.testing.assert_allclose(o, np.asarray(o_j)[:, :, rows],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(lse, np.asarray(lse_j)[:, :, rows],
                                   rtol=TOL, atol=TOL)
        g = flash_attention_bwd_plain(
            tq, tk, tv, o, lse, torch.from_numpy(do[:, :, rows].copy()),
            causal=True, window=window, q_offset=i * n)
        np.testing.assert_allclose(g[0], np.asarray(dq_j)[:, :, rows],
                                   rtol=TOL, atol=TOL)
        assert g[1].shape == g[2].shape == (B, H, SK, HD)
        dk += g[1]
        dv += g[2]
    np.testing.assert_allclose(dk, dk_j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dv, dv_j, rtol=TOL, atol=TOL)


def test_flash_plain_refuses_a_block_outside_the_keys():
    from repro_torch.kernels.attention.flash import check_bhsd
    q, kv = torch.ones(1, 2, 8, 16), torch.ones(1, 2, 16, 16)
    check_bhsd("flash", q, kv, kv, 8)
    for offset in (-1, 9):
        with pytest.raises(ValueError, match="do not lie"):
            check_bhsd("flash", q, kv, kv, offset)


# --------------------------------------------------------------------------
# the split of the work, on meta at full width
# --------------------------------------------------------------------------

META_SHAPE = ShapeSpec("train_meta", 256, 4, "train")
MATMULS = ("mm", "addmm", "bmm")


def _matmul_flops(cfg, mesh):
    """The matmul FLOPs of rank 0's train step (one layer of each kind)
    on an abstract ``mesh``, with the dry run's model and hooks."""
    fn, args, _ = dryrun.cell_step(cfg, META_SHAPE,
                                   make_rules(AbstractMesh(mesh,
                                                           ("data",
                                                            "model"))),
                                   "cost")
    with FlopCounterMode(display=False) as flops:
        fn(*args)
    return sum(n for op, n in flops.get_flop_counts()["Global"].items()
               if str(op).split(".")[1] in MATMULS)


@pytest.mark.parametrize("arch", ["gemma-2b", "codeqwen1.5-7b", "rwkv6-7b",
                                  "qwen2-moe-a2.7b"])
def test_each_rank_does_a_quarter_of_the_matmuls(arch):
    """On a (1, 4) mesh rank 0's matmul FLOPs are a quarter of the unsplit
    step's, within 1%.  What every rank still does alike: the rwkv decay
    LoRA's down product (d x 64, replicated wa) -- under 0.4% of an rwkv
    layer -- and the MoE capacity's rounding to 8 slots a rank."""
    cfg = get_arch(arch)
    cfg = cfg.with_layers(tuple(dict.fromkeys(cfg.layer_kinds())))
    whole = _matmul_flops(cfg, (1, 1))
    part = _matmul_flops(cfg, (1, 4))
    assert part * 4 == pytest.approx(whole, rel=0.01), (part * 4, whole)
