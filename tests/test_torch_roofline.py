"""The port's roofline analysis against the JAX package's: the ring
traffic model, the collective statistics and the affine combination on
the same inputs, exactly; the affine method on the port's ``meta``
FLOP count; ``analyze_step``'s FLOPs of one layer against a count by
hand; and flash attention on ``meta`` as the kernels' ops."""
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.roofline import analysis as jax_analysis
from repro_torch.configs import get_arch
from repro_torch.core import tree
from repro_torch.core.memory import F32_POLICY
from repro_torch.kernels import dispatch
from repro_torch.models import transformer as tfm
from repro_torch.roofline import analysis

torch.set_num_threads(1)

OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
       "collective-permute")
HLO = """
HloModule jit_train_step

ENTRY %main {
  %ar = f32[2048,1024]{1,0} all-reduce(%x), replica_groups=[32,16]<=[512], to_apply=%add
  %ag = bf16[16,4096]{1,0} all-gather(%y), replica_groups={{0,1,2,3}, {4,5,6,7}}, dimensions={1}
  %rs = f32[128]{0} reduce-scatter(%z), replica_groups=[64,8]<=[512], to_apply=%add
  %a2a = bf16[8,256]{1,0} all-to-all(%w), replica_groups=[32,16]<=[512]
  %cp = f32[333]{0} collective-permute(%v), source_target_pairs={{0,1},{1,0}}
  %ag2 = f32[7,3]{1,0} all-gather(%u), replica_groups=[2,256]<=[512], dimensions={0}
}
"""


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("nbytes,n", [(1000, 10), (4096, 16), (333, 1),
                                      (7, 256)])
def test_per_chip_traffic_matches_jax(op, nbytes, n):
    assert analysis.CollectiveOp(op, nbytes, n).per_chip_traffic \
        == jax_analysis.CollectiveOp(op, nbytes, n, "").per_chip_traffic


def test_collective_stats_match_jax():
    jops = jax_analysis.parse_collectives(HLO)
    ours = analysis.collective_stats(
        analysis.CollectiveOp(o.op, o.operand_bytes, o.group_size)
        for o in jops)
    theirs = jax_analysis.collective_stats(HLO)
    assert (ours.per_chip_bytes, ours.by_op, ours.count, ours.schedule) \
        == (theirs.per_chip_bytes, theirs.by_op, theirs.count,
            theirs.schedule)
    assert analysis.collective_stats([]).count == 0


def test_combine_affine_matches_jax():
    base = {"flops_per_device": 10.5, "hbm_bytes_per_device": 5.0,
            "collective_bytes_per_chip": 1.25}
    per_kind = {"attn/mlp": {"flops_per_device": 14.0,
                             "hbm_bytes_per_device": 7.5,
                             "collective_bytes_per_chip": 1.5},
                "rwkv/rwkv_cm": {"flops_per_device": 30.0,
                                 "hbm_bytes_per_device": 6.0}}
    counts = {"attn/mlp": 10, "rwkv/rwkv_cm": 3}
    assert analysis.combine_affine(base, per_kind, counts) \
        == jax_analysis.combine_affine(base, per_kind, counts)


def _batch(cfg, b, s):
    return {"tokens": torch.empty(b, s, dtype=torch.int32, device="meta"),
            "labels": torch.empty(b, s, dtype=torch.int32, device="meta")}


def _grad_flops(n_layers: int) -> float:
    """``meta`` FLOPs of the smoke gemma-2b loss gradient at depth
    ``n_layers``."""
    cfg0 = get_arch("gemma-2b").smoke()
    cfg = cfg0.with_layers((cfg0.layer_kinds()[0],) * n_layers)
    model = tfm.Model(cfg, dt=F32_POLICY, device="meta",
                      opts=tfm.ExecOptions(xent_chunks=4))

    def grad(params, batch):
        flat, rebuild = tree.flatten(params)
        for p in flat:
            p.requires_grad_(True)
        loss, _ = model.loss_fn(rebuild(flat), batch)
        return torch.autograd.grad(loss, flat)
    return analysis.analyze_step(grad, model.param_specs(),
                                 _batch(cfg, 2, 32))["flops_per_device"]


def test_affine_method_on_meta_flops():
    """cost(5 layers) == cost(0) + 5 (cost(1) - cost(0)): the eager
    program counts every op once, so the claim holds exactly (JAX's own
    test allows 8% for XLA's fusion differences across depths)."""
    f0, f1, f5 = (_grad_flops(n) for n in (0, 1, 5))
    assert f1 > f0 > 0
    assert f5 == f0 + 5 * (f1 - f0)


def test_one_layer_forward_flops_by_hand():
    cfg = get_arch("gemma-2b").smoke()
    kind = cfg.layer_kinds()[0]
    b, s = 2, 32
    d, h, hkv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim, cfg.d_ff)
    model = tfm.Model(cfg, dt=F32_POLICY, device="meta")
    p = model.param_specs()["prefix"][0]
    x = torch.empty(b, s, d, device="meta")
    pos = torch.empty(b, s, dtype=torch.int32, device="meta")

    @torch.no_grad()
    def layer(p, x, pos):
        return tfm.layer_apply(p, cfg, kind, x, pos, model.dt, model.opts)
    got = analysis.analyze_step(layer, p, x, pos)
    m = b * s
    matmuls = [(d, h * hd), (d, hkv * hd), (d, hkv * hd), (h * hd, d),
               (d, ff), (d, ff), (ff, d)]      # q k v o, gate up down
    attention = 2 * (2 * b * h * s * s * hd)   # Q K^T and P V, unmasked
    want = sum(2 * m * k * n for k, n in matmuls) + attention
    assert got["flops_per_device"] == want
    assert got["collective_count"] == 0
    args = sum(math.prod(t.shape) * t.element_size()
               for t in tree.leaves((p, x, pos)))
    assert got["argument_bytes_per_device"] == args
    assert got["peak_bytes_per_device"] > args
    assert got["hbm_bytes_per_device"] > got["temp_bytes_per_device"] > 0


def _attention_grad(q, k, v):
    for t in (q, k, v):
        t.requires_grad_(True)
    out = dispatch.attention(q, k, v, causal=True, out_dtype=torch.float32)
    return torch.autograd.grad(out.sum(), (q, k, v))


def test_meta_attention_holds_what_the_kernels_hold():
    """On ``meta`` flash attention is counted as the kernels' ops: the
    plain version's FLOPs (forward and backward, dense), but no (B, H, S,
    S) scores in the live set or the traffic, and the gradients' shapes
    and dtypes."""
    b, s, h, hd = 1, 16, 2, 8
    gen = torch.Generator().manual_seed(0)
    cpu = [torch.randn(b, s, h, hd, generator=gen) for _ in range(3)]
    with FlopCounterMode(display=False) as plain:
        want = _attention_grad(*cpu)
    meta = [t.detach().to("meta") for t in cpu]
    got = analysis.analyze_step(_attention_grad, *meta)
    assert got["flops_per_device"] == plain.get_total_flops() \
        == 14 * b * h * s * s * hd
    assert [(g.shape, g.dtype) for g in _attention_grad(*meta)] \
        == [(g.shape, g.dtype) for g in want]
    # 4096 tokens in bf16 at hd 256: one fp32 (B, H, S, S) score tile of
    # the plain version is 16 fp32 (B, H, S, hd) rows; the kernels hold
    # o, lse, dq, dk, dv and dO's bf16 halves, about 8 rows at the peak
    b, s, h, hd = 1, 4096, 8, 256
    qkv = [torch.empty(b, s, h, hd, dtype=torch.bfloat16, device="meta")
           for _ in range(3)]
    got = analysis.analyze_step(_attention_grad, *qkv)
    scores = b * h * s * s * 4
    row = b * h * s * hd * 4
    assert scores == 16 * row
    assert got["temp_bytes_per_device"] < 9 * row
    assert got["hbm_bytes_per_device"] < 24 * row
