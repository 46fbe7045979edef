"""The benchmark's operation and byte counts against hand counts."""
import json

import pytest

from benchlib import flops
from tiny import BENCH

PEAKS = {"bf16_flops": 1e15, "hbm_bytes_per_s": 1e12}


def sizes(name):
    return flops.sizes(json.loads((BENCH / "configs" / name).read_text()))


def test_codeqwen_parameters():
    s = sizes("codeqwen1.5-7b.json")
    per_layer = 4096 * 4096 * 2 + 4096 * 512 * 2 + 3 * 4096 * 13440
    assert sum(k * n for k, n in flops.dense_gemms(s)) == per_layer
    # with the embedding (a lookup, not counted) the model has 7.25e9
    total = flops.active_params(s) + 92416 * 4096
    assert 7.2e9 < total < 7.3e9


def test_moe_active_parameters():
    s = sizes("qwen2-moe-a2.7b.l4.json")
    attn = 2048 * 2048 * 4
    per_layer = attn + 2048 * 60 + 3 * 2048 * 5632 + 4 * 3 * 2048 * 1408
    assert flops.active_params(s) == 4 * per_layer + 2048 * 151936


def test_context_sum():
    # positions 3, 4, 5 attend 4, 5, 6 keys
    assert flops.context_sum(3, 3) == 15


def test_serve_flops_by_hand():
    s = flops.Sizes(d=8, layers=2, heads=2, kv_heads=1, head_dim=4, ff=16,
                    vocab=10)
    fwd = flops.Forward(chunks=[(0, 2)], decode=[5])
    per_tok = 8 * 8 + 8 * 4 * 2 + 8 * 8 + 3 * 8 * 16
    attn = 4 * 2 * 4 * (1 + 2 + 5)
    want = 2 * (2 * 3 * per_tok + attn) + 2 * 2 * 8 * 10
    assert flops.serve_flops(s, fwd) == want


def test_gemm_least_time_takes_the_larger_bound():
    # (1, 1000) x (1000, 1000): bytes bound
    t = flops.gemm_least_s(1, 1000, 1000, PEAKS)
    assert t == pytest.approx(2 * (1000 + 1e6 + 1000) / 1e12)
    # (1e4, 1e4) x (1e4, 1e4): flops bound
    t = flops.gemm_least_s(10 ** 4, 10 ** 4, 10 ** 4, PEAKS)
    assert t == pytest.approx(2e12 / 1e15)


def test_attention_least_time_reads_each_sequence_once():
    s = flops.Sizes(d=8, layers=1, heads=2, kv_heads=1, head_dim=4, ff=16,
                    vocab=10)
    t = flops.attn_least_s(s, flops.Forward([], [100]), PEAKS)
    assert t == pytest.approx((100 * 2 * 2 * 4 + 2 * 2 * 2 * 4) / 1e12)


def test_palm_train_flops():
    s = sizes("qwen2-moe-a2.7b.l4.json")
    per_tok = flops.train_flops_per_token(s, 2048)
    assert per_tok == 6 * flops.active_params(s) + 12 * 4 * 16 * 128 * 2048


def test_expert_least_time():
    s = sizes("qwen2-moe-a2.7b.l4.json")
    t = flops.expert_least_s(s, 4096, {"bf16_flops": 1e15,
                                       "hbm_bytes_per_s": 1e20})
    assert t == pytest.approx(4 * 3 * 3 * 2 * 16384 * 2048 * 1408 / 1e15)
