"""The 10 architectures, copied entry for entry from
``repro.configs.archs`` (tests/test_torch_configs.py holds the two equal).

Sources are in brackets; structural details beyond the one-line spec
(patterns, shared experts, head dims) follow the cited public configs and
are noted inline.
"""
from __future__ import annotations

from .base import ArchConfig

# ---- MoE --------------------------------------------------------------

QWEN2_MOE_A2_7B = ArchConfig(
    # [hf:Qwen/Qwen1.5-MoE-A2.7B] 24L d=2048 16H (kv=16) d_ff(expert)=1408
    # vocab=151936, 60 routed top-4 + 4 shared (fused 5632-wide shared MLP)
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=5632, vocab_size=151936,
    pattern=(("attn", "moe"),),
    n_experts=60, top_k=4, d_expert=1408,
    n_shared_experts=4, shared_d_expert=5632,
    activation="swiglu", qkv_bias=True, rope_theta=1e6,
    notes="shared experts fused into one 5632-wide MLP; norm_topk routing",
)

KIMI_K2_1T_A32B = ArchConfig(
    # [arXiv:2501.kimi2] 61L d=7168 64H (kv=8) moe_ff=2048 vocab=163840,
    # 384 experts top-8 (+1 shared, DeepSeek-V3 lineage; first layer dense
    # with ff=18432 per the DS-V3 recipe)
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=18432, vocab_size=163840,
    prefix=(("attn", "mlp"),),
    pattern=(("attn", "moe"),),
    n_experts=384, top_k=8, d_expert=2048,
    n_shared_experts=1, shared_d_expert=2048,
    activation="swiglu", rope_theta=5e4,
    notes="assignment mandates GQA kv=8 (real K2 uses MLA); 1 dense first "
          "layer; type demotion (§4.4 int8 moments) required to fit 512 "
          "chips — see EXPERIMENTS.md",
)

# ---- audio ------------------------------------------------------------

MUSICGEN_LARGE = ArchConfig(
    # [arXiv:2306.05284] 48L d=2048 32H d_ff=8192 vocab=2048 (EnCodec
    # codebook). Frontend (EnCodec + codebook delay interleave + text
    # conditioning) is a STUB: input_specs feeds precomputed frame
    # embeddings per the assignment.
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048,
    pattern=(("attn", "mlp"),),
    activation="gelu", rope_theta=1e4, input_mode="embeddings",
    notes="decoder-only over EnCodec tokens; cross-attn conditioning "
          "stubbed (frame embeddings already conditioned)",
)

# ---- dense ------------------------------------------------------------

GEMMA3_4B = ArchConfig(
    # [hf:google/gemma-3-*] 34L d=2560 8H (kv=4) d_ff=10240 vocab=262144,
    # 5 local (sliding 1024) : 1 global, head_dim 256, GeGLU, tied embed
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab_size=262144,
    pattern=(("swa", "mlp"),) * 5 + (("attn", "mlp"),),
    window=1024, activation="geglu", rope_theta=1e6,
    tie_embeddings=True, embed_scale=True,
    subquadratic=True,
    notes="hybrid local:global 5:1 -> long_500k runs (global layers are "
          "decode-linear; local layers keep a 1024-slot rolling cache)",
)

GEMMA_2B = ArchConfig(
    # [arXiv:2403.08295] 18L d=2048 8H MQA(kv=1) d_ff=16384 vocab=256000,
    # GeGLU, head_dim=256, tied embeddings
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000,
    pattern=(("attn", "mlp"),),
    activation="geglu", rope_theta=1e4,
    tie_embeddings=True, embed_scale=True,
)

DEEPSEEK_67B = ArchConfig(
    # [arXiv:2401.02954] 95L d=8192 64H (kv=8) d_ff=22016 vocab=102400,
    # llama-arch (SwiGLU, RMSNorm, RoPE)
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=102400,
    pattern=(("attn", "mlp"),),
    activation="swiglu", rope_theta=1e4,
)

CODEQWEN15_7B = ArchConfig(
    # [hf:Qwen/CodeQwen1.5-7B] 32L d=4096 32H (kv=32... spec says kv=32;
    # hf config uses GQA kv=4 for codeqwen — we follow the assignment)
    # d_ff=13440 vocab=92416, qwen1.5 arch (QKV bias)
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=13440, vocab_size=92416,
    pattern=(("attn", "mlp"),),
    activation="swiglu", qkv_bias=True, rope_theta=1e6,
)

# ---- SSM / hybrid -----------------------------------------------------

RWKV6_7B = ArchConfig(
    # [arXiv:2404.05892] Finch 32L d=4096 attn-free d_ff=14336 vocab=65536,
    # data-dependent decay, head_dim 64
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=0, head_dim=64,
    d_ff=14336, vocab_size=65536,
    pattern=(("rwkv", "rwkv_cm"),),
    rwkv_head_dim=64, rwkv_chunk=64,
    subquadratic=True,
    notes="attention transformations inapplicable (attn-free); chunked scan "
          "= tiled accumulation interleaving §2.1.2 on the matrix-state "
          "recurrence",
)

RECURRENTGEMMA_9B = ArchConfig(
    # [arXiv:2402.19427] Griffin: 38L d=4096 16H (kv=1, MQA) d_ff=12288,
    # vocab=256000, pattern 2 recurrent : 1 local-attn (window 2048),
    # lru_width=4096, GeGLU
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    pattern=(("rglru", "mlp"), ("rglru", "mlp"), ("swa", "mlp")),
    window=2048, lru_width=4096, conv_width=4,
    activation="geglu", tie_embeddings=True, embed_scale=True,
    subquadratic=True,
    notes="RG-LRU via associative_scan (log-depth); local attn keeps a "
          "2048-slot rolling cache",
)

# ---- VLM --------------------------------------------------------------

QWEN2_VL_2B = ArchConfig(
    # [arXiv:2409.12191] 28L d=1536 12H (kv=2) d_ff=8960 vocab=151936,
    # M-RoPE (sections 16/24/24 over head_dim/2), vision tower STUBBED:
    # input_specs feeds precomputed patch embeddings + 3-axis positions.
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936,
    pattern=(("attn", "mlp"),),
    activation="swiglu", qkv_bias=True, rope_theta=1e6,
    mrope_sections=(16, 24, 24), tie_embeddings=True,
    input_mode="embeddings",
    notes="backbone only per assignment; M-RoPE positions provided by the "
          "(stub) frontend",
)


ARCHS = {
    c.name: c
    for c in [
        QWEN2_MOE_A2_7B, KIMI_K2_1T_A32B, MUSICGEN_LARGE, GEMMA3_4B,
        GEMMA_2B, DEEPSEEK_67B, CODEQWEN15_7B, RWKV6_7B, RECURRENTGEMMA_9B,
        QWEN2_VL_2B,
    ]
}
