"""ArchConfig: one declarative description drives model build, smoke
reduction and serving-cache layout; ShapeSpec: the dry run's input
shapes.

A field-for-field copy of ``repro.configs.base``: that module imports
JAX, and this package must import without it.  ``input_specs`` returns
``meta`` tensors where JAX returns ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

# layer descriptor: (mixer, ffn)
#   mixer in {"attn", "swa", "rwkv", "rglru"}
#   ffn   in {"mlp", "moe", "rwkv_cm"}
LayerKind = Tuple[str, str]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # layer pattern: `prefix` explicit layers, then `pattern` repeated.
    pattern: Tuple[LayerKind, ...] = (("attn", "mlp"),)
    prefix: Tuple[LayerKind, ...] = ()
    window: int = 0               # sliding-window size for "swa" mixers
    activation: str = "swiglu"
    rope_theta: float = 1e6
    mrope_sections: Tuple[int, ...] = ()
    qkv_bias: bool = False
    tie_embeddings: bool = False
    embed_scale: bool = False     # gemma-style sqrt(d) embedding scaling
    input_mode: str = "tokens"    # tokens | embeddings (audio/vlm stubs)
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    shared_d_expert: int = 0
    top_k: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 64
    rwkv_intra: str = "direct"
    lru_width: int = 0
    conv_width: int = 4
    # long-context capability (sub-quadratic)
    subquadratic: bool = False
    # kernel routing knob of the JAX package; the port routes by device
    # (kernels/dispatch.py) and keeps the field only for parity
    dispatch: str = "auto"
    # serving KV-cache layout: "dense" | "paged"
    kv_cache: str = "dense"
    # page size for the paged layout; 0 = the serve default
    kv_page_size: int = 0
    # paged KV-cache storage dtype: "" = model compute dtype
    kv_dtype: str = ""
    # projection/MLP weight GEMMs: "" = float weights
    weights_dtype: str = ""
    notes: str = ""

    # ------------------------------------------------------------------
    def layer_kinds(self) -> Tuple[LayerKind, ...]:
        """The full, ordered list of (mixer, ffn) for all n_layers."""
        kinds = list(self.prefix)
        while len(kinds) < self.n_layers:
            kinds.extend(self.pattern)
        return tuple(kinds[: self.n_layers])

    def distinct_kinds(self) -> Tuple[LayerKind, ...]:
        return tuple(dict.fromkeys(self.layer_kinds()))

    def kind_counts(self) -> Dict[LayerKind, int]:
        counts: Dict[LayerKind, int] = {}
        for k in self.layer_kinds():
            counts[k] = counts.get(k, 0) + 1
        return counts

    # ------------------------------------------------------------------
    def with_layers(self, kinds: Tuple[LayerKind, ...]) -> "ArchConfig":
        """Override to an explicit (small) layer list."""
        return dataclasses.replace(
            self, n_layers=len(kinds), prefix=tuple(kinds), pattern=())

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        reduce = {
            "d_model": 128, "n_heads": 4, "n_kv_heads": min(self.n_kv_heads, 4)
            if self.n_kv_heads else 0, "head_dim": 32,
            "d_ff": 256, "vocab_size": 512,
        }
        kinds = self.layer_kinds()
        small_kinds = tuple(dict.fromkeys(kinds))[:3]  # one of each kind
        cfg = dataclasses.replace(
            self,
            name=self.name + "-smoke",
            **reduce,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            d_expert=64 if self.n_experts else 0,
            shared_d_expert=64 if self.n_shared_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            lru_width=128 if self.lru_width else 0,
            rwkv_head_dim=32,
            rwkv_chunk=16,
            window=min(self.window, 16) if self.window else 0,
            mrope_sections=(4, 6, 6) if self.mrope_sections else (),
        )
        return cfg.with_layers(small_kinds + small_kinds[:1])  # >=2 layers

    # ------------------------------------------------------------------
    # parameter accounting (exact; from the meta param tree)
    # ------------------------------------------------------------------
    def param_counts(self) -> Dict[str, float]:
        from ..models import transformer as tfm  # lazy, avoids the cycle
        return tfm.param_counts(self)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch          # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """The dry run's skips: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 500k-token KV footprint is "
                       "quadratic-history; skipped per assignment "
                       "(see DESIGN.md §Arch-applicability)")
    return True, ""


def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                compute_dtype: torch.dtype = torch.bfloat16
                ) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input (nothing is allocated).

    train/prefill -> token (or stub-embedding) batch + labels;
    decode        -> one new token per sequence (the cache's specs come
                     from the model, ``Model.cache_specs``).
    """
    b, s = shape.global_batch, shape.seq_len

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")
    n = s if shape.kind in ("train", "prefill") else 1
    if cfg.input_mode == "embeddings":
        batch = {"embeddings": meta((b, n, cfg.d_model), compute_dtype)}
    else:
        batch = {"tokens": meta((b, n), torch.int32)}
    if shape.kind == "train":
        batch["labels"] = meta((b, s), torch.int32)
    if cfg.mrope_sections:
        batch["positions"] = meta((b, n, len(cfg.mrope_sections)),
                                  torch.int32)
    return batch
