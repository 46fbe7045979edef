"""The benchmark's own counts of operations and bytes, from a
configuration's published sizes and the tokens a window processed.
They count the work the inputs need, whatever runs it: real tokens
only (no padding rows, no masked slots), no recompute, each input byte
read once and each output byte written once.  A least time is the larger
of operations over the peak rate and bytes over the peak bandwidth."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Tuple

BF16 = 2


@dataclass(frozen=True)
class Sizes:
    d: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    experts: int = 0
    top_k: int = 0
    expert_ff: int = 0
    shared_ff: int = 0


def sizes(config: Dict) -> Sizes:
    d, h = config["hidden_size"], config["num_attention_heads"]
    moe = "num_experts" in config
    return Sizes(d=d, layers=config["num_hidden_layers"], heads=h,
                 kv_heads=config["num_key_value_heads"],
                 head_dim=config.get("head_dim", d // h),
                 ff=config["intermediate_size"],
                 vocab=config["vocab_size"],
                 experts=config["num_experts"] if moe else 0,
                 top_k=config["num_experts_per_tok"] if moe else 0,
                 expert_ff=config["moe_intermediate_size"] if moe else 0,
                 shared_ff=config["shared_expert_intermediate_size"]
                 if moe else 0)


def dense_gemms(s: Sizes) -> List[Tuple[int, int]]:
    """(K, N) of each product every token takes through one layer,
    outside the routed experts: q, k, v, o, then the MLP's gate, up and
    down (or the MoE layer's router and shared MLP)."""
    q, kv = s.heads * s.head_dim, s.kv_heads * s.head_dim
    out = [(s.d, q), (s.d, kv), (s.d, kv), (q, s.d)]
    if s.experts:
        out += [(s.d, s.experts), (s.d, s.shared_ff), (s.d, s.shared_ff),
                (s.shared_ff, s.d)]
    else:
        out += [(s.d, s.ff), (s.d, s.ff), (s.ff, s.d)]
    return out


def active_params(s: Sizes) -> int:
    """Parameters a token multiplies through: every layer's dense
    products and its top-k experts, and the head (the embedding is a
    lookup)."""
    per_layer = sum(k * n for k, n in dense_gemms(s)) \
        + s.top_k * 3 * s.d * s.expert_ff
    return s.layers * per_layer + s.d * s.vocab


def least_s(flops: float, nbytes: float, peaks: Dict) -> float:
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"])


def gemm_least_s(m: int, k: int, n: int, peaks: Dict) -> float:
    """A bf16 product (m, k) x (k, n) -> (m, n)."""
    if m <= 0:
        return 0.0
    return least_s(2.0 * m * k * n, BF16 * (m * k + k * n + m * n), peaks)


def context_sum(start: int, n: int) -> int:
    """Keys attended by n query tokens at positions start..start+n-1."""
    return n * start + n * (n + 1) // 2


@dataclass
class Forward:
    """One serving forward over prompt chunks (start, real tokens) and
    decode rows (keys attended, the new token's included)."""
    chunks: Sequence[Tuple[int, int]]
    decode: Sequence[int]

    def tokens(self) -> int:
        return sum(n for _, n in self.chunks) + len(self.decode)

    def logit_rows(self) -> int:
        return len(self.chunks) + len(self.decode)

    def attn_keys(self) -> int:
        return sum(context_sum(st, n) for st, n in self.chunks) \
            + sum(self.decode)


def serve_flops(s: Sizes, fwd: Forward) -> float:
    """2 flops a multiply-add: the layers' products for every token, the
    head for every row whose logits are read, and attention (q k^T and p
    v) over each token's causal context."""
    per_tok = sum(k * n for k, n in dense_gemms(s))
    attn = 4.0 * s.heads * s.head_dim * fwd.attn_keys()
    return s.layers * (2.0 * fwd.tokens() * per_tok + attn) \
        + 2.0 * fwd.logit_rows() * s.d * s.vocab


def serve_gemm_least_s(s: Sizes, calls: Iterable[Tuple[int, int]],
                       peaks: Dict) -> float:
    """Least time of the dense products of forwards given as (rows, logit
    rows): each layer's products on the rows, the head on the logit
    rows."""
    total = 0.0
    for rows, logit_rows in calls:
        total += s.layers * sum(gemm_least_s(rows, k, n, peaks)
                                for k, n in dense_gemms(s))
        total += gemm_least_s(logit_rows, s.d, s.vocab, peaks)
    return total


def attn_least_s(s: Sizes, fwd: Forward, peaks: Dict) -> float:
    """Least time of one forward's attention over every layer: the keys
    and values each query row's sequence holds read once, the queries
    read and the outputs written; the products over the causal
    context."""
    qo = 2 * BF16 * s.heads * s.head_dim          # a row's query + output
    kv = 2 * BF16 * s.kv_heads * s.head_dim       # a position's key + value
    total = 0.0
    for st, n in fwd.chunks:
        total += least_s(4.0 * s.heads * s.head_dim * context_sum(st, n),
                         (st + n) * kv + n * qo, peaks)
    for keys in fwd.decode:
        total += least_s(4.0 * s.heads * s.head_dim * keys,
                         keys * kv + qo, peaks)
    return s.layers * total


def train_flops_per_token(s: Sizes, seq: int) -> float:
    """PaLM's model flops a token (arXiv:2204.02311, App. B): 6 N + 12 L
    H Q T, with N the active parameters, no credit for recompute."""
    return 6.0 * active_params(s) + 12.0 * s.layers * s.heads \
        * s.head_dim * seq


def expert_least_s(s: Sizes, tokens: int, peaks: Dict) -> float:
    """Least time of one train step's routed-expert products: for R =
    tokens x top_k assignments, each MoE layer's gate, up and down
    products forward and their two gradients each backward, every expert
    weight read once a product."""
    r = tokens * s.top_k
    total = 0.0
    for k, n in ((s.d, s.expert_ff), (s.d, s.expert_ff), (s.expert_ff, s.d)):
        flops = 2.0 * r * k * n
        nbytes = BF16 * (r * k + s.experts * k * n + r * n)
        total += 3 * least_s(flops, nbytes, peaks)
    return s.layers * total
