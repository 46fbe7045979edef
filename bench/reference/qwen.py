"""Plain float32 reference of the decoders the benchmark's configurations
state: Qwen2 (CodeQwen1.5) and Qwen2-MoE (Qwen1.5-MoE), forward, loss,
gradients and AdamW.

Plain ``torch`` operations only, float32 throughout, TF32 off
(``exact_fp32``).  It reads the published sizes from a configuration
file's top-level keys and the equations the file states under
``as_run`` (where the measured program departs from the published
model), and nothing else.  It imports no package of the program.

Weights come as a tree the benchmark made from its seed (one leaf per
kind of weight, a layer's leaves indexed by layer):

* ``embed`` (V, d), ``head`` (d, V), ``final_norm`` (d,);
* ``layers[i]``: ``ln1``, ``ln2`` (d,) as ``(1 + scale)`` RMSNorm scales;
  ``wq`` (d, H, hd), ``wk`` / ``wv`` (d, Hkv, hd), ``bq`` (H, hd), ``bk``
  / ``bv`` (Hkv, hd), ``wo`` (H, hd, d); then either ``mlp`` with ``wg``,
  ``wu`` (d, ff) and ``wd`` (ff, d), or ``moe`` with ``router`` (d, E),
  ``wg``, ``wu`` (E, d, f), ``wd`` (E, f, d) and ``shared`` (an ``mlp``).

``mm`` is the matrix product every projection goes through: ``fp32_mm``
here, ``fp8_mm`` for the lower-precision control.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

Mm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def exact_fp32() -> None:
    """float32 products stay float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.float() @ b.float()


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (amax to 448), back in float32; the gradient passes straight
    through."""
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control's product: a's rows and b's columns in float8 e4m3,
    accumulated in float32."""
    return _fp8(a.float(), -1) @ _fp8(b.float(), 0)


@dataclass(frozen=True)
class Spec:
    d: int
    n_layers: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    theta: float
    eps: float
    experts: int = 0
    top_k: int = 0
    expert_ff: int = 0
    shared_ff: int = 0
    capacity_factor: float = 0.0
    aux_coef: float = 0.0
    norm_topk: bool = False

    @property
    def moe(self) -> bool:
        return self.experts > 0

    def capacity(self, n_tokens: int) -> int:
        """Assignments an expert keeps (``as_run.capacity``): ceil(T k cf
        / E), rounded up to a multiple of 8, at least 8; 0 = dropless."""
        if not self.capacity_factor:
            return n_tokens * self.top_k
        c = math.ceil(n_tokens * self.top_k * self.capacity_factor
                      / self.experts)
        return max(8, -(-c // 8) * 8)


def spec_of(config: Dict) -> Spec:
    """The sizes of a configuration file (published keys), with what
    ``as_run`` states in place of the published behaviour."""
    run = config.get("as_run", {})
    d = config["hidden_size"]
    heads = config["num_attention_heads"]
    moe = "num_experts" in config
    return Spec(
        d=d, n_layers=config["num_hidden_layers"], heads=heads,
        kv_heads=config["num_key_value_heads"],
        head_dim=config.get("head_dim", d // heads),
        ff=config["intermediate_size"], vocab=config["vocab_size"],
        theta=float(config["rope_theta"]),
        eps=float(run.get("rms_norm_eps", config["rms_norm_eps"])),
        experts=config.get("num_experts", 0) if moe else 0,
        top_k=config.get("num_experts_per_tok", 0) if moe else 0,
        expert_ff=config.get("moe_intermediate_size", 0) if moe else 0,
        shared_ff=config.get("shared_expert_intermediate_size", 0)
        if moe else 0,
        capacity_factor=float(run.get("capacity_factor", 0.0)),
        aux_coef=float(config.get("router_aux_loss_coef", 0.0)) if moe
        else 0.0,
        norm_topk=bool(run.get("norm_topk_prob",
                               config.get("norm_topk_prob", False))))


# --------------------------------------------------------------- pieces

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, hd); the first and second halves of hd rotate as
    pairs (the half-split layout)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = pos.float()[..., None] * inv                 # (..., S, hd/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_block: int) -> torch.Tensor:
    """q (B, S, H, hd), k / v (B, S, Hkv, hd): softmax(q k^T / sqrt(hd))
    v under a causal mask, each kv head shared by H / Hkv query heads;
    query rows in blocks of ``q_block``."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)       # (B, H, S, hd)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    out = []
    for i in range(0, s, q_block):
        j = min(s, i + q_block)
        sc = q[:, :, i:j] @ k[:, :, :j].transpose(-1, -2) / math.sqrt(hd)
        rows = torch.arange(i, j, device=q.device)[:, None]
        cols = torch.arange(j, device=q.device)[None, :]
        sc = sc.masked_fill(cols > rows, float("-inf"))
        out.append(torch.softmax(sc, dim=-1) @ v[:, :, :j])
    return torch.cat(out, dim=2).transpose(1, 2)            # (B, S, H, hd)


def mlp(x: torch.Tensor, w: Dict, mm: Mm) -> torch.Tensor:
    """SwiGLU: (silu(x Wg) * x Wu) Wd."""
    return mm(F.silu(mm(x, w["wg"])) * mm(x, w["wu"]), w["wd"])


def moe(x: torch.Tensor, w: Dict, sp: Spec, mm: Mm):
    """Top-k routed experts plus the shared MLP, as ``as_run`` states:
    the router's softmax in float32 on the float32 router, the top k by a
    stable descending sort, renormalised when ``norm_topk``; an expert
    keeps the first ``capacity`` of its assignments in (token, k) order
    and drops the rest; the shared MLP is added without a gate.  The
    load-balancing loss is ``aux_coef * E * sum(mean prob * share of
    tokens whose first choice is the expert)``.  x (T, d) -> (out, aux)."""
    t = x.shape[0]
    probs = torch.softmax(x.float() @ w["router"].float(), dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :sp.top_k], idx[:, :sp.top_k]
    if sp.norm_topk:
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    first = F.one_hot(idx[:, 0], sp.experts).float().mean(0)
    aux = sp.aux_coef * sp.experts * torch.sum(probs.mean(0) * first)
    cap = sp.capacity(t)
    flat_e = idx.reshape(-1)
    flat_g = gate.reshape(-1)
    flat_t = torch.arange(t, device=x.device).repeat_interleave(sp.top_k)
    out = torch.zeros_like(x, dtype=torch.float32)
    for e in range(sp.experts):
        mine = torch.nonzero(flat_e == e).flatten()[:cap]
        if mine.numel() == 0:
            continue
        tok = flat_t[mine]
        xe = x[tok]
        h = F.silu(mm(xe, w["wg"][e])) * mm(xe, w["wu"][e])
        ye = mm(h, w["wd"][e]) * flat_g[mine, None]
        out = out.index_add(0, tok, ye)
    return out + mlp(x, w["shared"], mm), aux


def block(x: torch.Tensor, pos: torch.Tensor, w: Dict, sp: Spec, mm: Mm,
          q_block: int):
    """One decoder layer on x (B, S, d): attention with QKV biases and
    RoPE, then the MLP or the MoE layer, each behind an RMSNorm and on
    the residual.  Returns (x, aux)."""
    b, s, d = x.shape
    hd = sp.head_dim
    h = rmsnorm(x, w["ln1"], sp.eps)
    q = (mm(h, w["wq"].reshape(d, -1)).reshape(b, s, sp.heads, hd)
         + w["bq"].float())
    k = (mm(h, w["wk"].reshape(d, -1)).reshape(b, s, sp.kv_heads, hd)
         + w["bk"].float())
    v = (mm(h, w["wv"].reshape(d, -1)).reshape(b, s, sp.kv_heads, hd)
         + w["bv"].float())
    q, k = rope(q, pos, sp.theta), rope(k, pos, sp.theta)
    a = causal_attention(q, k, v, q_block).reshape(b, s, sp.heads * hd)
    x = x + mm(a, w["wo"].reshape(sp.heads * hd, d))
    h = rmsnorm(x, w["ln2"], sp.eps)
    if sp.moe:
        y, aux = moe(h.reshape(b * s, d), w["moe"], sp, mm)
        return x + y.reshape(b, s, d), aux
    return x + mlp(h, w["mlp"], mm), None


def hidden(weights: Dict, tokens: torch.Tensor, sp: Spec, mm: Mm = fp32_mm,
           q_block: int = 1024, layer_fn=None):
    """The final-normed hidden states (B, S, d) of tokens (B, S) and the
    summed aux loss.  ``layer_fn(i)`` may supply layer i's weights (a
    caller that upcasts one layer at a time)."""
    b, s = tokens.shape
    x = weights["embed"][tokens.long()].float()
    pos = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    aux = torch.zeros((), device=tokens.device)
    for i in range(sp.n_layers):
        w = layer_fn(i) if layer_fn is not None else weights["layers"][i]
        x, a = block(x, pos, w, sp, mm, q_block)
        if a is not None:
            aux = aux + a
    return rmsnorm(x, weights["final_norm"], sp.eps), aux


def logits_at(weights: Dict, tokens: torch.Tensor, rows: torch.Tensor,
              sp: Spec, mm: Mm = fp32_mm, layer_fn=None) -> torch.Tensor:
    """Logits (R, V) of one sequence tokens (S,) at positions ``rows``."""
    with torch.no_grad():
        h, _ = hidden(weights, tokens[None], sp, mm, layer_fn=layer_fn)
        return mm(h[0, rows.long()], weights["head"])


def loss(weights: Dict, tokens: torch.Tensor, labels: torch.Tensor,
         sp: Spec, mm: Mm = fp32_mm, chunk: int = 1024) -> torch.Tensor:
    """Mean next-token cross entropy over (B, S) plus the aux losses."""
    h, aux = hidden(weights, tokens, sp, mm)
    h = h.reshape(-1, sp.d)
    lab = labels.reshape(-1).long()
    total = torch.zeros((), device=h.device)
    for i in range(0, h.shape[0], chunk):
        lg = mm(h[i:i + chunk], weights["head"])
        total = total + F.cross_entropy(lg, lab[i:i + chunk],
                                        reduction="sum")
    return total / h.shape[0] + aux


# --------------------------------------------------------------- AdamW

@dataclass(frozen=True)
class AdamW:
    lr: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    grad_clip: float
    warmup_steps: int
    total_steps: int
    min_lr_ratio: float

    def lr_at(self, step: int) -> float:
        """Linear warm-up, then cosine decay to ``min_lr_ratio``."""
        warm = min(step / max(self.warmup_steps, 1), 1.0)
        prog = min(max((step - self.warmup_steps)
                       / max(self.total_steps - self.warmup_steps, 1), 0.0),
                   1.0)
        cos = 0.5 * (1 + math.cos(math.pi * prog))
        return self.lr * warm * (self.min_lr_ratio
                                 + (1 - self.min_lr_ratio) * cos)


def adamw_step(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               m: List[torch.Tensor], v: List[torch.Tensor], opt: AdamW,
               step: int) -> List[torch.Tensor]:
    """One AdamW step (step counts from 1) on float32 leaves in place:
    the gradients clipped to a global norm of ``grad_clip``, bias-
    corrected moments, decoupled weight decay.  Returns the clipped
    gradients."""
    with torch.no_grad():
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
        scale = min(1.0, opt.grad_clip / max(float(norm), 1e-9))
        lr = opt.lr_at(step)
        c1, c2 = 1 - opt.b1 ** step, 1 - opt.b2 ** step
        clipped = []
        for p, g, mi, vi in zip(params, grads, m, v):
            g = g * scale
            clipped.append(g)
            mi.mul_(opt.b1).add_((1 - opt.b1) * g)
            vi.mul_(opt.b2).add_((1 - opt.b2) * g.square())
            upd = (mi / c1) / ((vi / c2).sqrt() + opt.eps)
            p.sub_(lr * (upd + opt.weight_decay * p))
    return clipped


def train_steps(leaves: List[torch.Tensor], build: Callable, batches,
                sp: Spec, opt: AdamW, mm: Mm = fp32_mm,
                on_first: Optional[Callable] = None) -> Dict:
    """``len(batches)`` steps from float32 ``leaves`` (updated in place);
    ``build(leaves)`` gives the weight tree.  Returns each step's loss,
    the first step's clipped gradient norms by leaf and its raw
    gradient norms by leaf; ``on_first`` is handed the first step's
    clipped gradients."""
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    losses: List[float] = []
    first: Optional[List[float]] = None
    raw: Optional[List[float]] = None
    for n, (tokens, labels) in enumerate(batches, start=1):
        for p in leaves:
            p.requires_grad_(True)
        value = loss(build(leaves), tokens, labels, sp, mm)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        for p in leaves:
            p.requires_grad_(False)
        losses.append(float(value.detach()))
        clipped = adamw_step(leaves, grads, m, v, opt, n)
        if first is None:
            first = [float(g.norm()) for g in clipped]
            raw = [float(g.norm()) for g in grads]
            if on_first is not None:
                on_first(clipped)
        del grads, clipped, value
    return {"losses": losses, "grad_norms": first, "raw_grad_norms": raw}
