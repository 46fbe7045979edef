"""The RG-LRU recurrent block of RecurrentGemma (Griffin) -- the port of
``repro/models/griffin.py``.

The block: a GELU gate branch and a main branch, the main branch through
a width-K depthwise causal conv (a K-1 deep delay buffer carried as decode
state), then the real-gated linear recurrence

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    log a_t = -8 * r_t * softplus(lam),

whose gates r_t and i_t are block-diagonal projections, all in fp32; the
gated state goes out through the output projection.  The projections are
plain products, as in the JAX package (no Pallas kernel runs there).
Over a whole sequence the diagonal recurrence is a log-depth scan of
PyTorch ops (``rglru_scan``, the pairwise recursion of
``jax.lax.associative_scan``), differentiated by autograd; the decode
carries h and the conv's delay buffer one token at a time.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import dense_init

Params = Dict[str, torch.Tensor]

_C = 8.0  # Griffin's fixed gate sharpness


@dataclasses.dataclass(frozen=True)
class GriffinSpec:
    d_model: int
    lru_width: int
    conv_width: int = 4
    block_width: int = 256        # block-diagonal gate projections

    @property
    def n_blocks(self) -> int:
        return self.lru_width // self.block_width


def rglru_block_init(gen: torch.Generator, s: GriffinSpec,
                     lead=()) -> Params:
    """The JAX ``rglru_block_init`` distributions; ``lead`` =
    (n_periods,) stacks a period."""
    lead, d, w, dev = tuple(lead), s.d_model, s.lru_width, gen.device
    nb, bw = s.n_blocks, s.block_width

    def zeros(n):
        return torch.zeros(lead + (n,), dtype=torch.float32, device=dev)
    return {
        "w_main": dense_init(gen, lead + (d, w), d),
        "w_gate": dense_init(gen, lead + (d, w), d),
        "conv_w": 0.01 * torch.randn(lead + (s.conv_width, w),
                                     generator=gen, dtype=torch.float32,
                                     device=dev),
        "conv_b": zeros(w),
        # block-diagonal recurrence and input gates
        "wa": dense_init(gen, lead + (nb, bw, bw), bw),
        "ba": zeros(w),
        "wx": dense_init(gen, lead + (nb, bw, bw), bw),
        "bx": zeros(w),
        # lam parametrizes a in (0, 1): a = sigmoid(lam)
        "lam": torch.linspace(2.2, 5.5, w, dtype=torch.float32,
                              device=dev).expand(lead + (w,)).clone(),
        "w_out": dense_init(gen, lead + (w, d), w),
    }


def _block_diag(x: torch.Tensor, w: torch.Tensor,
                s: GriffinSpec) -> torch.Tensor:
    """x (..., lru) times the block-diagonal w (nb, bw, bw)."""
    shape = x.shape
    x = x.reshape(shape[:-1] + (s.n_blocks, s.block_width))
    return torch.einsum("...nc,ncd->...nd", x, w).reshape(shape)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of width K = w.shape[0] as K shifted taps.
    x: (B, S, lru); prev: (B, K-1, lru) delay buffer."""
    k, sq = w.shape[0], x.shape[1]
    xp = torch.cat([prev.to(x.dtype), x], dim=1)          # (B, S+K-1, lru)
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + sq, :] * w[k - 1 - i].to(x.dtype)
    return out + b.to(x.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it, logaddexp(x, 0),
    with no threshold (``F.softplus`` returns x itself past 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _rglru_coeffs(p: Params, s: GriffinSpec, x: torch.Tensor,
                  gates: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence weight a_t and input b_t, all fp32.  x: (..., lru);
    ``gates``: the block-diagonal products x wa and x wx, where the caller
    made them."""
    f32 = torch.float32
    xf = x.to(f32)
    if gates is None:
        gates = (_block_diag(xf, p["wa"].to(f32), s),
                 _block_diag(xf, p["wx"].to(f32), s))
    r = torch.sigmoid(gates[0] + p["ba"])
    i = torch.sigmoid(gates[1] + p["bx"])
    log_a = -_C * r * _softplus(p["lam"])        # log a_t <= 0
    a = torch.exp(log_a)
    # sqrt(1 - a^2) in a numerically safe form
    multiplier = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                        min=1e-12))
    return a, multiplier * i * xf


def _combine(left: Tuple[torch.Tensor, torch.Tensor],
             right: Tuple[torch.Tensor, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compose h -> a_l h + b_l, then h -> a_r h + b_r."""
    (al, bl), (ar, br) = left, right
    return al * ar, ar * bl + br


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along axis 1 (``even`` has as
    many entries as ``odd`` or one more)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([pairs, even[:, n:]], dim=1)


def _scan(a: torch.Tensor, b: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of (a, b) under ``_combine`` along axis 1, in
    ``jax.lax.associative_scan``'s recursion: combine adjacent pairs,
    scan the half-length sequence, then combine each of its prefixes with
    the next even element.  log2(S) levels, each a few elementwise ops
    over the whole sequence."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd_a, odd_b = _scan(*_combine((a[:, 0:n - 1:2], b[:, 0:n - 1:2]),
                                   (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        left = (odd_a[:, :-1], odd_b[:, :-1])
    else:
        left = (odd_a, odd_b)
    even_a, even_b = _combine(left, (a[:, 2::2], b[:, 2::2]))
    even_a = torch.cat([a[:, :1], even_a], dim=1)
    even_b = torch.cat([b[:, :1], even_b], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 of a, b (B, S, lru), from
    ``h0`` (B, lru) folded into the first step (zero when None)."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    return _scan(a, b)[1]


def rglru_block_apply(p: Params, s: GriffinSpec, x: torch.Tensor,
                      cdt: torch.dtype, split=None) -> torch.Tensor:
    """The block over whole sequences x (B, S, d) from a zero state: the
    gate and main branches, the causal conv from a zero delay buffer,
    the RG-LRU scan in fp32, the gated output projection.  Returns
    (B, S, d).  With ``split`` (``rglru_block_split``) it runs on the
    model axis's shards."""
    if split is not None:
        return rglru_block_split(p, s, x, cdt, split)
    gate = F.gelu(x @ p["w_gate"].to(cdt), approximate="tanh")
    main = x @ p["w_main"].to(cdt)
    prev = main.new_zeros((x.shape[0], s.conv_width - 1, s.lru_width))
    main = _causal_conv(main, p["conv_w"], p["conv_b"], prev)
    a, bb = _rglru_coeffs(p, s, main)
    h = rglru_scan(a, bb).to(cdt)
    return (h * gate) @ p["w_out"].to(cdt)


def rglru_block_split(p: Params, s: GriffinSpec, x: torch.Tensor,
                      cdt: torch.dtype, split) -> torch.Tensor:
    """The block on the model axis's shards (x whole, from
    ``split.branch``): ``w_main`` / ``w_gate`` give the rank's lru / m
    channels (column-parallel), ``w_out`` takes them (row-parallel,
    completed into the residual's layout); the conv, the gate biases, lam
    and the scan are per channel, on the rank's.  The block-diagonal
    gates take the rank's blocks where the blocks divide the axis, else
    their products run alike on whole channels and each rank keeps its
    own."""
    gate = F.gelu(split.col(x, p["w_gate"].to(cdt)), approximate="tanh")
    main = split.col(x, p["w_main"].to(cdt))
    local = _local_channels(p, main.shape[-1], split)
    prev = main.new_zeros((x.shape[0], s.conv_width - 1, main.shape[-1]))
    main = _causal_conv(main, local["conv_w"], local["conv_b"], prev)
    a, bb = _rglru_coeffs(local, s, main, _split_gates(p, s, main, split))
    h = rglru_scan(a, bb).to(cdt)
    # the row-parallel partials as fp32 sums, rounded once after the model
    # axis adds them
    return split.complete((h * gate).float() @ p["w_out"].to(cdt).float(),
                          cdt)


def _local_channels(p: Params, w: int, split) -> Params:
    """The per-channel leaves (conv, gate biases, lam) cut to the rank's
    ``w`` channels."""
    return {k: split.local(p[k], p[k].dim() - 1, w)
            for k in ("conv_w", "conv_b", "lam", "ba", "bx")}


def _split_gates(p: Params, s: GriffinSpec, main: torch.Tensor, split
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block-diagonal gate products of the rank's channels of
    ``main``: on the rank's blocks where the blocks divide the axis, else
    run alike on whole channels, each rank keeping its own."""
    f32 = torch.float32
    w = main.shape[-1]
    if p["wa"].shape[0] * s.block_width == w:     # the rank's blocks
        ls = dataclasses.replace(s, lru_width=w)
        return tuple(_block_diag(main.to(f32), p[k].to(f32), ls)
                     for k in ("wa", "wx"))

    def both(m):
        return torch.stack([_block_diag(m, p[k].to(f32), s)
                            for k in ("wa", "wx")])
    return split.own(split.alike(both, split.whole(main.to(f32), 2)),
                     3).unbind(0)


def rglru_block_decode(p: Params, s: GriffinSpec, x: torch.Tensor,
                       cache: Dict[str, torch.Tensor],
                       cdt: torch.dtype, split=None) -> torch.Tensor:
    """One token of the block.  x: (B, 1, d); cache: ``h`` (B, lru) fp32
    and ``conv`` (B, K-1, lru), both written in place: the delay buffer
    takes the pre-conv main branch.  Returns (B, 1, d).  With ``split``
    (the sharded decode, x alike on every rank) the projections split as
    ``rglru_block_split``'s and ``h`` and ``conv`` hold the rank's
    channels (``MeshRules.cache_spec``), its recurrence its own."""
    mm = torch.matmul if split is None else split.col
    gate = F.gelu(mm(x, p["w_gate"].to(cdt)), approximate="tanh")
    main = mm(x, p["w_main"].to(cdt))                    # (B, 1, lru)
    local = p if split is None else _local_channels(p, main.shape[-1],
                                                     split)
    conv = cache["conv"]
    main_c = _causal_conv(main, local["conv_w"], local["conv_b"], conv)
    conv.copy_(torch.cat([conv[:, 1:], main.to(conv.dtype)], dim=1))
    gates = None if split is None else _split_gates(p, s, main_c, split)
    a, bb = _rglru_coeffs(local, s, main_c, gates)
    h = a[:, 0] * cache["h"] + bb[:, 0]                  # (B, lru) fp32
    cache["h"].copy_(h)
    if split is None:
        return (h[:, None].to(cdt) * gate) @ p["w_out"].to(cdt)
    return split.complete((h[:, None].to(cdt) * gate).float()
                          @ p["w_out"].to(cdt).float(), cdt)


def griffin_cache_init(b: int, s: GriffinSpec, dtype: torch.dtype, device,
                       lead=()) -> Dict[str, torch.Tensor]:
    """Zero decode state: ``h`` (B, lru) fp32 and the conv's (B, K-1, lru)
    delay buffer in ``dtype``."""
    lead = tuple(lead)
    return {"h": torch.zeros(lead + (b, s.lru_width), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (b, s.conv_width - 1, s.lru_width),
                                dtype=dtype, device=device)}
