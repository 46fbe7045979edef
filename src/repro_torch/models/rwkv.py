"""RWKV6's chunked WKV recurrence -- the port of ``wkv_chunked`` and its
two intra-chunk forms from ``repro/models/rwkv.py``.

Per (batch, head), with data-dependent log-decays lw <= 0 and bonus u,

    S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T,
    o_t = r_t (S_{t-1} + diag(u) k_t v_t^T),

strip-mined into chunks of c tokens: within a chunk every interaction is
a product, and only the (hd, hd) state crosses from one chunk to the
next.  Every decay factor is the exponential of a non-positive log-sum,
so nothing overflows.  This is the plain version of the WKV kernel
(``kernels/wkv``), as ``repro/kernels/wkv/ref.py`` makes it the oracle of
the TPU kernel.  The rest of the RWKV model (time mix, channel mix,
decode, cache) is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def chunk_len(s: int, chunk: int) -> int:
    """The chunk length of a sequence of ``s`` tokens: ``min(chunk, s)``,
    halved until it divides ``s`` (``repro/models/rwkv.py:181-183``)."""
    c = min(chunk, s)
    while c > 1 and s % c:
        c //= 2
    return c


def _decay_weights(ecum_rows: torch.Tensor,
                   cum_cols: torch.Tensor) -> torch.Tensor:
    """exp(ecum_i - cum_j) for j < i, clamped at -60, zero elsewhere:
    (b, n, h, hd) x (b, n, h, hd) -> (b, n, n, h, hd)."""
    n = ecum_rows.shape[1]
    expo = ecum_rows[:, :, None] - cum_cols[:, None]
    below = torch.tril(torch.ones(n, n, dtype=torch.bool,
                                  device=expo.device), diagonal=-1)
    return torch.where(below[None, :, :, None, None],
                       torch.exp(torch.clamp(expo, min=-60.0)), 0.0)


def _intra_direct(rj, kj, vj, cum, ecum):
    """Direct per-channel form: materializes the (c, c, hd) decay tensor."""
    a = torch.einsum("bchk,bdhk,bcdhk->bcdh", rj, kj,
                     _decay_weights(ecum, cum))
    return torch.einsum("bcdh,bdhv->bchv", a, vj)


def _intra_matmul(rj, kj, vj, cum, ecum, c: int, sc: int):
    """Sub-chunked matmul form.  Off-diagonal (a > b) sub-blocks factor
    the decay as exp(ecum_i - m_a') * exp(m_a' - m_b) * exp(m_b - cum_j),
    with m_x the cumsum at sub-chunk x's end and a' = a - 1: every
    exponent is <= 0 and the contraction over channels is a product.
    Diagonal blocks use the direct form at (sc, sc, hd)."""
    b_, _, h, hd = rj.shape
    nsc = c // sc

    def split(x):
        return x.reshape(b_, nsc, sc, h, hd)

    cum_s, ecum_s = split(cum), split(ecum)
    r_s, k_s, v_s = split(rj), split(kj), split(vj)
    m = cum_s[:, :, -1]                                      # (b,nsc,h,hd)
    m_prev = torch.cat([torch.zeros_like(m[:, :1]), m[:, :-1]], dim=1)
    ra = r_s * torch.exp(ecum_s - m_prev[:, :, None])
    kb = k_s * torch.exp(m[:, :, None] - cum_s)
    outs = []
    for a in range(nsc):
        o_a = torch.zeros(b_, sc, h, hd, dtype=rj.dtype, device=rj.device)
        for b in range(a):
            gap = torch.exp(m_prev[:, a] - m[:, b])          # (b_,h,hd)
            att = torch.einsum("bchk,bdhk->bcdh", ra[:, a],
                               kb[:, b] * gap[:, None])
            o_a = o_a + torch.einsum("bcdh,bdhv->bchv", att, v_s[:, b])
        att_d = torch.einsum("bchk,bdhk,bcdhk->bcdh", r_s[:, a], k_s[:, a],
                             _decay_weights(ecum_s[:, a], cum_s[:, a]))
        o_a = o_a + torch.einsum("bcdh,bdhv->bchv", att_d, v_s[:, a])
        outs.append(o_a)
    return torch.cat(outs, dim=1)


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lw: torch.Tensor, u: torch.Tensor, *, chunk: int,
                state: Optional[torch.Tensor] = None, intra: str = "direct",
                subchunk: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV recurrence.

    r, k, v: (B, S, H, hd) compute dtype; lw: (B, S, H, hd) fp32 log-decay
    (<= 0); u: (H, hd) bonus; ``state``: an optional (B, H, hd, hd) fp32
    initial state.  Returns (o (B, S, H, hd) fp32, final state
    (B, H, hd, hd) fp32).  ``intra`` selects the intra-chunk form,
    "direct" or "matmul" (sub-chunks of ``subchunk`` rows); both compute
    the same function.  The chunk loop is a Python loop (JAX's scan)."""
    if intra not in ("direct", "matmul"):
        raise ValueError(f"wkv_chunked: intra must be 'direct' or "
                         f"'matmul', got {intra!r}")
    b, sq, h, hd = r.shape
    c = chunk_len(sq, chunk)
    sc = min(subchunk, c)
    use_matmul = intra == "matmul" and c % sc == 0 and c > sc
    f32 = torch.float32
    if state is None:
        state = torch.zeros(b, h, hd, hd, dtype=f32, device=r.device)
    uf = u.to(f32)
    S = state
    outs = []
    for s0 in range(0, sq, c):
        rj, kj, vj = (x[:, s0:s0 + c].to(f32) for x in (r, k, v))
        lwj = lw[:, s0:s0 + c].to(f32)
        cum = torch.cumsum(lwj, dim=1)           # inclusive, (b,c,h,hd)
        ecum = cum - lwj                         # exclusive
        total = cum[:, -1]                       # (b,h,hd)
        o_inter = torch.einsum("bchk,bhkv->bchv", rj * torch.exp(ecum), S)
        if use_matmul:
            o_intra = _intra_matmul(rj, kj, vj, cum, ecum, c, sc)
        else:
            o_intra = _intra_direct(rj, kj, vj, cum, ecum)
        diag = torch.einsum("bchk,hk,bchk->bch", rj, uf, kj)
        k_dec = kj * torch.exp(total[:, None] - cum)
        S = torch.exp(total)[..., None] * S \
            + torch.einsum("bchk,bchv->bhkv", k_dec, vj)
        outs.append(o_inter + o_intra + diag[..., None] * vj)
    return torch.cat(outs, dim=1), S
