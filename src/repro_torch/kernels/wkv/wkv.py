"""RWKV6 chunked WKV: the CUDA kernels' wrappers (the forward and its
backward) and their plain PyTorch versions.

Replaces ``repro/kernels/wkv/wkv.py::wkv_pallas``; the kernel is
``kernels/csrc/wkv.cu``, one per route (``wkv_route``: ``mma``, the TPU
kernel's sub-chunked form on the tensor cores, at head widths 64 and 128
with sub-chunks of 8 to 64 rows; ``simt``, the direct form on the FMA
units, for every other shape); the plain version is ``models/rwkv.py``'s
``wkv_chunked`` in its direct form, the oracle
``repro/kernels/wkv/ref.py`` names.

Layout, as the JAX op's (``repro/kernels/wkv/ops.py``): r, k, v
(B, S, H, hd) fp32 or bf16, one type for all three; lw (B, S, H, hd) fp32
log-decays (<= 0); u (H, hd) fp32.  Returns o (B, S, H, hd) fp32.  The
chunk length is ``models.rwkv.chunk_len(S, chunk)``, the sub-chunk length
``subchunk_len(c, subchunk)``.

The backward (``wkv_bwd_cuda``, ``kernels/csrc/wkv_bwd.cu``) replaces no
TPU kernel: the JAX package differentiates ``wkv_chunked`` by autodiff
(``repro/models/rwkv.py:171``), and its plain version here is the
autograd of ``wkv_chunked`` (``wkv_bwd_plain``); ``wkv_bwd_chunked``
writes the kernel's chunked decomposition in plain tensor code.
"""
from __future__ import annotations

import torch

from .. import cuda
# the module, not its names: models.rwkv imports dispatch, which imports
# this module, so its functions are looked up when called
from ...models import rwkv

# csrc/wkv.cu's tile edges: row pieces and value-column blocks of at most
# 64, key-side channels staged 64 at a time
TILE = 64
ROUTES = ("mma", "simt")
# the mma route's head widths (16-column tiles of the state over 8 warps,
# pairs of 8-column tiles a warp) and piece lengths (rows walked at a
# time, whole sub-chunks)
MMA_HEAD_DIMS = (64, 128)
MMA_PIECES = (64, 32, 16)


# csrc/wkv_bwd.cu's head widths (instantiated kernels)
BWD_HEAD_DIMS = (32, 64, 128)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous tensor whose data starts on a 16-byte
    boundary (a copy only where ``t`` is not one already)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def wkv_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lw: torch.Tensor, u: torch.Tensor, *,
              chunk: int = 64, intra: str = "direct",
              subchunk: int = 16) -> torch.Tensor:
    """The chunked WKV from a zero state (``models.rwkv.wkv_chunked``,
    its final state dropped): o (B, S, H, hd) fp32 (fp64 for fp64
    inputs)."""
    return rwkv.wkv_chunked(r, k, v, lw, u, chunk=chunk, intra=intra,
                            subchunk=subchunk)[0]


def smem_bytes(rows: int, cols: int, hd: int) -> int:
    """csrc/wkv.cu's shared memory per block for row pieces of ``rows``
    and blocks of ``cols`` value columns."""
    p = min(hd, TILE)
    return 4 * (3 * rows * (p + 1) + rows * (cols + 1) + rows * (rows + 1)
                + hd * (cols + 1) + hd)


def wkv_tiles(c: int, hd: int) -> tuple:
    """(rows, cols) of csrc/wkv.cu's grid for chunk ``c`` and head width
    ``hd``: row pieces of min(c, 64) rows, and value-column blocks of
    min(hd, 64) columns, halved while the state's columns (hd x cols)
    and the tiles do not fit a block's shared memory (from hd = 566 on).
    Raises only past hd = 13,781, where even one column of the state and
    the tiles exceed it (the TPU kernel would need an hd^2 state in VMEM
    of over 600 MB there)."""
    rows, cols = min(c, TILE), min(hd, TILE)
    while cols > 1 and smem_bytes(rows, cols, hd) > cuda.MAX_SMEM_BYTES:
        cols = (cols + 1) // 2
    if smem_bytes(rows, cols, hd) > cuda.MAX_SMEM_BYTES:
        raise ValueError(f"wkv: head width {hd} leaves no room for one "
                         f"column of the state in shared memory")
    return rows, cols


def subchunk_len(c: int, subchunk: int) -> int:
    """The sub-chunk length of a chunk of ``c`` rows:
    ``min(subchunk, c)``, halved until it divides ``c``, as
    ``repro/kernels/wkv/wkv.py:106-111`` resolves it."""
    if subchunk < 1:
        raise ValueError(f"wkv: subchunk {subchunk} < 1")
    sc = min(subchunk, c)
    while sc > 1 and c % sc:
        sc //= 2
    return sc


def wkv_piece(c: int, sc: int) -> int:
    """Rows the mma route walks at a time: the largest of 64, 32 and 16
    that divides the chunk and is a whole number of sub-chunks; 0 if
    none is."""
    return next((p for p in MMA_PIECES if c % p == 0 and p % sc == 0), 0)


def wkv_route(c: int, sc: int, hd: int, dtype: torch.dtype) -> str:
    """``mma`` where the tensor-core kernel takes the shape: hd 64 or 128,
    sub-chunks a multiple of 8 rows inside a piece of 64, 32 or 16
    rows (``wkv_piece``), fp32 or bf16 inputs but not fp32 at hd 128,
    whose block does not fit shared memory (csrc/wkv.cu builds no such
    kernel); ``simt`` otherwise.  By shape alone, never by data."""
    if (hd in MMA_HEAD_DIMS and sc % 8 == 0 and wkv_piece(c, sc)
            and dtype in cuda.DTYPE_CODES
            and not (hd == 128 and dtype == torch.float32)):
        return "mma"
    return "simt"


def wkv_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             lw: torch.Tensor, u: torch.Tensor, *, chunk: int = 64,
             subchunk: int = 16) -> torch.Tensor:
    """Launch the route ``wkv_route`` names: ``repro_wkv_mma`` (one block
    of 8 warps per (batch, head), the sub-chunked form on the tensor
    cores, the state in registers) or ``repro_wkv`` (one block per
    (batch, head, block of value columns), the direct form with its
    columns of the state in shared memory; tiles from ``wkv_tiles``):
    inputs contiguous on one CUDA device, 16-byte aligned on the mma
    route.  Counts the launch in ``.launches`` and on its route in
    ``.routes``.  Returns a new fp32 (B, S, H, hd) tensor; raises on
    anything the kernel does not take."""
    cuda.require_cuda("wkv", r, k, v, lw, u)
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, lw)):
        raise ValueError(f"wkv: want equal (B, S, H, hd) shapes for r, k, "
                         f"v and lw, got "
                         f"{[tuple(t.shape) for t in (r, k, v, lw)]}")
    b, s, h, hd = r.shape
    if u.shape != (h, hd):
        raise ValueError(f"wkv: want u of shape {(h, hd)}, got "
                         f"{tuple(u.shape)}")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv: r, k and v must share one dtype, got "
                        f"{[t.dtype for t in (r, k, v)]}")
    if lw.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"wkv: lw and u must be float32, got {lw.dtype} "
                        f"and {u.dtype}")
    if chunk < 1:
        raise ValueError(f"wkv: chunk {chunk} < 1")
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    if out.numel() == 0:
        return out
    c = rwkv.chunk_len(s, chunk)
    sc = subchunk_len(c, subchunk)
    route = wkv_route(c, sc, hd, r.dtype)
    ptrs = [t.data_ptr() for t in (r, k, v, lw, u, out)]
    if route == "mma":
        if any(p % 16 for p in ptrs):
            raise ValueError("wkv: the mma route needs 16-byte aligned "
                             "inputs (cp.async copies)")
        rc = cuda.library().repro_wkv_mma(
            *ptrs, *cuda.c_ints("wkv", b, s, h, hd, sc, wkv_piece(c, sc)),
            cuda.dtype_code(r), cuda.stream_of(r))
    else:
        rows, cols = wkv_tiles(c, hd)
        rc = cuda.library().repro_wkv(
            *ptrs, *cuda.c_ints("wkv", b, s, h, hd, c, rows, cols),
            cuda.dtype_code(r), cuda.stream_of(r))
    cuda.check(rc, "wkv")
    wkv_cuda.launches += 1
    wkv_cuda.routes[route] += 1
    return out


wkv_cuda.launches = 0
wkv_cuda.routes = {route: 0 for route in ROUTES}


def wkv_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lw: torch.Tensor, u: torch.Tensor, do: torch.Tensor, *,
                  chunk: int = 64, intra: str = "direct",
                  subchunk: int = 16) -> tuple:
    """The gradients (dr, dk, dv, dlw, du) of sum(o * do) where o =
    ``wkv_chunked(r, k, v, lw, u, ...)`` from a zero state (its final
    state unused): the autograd of the chunked form, recomputed here in
    fp32 (fp64 for fp64 inputs), the type of every gradient."""
    acc = torch.promote_types(r.dtype, torch.float32)
    with torch.enable_grad():
        leaves = [t.detach().to(acc).requires_grad_(True)
                  for t in (r, k, v, lw, u)]
        o = wkv_plain(*leaves, chunk=chunk, intra=intra,
                      subchunk=subchunk)
        return torch.autograd.grad(o, leaves, do.to(acc))


def _excl_prefix(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum of the entries before each one along ``dim`` (0 at the first),
    formed without subtracting anything."""
    head = torch.zeros_like(x.narrow(dim, 0, 1))
    return torch.cat([head, x.narrow(dim, 0, x.shape[dim] - 1)
                      .cumsum(dim)], dim)


def _excl_suffix(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum of the entries after each one along ``dim`` (0 at the last)."""
    return _excl_prefix(x.flip(dim), dim).flip(dim)


def wkv_bwd_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lw: torch.Tensor, u: torch.Tensor, do: torch.Tensor, *,
                    chunk: int = 64, subchunk: int = 16) -> tuple:
    """The WKV gradient (dr, dk, dv, dlw, du) of ``wkv_bwd_plain`` in the
    chunked form ``csrc/wkv_bwd.cu`` computes, as plain tensor code: the
    oracle of the kernel's decomposition (the model's CPU route stays
    ``wkv_bwd_plain``).  fp32 (fp64 for fp64 inputs); no intra-chunk
    weight is clamped, so it is the exact recurrence's gradient.

    For a chunk j of c rows (cum, ecum the inclusive and exclusive cumsums
    of lw over it, total its sum; rows past S zero, lw 0):

    * states: ``Sin_{j+1} = e^total Sin_j + (k e^(total - cum))^T v`` and
      state gradients ``Gout_{j-1} = e^total Gout_j + (r e^ecum)^T do``,
      each chunk's product taken apart and the two scans run after;
    * inter-chunk terms: dr += e^ecum (do Sin^T), dk += e^(total - cum)
      (v Gout^T), dv += (k e^(total - cum)) Gout;
    * intra-chunk terms from M = do v^T over sub-chunks of ``subchunk``
      rows, the decay between sub-chunks a > b factored through the
      sub-chunk ends (m_a the cumsum at a's last row): products off the
      diagonal sub-blocks, the direct form on them; the bonus u;
    * dlw_t = sum over s < t < tau of r_tau k_s e^(ecum_tau - cum_s)
      (v_s . do_tau), with the boundary state or gradient for s or tau
      outside the chunk.  Every such term carries w_t; the sum is split by
      where s and tau lie (before the chunk, an earlier sub-chunk, t's
      sub-chunk before t, ...; after t likewise) into a rowsum of
      Gout * Sin, whole sub-block sums, sums of r * dr' after t and of
      k * dk' before t in t's sub-chunk, and the direct form inside it.
      Nothing is a difference of sums that hold a weight-1 pair (tau =
      s + 1), as dlw = suffix(r dr) - suffix(k dk) would be: under strong
      decay (w_t ~ e^-20) that form leaves rounding noise of O(1) sums."""
    acc = torch.promote_types(r.dtype, torch.float32)
    b, s, h, hd = r.shape
    c = chunk
    sc = subchunk_len(c, subchunk)
    nc, nsc = -(-s // c), c // sc
    pad = nc * c - s

    def blocks(x):      # (b, s, h, hd) -> (b, h, nc, c, hd), zero past s
        x = torch.nn.functional.pad(x.to(acc), (0, 0, 0, 0, 0, pad))
        return x.reshape(b, nc, c, h, hd).permute(0, 3, 1, 2, 4)

    r_, k_, v_, lw_, do_ = map(blocks, (r, k, v, lw, do))
    u_ = u.to(acc)[None, :, None, None, :]
    cum = lw_.cumsum(3)
    ecum = _excl_prefix(lw_, 3)
    total = cum[..., -1, :]
    et = total.exp()

    # chunk states and state gradients
    kd = k_ * (total[..., None, :] - cum).exp()
    ds = kd.transpose(-1, -2) @ v_
    dg = (r_ * ecum.exp()).transpose(-1, -2) @ do_
    sin, gout = [], [None] * nc
    run = torch.zeros_like(ds[:, :, 0])
    for j in range(nc):
        sin.append(run)
        run = et[:, :, j, :, None] * run + ds[:, :, j]
    run = torch.zeros_like(run)
    for j in reversed(range(nc)):
        gout[j] = run
        run = et[:, :, j, :, None] * run + dg[:, :, j]
    sin, gout = torch.stack(sin, 2), torch.stack(gout, 2)

    dr_inter = ecum.exp() * (do_ @ sin.transpose(-1, -2))
    dk_inter = ((total[..., None, :] - cum).exp()
                * (v_ @ gout.transpose(-1, -2)))
    dv = kd @ gout
    er = et * (gout * sin).sum(-1)

    # sub-chunks: rows a * sc .. of each chunk
    def sub(x, a):
        return x[..., a * sc:(a + 1) * sc, :]

    m = cum[..., sc - 1::sc, :]                 # (b, h, nc, nsc, hd)
    m_prev = torch.cat([torch.zeros_like(m[..., :1, :]), m[..., :-1, :]], -2)
    mm = do_ @ v_.transpose(-1, -2)             # M[tau, s] = do_tau . v_s
    bonus = mm.diagonal(dim1=-2, dim2=-1)       # v_t . do_t
    att = torch.zeros_like(mm)                  # the forward's A, lower
    ra = [sub(r_, a) * (sub(ecum, a) - m_prev[..., a, None, :]).exp()
          for a in range(nsc)]
    kb = [sub(k_, a) * (m[..., a, None, :] - sub(cum, a)).exp()
          for a in range(nsc)]
    dr_off = [torch.zeros_like(x) for x in ra]
    dk_off = [torch.zeros_like(x) for x in ra]
    blk = {}                                    # B[a, b]: whole sub-blocks
    for a in range(nsc):
        for bb in range(a):
            gap = (m_prev[..., a, :] - m[..., bb, :]).exp()[..., None, :]
            mab = mm[..., a * sc:(a + 1) * sc, bb * sc:(bb + 1) * sc]
            scr = (sub(ecum, a) - m_prev[..., a, None, :]).exp()
            part = scr * (mab @ (kb[bb] * gap))
            dr_off[a] = dr_off[a] + part
            if a >= bb + 2:
                blk[a, bb] = (sub(r_, a) * part).sum(-2)
            sck = (m[..., bb, None, :] - sub(cum, bb)).exp()
            dk_off[bb] = dk_off[bb] + sck * (mab.transpose(-1, -2)
                                             @ (ra[a] * gap))
            att[..., a * sc:(a + 1) * sc, bb * sc:(bb + 1) * sc] = (
                (ra[a] * gap) @ kb[bb].transpose(-1, -2))

    # the diagonal sub-blocks in the direct form: E[tau, s, i] =
    # e^(ecum_tau - cum_s) for s < tau
    idx = torch.arange(sc, device=r_.device)
    lower = idx[:, None] > idx[None, :]
    between = ((idx[None, None, :] < idx[:, None, None])          # s < t
               & (idx[:, None, None] < idx[None, :, None]))       # t < tau
    between = between.to(acc)
    dr, dk, dlw = [], [], []
    ri = [(sub(r_, a) * sub(dr_inter, a)).sum(-2) for a in range(nsc)]
    ki = [(sub(k_, a) * sub(dk_inter, a)).sum(-2) for a in range(nsc)]
    for a in range(nsc):
        rr, kk = sub(r_, a), sub(k_, a)
        expo = sub(ecum, a)[..., :, None, :] - sub(cum, a)[..., None, :, :]
        e = torch.where(lower[..., None], expo,
                        torch.full_like(expo, -torch.inf)).exp()
        mab = mm[..., a * sc:(a + 1) * sc, a * sc:(a + 1) * sc]
        pp = e * mab[..., None]
        att[..., a * sc:(a + 1) * sc, a * sc:(a + 1) * sc] = (
            (rr[..., :, None, :] * kk[..., None, :, :] * e).sum(-1)
            + torch.diag_embed((rr * u_ * kk).sum(-1)))
        bon = sub(bonus[..., None], a)
        dr.append(sub(dr_inter, a) + dr_off[a] + (pp * kk[..., None, :, :])
                  .sum(-2) + u_ * kk * bon)
        dk.append(sub(dk_inter, a) + dk_off[a] + (pp * rr[..., :, None, :])
                  .sum(-3) + u_ * rr * bon)
        full = pp * rr[..., :, None, :] * kk[..., None, :, :]
        q = torch.einsum("tqs,...qsi->...ti", between, full)
        xs = rr * (sub(dr_inter, a) + dr_off[a])
        ys = kk * (sub(dk_inter, a) + dk_off[a])
        cross = er + sum((ri[x_] for x_ in range(a + 1, nsc)),
                         torch.zeros_like(er))
        cross = cross + sum((ki[y_] for y_ in range(a)), torch.zeros_like(er))
        cross = cross + sum((blk[a2, b2] for (a2, b2) in blk
                             if a2 > a > b2), torch.zeros_like(er))
        dlw.append(q + _excl_suffix(xs, -2) + _excl_prefix(ys, -2)
                   + cross[..., None, :])
    dv = dv + att.transpose(-1, -2) @ do_
    du = (r_ * k_ * bonus[..., None]).sum((0, 2, 3))

    def rows(parts):    # (b, h, nc, c, hd) pieces -> (b, s, h, hd)
        x = torch.cat(parts, -2) if isinstance(parts, list) else parts
        return x.permute(0, 2, 3, 1, 4).reshape(b, nc * c, h, hd)[:, :s]

    return rows(dr), rows(dk), rows(dv), rows(dlw), du


def bwd_chunk(hd: int) -> int:
    """Rows of csrc/wkv_bwd.cu's chunks: 64, or 32 at hd 128, where nine
    (64, 132) fp32 tiles would not fit a block's shared memory."""
    return 64 if hd <= 64 else 32


def wkv_bwd_scratch_floats(b: int, s: int, h: int, hd: int) -> int:
    """csrc/wkv_bwd.cu's scratch: for every (batch, head, chunk) the
    (hd, hd) state before the chunk and state gradient after it, the
    chunk's decay total and its partial du."""
    chunks = b * h * -(-s // bwd_chunk(hd))
    return chunks * (2 * hd * hd + 2 * hd)


def wkv_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lw: torch.Tensor, u: torch.Tensor,
                 do: torch.Tensor) -> tuple:
    """Launch ``repro_wkv_bwd``: the gradients (dr, dk, dv, dlw (B, S, H,
    hd), du (H, hd)), new fp32 tensors, of sum(o * do) for o the WKV
    recurrence from a zero state, in the chunked form on the tensor cores
    (``wkv_bwd_chunked`` is its plain oracle; four launches, counted as
    one).  r, k, v (B, S, H, hd) one float type; lw, do (B, S, H, hd) and
    u (H, hd) fp32; all contiguous on one CUDA device and 16-byte aligned;
    hd in ``BWD_HEAD_DIMS``; any S.  The kernel computes the exact
    recurrence's gradient; the chunked forward's e^-60 clamp moves it by
    less than e^-60 of a term.  Counts the launch in ``.launches`` and on
    its route, ``mma``, in ``.routes``; raises on anything the kernel does
    not take."""
    cuda.require_cuda("wkv_bwd", r, k, v, lw, u, do)
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, lw, do)):
        raise ValueError(f"wkv_bwd: want equal (B, S, H, hd) shapes for r, "
                         f"k, v, lw and do, got "
                         f"{[tuple(t.shape) for t in (r, k, v, lw, do)]}")
    b, s, h, hd = r.shape
    if u.shape != (h, hd):
        raise ValueError(f"wkv_bwd: want u of shape {(h, hd)}, got "
                         f"{tuple(u.shape)}")
    if hd not in BWD_HEAD_DIMS:
        raise ValueError(f"wkv_bwd: head width {hd} is not one of "
                         f"{BWD_HEAD_DIMS}")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv_bwd: r, k and v must share one dtype, got "
                        f"{[t.dtype for t in (r, k, v)]}")
    if any(t.dtype != torch.float32 for t in (lw, u, do)):
        raise TypeError(f"wkv_bwd: lw, u and do must be float32, got "
                        f"{[t.dtype for t in (lw, u, do)]}")
    if any(t.data_ptr() % 16 for t in (r, k, v, lw, u, do)):
        raise ValueError("wkv_bwd: inputs must start on a 16-byte boundary "
                         "(16-byte row loads)")
    grads = [torch.empty(r.shape, dtype=torch.float32, device=r.device)
             for _ in range(4)]
    du = torch.zeros((h, hd), dtype=torch.float32, device=r.device)
    if r.numel() == 0:
        return (*grads, du)
    scratch = torch.empty(wkv_bwd_scratch_floats(b, s, h, hd),
                          dtype=torch.float32, device=r.device)
    rc = cuda.library().repro_wkv_bwd(
        *(t.data_ptr() for t in (r, k, v, lw, u, do, *grads, du, scratch)),
        *cuda.c_ints("wkv_bwd", b, s, h, hd), cuda.dtype_code(r),
        cuda.stream_of(r))
    cuda.check(rc, "wkv_bwd")
    wkv_bwd_cuda.launches += 1
    wkv_bwd_cuda.routes["mma"] += 1
    return (*grads, du)


wkv_bwd_cuda.launches = 0
wkv_bwd_cuda.routes = {"mma": 0}
