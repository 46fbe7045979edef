"""All-pairs softened gravitational acceleration (paper §6.3): the CUDA
kernel's wrapper and its plain PyTorch version.

Replaces ``repro/kernels/nbody/nbody.py::nbody_pallas``; the kernel is
``kernels/csrc/nbody.cu`` (several targets a thread, the source range
split across blocks by ``nbody_split_plan``, the splits' partial sums
added in rank order by a second kernel); the plain version is the port
of ``repro/kernels/nbody/ref.py::nbody_accel_ref``.

SoA layout: pos (3, N) fp32, mass (N,) fp32; returns a (3, N) fp32 with
a_i = sum_j m_j (r_j - r_i) / (|r_j - r_i|^2 + eps^2)^1.5.
"""
from __future__ import annotations

import torch

from .. import cuda

# Plummer softening length (repro/kernels/nbody/ref.py)
SOFTENING = 1e-3
# elements of the plain version's largest (3, targets, N) temporary
_PLAIN_BLOCK_ELEMS = 1 << 27
# csrc/nbody.cu: targets a thread (TPT), a block of 128 threads, and
# sources a tile
TARGETS_PER_THREAD = 2
TARGETS_PER_BLOCK = 128 * TARGETS_PER_THREAD
SOURCE_TILE = 256
# the split plan aims at this many blocks (64 an SM of the H100's 132:
# short blocks even out the last wave) with splits of at least
# MIN_SPLIT_TILES tiles (a block's fixed cost against its pairs);
# tools/kernel_variants.py measures every split
PLAN_BLOCKS = 8448
MIN_SPLIT_TILES = 2


def nbody_split_plan(n: int) -> tuple:
    """(splits, sources a split) for N bodies, from N alone: enough
    splits of the source range that target blocks x splits reach about
    ``PLAN_BLOCKS``, each a whole number of ``SOURCE_TILE`` tiles and at
    least ``MIN_SPLIT_TILES`` of them; split s takes sources
    [s * per, min(N, (s + 1) * per)), so every source lies in exactly
    one."""
    if n < 1:
        return 1, max(n, 1)
    target_blocks = -(-n // TARGETS_PER_BLOCK)
    tiles = -(-n // SOURCE_TILE)
    splits = max(1, min(-(-PLAN_BLOCKS // target_blocks),
                        tiles // MIN_SPLIT_TILES))
    per = -(-tiles // splits) * SOURCE_TILE
    return -(-n // per), per


def nbody_accel_plain(pos: torch.Tensor, mass: torch.Tensor, *,
                      eps: float = SOFTENING) -> torch.Tensor:
    """The oracle's arithmetic, one block of targets at a time: a dense
    (3, N, N) tensor at N = 65536 would be 51 GB."""
    n = pos.shape[1]
    out = torch.empty(3, n, dtype=torch.float32, device=pos.device)
    bt = max(1, _PLAIN_BLOCK_ELEMS // (3 * max(n, 1)))
    for t0 in range(0, n, bt):
        diff = pos[:, None, :] - pos[:, t0:t0 + bt, None]   # r_j - r_i
        r2 = torch.sum(diff * diff, dim=0) + eps * eps
        w = torch.rsqrt(r2) / r2 * mass[None, :]
        out[:, t0:t0 + bt] = torch.einsum("cij,ij->ci", diff, w)
    return out


def nbody_accel_cuda(pos: torch.Tensor, mass: torch.Tensor, *,
                     eps: float = SOFTENING) -> torch.Tensor:
    """Launch ``repro_nbody`` (2 targets a thread, source tiles through
    shared memory, the sources split by ``nbody_split_plan`` into an fp32
    scratch that a second kernel sums in rank order; one launch counted a
    call): pos (3, N) and mass (N,) contiguous fp32 on one CUDA device,
    any N.  Returns a new (3, N) fp32 tensor; raises on anything the
    kernel does not take."""
    cuda.require_cuda("nbody_accel", pos, mass)
    if pos.dim() != 2 or pos.shape[0] != 3 or mass.shape != pos.shape[1:]:
        raise ValueError(f"nbody_accel: want pos (3, N) and mass (N,), got "
                         f"{tuple(pos.shape)} and {tuple(mass.shape)}")
    if pos.dtype != torch.float32 or mass.dtype != torch.float32:
        raise TypeError(f"nbody_accel: want float32, got {pos.dtype} and "
                        f"{mass.dtype}")
    (n,) = cuda.c_ints("nbody_accel", mass.shape[0])
    out = torch.empty(3, n, dtype=torch.float32, device=pos.device)
    if n == 0:
        return out
    splits, per = nbody_split_plan(n)
    part = (torch.empty(splits, 3, n, dtype=torch.float32,
                        device=pos.device) if splits > 1 else None)
    rc = cuda.library().repro_nbody(
        pos.data_ptr(), mass.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, n, splits, per,
        eps * eps, cuda.stream_of(pos))
    cuda.check(rc, "nbody_accel")
    nbody_accel_cuda.launches += 1
    return out


nbody_accel_cuda.launches = 0
