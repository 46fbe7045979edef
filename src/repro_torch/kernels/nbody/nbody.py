"""All-pairs softened gravitational acceleration (paper §6.3): the CUDA
kernel's wrapper and its plain PyTorch version.

Replaces ``repro/kernels/nbody/nbody.py::nbody_pallas``; the kernel is
``kernels/csrc/nbody.cu``; the plain version is the port of
``repro/kernels/nbody/ref.py::nbody_accel_ref``.

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
    """Launch ``repro_nbody`` (one target per thread, source tiles through
    shared memory): pos (3, N) and mass (N,) contiguous fp32 on one CUDA
    device, any N.  Returns a new (3, N) fp32 tensor; raises on anything
    the kernel does not take."""
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
    rc = cuda.library().repro_nbody(pos.data_ptr(), mass.data_ptr(),
                                    out.data_ptr(), n, eps * eps,
                                    cuda.stream_of(pos))
    cuda.check(rc, "nbody_accel")
    nbody_accel_cuda.launches += 1
    return out


nbody_accel_cuda.launches = 0
