"""Scaling transformations (paper §3): vectorization, replication, tiling
-- the port of ``repro/core/scaling.py``.

On the card the "unrolled hardware" already exists (32-lane warps, the
tensor cores' 64-row ``wgmma`` tiles, 132 SMs); the transformation
becomes choosing shapes that keep it fed:

* vectorization §3.1  -> pad trailing dims to whole warps and fragments,
* replication  §3.2   -> reuse-fed parallelism: split K across blocks,
                         tensor/expert parallelism across cards,
* tiling       §3.4   -> ``TilePlanner``: solve tile shapes against the
                         shared memory a block may hold.

Every function takes a ``HardwareSpec``, as in the JAX package; the
planner's budget is the spec's shared memory a block.  The port's
kernels choose their own tiles (``csrc/*.cu``) and split plans
(``kernels/*``): nothing routes through the planner, which is kept for
napkin math and the examples.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from .model import H100_SXM, HardwareSpec


def round_up(x: int, to: int) -> int:
    return ((x + to - 1) // to) * to


def vector_pad(shape: Sequence[int], dtype_bytes: int = 4,
               hw: HardwareSpec = H100_SXM) -> Tuple[int, ...]:
    """Vectorization §3.1: the shape the card's vector units process.

    The trailing dim pads to a whole warp; the second-to-last to a whole
    fragment of rows scaled by the dtype's packing (bf16 packs 2x, int8
    4x) -- narrower types widen W, the paper's W_max = B/(f*S).
    """
    if not shape:
        return tuple(shape)
    packing = max(1, 4 // dtype_bytes)
    out = list(shape)
    out[-1] = round_up(out[-1], hw.warp)
    if len(out) >= 2:
        out[-2] = round_up(out[-2], hw.frag_rows * packing)
    return tuple(out)


def lane_utilization(shape: Sequence[int], dtype_bytes: int = 4,
                     hw: HardwareSpec = H100_SXM) -> float:
    """Fraction of lanes doing useful work for this (unpadded) shape."""
    padded = vector_pad(shape, dtype_bytes, hw)
    used = math.prod(shape) if shape else 1
    total = math.prod(padded) if padded else 1
    return used / total


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """A solved tiling for a matmul-like kernel (bm, bn, bk blocks)."""

    bm: int
    bn: int
    bk: int
    vmem_bytes: int          # working set incl. double buffering
    grid: Tuple[int, ...]    # (m/bm, n/bn, k/bk)
    flops_per_step: float
    hbm_bytes_per_step: float

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops_per_step / max(self.hbm_bytes_per_step, 1)


def _default_tiles(hw: HardwareSpec, n: int) -> Tuple[int, ...]:
    """The candidate tile edges: ``n`` doublings of the spec's mma edge
    (the JAX package's 128 ... 2048 on a 128-edge MXU)."""
    return tuple(hw.mma_dim << i for i in range(n))


class TilePlanner:
    """Tiling §3.4 as a solver: pick mma-aligned (bm, bn, bk) maximizing
    arithmetic intensity subject to the shared-memory budget.

    Working set per step for C[bm,bn] += A[bm,bk] @ B[bk,bn]: A-block +
    B-block (double-buffered: x2 for copy overlap, the paper's memory
    oversubscription §4.2) + C-accumulator (single, revisited).
    """

    def __init__(self, hw: HardwareSpec = H100_SXM, *,
                 vmem_fraction: float = 0.75,
                 double_buffer: bool = True):
        self.hw = hw
        self.budget = int(hw.smem_bytes * vmem_fraction)
        self.double_buffer = double_buffer

    def plan_from_tiles(self, m: int, n: int, k: int,
                        bm: int, bn: int, bk: int, *,
                        in_bytes: int = 2, acc_bytes: int = 4) -> TilePlan:
        """The TilePlan for explicit (bm, bn, bk) tiles, or raise if the
        working set exceeds the budget."""
        buf = 2 if self.double_buffer else 1
        vmem = (bm * bk + bk * bn) * in_bytes * buf + bm * bn * acc_bytes
        if vmem > self.budget:
            raise ValueError(
                f"tiles ({bm},{bn},{bk}) need {vmem} bytes of shared "
                f"memory, budget is {self.budget}")
        grid = (math.ceil(m / bm), math.ceil(n / bn), math.ceil(k / bk))
        flops = 2.0 * bm * bn * bk
        hbm = (bm * bk + bk * bn) * in_bytes
        return TilePlan(bm, bn, bk, vmem, grid, flops, hbm)

    def enumerate_matmul(self, m: int, n: int, k: int, *,
                         in_bytes: int = 2, acc_bytes: int = 4,
                         candidates: Optional[Sequence[int]] = None
                         ) -> List[TilePlan]:
        """All feasible aligned tilings within the budget, sorted
        best-first by the heuristic order, so ``[0]``, when non-empty, is
        what ``plan_matmul`` returns."""
        cands = list(candidates or _default_tiles(self.hw, 5))
        edge = self.hw.mma_dim
        plans: List[TilePlan] = []
        for bm in cands:
            # tiles must divide the (clamped) problem dim
            if bm > round_up(m, edge) or m % min(bm, m):
                continue
            for bn in cands:
                if bn > round_up(n, edge) or n % min(bn, n):
                    continue
                for bk in cands:
                    if bk > round_up(k, edge) or k % min(bk, k):
                        continue
                    try:
                        plans.append(self.plan_from_tiles(
                            m, n, k, bm, bn, bk,
                            in_bytes=in_bytes, acc_bytes=acc_bytes))
                    except ValueError:
                        continue
        plans.sort(key=_plan_order_key, reverse=True)
        return plans

    def plan_matmul(self, m: int, n: int, k: int, *,
                    in_bytes: int = 2, acc_bytes: int = 4,
                    candidates: Optional[Sequence[int]] = None) -> TilePlan:
        plans = self.enumerate_matmul(m, n, k, in_bytes=in_bytes,
                                      acc_bytes=acc_bytes,
                                      candidates=candidates)
        if not plans:
            raise ValueError(
                f"no aligned tiling of ({m},{n},{k}) fits {self.budget} "
                f"bytes of shared memory")
        return plans[0]

    def enumerate_stencil(self, rows: int, cols: int, halo: int = 1, *,
                          dtype_bytes: int = 4,
                          candidates: Optional[Sequence[int]] = None
                          ) -> List[Tuple[int, int]]:
        """All feasible (brows, bcols) stencil blocks within the budget,
        sorted best-first by halo waste (then larger blocks)."""
        cands = list(candidates or _default_tiles(self.hw, 6))
        feasible = []
        for br in cands:
            if br > round_up(rows, self.hw.frag_rows):
                continue
            for bc in cands:
                if bc > round_up(cols, self.hw.warp):
                    continue
                vmem = ((br + 2 * halo) * (bc + 2 * halo) + br * bc) \
                    * dtype_bytes * 2
                if vmem > self.budget:
                    continue
                waste = ((br + 2 * halo) * (bc + 2 * halo)) / (br * bc)
                feasible.append(((waste, -br * bc), (br, bc)))
        feasible.sort(key=lambda kv: kv[0])
        return [blk for _, blk in feasible]

    def plan_stencil(self, rows: int, cols: int, halo: int = 1, *,
                     dtype_bytes: int = 4,
                     candidates: Optional[Sequence[int]] = None
                     ) -> Tuple[int, int]:
        """Block shape for a 2-D stencil: (brows+2*halo, bcols+2*halo)
        input window + (brows, bcols) output, double-buffered.  The halo
        overlap is the paper's delay buffer."""
        blocks = self.enumerate_stencil(rows, cols, halo,
                                        dtype_bytes=dtype_bytes,
                                        candidates=candidates)
        if not blocks:
            raise ValueError("no stencil tiling fits the shared memory")
        return blocks[0]


def _plan_order_key(p: TilePlan):
    """Heuristic rank: higher arithmetic intensity, then fewer grid
    steps."""
    return (p.arithmetic_intensity, -math.prod(p.grid))


def replication_factor(reuse: int, unit_flops: float,
                       hw: HardwareSpec = H100_SXM) -> int:
    """§3.2 napkin math: with ``reuse`` uses per loaded element, how many
    parallel units can one HBM stream feed before compute saturates?
        P_max = reuse * machine_balance / (flops per element per unit)
    """
    balance = hw.peak_flops / hw.hbm_bw
    return max(1, int(reuse * balance / max(unit_flops, 1e-9)))
