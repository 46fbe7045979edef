"""TransformConfig: the staged optimization levels of the paper's §6 --
the port of ``repro/core/plan.py`` (same fields, names and sweep order).

Each application example in the paper is optimized in stages; the ladder
is kept so that the library's public ops take a ``level=`` and the tuner
can sweep it:

  T0 naive        -- straight loop nest, no transformations
  T1 pipelined    -- pipeline-enabling transforms applied (§2)
  T2 vectorized   -- + vectorization (§3.1) and memory access
                     extraction/oversubscription (§4.1/4.2)
  T3 replicated   -- + replication/streaming/tiling (§3.2-3.4) and
                     striping (§4.3): the full spatial design

On the card the public ops run their plain PyTorch version at T0 and T1
and their hand-written kernel at T2 and T3 (the kernels are written at
T3: a T2 call takes the same kernel).  The knobs read, for the H100:

* ``accum_lanes`` (§2.1) -- independent accumulators a reduction keeps:
  the fp32 ``wgmma`` / FMA accumulator fragments of a tile, and the
  split-K ranks whose partials are summed in rank order;
* ``vector_width`` (§3.1) -- elements a warp moves in one instruction
  (16-byte vectors over 32 lanes);
* ``replication`` (§3.2) -- blocks that share one output tile (the split
  plans) or tensor-parallel ranks;
* ``stream_stages`` (§3.3) -- pipeline-parallel stages;
* ``vmem_fraction`` (§3.4) -- the share of a block's 227 KB of shared
  memory the ``TilePlanner`` may fill;
* ``prefetch_depth`` (§4.2) -- stages of a ``cp.async`` / TMA ring (the
  data pipeline's batches ahead on the host);
* ``stripe_ways`` (§4.3) -- shards of the weights and moments;
* ``dtypes``, ``int8_moments``, ``int8_grad_wire`` (§4.4) -- type
  demotion.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Iterator, Optional, Sequence

from .memory import BF16_POLICY, DtypePolicy


class Level(enum.IntEnum):
    T0_NAIVE = 0
    T1_PIPELINED = 1
    T2_VECTORIZED = 2
    T3_REPLICATED = 3


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    level: Level = Level.T3_REPLICATED
    # §2.1 accumulation interleaving: number of concurrent accumulators
    accum_lanes: int = 8
    # §3.1 vectorization width (elements per cycle target)
    vector_width: int = 128
    # §3.2 replication factor (blocks a tile / TP ways)
    replication: int = 1
    # §3.3 streaming dataflow stages (pipeline-parallel stages)
    stream_stages: int = 1
    # §3.4 tiling: the share of a block's shared memory the TilePlanner
    # may use
    vmem_fraction: float = 0.75
    # §4.2 oversubscription: prefetch depth (copy ring stages, batches)
    prefetch_depth: int = 2
    # §4.3 striping ways (shards of the weights and moments)
    stripe_ways: int = 1
    # §4.4 type demotion
    dtypes: DtypePolicy = BF16_POLICY
    int8_moments: bool = False
    int8_grad_wire: bool = False

    def at_level(self, level: Level) -> "TransformConfig":
        return dataclasses.replace(self, level=level)


# Default per-knob candidate sets of a sweep over the transformation
# knobs, as enumerable axes rather than the single point each kernel
# hard-codes.
TUNE_LEVELS: Sequence[Level] = (
    Level.T1_PIPELINED, Level.T2_VECTORIZED, Level.T3_REPLICATED)
TUNE_VECTOR_WIDTHS: Sequence[int] = (128, 256, 512)
TUNE_ACCUM_LANES: Sequence[int] = (4, 8, 16)
TUNE_PREFETCH_DEPTHS: Sequence[int] = (1, 2)
TUNE_VMEM_FRACTIONS: Sequence[float] = (0.5, 0.75, 0.9)


def enumerate_configs(
        base: Optional[TransformConfig] = None, *,
        levels: Sequence[Level] = TUNE_LEVELS,
        vector_widths: Sequence[int] = (None,),
        accum_lanes: Sequence[int] = (None,),
        prefetch_depths: Sequence[int] = (None,),
        vmem_fractions: Sequence[float] = (None,),
        max_configs: Optional[int] = None) -> Iterator[TransformConfig]:
    """Cartesian sweep over the transformation knobs, anchored at ``base``.

    ``None`` in a candidate list means "keep the base value", so callers
    sweep only the axes they name.  Deterministic order
    (``itertools.product`` over the given sequences).
    """
    base = base or TransformConfig()
    n = 0
    for lvl, vw, al, pf, vf in itertools.product(
            levels, vector_widths, accum_lanes, prefetch_depths,
            vmem_fractions):
        cfg = dataclasses.replace(
            base,
            level=lvl,
            vector_width=base.vector_width if vw is None else vw,
            accum_lanes=base.accum_lanes if al is None else al,
            prefetch_depth=base.prefetch_depth if pf is None else pf,
            vmem_fraction=base.vmem_fraction if vf is None else vf)
        yield cfg
        n += 1
        if max_configs is not None and n >= max_configs:
            return


PAPER_STAGES = {
    Level.T0_NAIVE: "naive loop nest",
    Level.T1_PIPELINED: "pipeline-enabled (§2)",
    Level.T2_VECTORIZED: "+ vectorized & memory-extracted (§3.1, §4.1-4.2)",
    Level.T3_REPLICATED: "+ replicated/streamed/tiled (§3.2-3.4, §4.3)",
}
