"""Performance models: the paper's pipeline model (§1.2) and a roofline of
the card -- the port of ``repro/core/model.py``.

The paper quantifies pipelines with two numbers, latency ``L`` (depth in
cycles) and initiation interval ``I`` (cycles between accepted inputs),
and the total cycle count

    C = L + I * (N - 1)                                              (Eq. 1)

for N inputs.  Sequential pipelines compose as ``L = L0 + L1`` with
``I = max(I0, I1)``.  On the H100 the model reads as it does for any
pipelined loop: a kernel's main loop over K tiles is a pipeline whose N
is the number of tiles and whose I is ``max(tensor-core cycles, copy
cycles)`` a tile once the ``cp.async`` / TMA ring overlaps the copies;
fill and drain (the paper's §2.5 motivation) is ``L / C``.

``HardwareSpec`` describes one card; ``H100_SXM`` holds the published
peaks of the H100 SXM (NVIDIA's data sheet, dense rates) that
``chip_smoke.py``'s bounds use.  The port states no TPU rate.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict


@dataclass(frozen=True)
class PipelineModel:
    """The paper's Eq. 1: C = L + I * (N - 1)."""

    latency: float              # L [cycles]
    initiation_interval: float  # I [cycles]
    n: float                    # N [inputs]

    def cycles(self) -> float:
        return self.latency + self.initiation_interval * (self.n - 1)

    def seconds(self, clock_hz: float) -> float:
        return self.cycles() / clock_hz

    def fill_drain_overhead(self) -> float:
        """Fraction of cycles lost to fill/drain (what §2.5 eliminates)."""
        c = self.cycles()
        return self.latency / c if c else 0.0

    def then(self, other: "PipelineModel") -> "PipelineModel":
        """Sequential composition (paper: L adds, I is max)."""
        if self.n != other.n:
            raise ValueError("sequential pipelines must agree on N")
        return PipelineModel(
            latency=self.latency + other.latency,
            initiation_interval=max(self.initiation_interval,
                                    other.initiation_interval),
            n=self.n,
        )

    def folded(self, factor: float) -> "PipelineModel":
        """Scaling transformations (§3) fold the iteration space by
        ``factor``."""
        return PipelineModel(self.latency, self.initiation_interval,
                             math.ceil(self.n / factor))


@dataclass(frozen=True)
class HardwareSpec:
    """One card.  The JAX package's ``HardwareSpec`` describes a TPU chip;
    its fields map onto the card's as follows:

    * ``peak_flops`` (bf16 MXU op/s) -> ``peak_flops``: dense bf16
      tensor-core op/s; ``peak_flops_fp32`` adds the fp32 FMA rate outside
      the tensor cores, which the fp32 kernels run on;
    * ``hbm_bw``, ``hbm_bytes``, ``clock_hz``: the same quantities (the
      clock is the SM's maximum);
    * ``ici_bw`` (B/s a chip-to-chip link) -> ``link_bw``: NVLink B/s in
      one direction;
    * ``vmem_bytes`` (the VMEM a core stages tiles in) -> ``smem_bytes``:
      the shared memory one block may opt into (227 KB), where the
      kernels stage their tiles; ``l2_bytes`` and ``sms`` have no JAX
      field;
    * ``mxu_dim`` (the systolic array's edge) -> ``mma_dim``: the M of one
      warpgroup ``wgmma`` instruction, the edge tiles align to;
    * ``lane`` (128 VPU lanes) -> ``warp``: the 32 threads of a warp that
      read a row's consecutive elements in one instruction;
    * ``sublane`` (8 VPU sublanes) -> ``frag_rows``: the 8 rows of an
      ``mma.sync`` / ``ldmatrix`` fragment.
    """

    name: str
    peak_flops: float           # dense bf16 tensor-core op/s
    peak_flops_fp32: float      # fp32 FMA op/s (no tensor cores)
    hbm_bw: float               # B/s
    link_bw: float              # NVLink B/s, one direction
    hbm_bytes: float
    smem_bytes: float           # shared memory a block may opt into
    l2_bytes: float
    sms: int
    clock_hz: float
    mma_dim: int = 64
    warp: int = 32
    frag_rows: int = 8

    def peak_ops(self, dtype: str) -> float:
        """op/s of the units that compute in ``dtype`` ("bfloat16" on the
        tensor cores, "float32" on the FMA units)."""
        return {"bfloat16": self.peak_flops,
                "float32": self.peak_flops_fp32}[dtype]


# NVIDIA H100 SXM (80 GB HBM3): the data sheet's dense peaks at the full
# 700 W power limit; 132 SMs at up to 1980 MHz, 50 MB of L2, 227 KB of
# shared memory a block, NVLink 4 at 900 GB/s both ways
H100_SXM = HardwareSpec(
    name="h100-sxm",
    peak_flops=989e12,
    peak_flops_fp32=67e12,
    hbm_bw=3.35e12,
    link_bw=450e9,
    hbm_bytes=80e9,
    smem_bytes=232448,
    l2_bytes=50 * 1024**2,
    sms=132,
    clock_hz=1.98e9,
)


@dataclass
class Roofline:
    """Three-term roofline for one (arch x shape x mesh) cell."""

    name: str
    chips: int
    hlo_flops: float               # total, all cards
    hlo_bytes: float               # HBM traffic, all cards
    collective_bytes: float        # total bytes crossing the links
    model_flops: float             # 6*N*D analytic "useful" FLOPs
    hw: HardwareSpec = field(default_factory=lambda: H100_SXM)

    # ---- the three terms, in seconds ----
    @property
    def compute_s(self) -> float:
        return self.hlo_flops / (self.chips * self.hw.peak_flops)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.chips * self.hw.hbm_bw)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (self.chips * self.hw.link_bw)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Optimistic overlap model: bound by the slowest roofline term."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs -- catches remat/redundancy waste."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved at the modeled step
        time: MODEL_FLOPS / (step_s * chips * peak)."""
        denom = self.step_s * self.chips * self.hw.peak_flops
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> Dict[str, float]:
        return {
            "name": self.name,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_s": self.step_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def dense_model_flops(n_params: int, n_tokens: int) -> float:
    """MODEL_FLOPS = 6 * N * D for a dense decoder train step."""
    return 6.0 * n_params * n_tokens


def arithmetic_intensity(flops: float, bytes_: float) -> float:
    return flops / bytes_ if bytes_ else float("inf")


def machine_balance(hw: HardwareSpec = H100_SXM) -> float:
    """FLOP/B at which a kernel turns from memory- to compute-bound."""
    return hw.peak_flops / hw.hbm_bw
