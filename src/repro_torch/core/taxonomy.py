"""Machine-readable encoding of the paper's Table 1 and Table 2 -- the port
of ``repro/core/taxonomy.py``.

The paper's primary contribution is a taxonomy of HLS transformations:
three classes (pipelining / scaling / memory), each transformation
annotated with characteristics (its effects on the code and the
hardware) and objectives (the bottlenecks an engineer can target with
it).  ``recommend(Objective.LOOP_CARRIED_DEPENDENCY)`` returns the
transformations the paper prescribes, each with what the port does for
it on the H100 (``gpu_mechanism``) and the ``repro_torch`` objects that
do it (``repo_entrypoints``, each resolvable by ``resolve``).  The
paper's columns are copied; the JAX package's TPU column is replaced.
"""
from __future__ import annotations

import enum
import importlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple


class TransformClass(enum.Enum):
    PIPELINING = "pipelining"
    SCALING = "scaling"
    MEMORY = "memory"


class Characteristic(enum.Enum):
    """Center column group of Table 1."""

    ENABLES_PIPELINING = "PL"      # enables pipelining
    INCREASES_REUSE = "RE"         # increases arithmetic intensity
    INCREASES_PARALLELISM = "PR"   # exposes more parallelism
    OPTIMIZES_MEMORY = "ME"        # optimizes memory accesses
    RESOURCE_NEUTRAL = "RS"        # does not significantly increase resources
    ROUTING_NEUTRAL = "RT"         # does not impair routing / frequency
    SCHEDULE_NEUTRAL = "SC"        # does not change loop-nest schedule
    CODE_NEUTRAL = "CC"            # does not increase code complexity


class Objective(enum.Enum):
    """Right column group of Table 1: what the engineer wants to fix."""

    LOOP_CARRIED_DEPENDENCY = "LD"   # resolve loop-carried dependencies
    INTERFACE_CONTENTION = "IC"      # resolve interface contention
    DATA_REUSE = "RE"                # increase data reuse
    PARALLELISM = "CU"               # increase parallelism (compute units)
    MEMORY_BANDWIDTH = "BW"          # increase usable memory bandwidth
    PIPELINING_OVERHEAD = "PL"       # reduce pipeline fill/drain overhead
    ROUTING = "RT"                   # improve routing results
    RESOURCES = "RS"                 # reduce resource utilization


@dataclass(frozen=True)
class Transformation:
    name: str
    cls: TransformClass
    section: str                      # paper section
    characteristics: Tuple[Characteristic, ...]
    objectives: Tuple[Objective, ...]
    fpga_mechanism: str               # what the paper does on FPGA
    gpu_mechanism: str                # what the port does on the H100
    repo_entrypoints: Tuple[str, ...] = field(default_factory=tuple)


_T = Transformation
_C = Characteristic
_O = Objective
_K = TransformClass

TABLE1: Dict[str, Transformation] = {
    t.name: t
    for t in [
        _T(
            "accumulation_interleaving", _K.PIPELINING, "2.1",
            (_C.ENABLES_PIPELINING, _C.SCHEDULE_NEUTRAL),
            (_O.LOOP_CARRIED_DEPENDENCY,),
            "interleave independent accumulations across an M-deep buffer so "
            "each partial sum is revisited only every M >= L_acc cycles",
            "fp32 wgmma / mma.sync accumulator fragments, many independent "
            "ones a warp; split-K ranks whose fp32 partials are summed in "
            "rank order (B1, B5, B2/B4a, B3/B4b, B10); online-softmax "
            "running max and sum in the flash kernels",
            ("repro_torch.core.pipelining.interleaved_accumulate",
             "repro_torch.core.pipelining.cross_input_interleave",
             "repro_torch.kernels.matmul.matmul.split_plan",
             "repro_torch.kernels.attention.decode.decode_split_plan"),
        ),
        _T(
            "delay_buffering", _K.PIPELINING, "2.2",
            (_C.ENABLES_PIPELINING, _C.INCREASES_REUSE, _C.OPTIMIZES_MEMORY),
            (_O.INTERFACE_CONTENTION, _O.DATA_REUSE),
            "FIFO line buffers / shift registers hold each loaded element "
            "until its last use (sliding-window stencils)",
            "the Jacobi kernel stages each block's rows with their halo in "
            "shared memory once (B9); sliding-window KV caches; the "
            "RG-LRU's conv ring buffer",
            ("repro_torch.kernels.stencil.jacobi4",
             "repro_torch.models.griffin"),
        ),
        _T(
            "random_access_buffering", _K.PIPELINING, "2.3",
            (_C.ENABLES_PIPELINING, _C.OPTIMIZES_MEMORY),
            (_O.INTERFACE_CONTENTION, _O.MEMORY_BANDWIDTH),
            "stage tiles into on-chip RAM and do random accesses there",
            "the histogram's private per-block bins in shared memory with "
            "shared-memory atomics, added to the output once a bin (B11 "
            "route shared); past shared memory, one atomic a run of equal "
            "values into L2 (route global)",
            ("repro_torch.kernels.histogram.histogram",
             "repro_torch.kernels.histogram.histogram.histogram_route"),
        ),
        _T(
            "pipelined_loop_fusion", _K.PIPELINING, "2.4",
            (_C.ENABLES_PIPELINING, _C.RESOURCE_NEUTRAL),
            (_O.PIPELINING_OVERHEAD,),
            "fuse sequential pipelined loops under loop guards to share one "
            "fill/drain",
            "one kernel runs what would be several passes: the flash "
            "kernels fuse scores, softmax and P @ V; the int8 kernels "
            "dequantize inside the tile; B5 scales at the flush",
            ("repro_torch.core.pipelining.fuse_phases",
             "repro_torch.optim.adamw"),
        ),
        _T(
            "loop_flattening", _K.PIPELINING, "2.5",
            (_C.ENABLES_PIPELINING, _C.RESOURCE_NEUTRAL),
            (_O.PIPELINING_OVERHEAD,),
            "coalesce nested loops so the inner pipeline never drains",
            "flattened grids: one launch over (slot x kv head x split) in "
            "the paged attention kernels and over (group x tile) in B1's "
            "grouped route, whose short tile is one persistent block an SM",
            ("repro_torch.core.pipelining.flatten_grid",
             "repro_torch.models.transformer"),
        ),
        _T(
            "inlining", _K.PIPELINING, "2.6",
            (_C.ENABLES_PIPELINING, _C.CODE_NEUTRAL),
            (_O.LOOP_CARRIED_DEPENDENCY, _O.PIPELINING_OVERHEAD),
            "instantiate called functions as dedicated hardware",
            "device functions and templates inline into each kernel "
            "(csrc/*.cuh); the host step runs its ops eagerly",
            ("repro_torch.train.steps",),
        ),
        _T(
            "condition_flattening", _K.PIPELINING, "2.7",
            (_C.RESOURCE_NEUTRAL, _C.SCHEDULE_NEUTRAL),
            (_O.ROUTING,),
            "balance conditional logic depth to shorten the critical path",
            "predication: masks by select (causal, window, ragged lengths) "
            "instead of branches in the kernels' inner loops, and "
            "torch.where masks in the plain versions",
            ("repro_torch.kernels.attention.flash.masked_scores",),
        ),
        _T(
            "vectorization", _K.SCALING, "3.1",
            (_C.INCREASES_PARALLELISM, _C.OPTIMIZES_MEMORY, _C.CODE_NEUTRAL),
            (_O.PARALLELISM, _O.MEMORY_BANDWIDTH),
            "widen the datapath by W via unrolling / vector types; bounded by "
            "W_max = B/(f*S)",
            "16-byte vector loads over a warp's 32 lanes; bf16 packs two "
            "values a 32-bit lane; the tensor cores' wgmma tiles",
            ("repro_torch.core.scaling.vector_pad",
             "repro_torch.core.scaling.TilePlanner"),
        ),
        _T(
            "replication", _K.SCALING, "3.2",
            (_C.INCREASES_PARALLELISM, _C.INCREASES_REUSE),
            (_O.PARALLELISM,),
            "replicate compute units fed from on-chip reuse; scales with "
            "silicon, not memory bandwidth",
            "within the card: blocks over output tiles and K splits across "
            "132 SMs (the split plans the tuner sweeps), several targets a "
            "thread in N-body; across cards: tensor and expert parallelism",
            ("repro_torch.runtime.sharding",
             "repro_torch.kernels.matmul.matmul.split_plan",
             "repro_torch.kernels.nbody.nbody.nbody_split_plan"),
        ),
        _T(
            "streaming_dataflow", _K.SCALING, "3.3",
            (_C.INCREASES_PARALLELISM, _C.ROUTING_NEUTRAL),
            (_O.PARALLELISM, _O.ROUTING),
            "partition into PEs connected by FIFOs; systolic arrays",
            "warp-specialized producer and consumer warpgroups joined by "
            "mbarrier rings of shared memory in the wgmma kernels; the "
            "stage pipeline over ranks with microbatches",
            ("repro_torch.runtime.pipeline_parallel",),
        ),
        _T(
            "tiling", _K.SCALING, "3.4",
            (_C.OPTIMIZES_MEMORY, _C.RESOURCE_NEUTRAL),
            (_O.DATA_REUSE, _O.RESOURCES),
            "fold large problems into chunks that fit on-chip memory",
            "tiles sized to a block's 227 KB of shared memory (TilePlanner "
            "for napkin math; the kernels' own tiles); WKV chunks; "
            "microbatching",
            ("repro_torch.core.scaling.TilePlanner",),
        ),
        _T(
            "memory_access_extraction", _K.MEMORY, "4.1",
            (_C.ENABLES_PIPELINING, _C.OPTIMIZES_MEMORY),
            (_O.INTERFACE_CONTENTION, _O.MEMORY_BANDWIDTH),
            "move memory accesses into separate modules; long bursts + "
            "streams decouple memory from compute schedules",
            "cp.async and TMA rings: producer warps (or the TMA unit) copy "
            "the next tiles while the consumers compute on shared memory; "
            "the host data pipeline prefetches batches on a thread",
            ("repro_torch.data.pipeline",
             "repro_torch.core.memory.prefetched_scan"),
        ),
        _T(
            "memory_oversubscription", _K.MEMORY, "4.2",
            (_C.OPTIMIZES_MEMORY,),
            (_O.MEMORY_BANDWIDTH,),
            "read ahead aggressively into deep buffers; gearbox bus widths",
            "multi-stage rings (4 stages in B1's short tile, the decode "
            "kernel's per-lane cp.async ring); batches ahead in the loader",
            ("repro_torch.data.pipeline",),
        ),
        _T(
            "memory_striping", _K.MEMORY, "4.3",
            (_C.OPTIMIZES_MEMORY,),
            (_O.MEMORY_BANDWIDTH,),
            "stripe arrays across DRAM banks (RAID-0)",
            "weights and moments striped over the mesh (each card's HBM a "
            "bank); experts striped over ranks; KV heads striped under "
            "tensor parallelism",
            ("repro_torch.runtime.sharding",),
        ),
        _T(
            "type_demotion", _K.MEMORY, "4.4",
            (_C.OPTIMIZES_MEMORY, _C.RESOURCE_NEUTRAL, _C.CODE_NEUTRAL),
            (_O.MEMORY_BANDWIDTH, _O.RESOURCES),
            "demote to cheaper types that still meet precision needs",
            "bf16 compute on the tensor cores; int8 weights (B5) and int8 "
            "KV pools (B4a/B4b) widened in the tile; block-scaled int8 "
            "Adam moments and gradient compression",
            ("repro_torch.core.memory.QuantizedBlock",
             "repro_torch.kernels.matmul.quantized_matmul_cuda",
             "repro_torch.optim.adamw", "repro_torch.optim.compress"),
        ),
    ]
}


def resolve(entrypoint: str) -> Any:
    """Import the object an entrypoint names: the longest importable
    module prefix, then attributes."""
    parts = entrypoint.split(".")
    for cut in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:cut]))
        except ModuleNotFoundError:
            continue
        for attr in parts[cut:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(entrypoint)


def recommend(objective: Objective) -> List[Transformation]:
    """The paper's cheat-sheet lookup: objective -> candidate
    transformations."""
    return [t for t in TABLE1.values() if objective in t.objectives]


def by_class(cls: TransformClass) -> List[Transformation]:
    return [t for t in TABLE1.values() if t.cls is cls]


# --------------------------------------------------------------------------
# Table 2: classic software transformations and their HLS relevance.
# --------------------------------------------------------------------------

class Relevance(enum.Enum):
    CORE = "core component of an HLS transformation"
    DIRECT = "applies directly, as in software"
    NONE = "little or no relevance to HLS/TPU"


TABLE2: Dict[str, Tuple[Relevance, str]] = {
    "loop_interchange": (Relevance.CORE, "resolves loop-carried deps (§2.1.1)"),
    "strip_mining": (Relevance.CORE, "backbone of tiling/vectorization"),
    "loop_tiling": (Relevance.CORE, "fit fast memory (§3.4 / BlockSpec)"),
    "loop_distribution": (Relevance.CORE, "separate schedules (§3.3)"),
    "loop_unrolling": (Relevance.CORE, "generates parallel hardware (§3.1/3.2)"),
    "software_pipelining": (Relevance.CORE, "what the scheduler does (§1.2)"),
    "loop_coalescing": (Relevance.CORE, "saves pipeline drains (§2.5)"),
    "reduction_recognition": (Relevance.CORE, "prevents accumulation deps (§2.1)"),
    "loop_idiom_recognition": (Relevance.CORE, "shift-buffer detection (§2.2)"),
    "procedure_inlining": (Relevance.CORE, "required for pipelining (§2.6)"),
    "loop_peeling": (Relevance.DIRECT, "opposite often better: coalesce (§2.5)"),
    "simd_transforms": (Relevance.CORE, "via unrolling (§3.1)"),
    "licm_hoisting": (Relevance.DIRECT, "saves memory operations"),
    "loop_normalization": (Relevance.DIRECT, "useful intermediate step"),
    "loop_reversal": (Relevance.DIRECT, "as in software"),
    "array_padding": (Relevance.DIRECT, "lane alignment is exactly this"),
    "scalar_replacement": (Relevance.DIRECT, "registers instead of buffers"),
    "function_memoization": (Relevance.DIRECT, "explicit fast-memory tables"),
    "tail_recursion_elimination": (Relevance.DIRECT, "enables hardware mapping"),
    "regular_array_decomposition": (Relevance.DIRECT, "on/off-chip partitioning"),
    "short_circuiting": (Relevance.NONE, "all logic is instantiated anyway"),
    "code_colocation": (Relevance.NONE, "no runtime function calls"),
    "vliw_transforms": (Relevance.NONE, "no instruction stream"),
    "cache_alignment": (Relevance.NONE, "no implicit cache coherence"),
    "supercompiling": (Relevance.NONE, "synthesis times prohibitive"),
}
