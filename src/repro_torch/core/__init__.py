"""repro_torch.core -- the paper's contribution, an HLS-transformation
toolbox, re-targeted at the H100: the performance models, the staged
levels, the scaling and pipelining helpers, the memory policies and the
taxonomy (the port of ``repro/core/__init__.py``'s exports)."""

from .model import (  # noqa: F401
    H100_SXM,
    HardwareSpec,
    PipelineModel,
    Roofline,
    arithmetic_intensity,
    dense_model_flops,
    machine_balance,
)
from .memory import (  # noqa: F401
    BF16_POLICY,
    F32_POLICY,
    DtypePolicy,
    QuantizedBlock,
    dequantize_block,
    quantize_block,
    quantized_bytes,
    striped_bytes_per_chip,
)
from .pipelining import (  # noqa: F401
    cross_input_interleave,
    flatten_grid,
    fuse_phases,
    interleaved_accumulate,
    tiled_accumulate,
)
from .plan import Level, TransformConfig, PAPER_STAGES  # noqa: F401
from .scaling import (  # noqa: F401
    TilePlan,
    TilePlanner,
    lane_utilization,
    replication_factor,
    round_up,
    vector_pad,
)
from .taxonomy import (  # noqa: F401
    TABLE1,
    TABLE2,
    Characteristic,
    Objective,
    Relevance,
    Transformation,
    TransformClass,
    by_class,
    recommend,
)
