from .analysis import (  # noqa: F401
    CollectiveOp,
    CollectiveStats,
    analyze_step,
    collective_stats,
    combine_affine,
)
