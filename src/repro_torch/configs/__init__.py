from .base import (ArchConfig, LayerKind, SHAPES, ShapeSpec,  # noqa: F401
                   input_specs, shape_applicable)
from .archs import ARCHS  # noqa: F401


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
