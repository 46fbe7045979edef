from .base import ArchConfig, LayerKind  # noqa: F401
from .archs import ARCHS  # noqa: F401


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
