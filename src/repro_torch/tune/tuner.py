"""The sweep over the Hopper kernels' plans -- the port of
``repro/tune/tuner.py``.

``tune()`` runs one (kernel, cell shape, dtype) cell: make the inputs at
the cell's shape, enumerate the candidate plans at the op's plan key
(``kernels/registry.py``: the shape its heuristic reads), time each
through the shared harness (``measure.py``), pick the fastest and,
given a cache, store it under that key, where the kernel route and
``plan="tuned"`` find it.  Candidate 0 is the heuristic plan and a later
candidate wins only by being strictly faster, so ``best_us <=
heuristic_us`` holds within a sweep's own measurements.

This module holds no op table: the space, inputs, call, dtype and
default cells come from each op's ``TuneSpec`` in the registry.
``KERNELS`` / ``DEFAULT_SHAPES`` resolve lazily, so importing
``repro_torch.tune`` imports no kernel package.  The cells run on the
card unless ``device`` names the CPU, where a kernel wrapper raises:
there every candidate fails and ``tune`` raises.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .cache import PlanCache, _backend_name, _dtype_name, make_key
from .measure import Harness, Measurement

PlanDict = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class KernelTuneSpec:
    """Tuner-facing view of one registered op's ``TuneSpec``."""

    name: str
    make_inputs: Callable[..., tuple]
    call: Callable[[tuple, PlanDict], Any]
    default_dtype: Any
    space: Callable[..., List[PlanDict]]
    default_shapes: Tuple[Tuple[int, ...], ...]


def _registry_kernels() -> Dict[str, KernelTuneSpec]:
    """The tunable-op table, derived from the registry (no second copy)."""
    from ..kernels import registry
    out: Dict[str, KernelTuneSpec] = {}
    for name, spec in registry.tunable().items():
        t = spec.tune
        out[name] = KernelTuneSpec(
            name=name, make_inputs=t.make_inputs, call=t.call,
            default_dtype=t.default_dtype, space=t.space,
            default_shapes=t.default_shapes)
    return out


def _default_shapes() -> Dict[str, List[Tuple[int, ...]]]:
    return {name: list(spec.default_shapes)
            for name, spec in _registry_kernels().items()}


def __getattr__(name: str):
    # lazy: building these imports the kernel packages
    if name == "KERNELS":
        return _registry_kernels()
    if name == "DEFAULT_SHAPES":
        return _default_shapes()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclasses.dataclass
class TuneResult:
    kernel: str
    shape: Tuple[int, ...]          # the cell
    key_shape: Tuple[int, ...]      # the plan key it was stored under
    namespace: str                  # the plan namespace of the key
    dtype: str
    key_dtype: str
    backend: str
    best: PlanDict
    best_us: float
    heuristic_us: float
    rows: List[dict]                # [{"plan": ..., "us": ..., "ok": ...}]

    @property
    def speedup(self) -> float:
        return self.heuristic_us / max(self.best_us, 1e-9)

    @property
    def heuristic(self) -> PlanDict:
        return self.rows[0]["plan"]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["shape"] = list(self.shape)
        d["key_shape"] = list(self.key_shape)
        d["speedup"] = self.speedup
        d["key"] = make_key(self.namespace, self.key_shape, self.key_dtype,
                            self.backend)
        return d


def tune(kernel: str, shape: Sequence[int], *, dtype: Any = None,
         cache: Optional[PlanCache] = None,
         harness: Optional[Harness] = None,
         max_candidates: Optional[int] = None,
         device: Any = "cuda",
         log: Optional[Callable[[str], None]] = None) -> TuneResult:
    """Sweep one (kernel, cell shape) cell; returns and, given a
    ``cache``, stores the winner under the op's plan key.  ``harness``
    is injectable for deterministic tests."""
    from ..kernels import registry
    spec = registry.get(kernel)
    t = spec.tune
    if t is None:
        raise KeyError(f"op {kernel!r} is not tunable")
    dtype = dtype or t.default_dtype
    harness = harness or Harness()
    args = t.make_inputs(tuple(shape), dtype, device)
    key = spec.key(*args)
    if key is None:
        raise ValueError(f"{kernel} {tuple(shape)}: this cell's route "
                         f"takes no plan")
    key_shape, key_dtype = key
    space_kw = {} if max_candidates is None \
        else {"max_candidates": max_candidates}
    candidates = t.space(key_shape, key_dtype, **space_kw)

    rows: List[dict] = []
    best_i, best_m = None, None
    for i, cand in enumerate(candidates):
        m: Measurement = harness.measure(functools.partial(t.call, args,
                                                           cand))
        rows.append({"plan": cand, "us": m.us, "ok": m.ok,
                     **({"error": m.error} if not m.ok else {})})
        if log:
            log(f"  [{kernel} {tuple(shape)}] {cand} -> "
                f"{m.us:.2f}us{'' if m.ok else ' (FAILED: ' + m.error + ')'}")
        if m.ok and (best_m is None or m.us < best_m.us):
            best_i, best_m = i, m
    if best_m is None:
        raise RuntimeError(
            f"every candidate failed for {kernel} {tuple(shape)}: {rows}")

    backend = _backend_name(None if torch.device(device).type == "cuda"
                            else "cpu")
    result = TuneResult(
        kernel=kernel, shape=tuple(shape), key_shape=key_shape,
        namespace=spec.namespace, dtype=_dtype_name(dtype),
        key_dtype=_dtype_name(key_dtype), backend=backend,
        best=candidates[best_i], best_us=best_m.us,
        heuristic_us=rows[0]["us"], rows=rows)
    if cache is not None:
        cache.put(spec.namespace, key_shape, key_dtype, result.best,
                  backend=backend, us=round(result.best_us, 3),
                  heuristic_us=round(result.heuristic_us, 3),
                  candidates=len(candidates))
    return result


def tune_all(shapes: Optional[Dict[str, List[Tuple[int, ...]]]] = None, *,
             cache: Optional[PlanCache] = None,
             harness: Optional[Harness] = None,
             max_candidates: Optional[int] = None,
             device: Any = "cuda",
             log: Optional[Callable[[str], None]] = None
             ) -> List[TuneResult]:
    """Sweep every registered tunable op over its cells (default: the
    registry's default cells, the shapes the port's main paths launch)."""
    shapes = shapes or _default_shapes()
    return [tune(kernel, shape, cache=cache, harness=harness,
                 max_candidates=max_candidates, device=device, log=log)
            for kernel, shape_list in shapes.items()
            for shape in shape_list]
