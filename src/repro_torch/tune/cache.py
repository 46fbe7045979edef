"""Persisted tuned-plan cache: JSON keyed by (kernel, shape, dtype, backend)
-- the port of ``repro/tune/cache.py``, in the same file format::

    {
      "version": 1,
      "entries": {
        "matmul|2048x1024|bfloat16|NVIDIA H100 80GB HBM3": {
          "plan": {"split": 4},
          "us": 6.1,                 # best measured microseconds a call
          "heuristic_us": 9.8,       # the heuristic plan's, same sweep
          "candidates": 8            # sweep size that produced the entry
        },
        ...
      }
    }

The path is ``$REPRO_TORCH_TUNE_CACHE``, else ``build/tuned_plans.json``
at the root of the checkout; the JAX package's ``REPRO_TUNE_CACHE`` and
``results/tuned_plans.json`` hold TPU and interpret plans and are never
read.  The backend is the card's name (``torch.cuda.get_device_name``),
``cpu`` without a card, so a plan tuned on one card never transplants to
another.  ``plan`` holds a kernel's plan kwargs (``tune/space.py``); a
``level`` below T3 (the plain version) is refused under a card's key:
the card runs kernels only.

The shape of a key is what the kernel's heuristic plan reads, never the
rows of a GEMM or the batch of an attention call (``kernels/registry.py``
``plan_shape``), so a row's bits never depend on the rows that share its
call.  Lookups are exact key first, then the nearest tuned shape (same
kernel, dtype, backend and rank) whose plan is feasible at the query's
key (``tune.space.plan_feasible``), then the heuristic.  The kernel
route resolves every call through ``tuned_plan``, which memoizes each
(kernel, shape, dtype) until the next ``put``, ``load`` or ``preload``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.plan import Level

CACHE_VERSION = 1
ENV = "REPRO_TORCH_TUNE_CACHE"
_REPO_ROOT = Path(__file__).resolve().parents[3]
CPU_BACKEND = "cpu"


def default_cache_path() -> Path:
    env = os.environ.get(ENV)
    if env:
        return Path(env)
    return _REPO_ROOT / "build" / "tuned_plans.json"


def _dtype_name(dtype: Any) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


_backends: Dict[int, str] = {}


def _backend_name(backend: Optional[str] = None) -> str:
    """``backend`` if given, else the current card's name (looked up once a
    device), else ``cpu``."""
    if backend is not None:
        return backend
    if not torch.cuda.is_available():
        return CPU_BACKEND
    index = torch.cuda.current_device()
    if index not in _backends:
        _backends[index] = torch.cuda.get_device_name(index)
    return _backends[index]


def make_key(kernel: str, shape: Sequence[int], dtype: Any,
             backend: Optional[str] = None) -> str:
    shape_s = "x".join(str(int(d)) for d in shape)
    return f"{kernel}|{shape_s}|{_dtype_name(dtype)}|{_backend_name(backend)}"


def parse_key(key: str) -> Tuple[str, Tuple[int, ...], str, str]:
    kernel, shape_s, dtype, backend = key.split("|")
    return kernel, tuple(int(d) for d in shape_s.split("x")), dtype, backend


def shape_distance(a: Sequence[int], b: Sequence[int]) -> float:
    """Geometric closeness: sum of squared log dim ratios.  Symmetric,
    zero iff equal, and scale-aware."""
    return sum((math.log(x / y)) ** 2 for x, y in zip(a, b))


def _kernel_only(plan: Dict[str, Any], key: str) -> None:
    """A card's plan runs a kernel: refuse a ``level`` below T3."""
    level = plan.get("level")
    if level is not None and level < int(Level.T3_REPLICATED):
        raise ValueError(
            f"tuned plan {key} asks for level {level} (the plain version); "
            f"a card's plans hold kernel plans only")


class PlanCache:
    """In-memory dict of tuned plans with JSON load/save."""

    def __init__(self, path: Union[str, Path, None] = None):
        self.path = Path(path) if path is not None else default_cache_path()
        self.entries: Dict[str, dict] = {}
        # (kernel, shape, dtype, backend) -> (plan or None, source)
        self._resolved: Dict[tuple, Tuple[Optional[dict], str]] = {}

    def __len__(self) -> int:
        return len(self.entries)

    def load(self) -> "PlanCache":
        self._resolved.clear()
        if self.path.exists():
            try:
                data = json.loads(self.path.read_text())
            except (json.JSONDecodeError, OSError):
                data = {}
            if isinstance(data, dict) \
                    and data.get("version") == CACHE_VERSION:
                self.entries = dict(data.get("entries", {}))
        return self

    def save(self) -> Path:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        payload = {"version": CACHE_VERSION, "entries": self.entries}
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
        tmp.replace(self.path)
        return self.path

    def get(self, kernel: str, shape: Sequence[int], dtype: Any,
            backend: Optional[str] = None) -> Optional[dict]:
        return self.entries.get(make_key(kernel, shape, dtype, backend))

    def get_nearest(self, kernel: str, shape: Sequence[int], dtype: Any,
                    backend: Optional[str] = None) -> Optional[dict]:
        found = self._nearest(kernel, shape, dtype, backend)
        return found[1] if found is not None else None

    def _nearest(self, kernel: str, shape: Sequence[int], dtype: Any,
                 backend: Optional[str]) -> Optional[Tuple[str, dict]]:
        """Nearest-shape fallback for an exact-key miss: among entries of
        the same kernel, dtype, backend and rank, the one whose shape is
        geometrically closest to the query (``shape_distance``) and whose
        plan is feasible at the query's shape (``plan_feasible``); an
        infeasible neighbour is skipped, never clamped.  Sorted keys with
        (distance, key) tie-breaking make it deterministic."""
        from .space import plan_feasible   # lazy: keeps this module a leaf
        qshape = tuple(int(d) for d in shape)
        if any(d <= 0 for d in qshape):
            return None
        dname = _dtype_name(dtype)
        bname = _backend_name(backend)
        best: Optional[Tuple[float, str, dict]] = None
        for key in sorted(self.entries):
            try:
                ker, eshape, edt, eb = parse_key(key)
            except ValueError:
                continue
            if (ker, edt, eb) != (kernel, dname, bname) \
                    or len(eshape) != len(qshape) \
                    or any(d <= 0 for d in eshape):
                continue
            plan = self.entries[key].get("plan", {})
            try:
                feasible = plan_feasible(kernel, qshape, plan, dtype=dname)
            except (KeyError, TypeError, ValueError):
                feasible = False
            if not feasible:
                continue
            cand = (shape_distance(qshape, eshape), key, self.entries[key])
            if best is None or cand[:2] < best[:2]:
                best = cand
        return best[1:] if best is not None else None

    def put(self, kernel: str, shape: Sequence[int], dtype: Any,
            plan: Dict[str, Any], *, backend: Optional[str] = None,
            **stats: Any) -> str:
        key = make_key(kernel, shape, dtype, backend)
        if _backend_name(backend) != CPU_BACKEND:
            _kernel_only(plan, key)
        self.entries[key] = {"plan": dict(plan), **stats}
        self._resolved.clear()
        return key

    def resolve(self, kernel: str, shape: Tuple[int, ...], dtype: Any,
                backend: Optional[str] = None
                ) -> Tuple[Optional[Dict[str, Any]], str]:
        """(plan kwargs or None, source) for a query: ``exact``,
        ``nearest`` or ``heuristic`` (a miss), memoized until the next
        ``put`` or ``load``.  A card's entry below T3 raises, naming the
        entry."""
        memo = (kernel, shape, dtype, backend)
        hit = self._resolved.get(memo)
        if hit is not None:
            return hit
        key = make_key(kernel, shape, dtype, backend)
        entry, source = self.entries.get(key), "exact"
        if entry is None:
            found = self._nearest(kernel, shape, dtype, backend)
            key, entry = found if found is not None else (key, None)
            source = "heuristic" if entry is None else "nearest"
        plan = None
        if entry is not None:
            plan = dict(entry.get("plan", {}))
            if _backend_name(backend) != CPU_BACKEND:
                _kernel_only(plan, key)
        hit = self._resolved[memo] = (plan, source)
        return hit


# ------------------------------------------------------------- default cache
_default: Optional[PlanCache] = None
_default_env: Optional[str] = None


def default_cache(*, reload: bool = False) -> PlanCache:
    """The process-wide cache the kernel route and ``plan="tuned"``
    consult: loaded from ``default_cache_path()`` at first use, and again
    with ``reload=True`` (``preload``) or when ``$REPRO_TORCH_TUNE_CACHE``
    changes."""
    global _default, _default_env
    env = os.environ.get(ENV)
    if _default is None or reload or env != _default_env:
        _default, _default_env = PlanCache().load(), env
    return _default


def preload(*, log=None) -> int:
    """Serve/train startup hook: (re)load the tuned-plan cache so the
    first request or step already runs tuned plans.  Returns the entry
    count."""
    cache = default_cache(reload=True)
    if log is not None:
        log(f"[tune] loaded {len(cache)} tuned plan(s) from {cache.path}")
    return len(cache)


# lookup counters of the kernel route and of plan="tuned": exact hit,
# nearest-shape hit, or a miss that ran the heuristic
_lookups: Dict[str, int] = {"exact": 0, "nearest": 0, "miss": 0}
_LOOKUP_OF = {"exact": "exact", "nearest": "nearest", "heuristic": "miss"}


def reset_lookup_stats() -> None:
    for k in _lookups:
        _lookups[k] = 0


def lookup_stats() -> Dict[str, int]:
    return dict(_lookups)


@contextlib.contextmanager
def lookup_scope():
    """Isolated lookup-counter scope: zeroed on entry, restored on exit."""
    saved = dict(_lookups)
    reset_lookup_stats()
    try:
        yield lookup_stats
    finally:
        for k in _lookups:
            _lookups[k] = saved.get(k, 0)


def tuned_plan(kernel: str, shape: Tuple[int, ...], dtype: Any
               ) -> Tuple[Optional[Dict[str, Any]], str]:
    """The default cache's plan for one kernel-route call and its source
    (``exact`` | ``nearest`` | ``heuristic``), counted in
    ``lookup_stats``.  Once loaded, the cache is the process's until
    ``preload`` (call it after pointing ``$REPRO_TORCH_TUNE_CACHE``
    elsewhere): the model's every kernel call comes here, and reading
    the environment costs the host as much as the lookup."""
    cache = _default if _default is not None else default_cache()
    plan, source = cache.resolve(kernel, shape, dtype)
    _lookups[_LOOKUP_OF[source]] += 1
    return plan, source


def resolve_plan_source(kernel: str, shape: Sequence[int], dtype: Any,
                        level, plan
                        ) -> Tuple[Any, Optional[Dict[str, Any]], str]:
    """``resolve_plan`` plus the lookup route that produced the result:
    ``(level, kwargs, source)``, ``source`` one of ``exact`` /
    ``nearest`` (tuned-cache hits), ``heuristic`` (a miss or a
    non-tuned plan argument) or ``explicit`` (a kwargs dict)."""
    if plan is None or plan == "heuristic":
        return level, None, "heuristic"
    source = "explicit"
    if plan == "tuned":
        plan, source = tuned_plan(kernel, tuple(int(d) for d in shape),
                                  dtype)
        if plan is None:
            return level, None, source
    if isinstance(plan, dict):
        kwargs = dict(plan)
        if "level" in kwargs:
            level = Level(kwargs.pop("level"))
        return level, kwargs, source
    raise ValueError(
        f"plan must be 'tuned', 'heuristic', None, or a kwargs dict; "
        f"got {plan!r}")


def resolve_plan(kernel: str, shape: Sequence[int], dtype: Any,
                 level, plan) -> Tuple[Any, Optional[Dict[str, Any]]]:
    """Resolve a public op's ``plan=`` argument to (level, kwargs):
    ``None`` or ``"heuristic"`` keep the kernel's heuristic plan,
    ``"tuned"`` consults the default cache (exact, nearest, then the
    heuristic on a miss), a dict is used as it is (its optional
    ``level`` overrides the caller's)."""
    level, kwargs, _ = resolve_plan_source(kernel, shape, dtype, level, plan)
    return level, kwargs
