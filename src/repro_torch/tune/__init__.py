"""Tuning over the Hopper kernels' plans (repro_torch.tune) -- the port of
``repro/tune``.

The paper's thesis is that HLS transformations form a parameterized
design space an engineer sweeps against the hardware.  On the card the
free parameters of the port's kernels are their split plans (and B11's
route); this package makes the sweep executable:

  space.py   -- per-kernel candidate plans, candidate 0 the heuristic
  measure.py -- the shared timing harness (median of reps, each rep
                ``inner`` calls and one synchronization)
  tuner.py   -- the sweep; winners match or beat the heuristic within a
                sweep by construction
  cache.py   -- JSON persistence keyed by (kernel, plan key, dtype, the
                card's name), which the model's kernel route and the
                public ops' ``plan="tuned"`` consult

On the card: ``repro_torch.tune.tune_all(cache=PlanCache())`` sweeps the
registry's default cells, then ``cache.save()`` writes
``$REPRO_TORCH_TUNE_CACHE`` (default ``build/tuned_plans.json``).
"""
from .cache import (PlanCache, default_cache, default_cache_path,
                    lookup_scope, lookup_stats, make_key, parse_key,
                    preload, reset_lookup_stats, resolve_plan,
                    resolve_plan_source, shape_distance, tuned_plan)
from .measure import Harness, Measurement
from .tuner import TuneResult, tune, tune_all

__all__ = [
    "PlanCache", "default_cache", "default_cache_path", "lookup_scope",
    "lookup_stats", "make_key", "parse_key", "preload",
    "reset_lookup_stats", "resolve_plan", "resolve_plan_source",
    "shape_distance", "tuned_plan", "Harness", "Measurement", "SPACES",
    "plan_feasible", "DEFAULT_SHAPES", "KERNELS", "TuneResult", "tune",
    "tune_all",
]


def __getattr__(name):
    # the spaces and KERNELS / DEFAULT_SHAPES import the kernel packages,
    # whose public ops import ``kernels.dispatch`` and, through the
    # registry, this package: resolve them lazily
    if name in ("KERNELS", "DEFAULT_SHAPES"):
        from . import tuner
        return getattr(tuner, name)
    if name in ("SPACES", "plan_feasible"):
        from . import space
        return getattr(space, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
