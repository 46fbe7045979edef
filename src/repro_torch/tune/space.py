"""Per-kernel candidate plans over the Hopper kernels' own plan parameters
-- the port of ``repro/tune/space.py``.

Each space function takes a plan key (the shape the kernel's heuristic
reads, ``kernels/registry.py`` ``plan_shape``) and its dtype, and returns
candidate plan dicts; **candidate 0 is always the heuristic plan**, the
one the kernel runs without a plan, so a sweep can only match or beat
it.  The paper's knobs map onto the kernels' as:

  replication (§3.2) / accumulation interleaving (§2.1)
      -> ``split``: blocks of B1 (and its grouped route) and B5 that
         share an output tile, their fp32 partials summed in rank order;
         ``split_keys``: keys a block of B2/B4a and B3/B4b takes of a
         slot; ``splits``: source ranges of B10
  random-access buffering (§2.3)
      -> ``route``: B11's private shared-memory bins or one pass of
         atomics into L2
  (none) -> B6, B7 and B9 take no plan: their spaces hold the heuristic
         (``{}``) alone.

The JAX package's TPU tile geometry (``bm``/``bn``/``bk``,
``block_rows`` ...) and its level-T1 candidates do not carry over: the
card's spaces hold kernel plans only.  A candidate never exceeds the
heuristic's own limits (``MAX_SPLIT``, ``Q_MAX_SPLIT``, the decode
split's key range), so a plan tuned at M = 4 allocates no more split
scratch at a training step's M than the heuristic could.
``plan_feasible`` applies the wrappers' own plan checks (which hold the
C entries' preconditions) at a query's key.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from ..kernels.attention import decode, prefill
from ..kernels.histogram.histogram import (ROUTES, bin_window,
                                           histogram_route, planned_route)
from ..kernels.matmul import matmul
from ..kernels.nbody import nbody

PlanDict = Dict[str, Any]
# the grid's group axis of B1's grouped route (csrc/matmul.cu)
MAX_GRID_Z = 65535


def torch_dtype(dtype: Any) -> torch.dtype:
    """A dtype given as a torch dtype or by name ("bfloat16")."""
    return dtype if isinstance(dtype, torch.dtype) \
        else getattr(torch, str(dtype))


def _dedup(cands: List[PlanDict],
           max_candidates: Optional[int]) -> List[PlanDict]:
    seen, out = set(), []
    for c in cands:
        key = tuple(sorted(c.items()))
        if key not in seen:
            seen.add(key)
            out.append(c)
    return out[:max_candidates] if max_candidates else out


def _doublings(lo: int, hi: int) -> List[int]:
    out, v = [], lo
    while v <= hi:
        out.append(v)
        v *= 2
    return out


def matmul_space(shape: Sequence[int], dtype: Any = torch.bfloat16, *,
                 max_candidates: Optional[int] = None) -> List[PlanDict]:
    """B1: shape (K, N), or (G, K, N) for the grouped route's tile path.
    ``{"split": s}`` for s = 1 .. MAX_SPLIT, each as ``split_at`` applies
    it at this K (so no two candidates run the same split)."""
    *lead, k, n = shape
    g = lead[0] if lead else 1
    tile_k = matmul.TILE_K[torch_dtype(dtype)]
    heur = matmul.split_plan(k, n, torch_dtype(dtype), groups=g)[0]
    cands = [{"split": heur}]
    for s in range(1, matmul.MAX_SPLIT + 1):
        split = matmul.split_at(k, tile_k, s)[0]
        if g * split <= MAX_GRID_Z:
            cands.append({"split": split})
    return _dedup(cands, max_candidates)


def quantized_matmul_space(shape: Sequence[int],
                           dtype: Any = torch.bfloat16, *,
                           max_candidates: Optional[int] = None
                           ) -> List[PlanDict]:
    """B5: shape (K, N), dtype the activations'.  ``{"split": s}`` for
    s = 1 .. Q_MAX_SPLIT."""
    k, n = shape
    heur = matmul.quantized_split_plan(k, n, torch_dtype(dtype))[0]
    cands = [{"split": heur}] + [
        {"split": matmul.split_at(k, matmul.Q_TILE_K, s)[0]}
        for s in range(1, matmul.Q_MAX_SPLIT + 1)]
    return _dedup(cands, max_candidates)


def decode_attention_space(shape: Sequence[int], dtype: Any = None, *,
                           max_candidates: Optional[int] = None
                           ) -> List[PlanDict]:
    """B2/B4a: shape (n_pages, page, Hkv) of the table and the pools.
    ``{"split_keys": n}``: whole pages, doubling from ``MIN_SPLIT_KEYS``
    to ``MAX_SPLIT_KEYS`` (``decode.split_keys_range``)."""
    n_pages, page, hkv = shape
    heur = decode.decode_split_plan(n_pages, page, hkv)[0]
    lo, hi = decode.split_keys_range(page)
    cands = [{"split_keys": heur}] + [
        {"split_keys": n} for n in _doublings(lo, hi)]
    return _dedup(cands, max_candidates)


def _prefill_wgmma(grp: int, hd: int) -> bool:
    """Whether a bf16 query of this group and head width takes the wgmma
    route, the one that splits."""
    return prefill.prefill_route(torch.bfloat16, hd, grp) == "wgmma"


def prefill_attention_space(shape: Sequence[int], dtype: Any = None, *,
                            max_candidates: Optional[int] = None
                            ) -> List[PlanDict]:
    """B3/B4b: shape (n_pages, page, Hkv, grp, C, hd).  On the wgmma
    route ``{"split_keys": n}``: multiples of ``split_keys_unit(page)``,
    doubling, up to the table's keys and ``MAX_SPLIT_PAGES`` pages; the
    simt route takes no plan."""
    n_pages, page, hkv, grp, c, hd = shape
    if not _prefill_wgmma(grp, hd):
        return [{}]
    heur = prefill.prefill_split_plan(n_pages, page, hkv, grp, c, hd)[0]
    unit = prefill.split_keys_unit(page)
    top = min(prefill.MAX_SPLIT_PAGES * page,
              max(unit, -(-n_pages * page // unit) * unit))
    cands = [{"split_keys": heur}] + [
        {"split_keys": n} for n in _doublings(unit, top)]
    return _dedup(cands, max_candidates)


def nbody_space(shape: Sequence[int], dtype: Any = torch.float32, *,
                max_candidates: Optional[int] = None) -> List[PlanDict]:
    """B10: shape (N,).  ``{"splits": s}``, doubling up to the source
    tiles, each as ``splits_at`` applies it at this N."""
    (n,) = shape
    tiles = max(1, -(-n // nbody.SOURCE_TILE))
    cands = [{"splits": nbody.nbody_split_plan(n)[0]}] + [
        {"splits": nbody.splits_at(n, s)[0]} for s in _doublings(1, tiles)]
    return _dedup(cands, max_candidates)


def histogram_space(shape: Sequence[int], dtype: Any = torch.int32, *,
                    max_candidates: Optional[int] = None) -> List[PlanDict]:
    """B11: shape (n_bins,).  ``{"route": r}``: both routes where
    ``bin_window`` holds every bin, else ``global`` alone."""
    (n_bins,) = shape
    cands = [{"route": histogram_route(n_bins)}] + [
        {"route": r} for r in ROUTES
        if r == "global" or bin_window(n_bins) == n_bins]
    return _dedup(cands, max_candidates)


def heuristic_only(shape: Sequence[int], dtype: Any = None, *,
                   max_candidates: Optional[int] = None) -> List[PlanDict]:
    """B6, B7 and B9 take no plan: the heuristic alone."""
    return [{}]


SPACES = {
    "matmul": matmul_space,
    "quantized_matmul": quantized_matmul_space,
    "decode_attention": decode_attention_space,
    "prefill_attention": prefill_attention_space,
    "nbody": nbody_space,
    "histogram": histogram_space,
    "flash_attention": heuristic_only,
    "flash_attention_bwd": heuristic_only,
    "stencil": heuristic_only,
}


# ------------------------------------------------------------- feasibility
def _raises(check) -> bool:
    try:
        check()
    except (ValueError, KeyError, TypeError):
        return True
    return False


def plan_feasible(kernel: str, shape: Sequence[int], plan: PlanDict, *,
                  dtype: Any = torch.bfloat16) -> bool:
    """Whether a plan may run at the query's key ``shape``: the wrappers'
    own plan checks (the C entries' preconditions and the heuristic's
    limits), so a nearest-shape transplant is never invalid.  ``{}`` (the
    heuristic) always is; a level below T3 claims no kernel and is
    feasible, as in the JAX package (a card's cache refuses it)."""
    level = plan.get("level")
    if level is not None and level < 3:
        return True
    plan = {k: v for k, v in plan.items() if k != "level"}
    if kernel not in SPACES:
        return False
    if not plan:
        return True
    if kernel == "matmul":
        *lead, k, n = shape
        dt = torch_dtype(dtype)
        if _raises(lambda: matmul.planned_split(
                "matmul", k, matmul.TILE_K[dt], matmul.MAX_SPLIT, plan,
                None)):
            return False
        split = matmul.split_at(k, matmul.TILE_K[dt], plan["split"])[0]
        return (lead[0] if lead else 1) * split <= MAX_GRID_Z
    if kernel == "quantized_matmul":
        k, _ = shape
        return not _raises(lambda: matmul.planned_split(
            "quantized_matmul", k, matmul.Q_TILE_K, matmul.Q_MAX_SPLIT,
            plan, None))
    if kernel == "decode_attention":
        n_pages, page, hkv = shape
        return not _raises(lambda: decode.planned_split(
            "decode_attention", n_pages, page, hkv, plan))
    if kernel == "prefill_attention":
        n_pages, page, hkv, grp, c, hd = shape
        return _prefill_wgmma(grp, hd) and not _raises(
            lambda: prefill.planned_split("prefill_attention", n_pages,
                                          page, hkv, grp, c, hd, plan))
    if kernel == "nbody":
        return not _raises(lambda: nbody.planned_splits(shape[0], plan))
    if kernel == "histogram":
        return not _raises(lambda: planned_route(shape[0], plan))
    return False              # B6, B7, B9: no plan but the heuristic's

