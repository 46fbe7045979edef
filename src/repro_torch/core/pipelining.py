"""Pipeline-enabling transformations (paper §2) as functions on tensors --
the port of ``repro/core/pipelining.py``.

A loop-carried dependency through an ``L_acc``-cycle operation forces
initiation interval ``I = L_acc``.  The cures are the paper's:

* §2.1.1/2.1.2  revisit each accumulator only every M >= L_acc steps
                -> ``interleaved_accumulate``, ``tiled_accumulate``
* §2.1.4        interleave independent problem instances
                -> ``cross_input_interleave``
* §2.4          fuse sequential pipelined phases -> ``fuse_phases``
* §2.5          flatten nested iteration spaces -> ``flatten_grid``

On the card the kernels apply them in CUDA (independent fp32 accumulator
fragments, split-K partials summed in rank order, one persistent block
walking flattened tiles); these helpers state each transformation on
tensors, for tests and napkin math.  The JAX package's ``lax.scan`` is a
host loop here.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch


def interleaved_accumulate(
    xs: torch.Tensor,
    *,
    lanes: int = 8,
    axis: int = 0,
    op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.add,
    init: float = 0.0,
) -> torch.Tensor:
    """Single-loop accumulation interleaving (paper §2.1.3, Lst. 2).

    Splits a length-N sequential reduction into ``lanes`` independent
    partial accumulators (stage 0: the loop with the dependency broken)
    and collapses them in a short second stage (stage 1, a tree fold).
    Works for any associative and commutative ``op``; equal to the naive
    fold for integers, and up to reassociation for floats.
    """
    xs = torch.movedim(xs, axis, 0)
    n = xs.shape[0]
    pad = (-n) % lanes
    if pad:
        fill = torch.full((pad,) + tuple(xs.shape[1:]), init,
                          dtype=xs.dtype, device=xs.device)
        xs = torch.cat([xs, fill], dim=0)
    # stage 0: lane-strided partials, (n/lanes, lanes, ...) reduced over
    # the sequential axis; every lane is an independent accumulator
    xs = xs.reshape((-1, lanes) + tuple(xs.shape[1:]))
    acc = torch.full((lanes,) + tuple(xs.shape[2:]), init, dtype=xs.dtype,
                     device=xs.device)
    for row in xs:
        acc = op(acc, row)
    # stage 1: collapse the lane partials
    return _fold(acc, op)


def _fold(xs: torch.Tensor, op) -> torch.Tensor:
    """Tree-fold along the leading axis (log-depth collapse; the paper's
    stage 1)."""
    n = xs.shape[0]
    while n > 1:
        half = n // 2
        lo, hi, rest = xs[:half], xs[half:2 * half], xs[2 * half:]
        xs = torch.cat([op(lo, hi), rest], dim=0)
        n = xs.shape[0]
    return xs[0]


def tiled_accumulate(
    terms_fn: Callable[[torch.Tensor], torch.Tensor],
    n: int,
    tile: int,
    out_shape: Tuple[int, ...],
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Tiled accumulation interleaving (paper §2.1.2, Lst. 1c).

    Evaluates ``sum_{i<n} terms_fn(i)`` where ``terms_fn`` maps a vector
    of indices to a (tile,) + out_shape block of terms.  A buffer of
    ``tile`` partial accumulators is carried over n/tile chunks: each is
    touched once a chunk.
    """
    if n % tile:
        raise ValueError(f"tiled_accumulate: {tile} does not divide {n}")
    acc = torch.zeros((tile,) + tuple(out_shape), dtype=dtype)
    for chunk in range(n // tile):
        acc = acc + terms_fn(chunk * tile + torch.arange(tile))
    return acc.sum(dim=0)


def cross_input_interleave(
    step: Callable[[torch.Tensor], torch.Tensor],
    states: torch.Tensor,
    n_steps: int,
) -> torch.Tensor:
    """Cross-input accumulation interleaving (paper §2.1.4, Lst. 3).

    A solver with a true dependency on its own state cannot be pipelined,
    but independent instances can: the step is vmapped across the leading
    axis (instances fill the lanes) and iterated over time.
    """
    vstep = torch.vmap(step)
    for _ in range(n_steps):
        states = vstep(states)
    return states


def fuse_phases(
    phases: Sequence[Callable[[torch.Tensor], torch.Tensor]],
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Pipelined loop fusion (paper §2.4): consecutive elementwise phases
    as one callable.  Eagerly each phase is still its own pass; a fused
    kernel (or a compiler) runs them as one loop with one fill/drain.  The
    helper documents the transformation and lets tests compare fused and
    phase-at-a-time execution."""

    def fused(x: torch.Tensor) -> torch.Tensor:
        for p in phases:
            x = p(x)
        return x

    return fused


def flatten_grid(shape: Sequence[int]
                 ) -> Tuple[int, Callable[[torch.Tensor],
                                          Tuple[torch.Tensor, ...]]]:
    """Pipelined loop flattening (paper §2.5, Lst. 7 + §2.7 Lst. 8).

    Returns the collapsed trip count and the function that maps the flat
    index back to per-dimension indices (row-major), as a persistent
    kernel walks its flattened tiles."""
    total = 1
    for s in shape:
        total *= int(s)

    def unflatten(flat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        idx = []
        rem = flat
        for s in reversed(shape):
            idx.append(rem % s)
            rem = rem // s
        return tuple(reversed(idx))

    return total, unflatten
