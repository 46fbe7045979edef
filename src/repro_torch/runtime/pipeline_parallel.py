"""Pipeline parallelism: streaming dataflow (§3.3) across a mesh axis --
the port of ``repro/runtime/pipeline_parallel.py``.

The paper's iterative-stencil design (replicated PEs joined by FIFO
channels, each computing one timestep) maps onto GPipe-style pipeline
parallelism: each stage (a contiguous group of layers) lives on one rank
of the ``stage`` axis, microbatches stream through, and the channel
between consecutive PEs is ``ppermute``.  With M microbatches and S
stages the fill/drain bubble is (S-1)/(M+S-1): the paper's pipeline
latency ``L`` in ``C = L + I*(N-1)``.

The schedule is JAX's rotating buffer: every rank runs the same program
for M + S - 1 ticks; stage 0 takes microbatch t, every stage passes its
output downstream, the last stage emits microbatch t - (S - 1), and a
masked psum hands the outputs to every rank.  Stage identity only masks
values (``torch.where``), so every rank builds the same graph and the
backward's ``ppermute``s pair up.  It is differentiable: the cotangents
flow back up the pipe through ``ppermute``'s transpose.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..core import tree
from . import collectives as coll


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x_microbatches: torch.Tensor, *,
                   mesh, stage_axis: str = "pod") -> torch.Tensor:
    """Run ``stage_fn`` as an S-stage pipeline over M microbatches.

    stage_params: this rank's stage slice, leaves (1, ...) (the
    ``P(stage_axis)`` shard of leaves stacked (S, ...)).  x_microbatches:
    (M, mb, ...), the same on every rank.  Returns (M, mb, ...), the last
    stage's outputs, on every rank.  M must be >= S."""
    group = mesh.group(stage_axis)
    n_stages = group.size
    m = x_microbatches.shape[0]
    if m < n_stages:
        raise ValueError(f"{m} microbatches for {n_stages} stages")
    params = tree.tree_map(lambda a: a[0], stage_params)
    dev = x_microbatches.device
    first = torch.tensor(group.index == 0, device=dev)
    last = torch.tensor(group.index == n_stages - 1, device=dev)
    state = torch.zeros_like(x_microbatches[0])
    outs = [None] * m
    for t in range(m + n_stages - 1):
        inp = torch.where(first, x_microbatches[min(t, m - 1)], state)
        out = stage_fn(params, inp)
        if t >= n_stages - 1:
            outs[t - (n_stages - 1)] = out
        # the FIFO channel to the next PE
        state = coll.ppermute(out, group)
    outs = torch.stack(outs)
    # only the last stage's outputs are real: one masked psum at the exit
    return coll.psum(torch.where(last, outs, torch.zeros_like(outs)), group)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """The pipeline model of §1.2 applied to the stage pipeline."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
