"""Roofline terms of one step, measured by running it on ``meta``: the
port of ``repro/roofline/analysis.py``.

JAX compiles the step and reads XLA's ``cost_analysis`` (FLOPs, bytes),
``memory_analysis`` (argument, temp and peak bytes) and the optimized
HLO text (the collectives).  PyTorch has no compiled program to read, so
``analyze_step`` runs the eager step on ``meta`` tensors, where nothing
is allocated and no kernel runs, and counts what it asks for:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (the products:
  matmul, bmm, einsum, convolution, attention), forward, backward and
  remat recompute alike.  On ``meta`` the dispatch takes each kernel's
  plain route (``kernels.dispatch._on_card`` tests ``is_cuda``), so the
  count is the work of the function each kernel computes;
* HBM bytes: every op's operand and output bytes, summed (views and
  ``empty`` allocations move nothing and are left out).  This is the
  eager program's unfused traffic, an upper bound on a fused program's;
  flash attention, one op a direction on ``meta``
  (``kernels/attention/meta.py``), counts its kernels' operands and
  outputs only;
* collective bytes: the collectives the step's ``RecordingGroup``s
  record (``runtime.collectives.recording``), under the ring model of
  ``CollectiveOp.per_chip_traffic``;
* argument bytes: the bytes of the step's tensor arguments (this rank's
  shards);
* peak bytes: the arguments plus the peak of the live set, each op's new
  output counted from its op until its storage is freed.

The ring model, ``CollectiveStats`` and ``combine_affine`` are the JAX
package's, unchanged:

    all-gather      (n-1)   * operand      (operand = local shard)
    reduce-scatter  (n-1)/n * operand      (operand = full local buffer)
    all-reduce    2*(n-1)/n * operand
    all-to-all      (n-1)/n * operand
    collective-permute        operand      (one hop)
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, Iterable, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..core import tree as tree_mod
from ..runtime import collectives


@dataclasses.dataclass
class CollectiveOp:
    op: str
    operand_bytes: int        # per partition; an all-gather's result
    group_size: int
    line: str = ""

    @property
    def per_chip_traffic(self) -> float:
        n = max(self.group_size, 1)
        b = self.operand_bytes
        if self.op == "all-gather":
            # the bytes are the *result*'s (gathered); operand = result/n
            return b / n * (n - 1)
        if self.op == "reduce-scatter":
            return b * (n - 1) / n
        if self.op == "all-reduce":
            return 2.0 * b * (n - 1) / n
        if self.op == "all-to-all":
            return b * (n - 1) / n
        return float(b)       # collective-permute: one hop


@dataclasses.dataclass
class CollectiveStats:
    per_chip_bytes: float                 # serialized link traffic a chip
    by_op: Dict[str, float]
    count: int
    schedule: List[str]

    @staticmethod
    def empty() -> "CollectiveStats":
        return CollectiveStats(0.0, {}, 0, [])


def collective_stats(ops: Iterable[CollectiveOp]) -> CollectiveStats:
    """The traffic of a list of collectives (JAX's ``collective_stats``
    after its HLO parse)."""
    by_op: Dict[str, float] = defaultdict(float)
    total = 0.0
    sched = []
    n = 0
    for o in ops:
        t = o.per_chip_traffic
        by_op[o.op] += t
        total += t
        n += 1
        sched.append(f"{o.op} {o.operand_bytes/1e6:.2f}MB x{o.group_size}")
    return CollectiveStats(total, dict(by_op), n, sched)


def combine_affine(base: Dict[str, float],
                   per_kind: Dict[str, Dict[str, float]],
                   kind_counts: Dict[str, int],
                   keys: Tuple[str, ...] = (
                       "flops_per_device", "hbm_bytes_per_device",
                       "collective_bytes_per_chip")) -> Dict[str, float]:
    """cost(full) = cost(0 layers) + sum_k count_k * (cost(1 layer of k) -
    cost(0 layers)): the affine extrapolation to full depth."""
    out = {}
    for key in keys:
        total = base.get(key, 0.0)
        for kind, counts in kind_counts.items():
            delta = per_kind[kind].get(key, 0.0) - base.get(key, 0.0)
            total += counts * delta
        out[key] = total
    return out


# --------------------------------------------------------------------------
# the meta run
# --------------------------------------------------------------------------

_EMPTY = {torch.ops.aten.empty.memory_format,
          torch.ops.aten.empty_like.default,
          torch.ops.aten.empty_strided.default,
          torch.ops.aten.new_empty.default,
          torch.ops.aten.new_empty_strided.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x: Any) -> List[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


class _Traffic(TorchDispatchMode):
    """Sums each op's operand and output bytes and follows the live set
    of the storages the ops create (freed when their storage is)."""

    def __init__(self, known: Sequence[torch.Tensor]):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._owned: Dict[int, int] = {}
        self._known = {t.untyped_storage()._cdata for t in known}

    def _free(self, key: int) -> None:
        self.live -= self._owned.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        in_storages = {t.untyped_storage()._cdata for t in ins}
        aliases = all(t.untyped_storage()._cdata in in_storages
                      for t in outs)
        moves = not (func.is_view or func in _EMPTY
                     or (aliases and not func._schema.is_mutable))
        if moves:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            storage = t.untyped_storage()
            key = storage._cdata
            if key in self._owned or key in self._known \
                    or key in in_storages:
                continue
            self._owned[key] = storage.nbytes()
            self.live += storage.nbytes()
            weakref.finalize(storage, self._free, key)
        self.peak = max(self.peak, self.live)
        return out


def argument_bytes(*args: Any) -> int:
    """The bytes of the tensors in ``args`` (each tensor once)."""
    return sum(_nbytes(t) for t in {id(t): t
                                    for t in _arg_tensors(args)}.values())


def _arg_tensors(args: Any) -> List[torch.Tensor]:
    return [x for x in tree_mod.leaves(args) if isinstance(x, torch.Tensor)]


def analyze_step(fn: Callable, *args: Any, chips: int = 1
                 ) -> Dict[str, Any]:
    """Run ``fn(*args)`` once on its (``meta``) arguments and return JAX's
    ``analyze_compiled`` keys: per-device FLOPs, HBM bytes and collective
    traffic, their totals over ``chips``, the collective count and its
    bytes by op, and the argument, temp (live-set peak) and peak bytes a
    device.  ``fn`` runs as given, so run it on ``meta`` tensors: on a
    device it would compute (and the peak would miss what the device's
    own allocator keeps)."""
    known = _arg_tensors(args)
    with collectives.recording() as recorded, \
            FlopCounterMode(display=False) as flops, \
            _Traffic(known) as traffic:
        fn(*args)
    ops = [CollectiveOp(op, nbytes, size) for op, nbytes, size in recorded]
    stats = collective_stats(ops)
    flops_dev = float(flops.get_total_flops())
    bytes_dev = float(traffic.bytes)
    args_dev = argument_bytes(*args)
    return {
        "flops_per_device": flops_dev,
        "hbm_bytes_per_device": bytes_dev,
        "collective_bytes_per_chip": stats.per_chip_bytes,
        "collective_count": stats.count,
        "collective_by_op": stats.by_op,
        "hlo_flops_total": flops_dev * chips,
        "hlo_bytes_total": bytes_dev * chips,
        "collective_bytes_total": stats.per_chip_bytes * chips,
        "argument_bytes_per_device": args_dev,
        "temp_bytes_per_device": int(traffic.peak),
        "peak_bytes_per_device": int(args_dev + traffic.peak),
    }
