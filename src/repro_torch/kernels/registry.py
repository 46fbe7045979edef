"""The op registry: one ``OpSpec`` per kernel, the one table that
``kernels.dispatch``, the public ops and the tuner read -- the port of
``repro/kernels/registry.py``.

Each op declares:

* ``plain`` -- its plain PyTorch version (the JAX ``reference``), which
  the CPU runs and the tests hold the kernel to;
* ``kernel`` -- the wrapper of its hand-written CUDA kernel, which
  counts its launches;
* ``eligible`` -- what the kernel takes (shapes, dtypes, layouts),
  whatever the device: the route is chosen by the tensors' device alone
  and a kernel raises on what it does not take, so this predicate routes
  nothing; it states the contract the examples are checked against;
* ``plan_shape`` / ``plan_kernel`` / ``plan_dtype`` -- the tuned-plan key:
  the shape the kernel's heuristic plan reads (never the rows of a GEMM
  or the batch of an attention call), the plan namespace (B1's grouped
  route shares ``matmul``'s; the int8 attention branches share the float
  ones', keyed by the pools' dtype) and the key's dtype;
* ``tune`` -- a ``TuneSpec`` (inputs at a tune cell's shape, the timed
  call, default dtype and cells) that ``tune.tuner`` sweeps;
* ``stats_op`` -- its route-counter name;
* ``example`` / ``bad_example`` -- a small call on the CPU, and one the
  kernel refuses;
* ``tp`` -- the tensor-parallel contracts its calls may be tagged with.

The counters live here: ``stats()`` by (op, route), route ``kernel`` or
``plain``; ``tp_stats()`` the same inside a ``tp_scope``; and
``plan_source_stats()`` by (op, route, source), where the kernel route's
source is the tuned plan's lookup (``exact``, ``nearest``,
``heuristic``; ``explicit`` for a public op's dict plan).  The plain
route resolves no plan.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from collections import Counter
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..core.plan import Level
from ..tune import cache as tune_cache
from .attention import (decode_attention_cuda, decode_attention_int8_cuda,
                        decode_attention_plain, flash_attention_bwd_cuda,
                        flash_attention_bwd_plain, flash_attention_cuda,
                        flash_attention_plain, prefill_attention_cuda,
                        prefill_attention_int8_cuda, prefill_attention_plain)
from .attention.decode import _check_paged
from .attention.flash import check_bhsd, check_route
from .attention.prefill import prefill_route
from .histogram.histogram import histogram_cuda, histogram_plain
from .matmul import (grouped_matmul_cuda, grouped_matmul_plain, matmul_cuda,
                     matmul_plain, quantized_matmul_cuda,
                     quantized_matmul_plain)
from .matmul.matmul import TILE_K, check_operands, grouped_route
from .nbody.nbody import nbody_accel_cuda, nbody_accel_plain
from .stencil.stencil import jacobi4_cuda, jacobi4_plain
from .wkv.wkv import wkv_bwd_cuda, wkv_bwd_plain, wkv_cuda, wkv_plain


@dataclasses.dataclass(frozen=True)
class TuneSpec:
    """How the tuner sweeps an op: its plan space, inputs, timed call."""

    space: Callable[..., list]            # (key shape, dtype) -> plans
    make_inputs: Callable[..., tuple]     # (shape, dtype, device) -> args
    call: Callable[..., Any]              # (args, plan dict) -> output
    default_dtype: torch.dtype
    default_shapes: Tuple[Tuple[int, ...], ...]


@dataclasses.dataclass(frozen=True)
class TPContract:
    """One way an op takes part in tensor parallelism: which dimension of
    each positional argument is this rank's shard (``None``: replicated),
    the collective that completes the op (``none``, ``psum`` or
    ``all_gather``) and the output dimension an ``all_gather``
    concatenates."""

    in_axes: Tuple[Optional[int], ...] = ()
    collective: str = "none"                # none | psum | all_gather
    gather_axis: int = 0

    def __post_init__(self):
        if self.collective not in ("none", "psum", "all_gather"):
            raise ValueError(
                f"TPContract collective must be none|psum|all_gather, "
                f"got {self.collective!r}")


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One kernel's dispatch and tuning contract (see the module doc)."""

    name: str
    plain: Callable
    kernel: Callable
    eligible: Callable[..., bool]            # (*args) -> bool
    # the model's calls reach it through kernels.dispatch (the others
    # are library ops)
    dispatched: bool = False
    plan_shape: Optional[Callable] = None    # (*args) -> int tuple or None
    plan_kernel: Optional[str] = None        # plan namespace (default name)
    plan_dtype: Optional[Callable] = None    # (*args) -> key dtype
    tune: Optional[TuneSpec] = None
    stats_op: Optional[str] = None           # route-counter name
    example: Optional[Callable] = None       # (dtype) -> (args, kwargs)
    bad_example: Optional[Callable] = None   # () -> (args, kwargs)
    tp: Optional[Dict[str, TPContract]] = None

    @property
    def namespace(self) -> str:
        return self.plan_kernel or self.name

    def key(self, *args) -> Optional[Tuple[Tuple[int, ...], Any]]:
        """(key shape, key dtype) of a call, or None where its route takes
        no plan."""
        shape = None if self.plan_shape is None else self.plan_shape(*args)
        if shape is None:
            return None
        dtype = (self.plan_dtype(*args) if self.plan_dtype is not None
                 else args[0].dtype)
        return shape, dtype


# ------------------------------------------------------------ the registry
_REGISTRY: Dict[str, OpSpec] = {}


def register(spec: OpSpec) -> OpSpec:
    if not isinstance(spec, OpSpec):
        raise TypeError(f"register() wants an OpSpec, got {type(spec)}")
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> OpSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown op {name!r}; registered: {sorted(_REGISTRY)}") from None


def ops() -> Dict[str, OpSpec]:
    """All registered OpSpecs, in registration order."""
    return dict(_REGISTRY)


def dispatchable() -> Dict[str, OpSpec]:
    """Ops the model's calls reach through ``kernels.dispatch``."""
    return {n: s for n, s in _REGISTRY.items() if s.dispatched}


def tunable() -> Dict[str, OpSpec]:
    """Ops the tuner sweeps (``tune.tuner`` enumerates from this)."""
    return {n: s for n, s in _REGISTRY.items() if s.tune is not None}


def tp_contracts() -> Dict[str, Dict[str, Any]]:
    """{op: {tag: None | "psum" | ("all_gather", dim)}}: each op's
    completing collective by tp tag, as ``dispatch`` applies them."""
    out = {}
    for name, spec in _REGISTRY.items():
        if spec.tp:
            out[name] = {
                tag: (None if c.collective == "none" else "psum"
                      if c.collective == "psum" else
                      (c.collective, c.gather_axis))
                for tag, c in spec.tp.items()}
    return out


# ------------------------------------------------------------------- stats
_stats: Counter = Counter()
# (op, route) counters ticked only inside a tp_scope: the probe that the
# ops ran inside the sharded step
_tp_stats: Counter = Counter()
_plan_stats: Counter = Counter()
_tp_group = None


def reset_stats() -> None:
    _stats.clear()
    _tp_stats.clear()
    _plan_stats.clear()


def stats() -> Dict[Tuple[str, str], int]:
    return dict(_stats)


def tp_stats() -> Dict[Tuple[str, str], int]:
    """The (op, route) counts of calls made inside a ``tp_scope``."""
    return dict(_tp_stats)


def plan_source_stats() -> Dict[Tuple[str, str, str], int]:
    """(op, route, source) counts of the calls that resolved a plan."""
    return dict(_plan_stats)


@contextlib.contextmanager
def stats_scope():
    """Isolated counter scope: zeroed on entry, restored on exit."""
    saved = (Counter(_stats), Counter(_tp_stats), Counter(_plan_stats))
    reset_stats()
    try:
        yield stats
    finally:
        reset_stats()
        for counter, before in zip((_stats, _tp_stats, _plan_stats), saved):
            counter.update(before)


def count_route(op: str, route: str) -> None:
    key = (op, route)
    _stats[key] += 1
    if _tp_group is not None:
        _tp_stats[key] += 1


def count_plan_source(op: str, route: str, source: str) -> None:
    _plan_stats[(op, route, source)] += 1


def tp_group():
    """The group of the active ``tp_scope``, or None outside one."""
    return _tp_group


@contextlib.contextmanager
def tp_scope(group):
    """Run the ops called inside as one tensor-parallel shard over
    ``group`` (a ``runtime.collectives.Group``): tagged calls complete
    themselves with their contract's collective, and every call ticks
    ``tp_stats``."""
    global _tp_group
    prev = _tp_group
    _tp_group = group
    try:
        yield
    finally:
        _tp_group = prev


# ------------------------------------------------------- the public ops
def route(name: str, *args, level=Level.T3_REPLICATED,
          plan="heuristic") -> Tuple[bool, Optional[Dict[str, Any]]]:
    """(kernel route?, plan kwargs) of a public op's call, counted.

    An explicit ``level`` below T2 runs the plain version on any device,
    counted as route ``plain``, as the JAX ladder runs its oracle at T0
    and T1; otherwise the device of ``args[0]`` decides
    (``dispatch._on_card``).  On the kernel route ``plan`` resolves as
    ``tune.cache.resolve_plan`` does (``"heuristic"``, ``"tuned"``, a
    dict), counted with its source; a plan dict's ``level`` overrides the
    caller's.  The plain route resolves nothing."""
    from . import dispatch
    spec = get(name)
    op = spec.stats_op or name
    if isinstance(plan, dict) and "level" in plan:
        plan = dict(plan)
        level = Level(plan.pop("level"))
    if level < Level.T2_VECTORIZED:
        count_route(op, "plain")
        return False, None
    if not dispatch._on_card(op, args[0]):
        return False, None
    key = spec.key(*args)
    if key is None:                 # this call's route takes no plan
        explicit = isinstance(plan, dict)
        kwargs = plan if explicit else None
        source = "explicit" if explicit else "heuristic"
    else:
        _, kwargs, source = tune_cache.resolve_plan_source(
            spec.namespace, key[0], key[1], level, plan)
    count_plan_source(op, "kernel", source)
    return True, kwargs or None


# ------------------------------------------------------------ declarations
def _ok(check: Callable[[], Any]) -> bool:
    try:
        return check() is not False
    except (ValueError, TypeError, KeyError, IndexError):
        return False


def _gen(device, seed: int = 0) -> Optional[torch.Generator]:
    """A seeded generator on ``device``; none on ``meta``, where inputs
    have shapes only (the tests read a cell's plan key from them)."""
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def _randn(gen, shape, dtype, device, scale: float = 1.0) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=device)
            * scale).to(dtype)


# -- B1 ------------------------------------------------------------------
def _matmul_inputs(shape, dtype, device="cuda"):
    m, k, n = shape
    gen = _gen(device)
    return (_randn(gen, (m, k), dtype, device),
            _randn(gen, (k, n), dtype, device, 1 / math.sqrt(k)))


def _matmul_eligible(a, b) -> bool:
    return _ok(lambda: (check_operands(a, b), TILE_K[a.dtype]))


def _grouped_inputs(shape, dtype, device="cuda"):
    g, c, k, n = shape
    gen = _gen(device)
    return (_randn(gen, (g, c, k), dtype, device),
            _randn(gen, (g, k, n), dtype, device, 1 / math.sqrt(k)))


def _grouped_eligible(x, w) -> bool:
    def check():
        if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
                or x.shape[2] != w.shape[1] or x.dtype != w.dtype:
            return False
        kmajor = x.is_contiguous()
        if not kmajor and not (x.dtype == torch.bfloat16
                               and x.transpose(1, 2).is_contiguous()):
            return False
        grouped_route(x.dtype, kmajor, w.stride(2) != 1)
        return 1 in w.stride()[1:] and x.dtype in TILE_K
    return _ok(check)


def _grouped_key(x, w):
    """The tile route's split plan reads (G, K, N); the short tile (the
    backward's layouts) takes no plan."""
    if grouped_route(x.dtype, x.is_contiguous(),
                     w.stride(2) != 1) == "wgmma_short":
        return None
    return (x.shape[0], x.shape[2], w.shape[2])


# -- B5 ------------------------------------------------------------------
def _quantized_inputs(shape, dtype, device="cuda"):
    from ..core.quant import quantize_channelwise
    m, k, n = shape
    gen = _gen(device)
    q, scale = quantize_channelwise(
        torch.randn((k, n), generator=gen, device=device) / math.sqrt(k))
    return _randn(gen, (m, k), dtype, device), q, scale


def _quantized_eligible(a, b_q, b_scale) -> bool:
    return (a.dim() == 2 and b_q.dim() == 2 and a.shape[1] == b_q.shape[0]
            and tuple(b_scale.shape) == (b_q.shape[1],)
            and a.dtype in TILE_K and b_q.dtype == torch.int8
            and b_scale.dtype == torch.float32)


# -- B2/B4a, B3/B4b ------------------------------------------------------
def _pools(gen, b, hkv, hd, page, n_pages, dtype, device, int8):
    """Pools of b * n_pages pages (plus an unused page 0) and a table
    that gives each slot its own pages, shuffled."""
    n_pool = b * n_pages + 1
    shape = (n_pool, page, hkv, hd)
    table = (1 + torch.randperm(b * n_pages, generator=gen, device=device)
             ).reshape(b, n_pages).to(torch.int32)
    if not int8:
        return (_randn(gen, shape, dtype, device),
                _randn(gen, shape, dtype, device), table, ())
    pools = [torch.randint(-127, 128, shape, generator=gen, device=device,
                           dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand((n_pool, hkv), generator=gen, device=device) / 64
              + 1e-3 for _ in range(2)]
    return pools[0], pools[1], table, tuple(scales)


def _decode_inputs(int8: bool):
    def make(shape, dtype, device="cuda"):
        b, h, hkv, hd, page, n_pages = shape
        gen = _gen(device)
        kp, vp, table, scales = _pools(gen, b, hkv, hd, page, n_pages,
                                       dtype, device, int8)
        lengths = torch.full((b,), n_pages * page, dtype=torch.int32,
                             device=device)
        return (_randn(gen, (b, h, hd), dtype, device), kp, vp, table,
                lengths, *scales)
    return make


def _prefill_inputs(int8: bool):
    def make(shape, dtype, device="cuda"):
        b, c, h, hkv, hd, page, n_pages = shape
        gen = _gen(device)
        kp, vp, table, scales = _pools(gen, b, hkv, hd, page, n_pages,
                                       dtype, device, int8)
        starts = torch.full((b,), max(0, n_pages * page - c),
                            dtype=torch.int32, device=device)
        return (_randn(gen, (b, c, h, hd), dtype, device), kp, vp, table,
                starts, *scales)
    return make


def _paged_eligible(q_heads_dim: int):
    def eligible(q, k_pages, v_pages, table, lens, *scales) -> bool:
        return _ok(lambda: _check_paged("paged", q, k_pages, v_pages, table,
                                        lens, q_heads_dim, *scales,
                                        device=False))
    return eligible


def _decode_key(q, k_pages, v_pages, table, *rest):
    return (table.shape[1], k_pages.shape[1], k_pages.shape[2])


def _prefill_key(q, k_pages, v_pages, table, *rest):
    b, c, h, hd = q.shape
    hkv = k_pages.shape[2]
    if prefill_route(q.dtype, hd, h // hkv) != "wgmma":
        return None                 # the simt route takes no plan
    return (table.shape[1], k_pages.shape[1], hkv, h // hkv, c, hd)


def _pool_dtype(q, k_pages, *rest):
    return k_pages.dtype


# -- B6/B7 ---------------------------------------------------------------
def _flash_inputs(shape, dtype, device="cuda"):
    gen = _gen(device)
    return tuple(_randn(gen, shape, dtype, device) for _ in range(3))


def _flash_bwd_inputs(shape, dtype, device="cuda"):
    q, k, v = _flash_inputs(shape, dtype, device)
    o, lse = flash_attention_plain(q, k, v, return_lse=True)
    do = torch.randn(shape, generator=_gen(device, 1), device=device)
    return q, k, v, o, lse, do


def _flash_eligible(bwd: bool):
    def eligible(q, k, v, *rest) -> bool:
        return _ok(lambda: (check_bhsd("flash", q, k, v),
                            check_route("flash", q.dtype, q.shape[-1], bwd)))
    return eligible


# -- B8 ------------------------------------------------------------------
def _wkv_inputs(shape, dtype, device="cpu"):
    b, s, h, hd = shape
    gen = _gen(device)
    r, k, v = (_randn(gen, shape, dtype, device) for _ in range(3))
    lw = -torch.rand(shape, generator=gen, device=device)
    u = torch.randn((h, hd), generator=gen, device=device)
    return r, k, v, lw, u


def _wkv_eligible(r, k, v, lw, u, *rest) -> bool:
    return (r.dim() == 4 and k.shape == v.shape == r.shape == lw.shape
            and r.dtype == k.dtype == v.dtype and r.dtype in TILE_K
            and tuple(u.shape) == tuple(r.shape[2:]))


# -- B9-B11 --------------------------------------------------------------
def _stencil_inputs(shape, dtype, device="cuda"):
    return (_randn(_gen(device), shape, dtype, device),)


def _nbody_inputs(shape, dtype, device="cuda"):
    (n,) = shape
    gen = _gen(device)
    return (torch.randn((3, n), generator=gen, device=device),
            torch.rand((n,), generator=gen, device=device) + 0.5)


def _histogram_inputs(shape, dtype, device="cuda"):
    n, n_bins = shape
    return (torch.randint(0, n_bins, (n,), generator=_gen(device),
                          device=device, dtype=torch.int32), n_bins)


def _call_with_plan(kernel):
    return lambda args, plan: kernel(*args, plan=plan or None)


def _call(kernel):
    return lambda args, plan: kernel(*args)


def _space(namespace: str) -> Callable[..., list]:
    """``tune.space.SPACES[namespace]``, looked up at the call: the space
    module imports the kernel packages, whose public ops import
    ``dispatch`` and with it this module."""
    def space(shape, dtype=None, **kwargs):
        from ..tune.space import SPACES
        return SPACES[namespace](shape, dtype, **kwargs)
    space.__name__ = f"{namespace}_space"
    return space


def _tune(namespace: str, make_inputs, call, default_dtype,
          shapes) -> TuneSpec:
    return TuneSpec(space=_space(namespace), make_inputs=make_inputs,
                    call=call, default_dtype=default_dtype,
                    default_shapes=tuple(tuple(s) for s in shapes))


def _small(make_inputs, shape):
    """An example: ``make_inputs`` at a small shape on the CPU."""
    return lambda dtype: (make_inputs(shape, dtype, "cpu"), {})


BF16, F32 = torch.bfloat16, torch.float32
# the tune cells: the shapes the port's main paths launch (PERF.md §6):
# gemma-2b's weights at M = 4 and the tp = 2 shards (gemma-2b's wq,
# codeqwen1.5-7b's row-parallel wd); qwen2-moe-a2.7b's experts at decode
# capacity; 256-key and 8192-key tables at gemma-2b's heads
GEMMA_WEIGHTS = ((2048, 2048), (2048, 256), (2048, 16384), (16384, 2048))
MATMUL_CELLS = tuple((4, k, n) for k, n in GEMMA_WEIGHTS) + (
    (4, 2048, 1024), (4, 6720, 4096))
GROUPED_CELLS = ((60, 8, 2048, 1408), (60, 8, 1408, 2048))
DECODE_CELLS = ((4, 8, 1, 256, 64, 4), (4, 8, 1, 256, 64, 128))
PREFILL_CELLS = ((2, 64, 8, 1, 256, 64, 4), (4, 64, 8, 1, 256, 64, 128))

_MATMUL_TP = {"col": TPContract(in_axes=(None, 1)),
              "row": TPContract(in_axes=(-1, 0), collective="psum")}

register(OpSpec(
    name="matmul", plain=matmul_plain, kernel=matmul_cuda,
    eligible=_matmul_eligible, dispatched=True,
    plan_shape=lambda a, b: (a.shape[1], b.shape[1]),
    tune=_tune("matmul", _matmul_inputs, _call_with_plan(matmul_cuda), BF16,
               MATMUL_CELLS),
    example=_small(_matmul_inputs, (5, 40, 24)),
    bad_example=lambda: ((torch.ones(4, 8), torch.ones(6, 5)), {}),
    tp=_MATMUL_TP))
register(OpSpec(
    name="grouped_matmul", plain=grouped_matmul_plain,
    kernel=grouped_matmul_cuda, eligible=_grouped_eligible,
    dispatched=True, plan_shape=_grouped_key, plan_kernel="matmul",
    tune=_tune("matmul", _grouped_inputs,
               _call_with_plan(grouped_matmul_cuda), BF16, GROUPED_CELLS),
    example=_small(_grouped_inputs, (3, 4, 40, 24)),
    bad_example=lambda: ((torch.ones(2, 4, 8), torch.ones(3, 8, 5)), {})))
register(OpSpec(
    name="quantized_matmul", plain=quantized_matmul_plain,
    kernel=quantized_matmul_cuda, eligible=_quantized_eligible,
    dispatched=True, plan_shape=lambda a, q, s: (a.shape[1], q.shape[1]),
    tune=_tune("quantized_matmul", _quantized_inputs,
               _call_with_plan(quantized_matmul_cuda), BF16,
               MATMUL_CELLS[:4]),
    example=_small(_quantized_inputs, (5, 40, 24)),
    bad_example=lambda: ((torch.ones(4, 8), torch.ones(8, 5),
                          torch.ones(5)), {}),
    tp={"col": TPContract(in_axes=(None, 1, 0)),
        "row": TPContract(in_axes=(-1, 0, None), collective="psum")}))
for _name, _kernel, _int8 in (
        ("decode_attention", decode_attention_cuda, False),
        ("decode_attention_int8", decode_attention_int8_cuda, True)):
    register(OpSpec(
        name=_name, plain=decode_attention_plain, kernel=_kernel,
        eligible=_paged_eligible(1), dispatched=True,
        plan_shape=_decode_key, plan_kernel="decode_attention",
        plan_dtype=_pool_dtype,
        tune=_tune("decode_attention", _decode_inputs(_int8),
                   _call_with_plan(_kernel), BF16, DECODE_CELLS),
        example=_small(_decode_inputs(_int8), (3, 4, 2, 16, 8, 3)),
        bad_example=lambda: ((torch.ones(2, 3, 8), torch.ones(5, 4, 2, 8),
                              torch.ones(5, 4, 2, 8),
                              torch.zeros(2, 2, dtype=torch.int32),
                              torch.ones(2, dtype=torch.int32)), {}),
        tp=None if _int8 else {"heads": TPContract(
            in_axes=(1, 2, 2, None, None), collective="all_gather",
            gather_axis=1)}))
for _name, _kernel, _int8 in (
        ("prefill_attention", prefill_attention_cuda, False),
        ("prefill_attention_int8", prefill_attention_int8_cuda, True)):
    register(OpSpec(
        name=_name, plain=prefill_attention_plain, kernel=_kernel,
        eligible=_paged_eligible(2), dispatched=True,
        plan_shape=_prefill_key, plan_kernel="prefill_attention",
        plan_dtype=_pool_dtype,
        tune=_tune("prefill_attention", _prefill_inputs(_int8),
                   _call_with_plan(_kernel), BF16, PREFILL_CELLS),
        example=_small(_prefill_inputs(_int8), (2, 4, 4, 2, 16, 8, 3)),
        bad_example=lambda: ((torch.ones(2, 4, 3, 8),
                              torch.ones(5, 4, 2, 8), torch.ones(5, 4, 2, 8),
                              torch.zeros(2, 2, dtype=torch.int32),
                              torch.ones(2, dtype=torch.int32)), {}),
        tp=None if _int8 else {"heads": TPContract(
            in_axes=(2, 2, 2, None, None), collective="all_gather",
            gather_axis=2)}))
register(OpSpec(
    name="flash_attention", plain=flash_attention_plain,
    kernel=flash_attention_cuda, eligible=_flash_eligible(False),
    dispatched=True, plan_shape=lambda q, k, v: tuple(q.shape),
    tune=_tune("flash_attention", _flash_inputs,
               _call(flash_attention_cuda), BF16, ((2, 8, 512, 256),)),
    stats_op="attention", example=_small(_flash_inputs, (2, 2, 12, 16)),
    bad_example=lambda: ((torch.ones(1, 2, 8, 16), torch.ones(1, 2, 4, 16),
                          torch.ones(1, 2, 8, 16)), {})))
register(OpSpec(
    name="flash_attention_bwd", plain=flash_attention_bwd_plain,
    kernel=flash_attention_bwd_cuda, eligible=_flash_eligible(True),
    dispatched=True, plan_shape=lambda q, *rest: tuple(q.shape),
    tune=_tune("flash_attention_bwd", _flash_bwd_inputs,
               _call(flash_attention_bwd_cuda), BF16, ((2, 8, 512, 256),)),
    stats_op="attention_bwd",
    example=_small(_flash_bwd_inputs, (2, 2, 12, 16)),
    bad_example=lambda: ((torch.ones(1, 2, 8, 512), torch.ones(1, 2, 8, 512),
                          torch.ones(1, 2, 8, 512)), {})))
register(OpSpec(
    name="wkv", plain=wkv_plain, kernel=wkv_cuda, eligible=_wkv_eligible,
    dispatched=True, example=_small(_wkv_inputs, (2, 16, 2, 8)),
    bad_example=lambda: (_wkv_inputs((2, 16, 2, 8), F32)[:4]
                         + (torch.ones(3, 8),), {})))
register(OpSpec(
    name="wkv_bwd", plain=wkv_bwd_plain, kernel=wkv_bwd_cuda,
    eligible=_wkv_eligible, dispatched=True,
    example=lambda dtype: (_wkv_inputs((2, 16, 2, 8), dtype)
                           + (torch.randn(2, 16, 2, 8),), {}),
    bad_example=lambda: (_wkv_inputs((2, 16, 2, 8), torch.float16)
                         + (torch.randn(2, 16, 2, 8),), {})))
register(OpSpec(
    name="stencil", plain=jacobi4_plain, kernel=jacobi4_cuda,
    eligible=lambda x: x.dim() == 2 and x.dtype in TILE_K,
    plan_shape=lambda x: tuple(x.shape),
    tune=_tune("stencil", _stencil_inputs, _call(jacobi4_cuda), F32,
               ((8192, 8192),)),
    example=_small(_stencil_inputs, (9, 13)),
    bad_example=lambda: ((torch.ones(2, 3, 4),), {})))
register(OpSpec(
    name="nbody", plain=nbody_accel_plain, kernel=nbody_accel_cuda,
    eligible=lambda pos, mass: (pos.dim() == 2 and pos.shape[0] == 3
                                and tuple(mass.shape) == (pos.shape[1],)
                                and pos.dtype == mass.dtype == F32),
    plan_shape=lambda pos, mass: (pos.shape[1],),
    tune=_tune("nbody", _nbody_inputs, _call_with_plan(nbody_accel_cuda),
               F32, ((16128,), (65536,))),
    example=_small(_nbody_inputs, (300,)),
    bad_example=lambda: ((torch.ones(2, 5), torch.ones(5)), {})))
register(OpSpec(
    name="histogram", plain=histogram_plain, kernel=histogram_cuda,
    eligible=lambda values, n_bins=256: (values.dim() == 1 and n_bins >= 1
                                         and values.dtype == torch.int32),
    plan_shape=lambda values, n_bins=256: (n_bins,),
    tune=_tune("histogram", _histogram_inputs,
               _call_with_plan(histogram_cuda), torch.int32,
               ((1 << 26, 256), (1 << 26, 1 << 20))),
    example=_small(_histogram_inputs, (1000, 37)),
    bad_example=lambda: ((torch.ones(3, 4, dtype=torch.int32), 8), {})))
