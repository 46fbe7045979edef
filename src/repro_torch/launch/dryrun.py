"""Multi-pod dry run of the port: the port of ``repro/launch/dryrun.py``.

For every (architecture x input shape) cell this driver:

1. builds the production mesh -- (data=16, model=16) and, unless
   skipped, (pod=2, data=16, model=16) -- as an abstract mesh
   (``launch/mesh.make_production_mesh``): sizes seen from rank 0, no
   process group;
2. runs rank 0's full-depth step on ``meta`` with the state laid out by
   the port's rules (``runtime/sharding``): the sharded train step
   (``TrainSharding``), the prefill, or the one-token decode step on the
   rank's block of the dense cache (``MeshRules.cache_spec``), and
   records what it asks of the device and the wire
   (``roofline.analysis.analyze_step``): argument and peak bytes a
   device (fits the H100's 80 GB?) and the collectives;
3. runs the *cost* steps -- 0 layers, then 1 layer of each kind -- and
   extrapolates FLOPs, HBM bytes and collective bytes to full depth by
   the affine method (``roofline.analysis.combine_affine``), with the
   sequence slope for the rwkv layers past 4096 tokens;
4. writes one JSON per cell under ``build/dryrun/``, with the roofline
   terms of the H100 SXM's data-sheet peaks (``core.model.H100_SXM``):
   a model of the card, not a measurement.

Nothing is allocated and no kernel runs: on ``meta`` the dispatch takes
each kernel's plain route, so the counts are the work of the function
each kernel computes.  Flash attention is the exception: on ``meta`` its
forward and backward are ops that hold and move what the kernels do
(``kernels/attention/meta.py``), not the plain versions' dense scores.
``compile_seconds`` is the seconds the ``meta`` run took.

The models are JAX's: ``build_model`` sets the residual-stream hook
(``make_constrain``: Megatron-SP striping of the sequence over
``model``) and the q/k/v hook (``attn_hook``), and every cell's model
axis splits each layer's work (``runtime/model_axis.py``): its
per-device FLOPs are the step's over all chips.  The same builders make
the serving steps on real tensors over a host mesh
(``launch/mesh.make_host_mesh``): pass ``device``, ``dt`` and the whole
``params`` (and ``batch``, ``cache``) to ``prefill_step`` /
``serve_step``.

Departures from the JAX cells, written into each cell's JSON with what
the peak counts:

* ``collectives``: ``Group.psum`` is an all-gather and a sum in rank
  order, so it is counted as an all-gather (not a ring all-reduce), and
  ``reduce_scatter`` as the all-to-all it is.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs import ARCHS, SHAPES, get_arch, input_specs, shape_applicable
from ..configs.base import ArchConfig, ShapeSpec
from ..core.memory import DtypePolicy
from ..core.model import H100_SXM, Roofline
from ..models.transformer import ExecOptions, Model, param_counts
from ..optim.adamw import AdamWConfig
from ..roofline.analysis import analyze_step
from ..runtime.sharding import (MeshRules, make_rules, shard_state,
                                train_sharding, tree_specs)
from ..train.steps import (TrainStepConfig, abstract_train_state,
                           make_serve_step, make_train_step)
from .mesh import make_production_mesh

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

BIG_PARAM_THRESHOLD = 30e9      # archs above this get bf16 params + int8 Adam

DEPARTURES = {
    "collectives": "the port's psum is an all-gather plus a rank-order sum, "
                   "counted as an all-gather; reduce_scatter is an "
                   "all-to-all",
    "peak": "arguments plus the eager step's live set on meta: flash "
            "attention holds what its kernels hold (out and lse; dq, dk, "
            "dv and dO's bf16 halves), every other kernel its plain "
            "version's temporaries",
    "hardware_model": "the H100 SXM data sheet's peaks "
                      "(core.model.H100_SXM): a model, not a measurement",
}

Builder = Callable[[ArchConfig, ShapeSpec, MeshRules, DtypePolicy], Model]
Step = Tuple[Callable, Tuple[Any, ...], int]


def policy_for(cfg: ArchConfig, kind: str) -> Tuple[DtypePolicy, bool]:
    """(dtype policy, int8_moments): bf16 params to serve; bf16 params and
    int8 Adam moments to train an arch past ``BIG_PARAM_THRESHOLD``;
    else fp32 params."""
    big = param_counts(cfg)["total"] >= BIG_PARAM_THRESHOLD
    if kind in ("decode", "prefill_serve"):
        return DtypePolicy(param=torch.bfloat16), False
    if big:
        return DtypePolicy(param=torch.bfloat16), True
    return DtypePolicy(param=torch.float32), False


def block_sizes(seq: int) -> Tuple[int, int]:
    b = min(max(512, seq // 8), 4096)
    b = min(b, seq)
    return b, b


def microbatches(cfg: ArchConfig, mode: str) -> int:
    """Big archs, and deep big-vocab ones (>= 30 layers x >= 200k vocab),
    train the memory run in 4 microbatches; the cost runs take one
    full-size batch (FLOPs and bytes are linear in the batch)."""
    big = param_counts(cfg)["total"] >= BIG_PARAM_THRESHOLD
    deep_vocab = cfg.n_layers >= 30 and cfg.vocab_size >= 200_000
    return 4 if ((big or deep_vocab) and mode == "mem") else 1


def departures(shape: ShapeSpec) -> Dict[str, str]:
    """The departures a cell of ``shape`` records: the same for every
    kind of cell."""
    del shape
    return dict(DEPARTURES)


def make_constrain(rules: MeshRules) -> Callable:
    """The residual stream's layout (JAX's ``make_constrain``): the spec of
    a (B, S, d) activation -- batch over the data axes, sequence over
    ``model`` (Megatron-SP) -- or None where nothing fits.  The port's
    sharded step reads it (``TrainSharding.model_split``) and moves the
    residual into it; JAX constrains the array to it."""
    def con(shape):
        return rules.activation_spec(tuple(shape))
    return con


def attn_hook(rules: MeshRules) -> Callable:
    """q/k/v's layout at attention entry (JAX's ``attn_hook``, the
    Megatron SP -> TP transition): the spec of a (B, S, H, hd) tensor of
    ``role`` "q" or "k"/"v" by ``MeshRules.attn_spec`` -- heads over
    ``model`` when they divide it, else q over the sequence and k/v
    whole; under ``attn_prefer_seq`` q over the sequence with every head.
    The port's attention lays q/k/v out by it
    (``models/layers.attention_split``)."""
    def hook(shape, role):
        return rules.attn_spec(tuple(shape), role)
    return hook


def build_model(cfg: ArchConfig, shape: ShapeSpec, rules: MeshRules,
                dt: DtypePolicy) -> Model:
    """The cell's model on ``meta``: remat on, the JAX blocks, the
    residual and attention hooks, the MoE layers expert-parallel over the
    rules' EP axes."""
    bq, bkv = block_sizes(shape.seq_len)
    opts = ExecOptions(block_q=bq, block_kv=bkv, remat=True,
                       constrain=make_constrain(rules),
                       attn_constrain=attn_hook(rules),
                       moe_mesh=rules.mesh, moe_dp_axes=rules.dp_axes,
                       moe_ep_axes=rules.ep_axes,
                       expert_pad=rules.axis_size(rules.ep_axes))
    return Model(cfg, dt=dt, device="meta", opts=opts)


# --------------------------------------------------------------------------
# the steps
# --------------------------------------------------------------------------

def train_step(cfg: ArchConfig, shape: ShapeSpec, rules: MeshRules,
               mode: str, builder: Builder = build_model,
               mb: int = 0) -> Step:
    """The port's sharded train step (``TrainSharding``, rank 0) and its
    arguments: (params, opt) shards and the rank's rows of the batch, in
    ``mb`` microbatches (0: ``microbatches``' rule)."""
    dt, int8 = policy_for(cfg, "train")
    model = builder(cfg, shape, rules, dt)
    mb = mb or microbatches(cfg, mode)
    ts_cfg = TrainStepConfig(opt=AdamWConfig(int8_moments=int8),
                             microbatches=mb)
    params, opt = abstract_train_state(model, ts_cfg)
    shd = train_sharding(rules, params, shape.global_batch // mb)
    state = shard_state((params, opt), (shd.specs, tree_specs(rules, opt)),
                        rules.mesh)
    batch = shd.split_batch(input_specs(cfg, shape), mb)
    step = make_train_step(model, dataclasses.replace(ts_cfg,
                                                      grad_shardings=shd))
    return step, (*state, batch), rules.mesh.size


def _serving_model(cfg: ArchConfig, shape: ShapeSpec, rules: MeshRules,
                   builder: Builder, dt: Optional[DtypePolicy],
                   device, params, cache=None):
    """A serving model on ``device`` laid out on ``rules.mesh``: (the
    model, its ``TrainSharding``, this rank's shards of ``params`` (the
    whole tree; None: ``param_specs`` on meta), this rank's block of the
    whole dense cache ``cache`` by ``MeshRules.cache_spec``, or None)."""
    model = builder(cfg, shape, rules,
                    dt or policy_for(cfg, "decode")[0])
    whole = model.param_specs() if params is None else params
    shd = train_sharding(rules, whole, shape.global_batch, cache)
    model = Model(model.cfg, model.dt, device,
                  dataclasses.replace(model.opts, sharding=shd))
    block = None if cache is None \
        else shard_state(cache, shd.cache, rules.mesh)
    return model, shd, shard_state(whole, shd.specs, rules.mesh), block


def prefill_step(cfg: ArchConfig, shape: ShapeSpec, rules: MeshRules,
                 builder: Builder = build_model, *,
                 dt: Optional[DtypePolicy] = None, device="meta",
                 params=None, batch=None) -> Step:
    """Inference prefill: forward only, last-token logits (B, V) out, the
    same on every rank.  Its arguments are this rank's shards of
    ``params`` and its rows of the whole ``batch`` (default: the meta
    params and ``input_specs``)."""
    model, shd, local, _ = _serving_model(cfg, shape, rules, builder, dt,
                                          device, params)
    batch = shd.split_batch(input_specs(cfg, shape) if batch is None
                            else batch)

    @torch.no_grad()
    def step(params, batch):
        return model.prefill(params, batch)
    return step, (local, batch), rules.mesh.size


def serve_step(cfg: ArchConfig, shape: ShapeSpec, rules: MeshRules,
               builder: Builder = build_model, *,
               dt: Optional[DtypePolicy] = None, device="meta",
               params=None, batch=None, cache=None) -> Step:
    """One decode token for the rank's rows against its block of a dense
    cache of ``seq_len`` positions (``MeshRules.cache_spec``, as JAX's
    ``tree_shardings(kind="cache")``), at position ``pos`` (default the
    last).  Its arguments are this rank's shards of ``params``, its block
    of the whole ``cache`` (default: ``cache_specs`` on meta) and its
    rows of the whole ``batch``; the block is written in place."""
    dt = dt or policy_for(cfg, "decode")[0]
    if cache is None:
        cache = builder(cfg, shape, rules, dt).cache_specs(
            shape.global_batch, shape.seq_len)
    model, shd, local, block = _serving_model(cfg, shape, rules, builder,
                                              dt, device, params, cache)
    batch = shd.split_batch(input_specs(cfg, shape) if batch is None
                            else batch)
    fn = make_serve_step(model)

    @torch.no_grad()
    def step(params, cache, batch, pos: int = shape.seq_len - 1):
        return fn(params, cache, batch, pos)
    return step, (local, block, batch), rules.mesh.size


def cell_step(cfg: ArchConfig, shape: ShapeSpec, rules: MeshRules,
              mode: str, seq_override: Optional[int] = None,
              builder: Builder = build_model, mb: int = 0) -> Step:
    """(step, its arguments, chips) of a cell: ``mode`` "mem" (the full
    memory run) or "cost" (one batch, no microbatches unless ``mb``)."""
    if seq_override:
        shape = dataclasses.replace(shape, seq_len=seq_override)
    if shape.kind == "decode":
        return serve_step(cfg, shape, rules, builder)
    if shape.kind == "prefill":
        return prefill_step(cfg, shape, rules, builder)
    return train_step(cfg, shape, rules, mode, builder, mb)


def analyze_cell(cfg: ArchConfig, shape: ShapeSpec, rules: MeshRules,
                 mode: str, seq_override: Optional[int] = None,
                 builder: Builder = build_model, mb: int = 0
                 ) -> Dict[str, Any]:
    """``analyze_step`` of the cell's step (``cell_step``)."""
    fn, args, chips = cell_step(cfg, shape, rules, mode, seq_override,
                                builder, mb)
    return analyze_step(fn, *args, chips=chips)


# --------------------------------------------------------------------------
# affine cost extraction
# --------------------------------------------------------------------------

COST_KEYS = ("flops_per_device", "hbm_bytes_per_device",
             "collective_bytes_per_chip")


def _needs_seq_split(cfg: ArchConfig, kind, shape: ShapeSpec) -> bool:
    """An rwkv layer's cost is affine in S (no quadratic term in an SSM):
    past 4096 tokens it is measured at 2048 and 4096 and extrapolated,
    as in the JAX package."""
    return (kind[0] == "rwkv" and shape.kind != "decode"
            and shape.seq_len > 4096)


def cost_terms(cfg: ArchConfig, shape: ShapeSpec, rules: MeshRules,
               log=print, builder: Builder = build_model,
               microbatches: int = 0) -> Dict:
    """Base (0 layers), per-kind deltas (1 layer of the kind minus the
    base) and their affine totals at full depth.  ``builder`` makes each
    step's model (``launch/perf.py`` passes a variant's);
    ``microbatches`` splits a train cell's batch (0: one batch)."""
    counts = cfg.kind_counts()
    cache: Dict[Tuple, Dict] = {}

    def cost(kinds: Tuple, seq: Optional[int] = None) -> Dict:
        key = (kinds, seq)
        if key not in cache:
            t0 = time.time()
            res = analyze_cell(cfg.with_layers(kinds), shape, rules, "cost",
                               seq, builder, microbatches)
            log(f"    cost[{'+'.join('/'.join(k) for k in kinds) or 'base'}"
                f"{f'@S={seq}' if seq else ''}] "
                f"{time.time() - t0:.1f}s "
                f"flops/dev={res['flops_per_device']:.3g}")
            cache[key] = res
        return cache[key]

    base = cost(())
    totals = {k: base.get(k, 0.0) for k in COST_KEYS}
    per_kind = {}
    for kind, n in counts.items():
        if _needs_seq_split(cfg, kind, shape):
            s1, s2 = 2048, 4096
            b1, b2 = cost((), s1), cost((), s2)
            k1, k2 = cost((kind,), s1), cost((kind,), s2)
            delta = {}
            for key in COST_KEYS:
                d1 = k1.get(key, 0.0) - b1.get(key, 0.0)
                d2 = k2.get(key, 0.0) - b2.get(key, 0.0)
                slope = (d2 - d1) / (s2 - s1)
                delta[key] = d2 + slope * (shape.seq_len - s2)
        else:
            kc = cost((kind,))
            delta = {key: kc.get(key, 0.0) - base.get(key, 0.0)
                     for key in COST_KEYS}
        per_kind["/".join(kind)] = delta
        for key in COST_KEYS:
            totals[key] += n * delta[key]

    return {"base": {k: base.get(k, 0.0) for k in COST_KEYS},
            "per_kind": per_kind,
            "kind_counts": {"/".join(k): v for k, v in counts.items()},
            "totals": totals}


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS: 6 N D to train, 2 N D to serve (N active params)."""
    return ((6.0 if shape.kind == "train" else 2.0)
            * param_counts(cfg)["n_active"] * shape.tokens_per_step)


def roofline_of(name: str, ct: Dict, chips: int, mf: float) -> Roofline:
    t = ct["totals"]
    return Roofline(name=name, chips=chips,
                    hlo_flops=t["flops_per_device"] * chips,
                    hlo_bytes=t["hbm_bytes_per_device"] * chips,
                    collective_bytes=t["collective_bytes_per_chip"] * chips,
                    model_flops=mf, hw=H100_SXM)


# --------------------------------------------------------------------------
# cell driver
# --------------------------------------------------------------------------

def run_cell(arch, shape_name, *, multipod: bool = True,
             cost: bool = True, out_dir: Path = RESULTS_DIR,
             log=print, meshes: Optional[Dict[str, Any]] = None) -> Dict:
    """One cell's JSON (written to ``out_dir`` and returned).  ``arch``
    and ``shape_name`` are names, or an ``ArchConfig`` and a
    ``ShapeSpec``; ``meshes`` (name -> ``AbstractMesh``) replaces the
    production meshes, the first of them running the cost steps."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    arch, shape_name = cfg.name, shape.name
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{arch}--{shape_name}.json"
    result: Dict = {"arch": arch, "shape": shape_name,
                    "shape_detail": dataclasses.asdict(shape),
                    **departures(shape)}

    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        result["skipped"] = reason
        out_path.write_text(json.dumps(result, indent=2, default=str))
        log(f"[{arch} x {shape_name}] SKIP: {reason}")
        return result

    pc = param_counts(cfg)
    result["params"] = pc
    mf = model_flops(cfg, shape)
    result["model_flops"] = mf

    if meshes is None:
        meshes = {"pod": make_production_mesh(multi_pod=False)}
        if multipod:
            meshes["multipod"] = make_production_mesh(multi_pod=True)

    big = pc["total"] >= BIG_PARAM_THRESHOLD
    result["mesh"] = {}
    for mesh_name, mesh in meshes.items():
        fsdp_axes = ("pod", "data") if (big and mesh_name == "multipod") \
            else ("data",)
        ep_axes = ("pod", "model") if (big and mesh_name == "multipod") \
            else ("model",)
        rules = make_rules(mesh, fsdp=True, fsdp_axes=fsdp_axes,
                           ep_axes=ep_axes)
        t0 = time.time()
        res = analyze_cell(cfg, shape, rules, "mem")
        res["compile_seconds"] = round(time.time() - t0, 1)
        res["fits_hbm"] = bool(res["peak_bytes_per_device"]
                               <= H100_SXM.hbm_bytes)
        result["mesh"][mesh_name] = res
        log(f"[{arch} x {shape_name}] {mesh_name}: meta run in "
            f"{res['compile_seconds']}s; args/dev="
            f"{res['argument_bytes_per_device']/2**30:.2f} GiB peak/dev="
            f"{res['peak_bytes_per_device']/2**30:.2f} GiB "
            f"fits={res['fits_hbm']} collectives={res['collective_count']}")

    if cost:
        mesh = next(iter(meshes.values()))
        rules = make_rules(mesh, fsdp=True)
        ct = cost_terms(cfg, shape, rules, log=log)
        result["cost"] = ct
        rl = roofline_of(f"{arch}--{shape_name}", ct, mesh.size, mf)
        result["roofline"] = rl.to_dict()
        log(f"[{arch} x {shape_name}] roofline (H100 SXM data-sheet model): "
            f"compute={rl.compute_s:.4f}s mem={rl.memory_s:.4f}s "
            f"coll={rl.collective_s:.4f}s dominant={rl.dominant} "
            f"frac={rl.roofline_fraction:.3f}")

    out_path.write_text(json.dumps(result, indent=2, default=str))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-multipod", action="store_true")
    ap.add_argument("--no-cost", action="store_true")
    ap.add_argument("--out", type=Path, default=RESULTS_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    failures = []
    for arch, shape in cells:
        out_path = args.out / f"{arch}--{shape}.json"
        if args.skip_existing and out_path.exists():
            data = json.loads(out_path.read_text())
            if "error" not in data:
                print(f"[{arch} x {shape}] exists, skipping")
                continue
        try:
            run_cell(arch, shape, multipod=not args.no_multipod,
                     cost=not args.no_cost, out_dir=args.out)
        except Exception as e:  # noqa: BLE001 -- record, keep sweeping
            traceback.print_exc()
            failures.append((arch, shape, repr(e)))
            args.out.mkdir(parents=True, exist_ok=True)
            out_path.write_text(json.dumps(
                {"arch": arch, "shape": shape, "error": repr(e)}, indent=2))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print("\ndry-run OK")


if __name__ == "__main__":
    main()
