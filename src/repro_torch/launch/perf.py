"""Perf-iteration driver: the port of ``repro/launch/perf.py``.

Runs one (arch x shape) cell's cost pipeline (``launch/dryrun.py``, on
``meta``) under a named VARIANT -- a set of transformation knobs -- and
appends the roofline terms (the H100 SXM data sheet's model) to
``build/perf/<cell>.jsonl``.  Diffs between rows are the modelled effect
of one change.

Knobs (all optional; defaults reproduce the baseline):
  remat=full|dots|none        activation-checkpoint policy
  rwkv_chunk=INT              WKV chunk length
  rwkv_intra=STR              WKV intra-chunk form
  fsdp=0|1                    weight striping over `data` on/off
  capacity=FLOAT              MoE capacity factor
  microbatches=INT            gradient-accumulation splits (train cells)
  xent_chunks=INT             sequence tiles for the loss
  seq_shard=0|1               Megatron-SP striping of the residual
                              (dryrun.make_constrain; default 1)
  attn_seq=0|1                MeshRules.attn_prefer_seq: q/k/v stay
                              sequence-striped at attention entry
  embed_stripe=0|1            MeshRules.stripe_embed: the embedding and
                              head also stripe d over `data` (default 1)

JAX's ``block_kv`` knob (the reference lowering's KV tile) is not one:
the port's attention kernels keep their own tiles, so no tile of the
dry run's would be read.

Usage:
  python -m repro_torch.launch.perf --arch gemma-2b --shape train_4k \\
      --name dots remat=dots
"""
import argparse
import dataclasses
import json
import time
from pathlib import Path

from ..configs import SHAPES, get_arch
from ..models.transformer import ExecOptions, Model
from ..runtime.sharding import make_rules
from . import dryrun
from .mesh import make_production_mesh

RESULTS = Path(__file__).resolve().parents[3] / "build" / "perf"


@dataclasses.dataclass
class Variant:
    """A set of knobs, at JAX's defaults."""
    name: str = "baseline"
    remat: str = "full"
    rwkv_chunk: int = 0
    rwkv_intra: str = ""         # "" = config default
    fsdp: bool = True
    seq_shard: bool = True
    embed_stripe: bool = True
    attn_seq: bool = False
    capacity: float = 0.0
    microbatches: int = 1
    xent_chunks: int = 8
    mem_proof: bool = False      # also run the full-depth memory run


def check_variant(v: Variant) -> None:
    if v.remat not in ("full", "dots", "none"):
        raise ValueError(f"remat {v.remat!r} (full, dots or none)")


def apply_variant(cfg, shape, v: Variant, rules):
    """(cfg, ExecOptions) of the variant on ``rules``' mesh."""
    check_variant(v)
    if v.rwkv_chunk:
        cfg = dataclasses.replace(cfg, rwkv_chunk=v.rwkv_chunk)
    if v.rwkv_intra:
        cfg = dataclasses.replace(cfg, rwkv_intra=v.rwkv_intra)
    if v.capacity:
        cfg = dataclasses.replace(cfg, capacity_factor=v.capacity)
    bq, bkv = dryrun.block_sizes(shape.seq_len)
    opts = ExecOptions(
        block_q=bq, block_kv=bkv, remat=v.remat != "none",
        remat_policy=v.remat if v.remat != "none" else "full",
        constrain=dryrun.make_constrain(rules) if v.seq_shard else None,
        attn_constrain=dryrun.attn_hook(rules), moe_mesh=rules.mesh, moe_dp_axes=rules.dp_axes,
        moe_ep_axes=rules.ep_axes,
        expert_pad=rules.axis_size(rules.ep_axes),
        xent_chunks=v.xent_chunks)
    return cfg, opts


def run_variant(arch: str, shape_name: str, v: Variant, log=print,
                out_dir: Path = RESULTS):
    check_variant(v)
    cfg0 = get_arch(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh()
    rules = dataclasses.replace(make_rules(mesh, fsdp=v.fsdp),
                                stripe_embed=v.embed_stripe,
                                attn_prefer_seq=v.attn_seq)
    chips = mesh.size

    def builder(cfg, shape_, rules_, dt):
        cfg_v, opts = apply_variant(cfg, shape_, v, rules_)
        return Model(cfg_v, dt=dt, device="meta", opts=opts)

    t0 = time.time()
    ct = dryrun.cost_terms(cfg0, shape, rules, log=log, builder=builder,
                           microbatches=v.microbatches)
    rl = dryrun.roofline_of(f"{arch}--{shape_name}--{v.name}", ct, chips,
                            dryrun.model_flops(cfg0, shape))
    row = {"variant": dataclasses.asdict(v), "arch": arch,
           "shape": shape_name, "roofline": rl.to_dict(),
           "cost": ct, "wall_s": round(time.time() - t0, 1),
           **dryrun.departures(shape)}
    if v.mem_proof:
        row["mem"] = dryrun.analyze_cell(cfg0, shape, rules, "mem",
                                         builder=builder)

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{arch}--{shape_name}.jsonl"
    with out.open("a") as f:
        f.write(json.dumps(row, default=str) + "\n")
    log(f"[{v.name}] compute={rl.compute_s:.3f}s mem={rl.memory_s:.3f}s "
        f"coll={rl.collective_s:.3f}s dominant={rl.dominant} "
        f"step={rl.step_s:.3f}s frac={rl.roofline_fraction:.4f} "
        "(H100 SXM data-sheet model)")
    return row


def parse_knobs(knobs) -> dict:
    """``key=value`` strings to Variant fields, typed by the defaults."""
    defaults = Variant()
    kw = {}
    for k in knobs:
        key, val = k.split("=", 1)
        if key not in Variant.__dataclass_fields__:
            raise SystemExit(f"unknown knob {key!r}")
        kind = type(getattr(defaults, key))
        kw[key] = val in ("1", "true", "True") if kind is bool else kind(val)
    return kw


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--name", default="baseline")
    ap.add_argument("--mem-proof", action="store_true")
    ap.add_argument("--out", type=Path, default=RESULTS)
    ap.add_argument("knobs", nargs="*", help="key=value overrides")
    args = ap.parse_args(argv)
    v = Variant(name=args.name, mem_proof=args.mem_proof,
                **parse_knobs(args.knobs))
    return run_variant(args.arch, args.shape, v, out_dir=args.out)


if __name__ == "__main__":
    main()
