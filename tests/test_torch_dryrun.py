"""The port's dry run (``launch/dryrun.py``) and perf driver
(``launch/perf.py``) on a small abstract mesh: a cell's JSON keys and
departures, the skip record, the argument bytes a device against the
JAX package's sharding rules counted by hand, and the all-gathers the
sharded train step records against what those rules imply."""
import json
import math
import types
from collections import Counter

import jax
import pytest
import torch

from repro.configs.archs import ARCHS as JAX_ARCHS
from repro.models import transformer as jax_tfm
from repro.runtime.sharding import _path_str
from repro.runtime.sharding import make_rules as jax_make_rules
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun, perf
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.runtime import collectives
from repro_torch.runtime.sharding import make_rules

torch.set_num_threads(1)
MESH = ((2, 2), ("data", "model"))
TINY = ShapeSpec("train_tiny", 32, 4, "train")
JSON_KEYS = {"arch", "shape", "shape_detail", "params", "model_flops",
             "mesh", "cost", "roofline", "collectives", "hardware_model"}
MEM_KEYS = {"flops_per_device", "hbm_bytes_per_device",
            "collective_bytes_per_chip", "collective_count",
            "collective_by_op", "argument_bytes_per_device",
            "temp_bytes_per_device", "peak_bytes_per_device",
            "compile_seconds", "fits_hbm"}


def _mesh():
    return AbstractMesh(*MESH)


def test_production_meshes():
    pod, multi = make_production_mesh(), make_production_mesh(True)
    assert (pod.shape, pod.size) == ({"data": 16, "model": 16}, 256)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    group = pod.group(("data", "model"))
    assert group.size == 256 and group.index == 0 and not group.local
    assert pod.group("model").ranks == list(range(16))
    assert pod.group("data").ranks == list(range(0, 256, 16))


def test_run_cell_on_a_small_mesh(tmp_path):
    cfg = get_arch("gemma-2b").smoke()
    res = dryrun.run_cell(cfg, TINY, out_dir=tmp_path,
                          meshes={"small": _mesh()}, log=lambda *a: None)
    assert JSON_KEYS <= set(res)
    # every cell splits the model axis's work: no cell records a
    # model_axis departure
    assert "model_axis" not in res
    for kind in ("prefill", "decode"):
        assert "model_axis" not in dryrun.departures(
            ShapeSpec(f"{kind}_tiny", 32, 4, kind))
    assert "all-gather" in res["collectives"]
    mem = res["mesh"]["small"]
    assert MEM_KEYS <= set(mem) and mem["fits_hbm"]
    assert mem["collective_by_op"]["all-gather"] > 0
    assert mem["peak_bytes_per_device"] > mem["argument_bytes_per_device"]
    assert res["params"] == jax_tfm.param_counts(JAX_ARCHS["gemma-2b"]
                                                 .smoke())
    assert res["model_flops"] == 6.0 * res["params"]["n_active"] * 4 * 32
    ct = res["cost"]
    assert ct["kind_counts"] == {"attn/mlp": 2}
    assert ct["totals"]["flops_per_device"] == \
        ct["base"]["flops_per_device"] \
        + 2 * ct["per_kind"]["attn/mlp"]["flops_per_device"]
    # the affine total is the full-depth step's own count on the eager
    # program (one batch, as the cost steps run)
    full = dryrun.analyze_cell(cfg, TINY, make_rules(_mesh()), "cost")
    for key in dryrun.COST_KEYS:
        assert ct["totals"][key] == pytest.approx(full[key], rel=1e-12)
    assert res["roofline"]["chips"] == 4
    on_disk = json.loads((tmp_path / f"{cfg.name}--train_tiny.json")
                         .read_text())
    assert on_disk["mesh"]["small"]["argument_bytes_per_device"] \
        == mem["argument_bytes_per_device"]


def test_long_context_cell_of_a_full_attention_arch_is_skipped(tmp_path):
    res = dryrun.run_cell("gemma-2b", "long_500k", out_dir=tmp_path,
                          log=lambda *a: None)
    assert "skipped" in res and "mesh" not in res
    assert json.loads((tmp_path / "gemma-2b--long_500k.json").read_text()
                      )["skipped"] == res["skipped"]


def _jax_rules(mesh=MESH):
    mesh = types.SimpleNamespace(axis_names=mesh[1],
                                 shape=dict(zip(mesh[1], mesh[0])))
    return jax_make_rules(mesh, fsdp=True)


def _names(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _jax_param_leaves(mesh=MESH):
    """(path, shape, itemsize, JAX spec) of the smoke params' leaves."""
    jcfg = JAX_ARCHS["gemma-2b"].smoke()
    specs = jax_tfm.Model(jcfg).param_specs()
    rules = _jax_rules(mesh)
    flat, _ = jax.tree_util.tree_flatten_with_path(specs)
    out = []
    for p, x in flat:
        path = _path_str(p)
        spec = tuple(rules.spec_for(path, tuple(x.shape)))
        spec = spec + (None,) * (len(x.shape) - len(spec))
        out.append((path, tuple(x.shape), x.dtype.itemsize, spec))
    return out


def _shard(shape, spec, sizes):
    return tuple(d // math.prod(sizes[a] for a in _names(e))
                 for d, e in zip(shape, spec))


def test_argument_bytes_are_the_rules_shard_sizes():
    sizes = dict(zip(MESH[1], MESH[0]))
    fn, args, _ = dryrun.cell_step(get_arch("gemma-2b").smoke(), TINY,
                                   make_rules(_mesh()), "cost")
    leaves = _jax_param_leaves()
    params = sum(math.prod(_shard(s, spec, sizes)) * item
                 for _, s, item, spec in leaves)
    moments = 2 * sum(math.prod(_shard(s, spec, sizes)) * 4
                      for _, s, _, spec in leaves)
    batch = 2 * (TINY.global_batch // sizes["data"]) * TINY.seq_len * 4
    want = params + moments + 4 + batch      # + the int32 step count
    from repro_torch.roofline.analysis import argument_bytes
    assert argument_bytes(*args) == want


def test_recorded_all_gathers_are_what_the_specs_imply():
    """On a (data 2, model 4) mesh, where a collective's group size names
    its axes: every param leaf is gathered at its use over the data axis
    only, data-axis dims first -- the layers' twice (forward and remat
    recompute), the top leaves once -- and stays its shard on the model
    axis; a leaf not split over an axis whose ranks hold parts of its
    gradient (data, which splits the batch; model, for a leaf replicated
    there, since the cell's residual is striped over the sequence) adds
    the psum (an all-gather) of its gradient's shard over those axes; the
    loss's pmean and the gradient norm's psum (one per set of split axes)
    add theirs.  Each all-gather is recorded with its result's bytes.
    The model axis's own all-gathers (group size 4) carry activations:
    the striped residual's, k/v's head_dim and the vocab-parallel
    loss's."""
    mesh = ((2, 4), ("data", "model"))
    sizes = dict(zip(mesh[1], mesh[0]))
    want = Counter()
    norm_sets = Counter()
    for path, shape, item, spec in _jax_param_leaves(mesh):
        shard = _shard(shape, spec, sizes)
        cur = list(shard)
        uses = 1 if path in ("embed", "final_norm.scale") else 2
        split = {a for e in spec for a in _names(e)}
        for d, e in enumerate(spec):
            if "data" in _names(e):
                cur[d] *= sizes["data"]
                want[(math.prod(cur) * item, sizes["data"])] += uses
        rest = [a for a in mesh[1] if a not in split]
        if rest:
            n = math.prod(sizes[a] for a in rest)
            want[(math.prod(shard) * item * n, n)] += 1
        if split:
            norm_sets[tuple(a for a in mesh[1] if a in split)] += 1
    want[(4 * sizes["data"], sizes["data"])] += 1          # the loss
    for axes, n in norm_sets.items():
        size = math.prod(sizes[a] for a in axes)
        want[(4 * n * size, size)] += 1
    model = sizes["model"]
    want = Counter({k: v for k, v in want.items() if k[1] != model})

    fn, args, _ = dryrun.cell_step(get_arch("gemma-2b").smoke(), TINY,
                                   make_rules(AbstractMesh(*mesh)), "cost")
    with collectives.recording() as rec:
        fn(*args)
    got = Counter((nbytes, n) for op, nbytes, n in rec
                  if op == "all-gather" and n != model)
    assert got == want
    # every gradient gathered over the data axis comes back through a
    # reduce-scatter; the striped residual's branches come back through
    # the model axis's
    sizes_rs = {n for op, _, n in rec if op == "reduce-scatter"}
    assert sizes_rs == {sizes["data"], model}
    assert any(op == "all-gather" and n == model for op, _, n in rec)


def test_perf_main_runs_dots_and_refuses_item_14d_knobs(tmp_path):
    row = perf.main(["--arch", "gemma-2b", "--shape", "train_4k", "--name",
                     "dots", "--out", str(tmp_path), "remat=dots"])
    assert row["variant"]["remat"] == "dots" and row["roofline"]["chips"] \
        == 256
    base = perf.main(["--arch", "gemma-2b", "--shape", "train_4k",
                      "--out", str(tmp_path)])
    # dots saves the layers' products: fewer FLOPs for the same step
    assert row["cost"]["totals"]["flops_per_device"] \
        < base["cost"]["totals"]["flops_per_device"]
    lines = (tmp_path / "gemma-2b--train_4k.jsonl").read_text().splitlines()
    assert len(lines) == 2
    # item 14d's knobs run at JAX's values (seq_shard defaults to 1)
    assert base["variant"]["seq_shard"] is True
    assert "model_axis" not in base
    flops = base["cost"]["totals"]["flops_per_device"]
    for knob in ("seq_shard=0", "attn_seq=1", "embed_stripe=0"):
        other = perf.main(["--arch", "gemma-2b", "--shape", "train_4k",
                           "--out", str(tmp_path), knob])
        # the same step's work, split as before over the chips
        assert other["cost"]["totals"]["flops_per_device"] \
            == pytest.approx(flops, rel=0.02)
    # JAX's block_kv tile has no reader in the port: refused, not ignored
    with pytest.raises(SystemExit, match="block_kv"):
        perf.main(["--arch", "gemma-2b", "--shape", "train_4k",
                   "--out", str(tmp_path), "block_kv=1024"])
