"""Rank processes for the port's tensor- and expert-parallel, sharded
training and pipeline tests.

``torch.multiprocessing.spawn`` imports the module of the function it
starts in every child, so the rank functions live here, in a module that
imports neither JAX nor the JAX package.  Each rank joins a gloo process
group through a ``file://`` store in the test's temporary directory (no
fixed port), runs one thread, computes what its test asks for from the
numpy inputs it was handed, and writes its results to
``<out_dir>/rank<r>.pt``; the test process compares them with the JAX
package.
"""
from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

SLOTS, MAX_LEN, PAGE = 2, 64, 16


def spawn(fn, world: int, tmp_path, *args) -> list:
    """Run ``fn(rank, world, store, out_dir, *args)`` on ``world`` ranks;
    returns each rank's saved results, in rank order."""
    import torch.multiprocessing as mp
    store = os.path.join(str(tmp_path), "store")
    mp.spawn(fn, args=(world, store, str(tmp_path)) + tuple(args),
             nprocs=world, join=True)
    return [torch.load(os.path.join(str(tmp_path), f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _join(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=3))


def _leave(rank: int, out_dir: str, results) -> None:
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def requests(vocab: int):
    """The JAX TP gate's traffic: 3 requests of 6 prompt tokens, 4 new."""
    from repro_torch.launch.loadgen import Request
    rng = np.random.default_rng(0)
    return [Request(i, rng.integers(0, vocab, 6), 4) for i in range(3)]


def streams(done) -> list:
    return [list(r.out) for r in sorted(done, key=lambda r: r.rid)]


def smoke_cfg(arch: str, kv_dtype: str = "", weights_dtype: str = ""):
    """The smoke config the tests serve: its head untied, so a random
    model's streams carry information."""
    from repro_torch.configs import ARCHS
    return dataclasses.replace(ARCHS[arch].smoke(), kv_cache="paged",
                               kv_dtype=kv_dtype,
                               weights_dtype=weights_dtype,
                               tie_embeddings=False)


def serve_streams(cfg, np_params, mesh=None):
    """Greedy streams of the port's ``PagedScheduler`` on params given as
    numpy arrays (fp32 compute on the CPU)."""
    from repro_torch.convert import params_from_jax
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.launch.serve import PagedScheduler
    from repro_torch.models.transformer import Model
    model = Model(cfg, dt=DtypePolicy(compute=torch.float32), device="cpu")
    params = params_from_jax(np_params, "cpu", torch.float32)
    sched = PagedScheduler(model, params, slots=SLOTS, max_len=MAX_LEN,
                           page_size=PAGE, mesh=mesh, log=None)
    return streams(sched.run(requests(cfg.vocab_size)))


def tp_worker(rank, world, store, out_dir, cases, mlp_case, cli_argv):
    """The tensor-parallel tests' two ranks: the paged streams of every
    (arch, kv_dtype, weights_dtype, numpy params) case on a ``--mesh 2``
    scheduler with the counters inside the scope; a row-parallel int8
    ``mlp_apply``; and ``serve.main`` on ``cli_argv``."""
    _join(rank, world, store)
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import layers
    from repro_torch.runtime import tp
    mesh = make_serving_mesh(2, device="cpu")
    results = {"coords": mesh.coords, "backend": mesh.backend, "cases": []}
    for arch, kv_dtype, np_params in cases:
        dispatch.reset_stats()
        got = serve_streams(smoke_cfg(arch, kv_dtype), np_params, mesh)
        results["cases"].append((got, dispatch.tp_stats()))

    # int8 weights, row-parallel wd: quantized after sharding, from each
    # rank's own slice
    p, x = mlp_case
    p = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in p.items()}
    p = tp.shard_tree(p, {"wg": (None, "model"), "wu": (None, "model"),
                          "wd": ("model", None)}, mesh)
    q = {k: layers.quantize_weight(w, 0, 1) for k, w in p.items()}
    with dispatch.tp_scope(mesh.group("model")):
        results["mlp_int8"] = layers.mlp_apply(
            q, torch.from_numpy(np.asarray(x, np.float32)), "swiglu",
            DtypePolicy(compute=torch.float32), "int8").numpy()

    rep = serve.main(cli_argv)
    results["cli"] = streams(rep["done"])
    results["cli_tp"] = rep["tp"]
    _leave(rank, out_dir, results)


def moe_worker(rank, world, store, out_dir, shape, spec_kw, np_p, np_x,
               model_case):
    """``moe_apply_sharded`` on a ``shape`` (data, model) mesh: the output,
    aux loss and the gradients of ``sum(out * out)`` (this rank's expert
    shards, the whole router and input); and with ``model_case``, a
    MoE ``Model.forward`` with ``ExecOptions.moe_mesh`` set."""
    _join(rank, world, store)
    from repro_torch.convert import shards_from_jax
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.moe import MoESpec
    from repro_torch.models.moe_sharded import moe_apply_sharded, moe_pspecs
    from repro_torch.models.transformer import ExecOptions, Model
    f32 = DtypePolicy(compute=torch.float32)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    s = MoESpec(**spec_kw)
    p = shards_from_jax({"moe": np_p}, moe_pspecs, mesh,
                        torch.float32)["moe"]
    for v in p.values():
        v.requires_grad_(True)
    x = torch.from_numpy(np.asarray(np_x, np.float32)).requires_grad_(True)
    dispatch.reset_stats()
    out, aux = moe_apply_sharded(p, s, x, f32, mesh=mesh, dp_axes=("data",))
    (out * out).sum().backward()
    results = {"coords": mesh.coords, "out": out.detach().numpy(),
               "aux": aux.item(), "dx": x.grad.numpy(),
               "dp": {k: v.grad.numpy() for k, v in p.items()},
               "routes": dispatch.stats()}
    if model_case is not None:
        cfg, np_params, tokens, pad = model_case
        opts = ExecOptions(moe_mesh=mesh, moe_dp_axes=("data",),
                           expert_pad=pad)
        model = Model(cfg, dt=f32, device="cpu", opts=opts)
        params = shards_from_jax(np_params, moe_pspecs, mesh, torch.float32)
        dispatch.reset_stats()
        with torch.no_grad():
            logits = model.forward(params, {"tokens": torch.from_numpy(
                np.asarray(tokens, np.int32))})
        results["model_logits"] = logits.numpy()
        results["model_routes"] = dispatch.stats()
    _leave(rank, out_dir, results)



# --------------------------------------------------------------------------
# sharded training (runtime/sharding.py, train/steps.py, launch/train.py)
# --------------------------------------------------------------------------

def sharded_setup(case, mesh):
    """The sharded train step of ``case`` on ``mesh``: fp32 policy, AdamW
    at ``case["lr"]``, ``microbatches``, ``compress`` and ``int8`` as the
    case says, a MoE arch expert-parallel with ``expert_pad``; with
    ``constrain`` the residual striped over the sequence (the dry run's
    ``make_constrain``), with ``attn_seq`` the rules'
    ``attn_prefer_seq`` (through ``attn_hook``); the state drawn from the
    numpy params ``case["params"]`` and sharded.  Returns (step, state,
    specs, sharding)."""
    from repro_torch.convert import params_from_jax
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.models.transformer import ExecOptions, Model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.optim.compress import CompressorConfig, init_residual
    from repro_torch.runtime import sharding
    from repro_torch.train.steps import TrainStepConfig, make_train_step
    from repro_torch.launch import dryrun
    rules = sharding.make_rules(mesh, fsdp=True)
    if case.get("attn_seq"):
        rules = dataclasses.replace(rules, attn_prefer_seq=True)
    cfg = case["cfg"]
    opts = ExecOptions(block_q=16, block_kv=16,
                       constrain=dryrun.make_constrain(rules)
                       if case.get("constrain") else None,
                       attn_constrain=dryrun.attn_hook(rules))
    if any(f == "moe" for _, f in cfg.layer_kinds()):
        opts = dataclasses.replace(opts, moe_mesh=mesh,
                                   moe_dp_axes=rules.dp_axes,
                                   expert_pad=case.get("expert_pad", 1))
    model = Model(cfg, dt=DtypePolicy(compute=torch.float32), device="cpu",
                  opts=opts)
    mb = case.get("microbatches", 1)
    ts = TrainStepConfig(
        opt=AdamWConfig(lr=case["lr"], int8_moments=case.get("int8", False)),
        microbatches=mb,
        compress=CompressorConfig() if case.get("compress") else None)
    params = params_from_jax(case["params"], "cpu", torch.float32)
    opt = adamw_init(params, ts.opt)
    if ts.compress is not None:
        opt = (opt, init_residual(params))
    rows = len(next(iter(case["batches"][0].values())))
    shd = sharding.train_sharding(rules, params, rows // mb)
    specs = (shd.specs, sharding.tree_specs(rules, opt))
    state = sharding.shard_state((params, opt), specs, mesh)
    step = make_train_step(model, dataclasses.replace(ts,
                                                      grad_shardings=shd))
    return step, state, specs, shd


def run_steps(step, state, shd, batches, microbatches=1):
    """``step`` over whole ``batches`` (numpy), each split to this rank's
    rows; returns (state, per-step metrics)."""
    metrics = []
    for batch in batches:
        local = shd.split_batch({k: torch.from_numpy(np.asarray(v))
                                 for k, v in batch.items()}, microbatches)
        params, opt, met = step(*state, local)
        state = (params, opt)
        metrics.append({k: float(v) for k, v in met.items()})
    return state, metrics


def sharded_steps(case, mesh=None):
    """Every batch of ``case["batches"]`` through ``sharded_setup``'s step
    on a ``case["shape"]`` mesh over ``case["axes"]``: the per-step
    metrics, the collectives the steps ran, the leaves gathered whole
    over the model axis, the attention and WKV calls' shapes and the
    whole state, gathered (on every rank).  ``mesh`` (a mesh over some of the
    ranks running) replaces ``make_mesh``'s."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import collectives, sharding
    if mesh is None:
        mesh = make_mesh(case["shape"], case["axes"], device="cpu")
    step, state, specs, shd = sharded_setup(case, mesh)
    collectives.reset_collective_counts()
    sharding.reset_model_gathers()
    shapes, wkv_shapes = [], []
    attention, wkv = dispatch.attention, dispatch.wkv

    def record(q, k, v, **kw):
        shapes.append((tuple(q.shape), tuple(k.shape),
                       kw.get("q_offset", 0)))
        return attention(q, k, v, **kw)

    def record_wkv(r, *args, **kw):
        wkv_shapes.append(tuple(r.shape))
        return wkv(r, *args, **kw)
    dispatch.attention, dispatch.wkv = record, record_wkv
    try:
        state, metrics = run_steps(step, state, shd, case["batches"],
                                   case.get("microbatches", 1))
    finally:
        dispatch.attention, dispatch.wkv = attention, wkv
    return {"metrics": metrics, "batch_axes": shd.batch,
            "collectives": collectives.collective_counts(),
            "model_gathers": sharding.model_gathers(),
            "attention": shapes, "wkv": wkv_shapes,
            "state": sharding.gather_state(state, specs, mesh)}


def megatron_worker(rank, world, store, out_dir, cases):
    """Every ``sharded_steps`` case on a mesh over ranks ``0..n-1`` of the
    ``world`` running (each rank joins every mesh's process groups; the
    ranks outside a case's mesh sit it out, with None)."""
    _join(rank, world, store)
    from repro_torch.launch.mesh import Mesh
    results = []
    for case in cases:
        mesh = Mesh(case["shape"], case["axes"], torch.device("cpu"),
                    "gloo")
        results.append(sharded_steps(case, mesh) if rank < mesh.size
                       else None)
        dist.barrier()
    _leave(rank, out_dir, results)


MATMUL_OPS = ("mm", "addmm", "bmm")


def matmul_flops(counter) -> int:
    """The matmul FLOPs a ``FlopCounterMode`` counted."""
    return sum(n for op, n in counter.get_flop_counts()["Global"].items()
               if str(op).split(".")[1] in MATMUL_OPS)


def cli_run(argv):
    """``train.main`` on ``argv``: its losses, restarts, routes and the
    matmul FLOPs this rank ran."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import train
    rep = {}
    with FlopCounterMode(display=False) as flops:
        losses = train.main(argv, report=rep)
    return {"losses": losses, "restarts": rep["restarts"],
            "routes": rep["routes"], "matmul_flops": matmul_flops(flops)}


def train_worker(rank, world, store, out_dir, cases, cli_argvs, elastic):
    """The sharded-training tests' ranks: every case of ``sharded_steps``,
    ``train.main`` on each argv of ``cli_argvs`` (the CLI's own host mesh)
    and the ``elastic_job``, if any."""
    _join(rank, world, store)
    results = {"cases": [sharded_steps(c) for c in cases],
               "cli": [cli_run(a) for a in cli_argvs]}
    if elastic is not None:
        results["elastic"] = elastic_job(elastic)
    _leave(rank, out_dir, results)


def elastic_job(job):
    """With ``job["save"]``: ``job["case"]``'s steps on a ``job["shape"]``
    (data, model) mesh, the state saved whole in ``job["dir"]``, then
    ``reshard_state`` onto ``job["reshard"]`` (a mesh over the same ranks)
    and ``job["case"]["more"]`` further steps on both layouts.  Else
    ``restore_on_mesh`` of the newest checkpoint in ``job["dir"]`` onto a
    ``job["shape"]`` mesh.  Whole states come back gathered."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import elastic, sharding
    mesh = make_mesh(job["shape"], ("data", "model"), device="cpu")
    case = job["case"]
    step, state, specs, shd = sharded_setup(case, mesh)
    if not job.get("save"):
        like = sharding.gather_state(state, specs, mesh)
        restored, at, _ = elastic.restore_on_mesh(
            CheckpointManager(job["dir"]), like,
            sharding.make_rules(mesh, fsdp=True))
        return {"step": at,
                "state": sharding.gather_state(restored, specs, mesh)}
    state, _ = run_steps(step, state, shd, case["batches"])
    CheckpointManager(job["dir"], specs=specs, mesh=mesh).save(
        len(case["batches"]), state)
    out = {"saved": sharding.gather_state(state, specs, mesh)}
    new_mesh = make_mesh(job["reshard"], ("data", "model"), device="cpu")
    moved, new_specs = elastic.reshard_state(
        state, sharding.make_rules(new_mesh, fsdp=True), specs=specs,
        mesh=mesh)
    out["resharded"] = sharding.gather_state(moved, new_specs, new_mesh)
    out["reshard_specs"] = new_specs
    # one more step on each layout, the new one's step built on its mesh
    new_step, _, _, new_shd = sharded_setup(case, new_mesh)
    _, out["more_old"] = run_steps(step, state, shd, case["more"])
    _, out["more_new"] = run_steps(new_step, moved, new_shd, case["more"])
    return out


def pipeline_worker(rank, world, store, out_dir, w, x, cot):
    """``pipeline_apply`` of tanh(x @ w_s) over ``world`` stages on a
    ("pod",) mesh (this rank's stage of ``w`` (S, d, d), the microbatches
    ``x`` (M, mb, d)): its output and the gradient of sum(out * cot) in
    the stage's weights; and the collectives' own checks: reduce_scatter
    against chunk(psum), ppermute, the transposes of gather_shards and
    psum, and ``quantize_shard`` against ``quantize_block`` of the whole
    leaf."""
    _join(rank, world, store)
    from repro_torch.core.memory import dequantize_block, quantize_block
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import collectives as coll
    from repro_torch.runtime import sharding
    from repro_torch.runtime.pipeline_parallel import (bubble_fraction,
                                                       pipeline_apply)
    mesh = make_mesh((world,), ("pod",), device="cpu")
    group = mesh.group("pod")
    stage = sharding.shard_leaf(torch.from_numpy(w), sharding.P("pod"),
                                mesh).requires_grad_(True)
    xs = torch.from_numpy(x)
    out = pipeline_apply(
        lambda p, h: torch.tanh(dispatch.matmul(h, p["w"])), {"w": stage},
        xs, mesh=mesh, stage_axis="pod")
    (out * torch.from_numpy(cot)).sum().backward()
    results = {"out": out.detach().numpy(), "dw": stage.grad.numpy(),
               "bubble": bubble_fraction(world, x.shape[0])}

    gen = torch.Generator().manual_seed(rank)
    t = torch.randn((4 * world, 6), generator=gen)
    results["reduce_scatter_bits"] = torch.equal(
        group.reduce_scatter(t, 0), group.chunk(group.psum(t), 0))
    results["ppermute_from"] = group.ppermute(
        torch.full((2,), float(rank)), 1)[0].item()
    shard = torch.randn((3, 5), generator=gen).requires_grad_(True)
    c = torch.randn((3 * world, 5), generator=gen)
    (coll.gather_shards(shard, group, 0) * c).sum().backward()
    results["gather_shards_grad_bits"] = torch.equal(
        shard.grad, group.chunk(group.psum(c), 0))
    s = torch.randn((3,), generator=gen).requires_grad_(True)
    (coll.psum(s, group) * 2).sum().backward()
    results["psum_grad"] = s.grad.numpy()

    whole = torch.randn((6, 96 * world), generator=torch.Generator()
                        .manual_seed(7))
    results["quantize"] = []
    for width in (96, 256):          # off and on the 128-wide block edge
        leaf = whole[:, :width * world].contiguous()
        spec = sharding.P(None, "pod")
        want = quantize_block(leaf, 128)
        scale_spec = sharding.P(None, "pod" if want.scale.shape[-1]
                                % world == 0 else None)
        qb = sharding.quantize_shard(group.chunk(leaf, 1), 128, spec,
                                     scale_spec, mesh)
        back = sharding.dequantize_shard(qb, spec, scale_spec, mesh)
        results["quantize"].append({
            "q": torch.equal(qb.q, group.chunk(want.q, 1)),
            "scale": torch.equal(qb.scale, sharding.shard_leaf(
                want.scale, scale_spec, mesh)),
            "dequantized": torch.equal(back, group.chunk(
                dequantize_block(want), 1))})
    _leave(rank, out_dir, results)


def card_train_step(mesh=None):
    """One train step of a 2-layer smoke gemma-2b (bf16 compute) on the
    card, batch 2 x 64, sharded on ``mesh`` (None: one process): its
    loss, the launches per kernel and the dispatch routes that were not
    a kernel's."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import dispatch
    from repro_torch.launch.train import sharded_train_state
    from repro_torch.models.transformer import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import sharding
    from repro_torch.train.steps import (TrainStepConfig, init_train_state,
                                         make_train_step)
    model = Model(ARCHS["gemma-2b"].smoke(), device="cuda")
    ts = TrainStepConfig(opt=AdamWConfig(lr=1e-3))
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, 512, (2, 64)).astype(
        np.int32)).cuda() for k in ("tokens", "labels")}
    if mesh is None:
        state = init_train_state(model, ts, seed=0)
    else:
        rules = sharding.make_rules(mesh, fsdp=True)
        state, _, shd, _ = sharded_train_state(model, ts, rules, 2)
        ts = dataclasses.replace(ts, grad_shardings=shd)
        batch = shd.split_batch(batch)
    step = make_train_step(model, ts)
    dispatch.reset_stats()
    dispatch.reset_launch_counts()
    _, _, metrics = step(*state, batch)
    torch.cuda.synchronize()
    return {"loss": float(metrics["loss"]),
            "launches": dispatch.launch_counts(),
            "plain": [k for k in dispatch.stats() if k[1] != "kernel"]}


def card_train_worker(rank, world, store, out_dir, shape):
    """``card_train_step`` on a ``shape`` (data, model) mesh of ranks
    sharing cuda:0 over gloo."""
    _join(rank, world, store)
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(shape, ("data", "model"), device="cuda")
    _leave(rank, out_dir, card_train_step(mesh))


# --------------------------------------------------------------------------
# the serving steps on the model axis (launch/dryrun.py's builders)
# --------------------------------------------------------------------------

def serve_axis_steps(case, mesh):
    """The dry run's prefill and decode steps (``dryrun.prefill_step``,
    ``dryrun.serve_step``) of ``case`` on ``mesh``, fp32 on the CPU, from
    the whole numpy params, prompt and dense cache: the prefill logits,
    each decode step's logits, the leaves gathered whole over the model
    axis, every decode attention call's (q, pool, return_lse) shapes and
    the cache block's leaf shapes by path."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import dense_cache_from_jax, params_from_jax
    from repro_torch.core import tree
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.kernels import dispatch
    from repro_torch.launch import dryrun
    from repro_torch.runtime import sharding
    rules = sharding.make_rules(mesh, fsdp=True)
    if case.get("attn_seq"):
        rules = dataclasses.replace(rules, attn_prefer_seq=True)
    cfg, f32 = case["cfg"], torch.float32
    dt = DtypePolicy(compute=f32)
    params = params_from_jax(case["params"], "cpu", f32)
    prompt = torch.from_numpy(case["prompt"])
    b, s = prompt.shape
    sharding.reset_model_gathers()
    step, args, _ = dryrun.prefill_step(
        cfg, ShapeSpec("prefill_axis", s, b, "prefill"), rules, dt=dt,
        device="cpu", params=params, batch={"tokens": prompt})
    out = {"prefill": step(*args).numpy()}
    cache = dense_cache_from_jax(case["cache"], "cpu", f32)
    step, (local, block, _), _ = dryrun.serve_step(
        cfg, ShapeSpec("decode_axis", case["max_len"], b, "decode"), rules,
        dt=dt, device="cpu", params=params,
        batch={"tokens": torch.from_numpy(case["tokens"][0])}, cache=cache)
    rows = sharding.train_sharding(rules, params, b)
    calls = []
    attention = dispatch.decode_attention

    def record(q, k_pages, *args, **kw):
        calls.append((tuple(q.shape), tuple(k_pages.shape),
                      kw.get("return_lse", False)))
        return attention(q, k_pages, *args, **kw)
    dispatch.decode_attention = record
    try:
        out["decode"] = [step(local, block, rows.split_batch(
            {"tokens": torch.from_numpy(t)}), pos)[0].numpy()
            for pos, t in zip(case["positions"], case["tokens"])]
    finally:
        dispatch.decode_attention = attention
    out["model_gathers"] = sharding.model_gathers()
    out["decode_calls"] = calls
    out["cache_shapes"] = dict(zip(sharding.leaf_paths(block),
                                   (tuple(x.shape)
                                    for x in tree.leaves(block))))
    return out


def serve_axis_worker(rank, world, store, out_dir, cases):
    """Every ``serve_axis_steps`` case on a mesh over ranks ``0..n-1`` of
    the ``world`` running (the ranks outside a case's mesh sit it out,
    with None)."""
    _join(rank, world, store)
    from repro_torch.launch.mesh import Mesh
    results = []
    for case in cases:
        mesh = Mesh(case["shape"], case["axes"], torch.device("cpu"),
                    "gloo")
        with torch.no_grad():
            results.append(serve_axis_steps(case, mesh) if rank < mesh.size
                           else None)
        dist.barrier()
    _leave(rank, out_dir, results)
