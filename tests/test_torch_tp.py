"""The port's tensor-parallel paged serving against the JAX package.

The gates of ``tests/test_tp_serving.py``, held across the packages:

1. the degenerate mesh: ``--mesh 1`` streams bit-identical to the
   unsharded port and to JAX's ``PagedScheduler``, with ``tp_stats``
   showing the serving ops ran inside the sharded step;
2. a real mesh: two gloo ranks (``tests/_torch_ranks.py``, started by
   ``torch.multiprocessing.spawn``) on params from ``params_from_jax``,
   whose streams equal JAX's unsharded scheduler's for sharded GQA pools
   (codeqwen1.5-7b), replicated MQA (gemma-2b), int8 pools and a MoE arch
   whose MoE layers stay replicated; a row-parallel int8 MLP equal to
   JAX's per-shard computation summed by hand; ``serve.main --mesh 2
   --clock wall`` with the same streams on both ranks;
3. the contracts: ``tp_error`` and ``kv_sharded`` give JAX's answers,
   the shard plans name JAX's dims, the ops' contracts are the JAX
   registry's, tags are inert outside a scope and an unknown tag raises
   inside one; the CLI's refusals.

Smoke widths in fp32 on the CPU (plain versions), the heads untied.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec

import _torch_ranks as ranks
from helpers import run_multidevice
from repro.configs.archs import ARCHS as JAX_ARCHS
from repro.core.memory import F32_POLICY as JAX_F32
from repro.core.memory import DtypePolicy as JaxPolicy
from repro.kernels import registry
from repro.launch import serve as jax_serve
from repro.launch.loadgen import Request as JaxRequest
from repro.models import layers as jax_layers
from repro.models.transformer import ExecOptions, Model as JaxModel
from repro.runtime import tp as jax_tp
from repro.tune import cache as tune_cache
from repro_torch.configs import ARCHS
from repro_torch.core.memory import DtypePolicy
from repro_torch.kernels import dispatch
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models.transformer import Model
from repro_torch.runtime import tp

torch.set_num_threads(1)
# JAX's _TP2_CODE cases, and a MoE arch
TP2_CASES = (("codeqwen1.5-7b", ""), ("gemma-2b", ""),
             ("codeqwen1.5-7b", "int8"), ("qwen2-moe-a2.7b", ""))
CLI_ARGS = ["--arch", "gemma-2b", "--smoke", "--cache", "paged",
            "--device", "cpu", "--slots", "2", "--requests", "3",
            "--prompt-len", "6", "--max-new", "4", "--max-len", "64",
            "--page-size", "16"]


@pytest.fixture(scope="module", autouse=True)
def empty_plan_cache(tmp_path_factory):
    """The JAX side reads no tuned-plan state left by other tests."""
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_TUNE_CACHE",
              str(tmp_path_factory.mktemp("plans") / "empty.json"))
    tune_cache.preload()
    yield
    mp.undo()
    tune_cache.preload()


@pytest.fixture(scope="module", autouse=True)
def one_rank_group():
    """The one-rank process group a ``--mesh 1`` builds in this process,
    gone when the module is done."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _jax_cfg(arch, kv_dtype=""):
    return dataclasses.replace(JAX_ARCHS[arch].smoke(), dispatch="reference",
                               kv_cache="paged", kv_dtype=kv_dtype,
                               tie_embeddings=False)


def _jax_streams(arch, kv_dtype=""):
    """JAX's unsharded paged streams of the TP gate's traffic, and the
    params (numpy) they ran on."""
    jmodel = JaxModel(_jax_cfg(arch, kv_dtype),
                      dt=JaxPolicy(compute=jnp.float32),
                      opts=ExecOptions(mode="run"))
    jparams = jax.jit(jmodel.init)(jax.random.key(0))
    sched = jax_serve.PagedScheduler(jmodel, jparams, slots=ranks.SLOTS,
                                     max_len=ranks.MAX_LEN,
                                     page_size=ranks.PAGE, log=None)
    rng = np.random.default_rng(0)
    reqs = [JaxRequest(i, rng.integers(0, jmodel.cfg.vocab_size, 6), 4)
            for i in range(3)]
    return ranks.streams(sched.run(reqs)), jax.device_get(jparams)


@pytest.fixture(scope="module")
def jax_runs():
    return {case: _jax_streams(*case) for case in TP2_CASES}


@pytest.fixture(scope="module")
def mlp_case():
    """A smoke codeqwen1.5-7b SwiGLU MLP (d 128, ff 256) and its input."""
    p = jax.device_get(jax_layers.mlp_init(jax.random.key(3), 128, 256,
                                           "swiglu"))
    x = np.random.default_rng(4).standard_normal((2, 3, 128)).astype(
        np.float32)
    return p, x


@pytest.fixture(scope="module")
def two_ranks(jax_runs, mlp_case, tmp_path_factory):
    """Everything the two-rank tests read, from one start of two ranks."""
    cases = [(arch, kv, jax_runs[(arch, kv)][1]) for arch, kv in TP2_CASES]
    argv = CLI_ARGS + ["--schedule", "continuous", "--clock", "wall",
                       "--mesh", "2"]
    return ranks.spawn(ranks.tp_worker, 2, tmp_path_factory.mktemp("tp2"),
                       cases, mlp_case, argv)


# --------------------------------------------------------------- tp == 1

def test_tp1_streams_bit_identical(jax_runs):
    """The degenerate mesh gives the unsharded port's streams bit for bit,
    and JAX's; its serving ops ran inside the scope."""
    want, np_params = jax_runs[("gemma-2b", "")]
    cfg = ranks.smoke_cfg("gemma-2b")
    with dispatch.stats_scope():
        base = ranks.serve_streams(cfg, np_params)
        assert dispatch.tp_stats() == {}, \
            "unsharded serving must not tick tp counters"
    with dispatch.stats_scope():
        sharded = ranks.serve_streams(cfg, np_params,
                                      make_serving_mesh(1, device="cpu"))
        tp_routes = dispatch.tp_stats()
    assert sharded == base == want
    ops = {op for op, _ in tp_routes}
    assert {"matmul", "decode_attention", "prefill_attention"} <= ops, \
        tp_routes
    # CPU tensors: the plain versions (on the card every route is kernel)
    assert all(route == "plain" for _, route in tp_routes), tp_routes


def test_tp1_scheduler_reports_mesh():
    cfg = ranks.smoke_cfg("gemma-2b")
    model = Model(cfg, dt=DtypePolicy(compute=torch.float32), device="cpu")
    sched = serve.PagedScheduler(model, model.init(seed=1), slots=2,
                                 max_len=64, page_size=16,
                                 mesh=make_serving_mesh(1, device="cpu"),
                                 log=None)
    assert sched.tp == 1 and sched.mesh is not None


def test_serve_main_mesh1_equals_unsharded():
    """``serve.main --mesh 1`` on the CPU: the unsharded CLI's streams."""
    argv = CLI_ARGS + ["--schedule", "static"]
    base = serve.main(argv)
    rep = serve.main(argv + ["--mesh", "1"])
    assert rep["tp"] == 1 and base["tp"] == 1
    assert ranks.streams(rep["done"]) == ranks.streams(base["done"])
    assert {op for op, _ in rep["tp_routes"]} >= {
        "matmul", "decode_attention", "prefill_attention"}


# ------------------------------------------------------------ eligibility

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_tp_error_and_kv_sharded_match_jax(arch):
    for tp_deg in (1, 2, 3, 4):
        for smoke in (False, True):
            jcfg = JAX_ARCHS[arch].smoke() if smoke else JAX_ARCHS[arch]
            tcfg = ARCHS[arch].smoke() if smoke else ARCHS[arch]
            assert tp.tp_error(tcfg, tp_deg) == jax_tp.tp_error(jcfg, tp_deg)
            assert tp.kv_sharded(tcfg, tp_deg) == jax_tp.kv_sharded(jcfg,
                                                                   tp_deg)


def _jax_dims(tree, path=()):
    """{path of dict keys and list indices: the dim JAX shards (None)}."""
    if isinstance(tree, PartitionSpec):
        spec = tuple(tree)
        return {path: spec.index("model") if "model" in spec else None}
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_jax_dims(v, path + (k,)))
    return out


def _port_dims(tree, path=()):
    if isinstance(tree, tuple):
        return {path: tree.index("model") if "model" in tree else None}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_dims(v, path + (k,)))
    return out


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "gemma-2b"])
@pytest.mark.parametrize("tp_deg", [1, 2, 4])
def test_shard_plans_match_jax_pspecs(arch, tp_deg):
    """Every leaf of the params and paged-cache trees shards the dim JAX's
    ``param_pspecs`` / ``cache_pspecs`` shard (or none)."""
    jcfg, tcfg = _jax_cfg(arch), ranks.smoke_cfg(arch)
    jmodel = JaxModel(jcfg, opts=ExecOptions(mode="run"))
    jparams = jax.eval_shape(jmodel.init, jax.random.key(0))
    jcache = jax.eval_shape(lambda: jmodel.init_paged_cache(2, 64, 16))
    tmodel = Model(tcfg, dt=DtypePolicy(compute=torch.float32), device="cpu")
    tparams = tmodel.init(seed=0)
    tcache = tmodel.init_paged_cache(2, 64, 16)
    for want, got in (
            (jax_tp.param_pspecs(jparams, jcfg, tp_deg),
             tp.param_pspecs(tparams, tcfg, tp_deg)),
            (jax_tp.cache_pspecs(jcache, jcfg, tp_deg),
             tp.cache_pspecs(tcache, tcfg, tp_deg))):
        assert _port_dims(got) == _jax_dims(want)


# ------------------------------------------------------- contract surface

def test_contracts_match_jax_registry():
    for op, contracts in dispatch.TP_CONTRACTS.items():
        spec = registry.get(op).tp
        assert set(contracts) == set(spec), op
        for tag, how in contracts.items():
            if how is None:
                assert spec[tag].collective == "none"
            elif how == "psum":
                assert spec[tag].collective == "psum"
            else:
                assert spec[tag].collective == how[0]
                assert spec[tag].gather_axis == how[1]


def test_tp_tags_inert_outside_scope():
    x = torch.ones(4, 8)
    w = torch.ones(8, 6)
    assert torch.equal(dispatch.matmul(x, w), dispatch.matmul(x, w, tp="col"))
    assert torch.equal(dispatch.matmul(x, w), dispatch.matmul(x, w, tp="row"))
    assert dispatch.tp_group() is None


def test_unknown_tp_tag_raises_inside_scope():
    x = torch.ones(4, 8)
    w = torch.ones(8, 6)
    group = make_serving_mesh(1, device="cpu").group("model")
    with dispatch.tp_scope(group):
        assert dispatch.tp_group() is group
        with pytest.raises(ValueError, match="no tp contract"):
            dispatch.matmul(x, w, tp="bogus")
    assert dispatch.tp_group() is None


# ------------------------------------------------------------------ CLI

def test_cli_mesh_refusals():
    with pytest.raises(SystemExit, match="--mesh requires --cache paged"):
        serve.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                    "--cache", "dense", "--mesh", "1"])
    with pytest.raises(SystemExit, match="--speculate is not supported "
                                         "with --mesh"):
        serve.main(CLI_ARGS + ["--speculate", "ngram", "--mesh", "1"])


def test_make_serving_mesh_bounds():
    with pytest.raises(ValueError, match=">= 1"):
        make_serving_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="exceeds .*torchrun "
                                         "--nproc-per-node 2"):
        make_serving_mesh(2, device="cpu")


# ------------------------------------------------------------ tp == 2

@pytest.mark.parametrize("case", range(len(TP2_CASES)),
                         ids=[f"{a}-{k or 'compute'}" for a, k in TP2_CASES])
def test_tp2_matches_jax_unsharded(case, two_ranks, jax_runs):
    """Two gloo ranks serve JAX's unsharded streams; both ranks ran the
    serving ops inside the scope."""
    want = jax_runs[TP2_CASES[case]][0]
    assert [r["backend"] for r in two_ranks] == ["gloo", "gloo"]
    assert [r["coords"] for r in two_ranks] == [{"model": 0}, {"model": 1}]
    for r in two_ranks:
        got, tp_routes = r["cases"][case]
        assert got == want, (TP2_CASES[case], got, want)
        # int8 pools count under the int8 branches' names
        assert {op.replace("_int8", "") for op, _ in tp_routes} >= {
            "decode_attention", "prefill_attention"}
        assert ("matmul", "plain") in tp_routes or (
            "quantized_matmul", "plain") in tp_routes


def test_tp2_int8_row_parallel_mlp_matches_jax_shards(two_ranks, mlp_case):
    """A two-rank int8-weight MLP (wd row-parallel, quantized from each
    rank's K slice) equals JAX's ``mlp_apply`` on each shard's params,
    outside any scope, summed by hand."""
    p, x = mlp_case
    half = 128
    want = 0
    for r in range(2):
        cols = slice(r * half, (r + 1) * half)
        shard = {"wg": p["wg"][:, cols], "wu": p["wu"][:, cols],
                 "wd": p["wd"][cols, :]}
        want = want + np.asarray(jax_layers.mlp_apply(
            shard, jnp.asarray(x), "swiglu", JAX_F32, policy="reference",
            weights_dtype="int8"))
    for r in two_ranks:
        np.testing.assert_allclose(r["mlp_int8"], want, rtol=1e-5,
                                   atol=1e-5)
    assert np.array_equal(two_ranks[0]["mlp_int8"],
                          two_ranks[1]["mlp_int8"])


def test_tp2_wall_clock_cli_same_streams_on_both_ranks(two_ranks):
    """``serve.main --mesh 2 --schedule continuous --clock wall``: every
    rank takes rank 0's step time, so both admit alike and reach the same
    streams (``serve.main`` asserts it too)."""
    a, b = (r["cli"] for r in two_ranks)
    assert a == b and len(a) == 3 and all(len(s) == 4 for s in a)
    assert [r["cli_tp"] for r in two_ranks] == [2, 2]


def test_jax_sums_the_moe_shared_mlp_once_a_shard_and_the_port_does_not(
        two_ranks, jax_runs):
    """A reference caveat (ROADMAP Queue 3): JAX's MoE layer runs its
    replicated shared MLP through the tagged ``mlp_apply``, so inside a
    tp scope the row-parallel psum adds the whole shared MLP once a shard
    (twice at tp = 2).  The port's shared MLP is untagged: its two ranks
    give the unsharded streams of a MoE arch with shared experts."""
    out = run_multidevice("""
        import jax, jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from repro.core.memory import F32_POLICY
        from repro.kernels import registry
        from repro.launch.mesh import make_serving_mesh
        from repro.models import layers
        from repro.runtime import compat
        p = layers.mlp_init(jax.random.key(0), 16, 32, "swiglu")
        x = jax.random.normal(jax.random.key(1), (1, 3, 16))

        def mlp(x):
            return layers.mlp_apply(p, x, "swiglu", F32_POLICY,
                                    policy="reference")

        def body(x):
            with registry.tp_scope("model"):
                return mlp(x)
        y = compat.shard_map(body, mesh=make_serving_mesh(2),
                             in_specs=(P(),), out_specs=P(),
                             check_vma=False)(x)
        print("RATIO", float(jnp.abs(y).max() / jnp.abs(mlp(x)).max()))
    """, n_devices=2, timeout=300)
    assert "RATIO 2.0" in out, out
    case = TP2_CASES.index(("qwen2-moe-a2.7b", ""))
    assert ranks.smoke_cfg("qwen2-moe-a2.7b").n_shared_experts
    for r in two_ranks:
        assert r["cases"][case][0] == jax_runs[TP2_CASES[case]][0]
