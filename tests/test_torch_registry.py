"""The op registry (``src/repro_torch/kernels/registry.py``), as
``tests/test_registry.py`` holds the JAX one: every op declares its whole
contract, the examples fit it and the bad examples do not, the tuner's
and dispatch's tables are derived from the registry, the plan-source
counters are scoped, and the public ops' ``level=`` / ``plan=`` ladder
routes as the JAX ops' does (T0/T1 the plain version, counted as the
plain route).  The kernel route is entered by patching
``dispatch._on_card`` and the wrappers: the card's kernels do not run
here."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import registry as jregistry
from repro.kernels.histogram.ops import histogram as jhistogram
from repro.kernels.matmul.ops import matmul as jmatmul
from repro.kernels.nbody.ops import nbody_accel as jnbody
from repro.kernels.stencil.ops import jacobi4 as jjacobi4
from repro_torch.core.plan import Level
from repro_torch.kernels import dispatch, registry
from repro_torch.kernels.attention import ops as attention_ops
from repro_torch.kernels.histogram import histogram
from repro_torch.kernels.matmul import ops as matmul_ops
from repro_torch.kernels.nbody import nbody_accel
from repro_torch.kernels.stencil import jacobi4
from repro_torch.tune import PlanCache, plan_feasible, preload
from repro_torch.tune import cache as tcache

torch.set_num_threads(1)
OPS = list(registry.ops())
DISPATCHABLE = sorted(registry.dispatchable())
TUNABLE = sorted(registry.tunable())
# B1's, B5's and the paged attention's contracts, as the JAX ops declare
# them (matmul/ops.py:406-429, attention/ops.py:845-871)
JAX_TP_OPS = ("matmul", "quantized_matmul", "decode_attention",
              "prefill_attention")


@pytest.fixture
def plan_file(tmp_path, monkeypatch):
    path = tmp_path / "plans.json"
    monkeypatch.setenv(tcache.ENV, str(path))
    preload()
    yield path
    monkeypatch.delenv(tcache.ENV)
    preload()


# ------------------------------------------------------------ completeness
@pytest.mark.parametrize("op", OPS)
def test_ops_declare_the_whole_contract(op):
    spec = registry.get(op)
    assert spec.plain is not None and spec.kernel is not None
    assert hasattr(spec.kernel, "launches")
    assert spec.eligible is not None
    assert spec.example is not None and spec.bad_example is not None
    if spec.tune is not None:
        assert spec.plan_shape is not None, f"{op} has no plan key"


@pytest.mark.parametrize("op", OPS)
def test_examples_fit_the_contract_and_bad_examples_do_not(op):
    spec = registry.get(op)
    dtype = torch.int32 if op == "histogram" else torch.float32
    args, kwargs = spec.example(dtype)
    assert spec.eligible(*args)
    out = spec.plain(*args, **kwargs)
    assert all(bool(torch.isfinite(t.float()).all()) for t in
               (out if isinstance(out, tuple) else (out,)))
    bad, _ = spec.bad_example()
    assert not spec.eligible(*bad)
    with pytest.raises((ValueError, TypeError)):
        spec.kernel(*bad)                  # the wrapper refuses it too


def test_dispatch_tables_are_registry_derived():
    assert dispatch.KERNELS == {n: s.kernel for n, s in
                                registry.ops().items()}
    assert dispatch.TP_CONTRACTS == registry.tp_contracts()
    assert set(dispatch.launch_counts()) == set(registry.ops())
    assert dispatch.stats_scope is registry.stats_scope
    assert dispatch.plan_source_stats is registry.plan_source_stats


@pytest.mark.parametrize("op", JAX_TP_OPS)
def test_tp_contracts_match_jax(op):
    want = jregistry.get(op).tp
    got = registry.get(op).tp
    assert set(got) == set(want)
    for tag, c in got.items():
        assert (c.collective, c.gather_axis if c.collective ==
                "all_gather" else 0) == \
            (want[tag].collective, want[tag].gather_axis
             if want[tag].collective == "all_gather" else 0)
    if op in ("matmul", "quantized_matmul"):
        assert {t: c.in_axes for t, c in got.items()} == \
            {t: c.in_axes for t, c in want.items()}


# ------------------------------------------------------------- tune wiring
@pytest.mark.parametrize("op", TUNABLE)
def test_tune_space_yields_feasible_plans_on_default_cells(op):
    spec = registry.get(op)
    t = spec.tune
    for shape in t.default_shapes:
        key, dtype = spec.key(*t.make_inputs(shape, t.default_dtype,
                                             "meta"))
        cands = t.space(key, dtype)
        assert cands, (op, shape)
        assert all(plan_feasible(spec.namespace, key, c, dtype=dtype)
                   for c in cands), (op, shape, cands)


def test_tuner_tables_are_registry_derived():
    from repro_torch.tune import DEFAULT_SHAPES, KERNELS
    assert sorted(KERNELS) == TUNABLE
    assert sorted(DEFAULT_SHAPES) == TUNABLE
    for name, spec in registry.tunable().items():
        assert tuple(DEFAULT_SHAPES[name]) == spec.tune.default_shapes
        assert KERNELS[name].call is spec.tune.call
        assert KERNELS[name].make_inputs is spec.tune.make_inputs


def test_plan_source_stats_isolated_by_stats_scope(plan_file, monkeypatch):
    monkeypatch.setattr(dispatch, "_on_card", lambda op, t: (
        registry.count_route(op, "kernel") or True))
    monkeypatch.setattr(dispatch, "matmul_cuda",
                        lambda a, b, plan=None: a @ b)
    before = dispatch.plan_source_stats()
    with dispatch.stats_scope():
        dispatch.matmul(torch.randn(8, 16), torch.randn(16, 8))
        inside = dispatch.plan_source_stats()
        assert inside == {("matmul", "kernel", "heuristic"): 1}, inside
    assert dispatch.plan_source_stats() == before


# ---------------------------------------------------- the public op ladder
def _public_calls():
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(6, 40, generator=gen)
    b = torch.randn(40, 24, generator=gen)
    q8, scale = registry.get("quantized_matmul").example(torch.float32)[0][1:]
    dec = registry.get("decode_attention").example(torch.float32)[0]
    pre = registry.get("prefill_attention").example(torch.float32)[0]
    fl = registry.get("flash_attention").example(torch.float32)[0]
    bw = registry.get("flash_attention_bwd").example(torch.float32)[0]
    x = torch.randn(9, 13, generator=gen)
    pos, mass = registry.get("nbody").example(torch.float32)[0]
    vals = torch.randint(-3, 40, (500,), generator=gen, dtype=torch.int32)
    return [
        ("matmul", lambda **kw: matmul_ops.matmul(a, b, **kw)),
        ("quantized_matmul", lambda **kw: matmul_ops.quantized_matmul(
            a, q8, scale, **kw)),
        ("decode_attention", lambda **kw: attention_ops.decode_attention(
            *dec, **kw)),
        ("prefill_attention", lambda **kw: attention_ops.prefill_attention(
            *pre, **kw)),
        ("attention", lambda **kw: attention_ops.flash_attention(
            *fl, **kw)),
        ("attention_bwd", lambda **kw: attention_ops.flash_attention_bwd(
            *bw, **kw)[0]),
        ("stencil", lambda **kw: jacobi4(x, steps=2, **kw)),
        ("nbody", lambda **kw: nbody_accel(pos, mass, **kw)),
        ("histogram", lambda **kw: histogram(vals, 37, **kw)),
    ]


@pytest.mark.parametrize("op, call", _public_calls(),
                         ids=[c[0] for c in _public_calls()])
def test_public_ops_take_level_and_plan(op, call, plan_file):
    with dispatch.stats_scope() as stats:
        want = call()
        assert stats() == {(op, "plain"): 1}
    for level in Level:
        with dispatch.stats_scope() as stats:
            got = call(level=level)
            assert stats() == {(op, "plain"): 1}
            assert dispatch.plan_source_stats() == {}   # plain: no lookup
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for plan in ("heuristic", "tuned", {"level": 1}):
        torch.testing.assert_close(call(plan=plan), want, rtol=0, atol=0)


def test_public_ops_pass_plans_on_the_kernel_route(plan_file, monkeypatch):
    """On the kernel route a dict plan reaches the wrapper as it is, a
    ``"tuned"`` plan comes from the cache, the heuristic passes none, and
    a plan's level below T2 takes the plain route however the device."""
    seen = []
    monkeypatch.setattr(dispatch, "_on_card", lambda op, t: (
        registry.count_route(op, "kernel") or True))
    monkeypatch.setattr(matmul_ops, "matmul_cuda",
                        lambda a, b, plan=None: seen.append(plan) or a @ b)
    a, b = torch.randn(4, 64), torch.randn(64, 8)
    cache = PlanCache(plan_file)
    cache.put("matmul", (64, 8), torch.float32, {"split": 2})
    cache.save()
    preload()
    with dispatch.stats_scope() as stats:
        for plan in ("heuristic", {"split": 1}, "tuned"):
            matmul_ops.matmul(a, b, plan=plan)
        matmul_ops.matmul(a, b, plan={"level": 1, "split": 4})
        matmul_ops.matmul(a, b, level=Level.T0_NAIVE, plan="tuned")
        assert stats() == {("matmul", "kernel"): 3, ("matmul", "plain"): 2}
        assert dispatch.plan_source_stats() == {
            ("matmul", "kernel", "heuristic"): 1,
            ("matmul", "kernel", "explicit"): 1,
            ("matmul", "kernel", "exact"): 1}
    assert seen == [None, {"split": 1}, {"split": 2}]


def test_public_ops_agree_with_the_jax_ops_at_t0_and_t1():
    """The ladder's plain rungs against the JAX ops' oracle rungs (no
    Pallas kernel runs): the stencil and histogram exactly, the N-body
    accelerations and the GEMM within 1e-5 of their scale."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((17, 23)).astype(np.float32)
    want = jjacobi4(jnp.asarray(x), steps=3, level=Level.T0_NAIVE)
    for level in (Level.T0_NAIVE, Level.T1_PIPELINED):
        got = jacobi4(torch.from_numpy(x), steps=3, level=level)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    v = rng.integers(0, 50, 1000).astype(np.int32)
    np.testing.assert_array_equal(
        histogram(torch.from_numpy(v), 50, level=Level.T1_PIPELINED).numpy(),
        np.asarray(jhistogram(jnp.asarray(v), 50,
                              level=Level.T1_PIPELINED)))
    pos = rng.standard_normal((3, 64)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    want = np.asarray(jnbody(jnp.asarray(pos), jnp.asarray(mass),
                             level=Level.T0_NAIVE))
    got = nbody_accel(torch.from_numpy(pos), torch.from_numpy(mass),
                      level=Level.T0_NAIVE).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    a = rng.standard_normal((8, 32)).astype(np.float32)
    b = rng.standard_normal((32, 16)).astype(np.float32)
    want = np.asarray(jmatmul(jnp.asarray(a), jnp.asarray(b),
                              level=Level.T1_PIPELINED))
    got = matmul_ops.matmul(torch.from_numpy(a), torch.from_numpy(b),
                            level=Level.T1_PIPELINED).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
