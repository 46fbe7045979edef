"""The port's tuner (``src/repro_torch/tune/``) held to the JAX package's
``repro.tune``: keys, distances and the cache file format (a file written
by either package loads in the other), the deterministic search under a
stubbed harness with the heuristic as candidate 0, and the lookup route
(exact, nearest, heuristic) as the kernel route meets it.  The card's
kernels do not run here: the kernel route is entered by patching
``dispatch._on_card`` and the wrappers, to record the plan each call
receives."""
import json
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.tune import cache as jcache
from repro_torch.kernels import dispatch, registry
from repro_torch.kernels.attention import decode, prefill
from repro_torch.kernels.histogram.histogram import histogram_route
from repro_torch.kernels.matmul import matmul as mm
from repro_torch.kernels.matmul import matmul_plain
from repro_torch.kernels.nbody import nbody
from repro_torch.tune import (DEFAULT_SHAPES, Harness, PlanCache, SPACES,
                              lookup_scope, make_key, parse_key,
                              plan_feasible, preload, shape_distance, tune)
from repro_torch.tune import cache as tcache
from repro_torch.tune.measure import Measurement

torch.set_num_threads(1)


@pytest.fixture
def plan_file(tmp_path, monkeypatch):
    """The default cache at an empty file of this test's own."""
    path = tmp_path / "plans.json"
    monkeypatch.setenv(tcache.ENV, str(path))
    preload()
    yield path
    monkeypatch.delenv(tcache.ENV)
    preload()


@pytest.fixture
def kernel_route(monkeypatch):
    """Every dispatch call takes the kernel route; the B1, B5, B2 and B3
    wrappers record the plan they get and return the plain result."""
    seen = []

    def fake(plain):
        def run(*args, plan=None, **kwargs):
            seen.append(plan)
            return plain(*args, **kwargs)
        return run

    monkeypatch.setattr(dispatch, "_on_card", lambda op, t: (
        registry.count_route(op, "kernel") or True))
    monkeypatch.setattr(dispatch, "matmul_cuda", fake(matmul_plain))
    monkeypatch.setattr(dispatch, "decode_attention_cuda",
                        fake(decode.decode_attention_plain))
    monkeypatch.setattr(dispatch, "prefill_attention_cuda",
                        fake(prefill.prefill_attention_plain))
    return seen


class StubHarness(Harness):
    """Deterministic "measurements": a pure function of the plan."""

    def __init__(self, cost_fn):
        super().__init__(reps=1, warmup=0)
        self.cost_fn = cost_fn
        self.measured = []

    def measure(self, fn):
        plan = fn.args[1]        # functools.partial(spec.call, args, plan)
        self.measured.append(plan)
        return Measurement(us=float(self.cost_fn(plan)), reps=1)


def _cost(plan):
    return 1.0 + abs(plan.get("split", 0) - 3)


# ------------------------------------------------------------- keys, file
@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(1, 70000), min_size=1, max_size=6),
       st.sampled_from(["float32", "bfloat16", "int8", "int32"]),
       st.sampled_from(["cpu", "NVIDIA H100 80GB HBM3"]))
def test_keys_and_distance_match_jax(shape, dtype, backend):
    key = make_key("matmul", shape, getattr(torch, dtype), backend)
    assert key == jcache.make_key("matmul", shape, dtype, backend)
    assert parse_key(key) == jcache.parse_key(key)
    other = [d * 2 + 1 for d in shape]
    assert shape_distance(shape, other) == \
        jcache.shape_distance(shape, other)


def test_cache_files_load_across_packages(tmp_path):
    jpath, tpath = tmp_path / "jax.json", tmp_path / "torch.json"
    j = jcache.PlanCache(jpath)
    j.put("matmul", (256, 256, 256), jnp.float32,
          {"level": 3, "bm": 128, "bn": 128, "bk": 128}, backend="cpu",
          us=1.5)
    j.put("stencil", (64, 64), jnp.float32, {"level": 1}, backend="cpu")
    j.save()
    t = PlanCache(jpath).load()
    assert t.entries == j.entries
    assert t.get("matmul", (256, 256, 256), torch.float32, "cpu") == \
        j.get("matmul", (256, 256, 256), jnp.float32, "cpu")
    t = PlanCache(tpath)
    t.put("matmul", (2048, 1024), torch.bfloat16, {"split": 4},
          backend="NVIDIA H100 80GB HBM3", us=6.0, heuristic_us=9.0,
          candidates=8)
    t.save()
    j = jcache.PlanCache(tpath).load()
    assert j.entries == t.entries
    assert json.loads(tpath.read_text())["version"] == jcache.CACHE_VERSION


def test_card_keys_hold_kernel_plans_only(tmp_path):
    card = "NVIDIA H100 80GB HBM3"
    cache = PlanCache(tmp_path / "p.json")
    with pytest.raises(ValueError, match="level 1"):
        cache.put("matmul", (2048, 1024), torch.bfloat16, {"level": 1},
                  backend=card)
    cache.put("matmul", (2048, 1024), torch.bfloat16, {"level": 1},
              backend="cpu")                       # as in the JAX cache
    # a hand-written card entry below T3 raises when a lookup meets it,
    # exact or nearest, naming the entry
    key = make_key("matmul", (2048, 1024), torch.bfloat16, card)
    cache.entries[key] = {"plan": {"level": 1}}
    for shape in ((2048, 1024), (2048, 2048)):
        with pytest.raises(ValueError, match=key.replace("|", r"\|")):
            cache.resolve("matmul", shape, torch.bfloat16, card)


# ------------------------------------------------------------ the search
def test_search_is_deterministic_and_candidate_0_is_the_heuristic():
    results = []
    for _ in range(2):
        h = StubHarness(_cost)
        res = tune("matmul", (4, 8192, 256), harness=h, device="meta")
        results.append((res.best, res.best_us, h.measured))
    assert results[0] == results[1]
    space = SPACES["matmul"]((8192, 256), torch.bfloat16)
    assert results[0][2] == space
    assert results[0][0] == min(space, key=_cost) == {"split": 3}
    h = StubHarness(lambda plan: 1.0)      # every plan ties: the heuristic
    res = tune("matmul", (4, 8192, 256), harness=h, device="meta")
    assert res.best == res.heuristic == {"split": mm.split_plan(
        8192, 256, torch.bfloat16)[0]}
    assert res.best_us <= res.heuristic_us and res.speedup == 1.0


def test_failed_candidates_lose_and_the_winner_is_cached(tmp_path):
    cache = PlanCache(tmp_path / "p.json")
    h = StubHarness(lambda plan: float("inf") if plan["split"] == 1
                    else _cost(plan))

    def measure(fn, base=h.measure):
        m = base(fn)
        return m if np.isfinite(m.us) else Measurement(
            float("inf"), 0, ok=False, error="RuntimeError: refused")
    h.measure = measure
    res = tune("matmul", (4, 8192, 256), harness=h, cache=cache,
               device="meta")
    assert res.rows[1] == {"plan": {"split": 1}, "us": float("inf"),
                           "ok": False, "error": "RuntimeError: refused"}
    assert res.best == {"split": 3}
    key = make_key("matmul", (8192, 256), torch.bfloat16, "cpu")
    assert res.to_dict()["key"] == key
    assert cache.entries[key]["plan"] == {"split": 3}
    assert cache.entries[key]["candidates"] == len(res.rows)


def test_harness_times_inner_calls_per_rep():
    ticks = iter(range(0, 10_000, 7))
    calls, syncs = [], []
    h = Harness(reps=3, warmup=2, inner=5, clock=lambda: next(ticks) / 1e6,
                sync=lambda: syncs.append(1))
    m = h.measure(lambda: calls.append(1))
    assert m.ok and m.reps == 3 and m.us == pytest.approx(7 / 5)
    assert len(calls) == 2 + 3 * 5 and len(syncs) == 1 + 3

    def boom():
        raise RuntimeError("refused")
    bad = h.measure(boom)
    assert not bad.ok and bad.us == float("inf") and "refused" in bad.error


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 40000), st.integers(1, 20000),
       st.sampled_from([torch.bfloat16, torch.float32]),
       st.integers(1, 64))
def test_candidate_0_is_each_heuristic_and_runs_its_split(k, n, dtype, g):
    """Candidate 0 equals the heuristic plan function's output, and the
    wrapper's application of it gives the heuristic's (split, slice)."""
    h = SPACES["matmul"]((k, n), dtype)[0]
    assert h == {"split": mm.split_plan(k, n, dtype)[0]}
    tile = mm.TILE_K[dtype]
    assert mm.planned_split("matmul", k, tile, mm.MAX_SPLIT, h, None) == \
        mm.split_plan(k, n, dtype)
    hg = SPACES["matmul"]((g, k, n), dtype)[0]
    assert mm.split_at(k, tile, hg["split"]) == \
        mm.split_plan(k, n, dtype, groups=g)
    hq = SPACES["quantized_matmul"]((k, n), dtype)[0]
    assert mm.split_at(k, mm.Q_TILE_K, hq["split"]) == \
        mm.quantized_split_plan(k, n, dtype)
    assert SPACES["nbody"]((k,))[0] == {
        "splits": nbody.nbody_split_plan(k)[0]}
    assert nbody.planned_splits(k, SPACES["nbody"]((k,))[0]) == \
        nbody.nbody_split_plan(k)
    assert SPACES["histogram"]((n * 64,))[0] == {
        "route": histogram_route(n * 64)}


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 300), st.sampled_from([8, 16, 48, 64, 256]),
       st.sampled_from([1, 2, 8, 32]), st.sampled_from([1, 4, 8]),
       st.sampled_from([1, 4, 64]), st.sampled_from([64, 128, 256]))
def test_attention_candidate_0_is_the_heuristic(n_pages, page, hkv, grp, c,
                                                hd):
    h = SPACES["decode_attention"]((n_pages, page, hkv))[0]
    assert decode.planned_split("d", n_pages, page, hkv, h) == \
        decode.decode_split_plan(n_pages, page, hkv)
    space = SPACES["prefill_attention"]((n_pages, page, hkv, grp, c, hd))
    want = prefill.prefill_split_plan(n_pages, page, hkv, grp, c, hd)
    assert prefill.planned_split("p", n_pages, page, hkv, grp, c, hd,
                                 space[0]) == want
    for cand in space:
        assert plan_feasible("prefill_attention",
                             (n_pages, page, hkv, grp, c, hd), cand)


def test_default_cells_have_feasible_spaces():
    for name, shapes in DEFAULT_SHAPES.items():
        spec = registry.get(name)
        for shape in shapes:
            args = spec.tune.make_inputs(shape, spec.tune.default_dtype,
                                         "meta")
            key, dtype = spec.key(*args)
            cands = spec.tune.space(key, dtype)
            assert cands and all(plan_feasible(spec.namespace, key, c,
                                               dtype=dtype) for c in cands)


# ------------------------------------------------ the kernel route's plan
def test_lookup_tags_agree_with_lookup_stats(plan_file, kernel_route):
    cache = PlanCache(plan_file)
    cache.put("matmul", (40, 24), torch.float32, {"split": 2}, us=1.0)
    cache.save()
    preload()
    x = torch.randn(3, 40)
    with dispatch.stats_scope(), lookup_scope() as looks:
        dispatch.matmul(x, torch.randn(40, 24))              # exact
        dispatch.matmul(x, torch.randn(40, 48))              # nearest
        dispatch.matmul(x.double(), torch.randn(40, 24).double())  # miss
        sources = dispatch.plan_source_stats()
        assert looks() == {"exact": 1, "nearest": 1, "miss": 1}
        assert dispatch.stats() == {("matmul", "kernel"): 3}
    assert sources == {("matmul", "kernel", "exact"): 1,
                       ("matmul", "kernel", "nearest"): 1,
                       ("matmul", "kernel", "heuristic"): 1}
    assert kernel_route == [{"split": 2}, {"split": 2}, None]


def test_plain_route_resolves_nothing(plan_file):
    with dispatch.stats_scope(), lookup_scope() as looks:
        dispatch.matmul(torch.randn(3, 40), torch.randn(40, 24))
        assert dispatch.plan_source_stats() == {}
        assert looks() == {"exact": 0, "nearest": 0, "miss": 0}


def test_resolution_is_memoized_until_put_or_preload(plan_file,
                                                     kernel_route):
    a, b = torch.randn(2, 64), torch.randn(64, 16)
    dispatch.matmul(a, b)
    cache = tcache.default_cache()
    assert cache._resolved                      # the miss is remembered
    cache.put("matmul", (64, 16), torch.float32, {"split": 1})
    dispatch.matmul(a, b)
    PlanCache(plan_file).save()                 # an empty file
    preload()
    dispatch.matmul(a, b)
    assert kernel_route == [None, {"split": 1}, None]


def test_attention_calls_resolve_on_their_tables(plan_file, kernel_route):
    spec = registry.get("decode_attention")
    args, _ = spec.example(torch.float32)
    cache = PlanCache(plan_file)
    cache.put("decode_attention", (3, 8, 2), torch.float32,
              {"split_keys": 64})
    cache.save()
    preload()
    pargs, _ = registry.get("prefill_attention").example(torch.float32)
    with dispatch.stats_scope():
        got = dispatch.decode_attention(*args)
        dispatch.prefill_attention(*pargs)            # fp32: simt, no plan
        assert dispatch.plan_source_stats() == {
            ("decode_attention", "kernel", "exact"): 1}
    assert kernel_route == [{"split_keys": 64}, None]
    torch.testing.assert_close(got, decode.decode_attention_plain(*args))


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 64), st.integers(1, 48), st.integers(1, 6))
def test_one_key_resolves_one_plan_at_any_rows(k64, n8, split):
    """The plan key is (K, N, dtype): a cached plan reaches a 4-row and a
    1024-row call alike, so a row's bits do not depend on its call."""
    k, n = 64 * k64, 8 * n8
    cache = PlanCache("unused.json")
    cache.put("matmul", (k, n), torch.float32, {"split": split},
              backend="cpu")
    for rows in (4, 1024):
        a = torch.empty(rows, k, device="meta")
        b = torch.empty(k, n, device="meta")
        key, dtype = registry.get("matmul").key(a, b)
        assert cache.resolve("matmul", key, dtype, "cpu") == (
            {"split": split}, "exact")


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 600), st.integers(1, 4096),
       st.sampled_from([1, 8, 60]))
def test_nearest_never_returns_an_infeasible_plan(k8, n, g):
    """Whatever the nearest lookup returns is feasible at the query's key
    (the split limits, the grouped route's grid), and applying it cuts the
    split to the K steps the query has."""
    cache = PlanCache("unused.json")
    entries = [((4096, 2048), {"split": 8}), ((512, 64), {"split": 2}),
               ((60, 2048, 1408), {"split": 8}),
               ((60, 1408, 2048), {"split": 3}),
               ((16384, 16384), {"split": 99}),       # infeasible anywhere
               ((8, 64, 64), {"split": 9})]
    random.Random(k8).shuffle(entries)
    for shape, plan in entries:
        cache.entries[make_key("matmul", shape, "float32", "cpu")] = {
            "plan": plan}
    k = 8 * k8
    for query in ((k, n), (g, k, n)):
        entry = cache.get_nearest("matmul", query, torch.float32, "cpu")
        assert entry is not None
        assert plan_feasible("matmul", query, entry["plan"],
                             dtype=torch.float32)
        split, per = mm.split_at(k, mm.TILE_K[torch.float32],
                                 entry["plan"]["split"])
        assert 1 <= split <= mm.MAX_SPLIT and (split - 1) * per < -(-k // 32)


def test_feasibility_is_the_wrappers_own_checks():
    assert not plan_feasible("matmul", (4096, 2048), {"split": 9})
    assert not plan_feasible("quantized_matmul", (4096, 2048),
                             {"split": 17})
    assert plan_feasible("quantized_matmul", (4096, 2048), {"split": 16})
    assert not plan_feasible("decode_attention", (128, 64, 1),
                             {"split_keys": 96})             # not pages
    assert not plan_feasible("decode_attention", (128, 64, 1),
                             {"split_keys": 2048})           # past the max
    assert not plan_feasible("prefill_attention", (4, 64, 1, 8, 64, 300),
                             {"split_keys": 64})             # simt route
    assert not plan_feasible("prefill_attention", (4, 48, 1, 8, 64, 256),
                             {"split_keys": 64})             # not lcm(48, 64)
    assert not plan_feasible("nbody", (300,), {"splits": 3})  # 2 tiles
    assert not plan_feasible("histogram", (1 << 20,), {"route": "shared"})
    assert not plan_feasible("stencil", (64, 64), {"block_rows": 8})
    assert plan_feasible("stencil", (64, 64), {})
    assert not plan_feasible("no_such_kernel", (1,), {"split": 1})
