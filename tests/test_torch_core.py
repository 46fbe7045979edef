"""The port's ``core`` (``src/repro_torch/core/``) held to the JAX
package's: the pipeline model and the roofline under the same explicit
hardware numbers, the tile planner, the staged levels and their sweep
order, the taxonomy's tables, the pipelining helpers and the memory
napkin math.  Float helpers agree within 1e-6 relative in fp32; the rest
exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import memory as jmemory
from repro.core import plan as jplan
from repro_torch.core import memory as tmemory
from repro_torch.core import plan as tplan
from repro_torch.core import taxonomy as ttax

torch.set_num_threads(1)
RTOL = 1e-6


def _close(got, want):
    """Within 1e-6 of the output's scale: max |got - want| <= 1e-6 *
    max(1, max |want|) (an fp32 reassociation moves a sum by a few ulps
    of its largest term, not of itself)."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    assert float(np.abs(got - want).max(initial=0.0)) <= RTOL * scale


# one set of hardware numbers, in each package's fields (the port's
# docstring maps vmem_bytes -> smem_bytes, mxu_dim -> mma_dim, lane ->
# warp, sublane -> frag_rows, ici_bw -> link_bw)
HW_NUMBERS = [
    dict(peak_flops=197e12, hbm_bw=819e9, link=50e9, hbm_bytes=16 * 2**30,
         fast=16 * 2**20, clock=940e6, edge=128, lane=128, sub=8),
    dict(peak_flops=989e12, hbm_bw=3.35e12, link=450e9, hbm_bytes=80e9,
         fast=232448, clock=1.98e9, edge=64, lane=32, sub=8),
]


def _specs(n):
    j = jcore.HardwareSpec(name="hw", peak_flops=n["peak_flops"],
                           hbm_bw=n["hbm_bw"], ici_bw=n["link"],
                           hbm_bytes=n["hbm_bytes"], vmem_bytes=n["fast"],
                           clock_hz=n["clock"], mxu_dim=n["edge"],
                           lane=n["lane"], sublane=n["sub"])
    t = tcore.HardwareSpec(name="hw", peak_flops=n["peak_flops"],
                           peak_flops_fp32=n["peak_flops"] / 16,
                           hbm_bw=n["hbm_bw"], link_bw=n["link"],
                           hbm_bytes=n["hbm_bytes"], smem_bytes=n["fast"],
                           l2_bytes=50 * 2**20, sms=132,
                           clock_hz=n["clock"], mma_dim=n["edge"],
                           warp=n["lane"], frag_rows=n["sub"])
    return j, t


# ------------------------------------------------------------ performance
@settings(max_examples=25, deadline=None)
@given(st.integers(0, 500), st.integers(1, 16), st.integers(1, 5000),
       st.integers(1, 64))
def test_pipeline_model_matches_jax(lat, ii, n, fold):
    j = jcore.PipelineModel(lat, ii, n)
    t = tcore.PipelineModel(lat, ii, n)
    assert t.cycles() == j.cycles()
    assert t.seconds(1.98e9) == j.seconds(1.98e9)
    assert t.fill_drain_overhead() == j.fill_drain_overhead()
    assert dataclasses.astuple(t.folded(fold)) == \
        dataclasses.astuple(j.folded(fold))
    other = (lat + 3, ii + 1, n)
    assert dataclasses.astuple(t.then(tcore.PipelineModel(*other))) == \
        dataclasses.astuple(j.then(jcore.PipelineModel(*other)))
    with pytest.raises(ValueError):
        t.then(tcore.PipelineModel(1, 1, n + 1))


@pytest.mark.parametrize("numbers", HW_NUMBERS, ids=["tpu-like", "h100"])
def test_roofline_and_balance_match_jax(numbers):
    jhw, thw = _specs(numbers)
    rng = np.random.default_rng(0)
    for _ in range(5):
        chips, flops, bytes_, coll, model = (
            int(rng.integers(1, 512)), *(float(v) for v in
                                         rng.uniform(1e12, 1e18, 4)))
        j = jcore.Roofline("c", chips, flops, bytes_, coll, model, hw=jhw)
        t = tcore.Roofline("c", chips, flops, bytes_, coll, model, hw=thw)
        assert t.to_dict() == j.to_dict()
    assert tcore.machine_balance(thw) == jcore.machine_balance(jhw)
    assert tcore.dense_model_flops(2_500_000_000, 1024) == \
        jcore.dense_model_flops(2_500_000_000, 1024)
    assert tcore.arithmetic_intensity(3.0, 0) == \
        jcore.arithmetic_intensity(3.0, 0)


def test_h100_spec_is_the_card_and_states_no_tpu_rate():
    hw = tcore.H100_SXM
    assert (hw.peak_ops("bfloat16"), hw.peak_ops("float32"),
            hw.hbm_bw) == (989e12, 67e12, 3.35e12)
    assert hw.smem_bytes == 227 * 1024 and hw.sms == 132
    assert tcore.Roofline("c", 1, 1, 1, 1, 1).hw is hw
    tpu = jcore.TPU_V5E
    assert {hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.smem_bytes} \
        .isdisjoint({tpu.peak_flops, tpu.hbm_bw, tpu.ici_bw,
                     tpu.vmem_bytes})


# ------------------------------------------------------------- scaling
@pytest.mark.parametrize("numbers", HW_NUMBERS, ids=["tpu-like", "h100"])
@pytest.mark.parametrize("fraction", [0.1, 0.75])
def test_tile_planner_matches_jax(numbers, fraction):
    jhw, thw = _specs(numbers)
    jp = jcore.TilePlanner(jhw, vmem_fraction=fraction)
    tp = tcore.TilePlanner(thw, vmem_fraction=fraction)
    assert tp.budget == jp.budget
    edge = numbers["edge"]
    cands = tuple(edge << i for i in range(5))
    for m, n, k in ((512, 1024, 4096), (4 * edge, 2 * edge, 8 * edge),
                    (edge, 16 * edge, edge)):
        for in_bytes in (2, 4):
            want = jp.enumerate_matmul(m, n, k, in_bytes=in_bytes,
                                       candidates=cands)
            got = tp.enumerate_matmul(m, n, k, in_bytes=in_bytes)
            assert [dataclasses.astuple(p) for p in got] == \
                [dataclasses.astuple(p) for p in want]
    stencil_cands = tuple(edge << i for i in range(6))
    for rows, cols in ((8192, 8192), (300, 700)):
        assert tp.enumerate_stencil(rows, cols) == jp.enumerate_stencil(
            rows, cols, candidates=stencil_cands)
    for shape, nbytes in (((100,), 4), ((5, 100), 4), ((5, 100), 2),
                          ((3, 7, 33), 1)):
        assert tcore.vector_pad(shape, nbytes, thw) == \
            jcore.vector_pad(shape, nbytes, jhw)
        assert tcore.lane_utilization(shape, nbytes, thw) == \
            jcore.lane_utilization(shape, nbytes, jhw)
    from repro.core.scaling import replication_factor as jrep
    assert tcore.replication_factor(16, 2.0, thw) == jrep(16, 2.0, jhw)
    with pytest.raises(ValueError):
        tp.plan_from_tiles(64, 64, 64, 1 << 14, 1 << 14, 1 << 14)


def test_tile_planner_on_the_card_plans_b1s_tile():
    """With the card's numbers the planner picks 128 x 128 outputs over
    64-deep K steps: csrc/matmul.cu's bf16 tile."""
    plan = tcore.TilePlanner().plan_matmul(4096, 4096, 4096)
    assert (plan.bm, plan.bn, plan.bk) == (128, 128, 64)
    assert plan.vmem_bytes <= tcore.TilePlanner().budget


# ---------------------------------------------------------------- plan
def test_levels_configs_and_sweep_order_match_jax():
    assert [(lv.name, int(lv)) for lv in tplan.Level] == \
        [(lv.name, int(lv)) for lv in jplan.Level]
    jfields = [f.name for f in dataclasses.fields(jplan.TransformConfig)]
    assert [f.name for f in dataclasses.fields(tplan.TransformConfig)] \
        == jfields
    for name in ("TUNE_VECTOR_WIDTHS", "TUNE_ACCUM_LANES",
                 "TUNE_PREFETCH_DEPTHS", "TUNE_VMEM_FRACTIONS"):
        assert tuple(getattr(tplan, name)) == tuple(getattr(jplan, name))
    assert [int(v) for v in tplan.TUNE_LEVELS] == \
        [int(v) for v in jplan.TUNE_LEVELS]
    assert {int(k): v for k, v in tplan.PAPER_STAGES.items()} == \
        {int(k): v for k, v in jplan.PAPER_STAGES.items()}

    def knobs(cfgs):
        return [(int(c.level), c.vector_width, c.accum_lanes,
                 c.prefetch_depth, c.vmem_fraction) for c in cfgs]

    sweeps = [dict(), dict(vector_widths=(128, 512), accum_lanes=(4, 16),
                           prefetch_depths=(1, 2)),
              dict(vmem_fractions=(0.5, 0.9), max_configs=5)]
    for kw in sweeps:
        assert knobs(tplan.enumerate_configs(**kw)) == \
            knobs(jplan.enumerate_configs(**kw))
    base_t = tplan.TransformConfig(accum_lanes=5)
    base_j = jplan.TransformConfig(accum_lanes=5)
    assert knobs(tplan.enumerate_configs(base_t)) == \
        knobs(jplan.enumerate_configs(base_j))
    assert tplan.TransformConfig().at_level(tplan.Level.T0_NAIVE).level \
        == tplan.Level.T0_NAIVE


# ------------------------------------------------------------ taxonomy
def test_table1_and_table2_match_jax():
    from repro.core import taxonomy as jtax
    assert list(ttax.TABLE1) == list(jtax.TABLE1)
    for name, t in ttax.TABLE1.items():
        j = jtax.TABLE1[name]
        assert (t.cls.value, t.section, t.fpga_mechanism) == \
            (j.cls.value, j.section, j.fpga_mechanism)
        assert [c.value for c in t.characteristics] == \
            [c.value for c in j.characteristics]
        assert [o.value for o in t.objectives] == \
            [o.value for o in j.objectives]
        assert t.gpu_mechanism and t.repo_entrypoints
    for obj in ttax.Objective:
        jobj = jtax.Objective(obj.value)
        assert [t.name for t in ttax.recommend(obj)] == \
            [t.name for t in jtax.recommend(jobj)]
    for cls in ttax.TransformClass:
        assert [t.name for t in ttax.by_class(cls)] == \
            [t.name for t in jtax.by_class(jtax.TransformClass(cls.value))]
    assert {k: (r.name, s) for k, (r, s) in ttax.TABLE2.items()} == \
        {k: (r.name, s) for k, (r, s) in jtax.TABLE2.items()}


def test_every_port_entrypoint_resolves():
    for t in ttax.TABLE1.values():
        for entry in t.repo_entrypoints:
            assert entry.startswith("repro_torch."), entry
            assert ttax.resolve(entry) is not None, entry


def test_core_exports_what_jax_core_exports():
    jnames = {n for n in dir(jcore) if not n.startswith("_")
              and not isinstance(getattr(jcore, n), type(jcore))}
    want = (jnames - {"TPU_V5E", "annotations"}) | {"H100_SXM"}
    missing = {n for n in want if not hasattr(tcore, n)}
    assert not missing, missing


# ---------------------------------------------------------- pipelining
@settings(max_examples=8, deadline=None)
@given(st.integers(1, 300), st.integers(1, 16))
def test_interleaved_accumulate_matches_jax(n, lanes):
    x = np.random.default_rng(n).standard_normal((n, 3)).astype(np.float32)
    want = np.asarray(jcore.interleaved_accumulate(jnp.asarray(x),
                                                   lanes=lanes))
    got = tcore.interleaved_accumulate(torch.from_numpy(x), lanes=lanes)
    _close(got.numpy(), want)
    want = np.asarray(jcore.interleaved_accumulate(
        jnp.asarray(x), lanes=lanes, axis=1, op=jnp.maximum, init=-np.inf))
    got = tcore.interleaved_accumulate(torch.from_numpy(x), lanes=lanes,
                                       axis=1, op=torch.maximum,
                                       init=-np.inf)
    _close(got.numpy(), want)


def test_tiled_and_cross_input_interleave_match_jax():
    w = np.random.default_rng(1).standard_normal((64, 5)).astype(np.float32)
    want = jcore.tiled_accumulate(lambda idx: jnp.asarray(w)[idx], 64, 8,
                                  (5,))
    got = tcore.tiled_accumulate(lambda idx: torch.from_numpy(w)[idx], 64,
                                 8, (5,))
    _close(got.numpy(), want)
    s0 = np.random.default_rng(2).uniform(0.5, 2.0, (6, 4)).astype(
        np.float32)
    want = jcore.cross_input_interleave(lambda s: 0.5 * (s + 2.0 / s),
                                        jnp.asarray(s0), 7)
    got = tcore.cross_input_interleave(lambda s: 0.5 * (s + 2.0 / s),
                                       torch.from_numpy(s0), 7)
    _close(got.numpy(), want)


def test_fuse_phases_and_flatten_grid_match_jax():
    x = np.linspace(-1, 1, 17, dtype=np.float32)
    want = jcore.fuse_phases([jnp.sin, jnp.cos, jnp.tanh])(jnp.asarray(x))
    got = tcore.fuse_phases([torch.sin, torch.cos, torch.tanh])(
        torch.from_numpy(x))
    _close(got.numpy(), want)
    for dims in ((3,), (2, 5), (4, 1, 7), (2, 3, 2, 5)):
        jt, jun = jcore.flatten_grid(dims)
        tt, tun = tcore.flatten_grid(dims)
        assert tt == jt
        flat = np.arange(tt)
        for a, b in zip(tun(torch.from_numpy(flat)), jun(jnp.asarray(flat))):
            assert a.tolist() == np.asarray(b).tolist()


@pytest.mark.parametrize("prefetch", [0, 1, 3])
def test_prefetched_scan_matches_jax(prefetch):
    rng = np.random.default_rng(prefetch)
    xs = rng.standard_normal((9, 4)).astype(np.float32)
    ws = rng.standard_normal((9,)).astype(np.float32)

    def jbody(c, x):
        a, w = x
        c = c * 0.9 + a * w
        return c, (c.sum(), a * 2)

    def tbody(c, x):
        a, w = x
        c = c * 0.9 + a * w
        return c, (c.sum(), a * 2)

    jc, jys = jmemory.prefetched_scan(
        jbody, jnp.zeros(4), (jnp.asarray(xs), jnp.asarray(ws)),
        prefetch=prefetch)
    tc, tys = tmemory.prefetched_scan(
        tbody, torch.zeros(4), (torch.from_numpy(xs), torch.from_numpy(ws)),
        prefetch=prefetch, device=torch.device("cpu"))
    _close(tc.numpy(), jc)
    for a, b in zip(tys, jys):
        _close(a.numpy(), b)
    seen = []
    tmemory.prefetched_scan(lambda c, x: (seen.append(x.item()) or c, None),
                            0, torch.arange(5.0), prefetch=prefetch)
    assert seen == [0.0, 1.0, 2.0, 3.0, 4.0]


# -------------------------------------------------------------- memory
def test_memory_napkin_math_matches_jax():
    for jpol, tpol in ((jmemory.BF16_POLICY, tmemory.BF16_POLICY),
                       (jmemory.F32_POLICY, tmemory.F32_POLICY)):
        for adam in (False, True):
            for int8 in (False, True):
                assert tpol.bytes_per_param(adam=adam, int8_moments=int8) \
                    == jpol.bytes_per_param(adam=adam, int8_moments=int8)
    for n, block in ((1000, 128), (7, 32)):
        assert tmemory.quantized_bytes(n, block) == \
            jmemory.quantized_bytes(n, block)
    for total, ways in ((1e9, 4), (3.0, 0)):
        assert tmemory.striped_bytes_per_chip(total, ways) == \
            jmemory.striped_bytes_per_chip(total, ways)
    assert jax.numpy.dtype(jmemory.BF16_POLICY.moment).itemsize == \
        tmemory.BF16_POLICY.moment.itemsize
