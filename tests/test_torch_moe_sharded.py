"""The port's expert-parallel MoE (``models/moe_sharded.py``) against the
JAX package's global ``moe.moe_apply``.

The gate of ``tests/test_distributed.py::test_moe_sharded_matches_global``,
held across the packages: the JAX test's spec (d 16, 8 experts, top 2,
d_expert 32, capacity factor 8.0 so no path drops a token, ``pad_to=4``)
on a (data=2, model=2) mesh of four gloo ranks (``tests/_torch_ranks.py``,
started by ``torch.multiprocessing.spawn``): every rank's output within
rtol 2e-3 / atol 2e-4 of JAX's, the aux loss finite and JAX's, and the
gradients of ``sum(o * o)``, this rank's expert shards, the router and
the input, within the same limits of ``jax.grad``'s.  The same ranks run
a smoke qwen2-moe-a2.7b ``Model.forward`` with ``ExecOptions.moe_mesh``
set against JAX's unsharded forward.  In this process the degenerate
(1, 1) mesh matches the port's own ``moe_apply`` within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_ranks as ranks
from repro.configs.archs import ARCHS as JAX_ARCHS
from repro.core.memory import F32_POLICY as JAX_F32
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro.models import moe as jax_moe
from repro.models.moe_sharded import moe_apply_sharded as jax_moe_sharded
from repro.models.transformer import ExecOptions as JaxOptions
from repro.models.transformer import Model as JaxModel
from repro.tune import cache as tune_cache
from repro_torch.configs import ARCHS
from repro_torch.convert import params_from_jax, shards_from_jax
from repro_torch.core.memory import DtypePolicy
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
from repro_torch.models.moe_sharded import moe_apply_sharded, moe_pspecs

torch.set_num_threads(1)
SPEC = dict(d_model=16, n_experts=8, top_k=2, d_expert=32,
            capacity_factor=8.0, norm_topk=True, pad_to=4)
RTOL, ATOL = 2e-3, 2e-4
F32 = DtypePolicy(compute=torch.float32)
MODEL_ARCH, MODEL_PAD = "qwen2-moe-a2.7b", 2


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


@pytest.fixture(scope="module")
def layer():
    """JAX's spec, params and input, its global output, aux loss and the
    gradients of sum(o * o) in the params and the input."""
    s = jax_moe.MoESpec(**SPEC, dispatch="reference")
    p = jax.jit(lambda k: jax_moe.moe_init(k, s))(jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (4, 8, 16), jnp.float32)

    def loss(p, x):
        o, aux = jax_moe.moe_apply(p, s, x, JAX_F32)
        return jnp.sum(o * o), (o, aux)
    (_, (out, aux)), (dp, dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, x)
    return jax.device_get((p, x, out, aux, dp, dx))


def _model_cfg(jax_side: bool):
    archs = JAX_ARCHS if jax_side else ARCHS
    cfg = dataclasses.replace(archs[MODEL_ARCH].smoke(), capacity_factor=8.0)
    return dataclasses.replace(cfg, dispatch="reference") if jax_side \
        else cfg


@pytest.fixture(scope="module")
def model_case():
    """A smoke qwen2-moe-a2.7b (its experts padded to a multiple of 2,
    ample capacity), JAX's params and its unsharded logits."""
    jmodel = JaxModel(_model_cfg(True), dt=JAX_F32,
                      opts=JaxOptions(mode="run", expert_pad=MODEL_PAD))
    jparams = jax.jit(jmodel.init)(jax.random.key(0))
    tokens = np.random.default_rng(5).integers(0, 512, (2, 8)).astype(
        np.int32)
    logits = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(tokens)})
    return jax.device_get(jparams), tokens, np.asarray(logits)


@pytest.fixture(scope="module")
def four_ranks(layer, model_case, tmp_path_factory):
    p, x = layer[:2]
    np_params, tokens, _ = model_case
    return ranks.spawn(ranks.moe_worker, 4, tmp_path_factory.mktemp("moe"),
                       (2, 2), SPEC, p, x,
                       (_model_cfg(False), np_params, tokens, MODEL_PAD))


def _local(a, spec, coords):
    """The block of a global array a rank with ``coords`` holds under
    ``spec`` on the (data=2, model=2) mesh."""
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else axes
        idx, n = 0, 1
        for ax in axes:
            idx, n = idx * 2 + coords[ax], n * 2
        size = a.shape[d] // n
        a = np.take(a, range(idx * size, (idx + 1) * size), axis=d)
    return a


def test_moe_sharded_four_ranks_match_global(four_ranks, layer):
    _, _, out, aux, _, _ = layer
    assert sorted(tuple(r["coords"].values()) for r in four_ranks) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in four_ranks:
        np.testing.assert_allclose(r["out"], out, rtol=RTOL, atol=ATOL)
        assert np.isfinite(r["aux"])
        np.testing.assert_allclose(r["aux"], float(aux), rtol=RTOL,
                                   atol=ATOL)
        assert r["routes"][("grouped_matmul", "plain")] == 3
    # replicated: equal bits on every rank
    for r in four_ranks[1:]:
        assert np.array_equal(r["out"], four_ranks[0]["out"])


def test_moe_sharded_four_ranks_gradients_match_jax_grad(four_ranks, layer):
    """Each rank's expert shards get their part of ``jax.grad``'s
    gradient, the router and the input the whole of it."""
    p = layer[0]
    dp, dx = layer[4], layer[5]
    specs = moe_pspecs({"moe": {k: torch.empty((0,) * np.ndim(v))
                                for k, v in p.items()}})["moe"]
    for r in four_ranks:
        np.testing.assert_allclose(r["dx"], dx, rtol=RTOL, atol=ATOL)
        for name, g in r["dp"].items():
            want = _local(np.asarray(dp[name]), specs[name], r["coords"])
            assert g.shape == want.shape, name
            np.testing.assert_allclose(g, want, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        assert np.abs(r["dp"]["wg"]).sum() > 0


def test_model_reaches_moe_sharded_through_exec_options(four_ranks,
                                                        model_case):
    """``Model.forward`` with ``ExecOptions.moe_mesh`` set runs every MoE
    layer expert-parallel on the rank's shards and gives JAX's unsharded
    logits."""
    _, _, want = model_case
    n_moe = sum(f == "moe" for _, f in ARCHS[MODEL_ARCH].smoke()
                .layer_kinds())
    for r in four_ranks:
        np.testing.assert_allclose(r["model_logits"], want, rtol=RTOL,
                                   atol=ATOL)
        assert r["model_routes"][("grouped_matmul", "plain")] == 3 * n_moe


def test_moe_sharded_degenerate_mesh_matches_moe_apply(layer):
    """The (1, 1) mesh in this process: the port's global ``moe_apply``
    on the same params within 1e-6."""
    p, x = layer[:2]
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    try:
        s = moe.MoESpec(**SPEC)
        full = params_from_jax(p, "cpu", torch.float32)
        local = shards_from_jax({"moe": p}, moe_pspecs, mesh,
                                torch.float32)["moe"]
        xt = torch.from_numpy(np.array(x))
        want, want_aux = moe.moe_apply(full, s, xt, F32)
        with dispatch.stats_scope() as stats:
            got, aux = moe_apply_sharded(local, s, xt, F32, mesh=mesh,
                                         dp_axes=("data",))
            assert stats()[("grouped_matmul", "plain")] == 3
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(aux, want_aux, rtol=1e-6, atol=1e-6)
    finally:
        dist.destroy_process_group()


def test_padded_experts_are_never_routed():
    """6 experts padded to 8 (``pad_to=4``): the dummies' router logits
    are -1e30, so the (1, 1) mesh gives ``moe_apply`` over the 6 real
    experts within 1e-6.  A reference caveat (ROADMAP Queue 3): JAX's
    ``moe_init`` makes the router E_pad wide, so its global ``moe_apply``
    raises (an E_pad-wide mean times an E-wide one-hot in the aux loss)
    and its ``moe_apply_sharded`` routes tokens to the padded experts."""
    spec = dict(SPEC, n_experts=6)
    s = jax_moe.MoESpec(**spec, dispatch="reference")
    p = jax.jit(lambda k: jax_moe.moe_init(k, s))(jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (2, 8, 16), jnp.float32)
    with pytest.raises(TypeError, match="broadcasting"):
        jax_moe.moe_apply(p, s, x, JAX_F32)
    jmesh = jax_make_mesh((1, 1), ("data", "model"))
    with jmesh:
        jax_out, _ = jax_moe_sharded(p, s, x, JAX_F32, mesh=jmesh,
                                     dp_axes=("data",))
    p, x, jax_out = jax.device_get((p, x, jax_out))
    real = {"router": p["router"][:, :6],
            **{k: p[k][:6] for k in ("wg", "wu", "wd")}}
    xt = torch.from_numpy(np.array(x))
    want, want_aux = moe.moe_apply(params_from_jax(real, "cpu",
                                                   torch.float32),
                                   moe.MoESpec(**dict(spec, pad_to=1)), xt,
                                   F32)
    assert not np.allclose(jax_out, want.numpy(), rtol=RTOL, atol=ATOL)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    try:
        local = shards_from_jax({"moe": p}, moe_pspecs, mesh,
                                torch.float32)["moe"]
        assert local["wg"].shape[0] == 8
        got, aux = moe_apply_sharded(local, moe.MoESpec(**spec), xt, F32,
                                     mesh=mesh, dp_axes=("data",))
    finally:
        dist.destroy_process_group()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(aux, want_aux, rtol=1e-6, atol=1e-6)
