"""The JAX side of the sharded-training tests
(``test_torch_sharded_train.py``, ``test_torch_sharded_cli.py``): the
inputs of a case, JAX's one-device ``make_train_step`` on them, and the
gates that hold a port run's gathered state to JAX's.

The gates, for two steps of fp32 policy, batch 4 x 32,
``AdamWConfig(lr=1e-2)``:

* each step's loss within 1e-5 relative; the grad norm within 1e-5 at
  the first step and 1e-4 after an update (the unsharded port's own
  distance from JAX on rwkv6-7b, 3.5e-5);
* every fp32 moment within 1e-3 of its largest value: the gradients, in
  the layout they were stored in;
* every param leaf within 2e-3 of its largest update at the elements
  whose first gradient is at least 1e-3 of the leaf's largest (all but a
  thousandth of them, or one), and within the largest update everywhere.
  Adam's first update is lr g / (|g| + eps): where g is at the level of
  the fp32 rounding of the leaf's sums (below 1.1e-4 of its largest, in
  every element that differed more, on both the sharded and the
  unsharded port), the two packages' roundings move the element by
  up to lr;
* with gradient compression or int8 moments a value at a rounding tie
  may land one int8 step apart: a thousandth of the moments' elements
  may differ beyond 1e-3 of the largest (an int8 moment by one step), and
  the compression residual, a rounding remainder, is held within one
  step of its block.

Every rank must hold the same bits of every metric and gathered leaf.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.archs import ARCHS as JAX_ARCHS
from repro.core import memory as jax_memory
from repro.models.transformer import ExecOptions as JaxOptions
from repro.models.transformer import Model as JaxModel
from repro.optim import adamw as jax_adamw
from repro.optim import compress as jax_compress
from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro.optim.compress import CompressorConfig as JaxCompressor
from repro.train import steps as jax_steps
from repro_torch.configs import ARCHS
from repro_torch.core import tree
from repro_torch.runtime import sharding

B, S, LR, STEPS = 4, 32, 1e-2, 2
AXES = ("data", "model")
# MoE capacity at which neither the one-device nor the sharded layer
# (which sizes capacity from a rank's tokens) drops a token
MOE_CF = 8.0


def config(arch, jax_side, **over):
    """The smoke config of ``arch`` on either side, with ``over``'s fields
    replaced."""
    cfg = dataclasses.replace((JAX_ARCHS if jax_side else ARCHS)[arch]
                              .smoke(), **over)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=MOE_CF)
    return dataclasses.replace(cfg, dispatch="reference") if jax_side \
        else cfg


def batches(seed, n=STEPS, cfg=None):
    """``n`` batches of B x S: tokens and labels, or for an
    embedding-input ``cfg`` (B, S, d) embeddings, and M-RoPE positions
    (B, S, 3) (each row's stream from its own offset) where it has
    sections."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = {"labels": rng.integers(0, 512, (B, S)).astype(np.int32)}
        if cfg is not None and cfg.input_mode == "embeddings":
            batch["embeddings"] = rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)
            if cfg.mrope_sections:
                start = rng.integers(0, 64, (B, 1, 3))
                batch["positions"] = (start + np.arange(S)[None, :, None]
                                      ).astype(np.int32)
        else:
            batch["tokens"] = rng.integers(0, 512, (B, S)).astype(np.int32)
        out.append(batch)
    return out


def _model(arch, over=None):
    return JaxModel(config(arch, True, **(over or {})),
                    dt=jax_memory.DtypePolicy(compute=jnp.float32),
                    opts=JaxOptions(mode="run", block_q=16, block_kv=16,
                                    remat=False))


def case_inputs(spec, seed):
    """A case of ``(arch, mesh shape, options)`` for the ranks: its numpy
    params (JAX's ``Model.init``), batches and options."""
    arch, shape, opts = spec
    over = opts.get("over", {})
    params = jax.device_get(jax.jit(_model(arch, over).init)(
        jax.random.key(0)))
    cfg = config(arch, False, **over)
    return dict(opts, cfg=cfg, shape=shape, axes=AXES, params=params,
                batches=batches(seed, cfg=cfg), lr=LR)


def jax_reference(arch, case):
    """JAX's one-device steps on ``case``: (its params, per-step metrics,
    the final (params, opt), the opt state after the first step)."""
    ts = jax_steps.TrainStepConfig(
        opt=JaxAdamW(lr=LR, int8_moments=case.get("int8", False)),
        microbatches=case.get("microbatches", 1),
        compress=JaxCompressor() if case.get("compress") else None)
    model = _model(arch, case.get("over"))
    params = jax.tree.map(jnp.asarray, case["params"])
    opt = jax_adamw.adamw_init(params, ts.opt)
    if ts.compress is not None:
        opt = (opt, jax_compress.init_residual(params))
    step = jax.jit(jax_steps.make_train_step(model, ts))
    metrics, first = [], None
    for batch in case["batches"]:
        params, opt, met = step(params, opt, {k: jnp.asarray(v)
                                              for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in met.items()})
        if first is None:
            first = jax.device_get(opt)
    return case["params"], metrics, jax.device_get((params, opt)), first


def leaves(state):
    """(path, numpy leaf) of a port or JAX state, in ``core.tree`` order
    (JAX flattens dicts sorted, NamedTuples by field and a
    ``QuantizedBlock`` to q, scale, as ``core.tree`` does)."""
    paths = sharding.leaf_paths(state)
    flat = [np.asarray(x) for x in tree.leaves(state)]
    assert len(paths) == len(flat)
    return list(zip(paths, flat))


def jax_leaves(state):
    return [np.asarray(x) for x in jax.tree.leaves(state)]


def rel(a, b):
    return abs(a - b) / abs(b)


def _first_gradients(first, n):
    """|m| per param leaf after JAX's first step (m = (1 - b1) g then)."""
    state = first if hasattr(first, "m") else first[0]
    out = []
    for m in jax.tree.leaves(state.m, is_leaf=lambda x: isinstance(
            x, jax_memory.QuantizedBlock)):
        if isinstance(m, jax_memory.QuantizedBlock):
            m = jax_memory.dequantize_block(m)
        out.append(np.abs(np.asarray(m, np.float64)))
    assert len(out) == n
    return out


def _off(err, scale, tol, frac, bound):
    """At most ``frac`` of the elements (one, where that is less) beyond
    ``tol`` x ``scale``, none beyond ``bound`` x ``scale``."""
    if err.size == 0:
        return True
    return (err > tol * scale).sum() <= max(frac * err.size, frac > 0) \
        and err.max() <= bound * scale


def check_against_jax(name, case, got, ref):
    """The gates of the module docstring."""
    np_params, want_metrics, want_state, first = ref
    quantized = bool(case.get("compress") or case.get("int8"))
    for i, (g, w) in enumerate(zip(got["metrics"], want_metrics)):
        assert rel(g["loss"], w["loss"]) <= 1e-5, (name, i, g, w)
        assert rel(g["grad_norm"], w["grad_norm"]) <= \
            (1e-5 if i == 0 else 1e-4), (name, i, g, w)
    p0 = jax_leaves(np_params)
    g1 = _first_gradients(first, len(p0))
    ours = leaves(got["state"])
    theirs = jax_leaves(want_state)
    assert len(ours) == len(theirs), name
    bad = []
    for i, ((path, a), b) in enumerate(zip(ours, theirs)):
        assert a.shape == b.shape and a.dtype == b.dtype, (name, path)
        err = np.abs(a.astype(np.float64) - b.astype(np.float64))
        scale = np.abs(b.astype(np.float64)).max()
        if i < len(p0):                       # a param: by its update
            scale = np.abs(b - p0[i]).max()
            well = g1[i] >= 1e-3 * g1[i].max()
            ok = _off(err[well], scale, 2e-3, 1e-3, 1.0) \
                and err.max() <= scale
        elif a.dtype == np.int8:              # an int8 moment
            ok = _off(err, 1.0, 0.5, 1e-3, 1.0)
        elif path.endswith("count"):
            ok = err.max() == 0
        elif case.get("compress") and path.startswith("1.1."):
            # the residual (|r| <= half a step of its block)
            ok = err.max() <= 2.002 * scale
        else:                            # fp32 moments, block scales
            ok = _off(err, scale, 1e-3, 1e-3 if quantized else 0.0,
                      1.0 if quantized else 1e-3)
        if not ok:
            bad.append((path, float(err.max() / max(scale, 1e-30)),
                        float((err > 1e-3 * scale).mean())))
    assert not bad, (name, bad)


def check_ranks_agree(name, outs):
    first = outs[0]
    for other in outs[1:]:
        assert other["metrics"] == first["metrics"], name
        for (path, a), (_, b) in zip(leaves(first["state"]),
                                     leaves(other["state"])):
            assert np.array_equal(a, b), (name, path)
