"""The whole train step, composed, across the packages: three steps of
the port's ``make_train_step`` and three of the JAX package's on the same
params (``convert.params_from_jax``), fp32 policy, AdamW at its
default settings, smoke gemma-2b,
rwkv6-7b and recurrentgemma-9b, batch 4 x 16; once plain, and once with
microbatches 2, gradient compression and int8 moments together.  Every
step's loss within 1e-6 relative and its grad norm within 1e-4.

The port's other tests hold the step's pieces to JAX one at a time (the
loss and gradients, the AdamW update, the clipping, the batches); this
holds their composition, over updates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_sharded as ref
from repro.optim import adamw as jax_adamw
from repro.optim import compress as jax_compress
from repro.train import steps as jax_steps
from repro.tune import cache as tune_cache
from repro_torch.convert import params_from_jax
from repro_torch.core.memory import DtypePolicy
from repro_torch.models.transformer import ExecOptions, Model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.compress import CompressorConfig, init_residual
from repro_torch.train.steps import TrainStepConfig, make_train_step

torch.set_num_threads(1)
ARCHS = ("gemma-2b", "rwkv6-7b", "recurrentgemma-9b")
VARIANTS = {"plain": {},
            "mb2-compress-int8": {"microbatches": 2, "compress": True,
                                  "int8": True}}
STEPS, B, S = 3, 4, 16


@pytest.fixture(autouse=True)
def empty_plan_cache(tmp_path, monkeypatch):
    """The JAX side reads no tuned-plan state left by other tests."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "empty.json"))
    tune_cache.preload()
    yield
    monkeypatch.undo()
    tune_cache.preload()


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_compose_as_jax(arch, variant):
    opts = VARIANTS[variant]
    rng = np.random.default_rng(len(arch))
    batches = [{k: rng.integers(0, 512, (B, S)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(STEPS)]
    jmodel = ref._model(arch)
    jparams = jax.jit(jmodel.init)(jax.random.key(0))
    jts = jax_steps.TrainStepConfig(
        opt=jax_adamw.AdamWConfig(int8_moments=opts.get("int8",
                                                                 False)),
        microbatches=opts.get("microbatches", 1),
        compress=jax_compress.CompressorConfig()
        if opts.get("compress") else None)
    jopt = jax_adamw.adamw_init(jparams, jts.opt)
    if jts.compress is not None:
        jopt = (jopt, jax_compress.init_residual(jparams))
    jstep = jax.jit(jax_steps.make_train_step(jmodel, jts))

    model = Model(ref.config(arch, False),
                  dt=DtypePolicy(compute=torch.float32), device="cpu",
                  opts=ExecOptions(block_q=16, block_kv=16))
    ts = TrainStepConfig(
        opt=AdamWConfig(int8_moments=opts.get("int8", False)),
        microbatches=opts.get("microbatches", 1),
        compress=CompressorConfig() if opts.get("compress") else None)
    params = params_from_jax(jax.device_get(jparams), "cpu", torch.float32)
    opt = adamw_init(params, ts.opt)
    if ts.compress is not None:
        opt = (opt, init_residual(params))
    step = make_train_step(model, ts)
    for i, batch in enumerate(batches):
        jparams, jopt, want = jstep(jparams, jopt, {
            k: jnp.asarray(v) for k, v in batch.items()})
        params, opt, got = step(params, opt, {
            k: torch.from_numpy(v) for k, v in batch.items()})
        assert ref.rel(float(got["loss"]), float(want["loss"])) <= 1e-6, \
            (i, float(got["loss"]), float(want["loss"]))
        assert ref.rel(float(got["grad_norm"]),
                       float(want["grad_norm"])) <= 1e-4, i
