"""The dry run's shape functions are the JAX package's: parameter counts,
the params, cache and train-state trees on ``meta`` against JAX's
``eval_shape`` (every leaf's path, shape and dtype), and the input specs
and skips of every arch x shape."""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import input_specs as jax_input_specs
from repro.configs import shape_applicable as jax_shape_applicable
from repro.configs.archs import ARCHS as JAX_ARCHS
from repro.core.memory import DtypePolicy as JaxPolicy
from repro.models import transformer as jax_tfm
from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro.runtime.sharding import _path_str
from repro.train import steps as jax_steps
from repro_torch.configs import (SHAPES, get_arch, input_specs,
                                 shape_applicable)
from repro_torch.core.memory import DtypePolicy
from repro_torch.models import transformer as torch_tfm
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.sharding import map_with_path
from repro_torch.train import steps as torch_steps

torch.set_num_threads(1)
ARCH_NAMES = sorted(JAX_ARCHS)
POLICIES = {"fp32": (jnp.float32, torch.float32),
            "bf16": (jnp.bfloat16, torch.bfloat16)}


def _dtype(d) -> str:
    return str(d).rsplit(".", 1)[-1]


def jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(_path_str(p), tuple(x.shape), _dtype(x.dtype)) for p, x in flat]


def torch_leaves(tree):
    out = []
    map_with_path(lambda p, x: out.append((p, tuple(x.shape),
                                           _dtype(x.dtype))), tree)
    return out


def _shapes(leaves):
    return [(shape, dtype) for _, shape, dtype in leaves]


@functools.lru_cache(maxsize=None)
def _jax_model(name: str, policy: str):
    return jax_tfm.Model(JAX_ARCHS[name],
                         dt=JaxPolicy(param=POLICIES[policy][0]))


def _torch_model(name: str, policy: str):
    return torch_tfm.Model(get_arch(name),
                           dt=DtypePolicy(param=POLICIES[policy][1]),
                           device="meta")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_counts_match_jax(name):
    assert torch_tfm.param_counts(get_arch(name)) \
        == jax_tfm.param_counts(JAX_ARCHS[name])
    assert get_arch(name).param_counts() \
        == jax_tfm.param_counts(JAX_ARCHS[name])


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_specs_match_jax(name, policy):
    specs = _torch_model(name, policy).param_specs()
    assert all(t.device.type == "meta" for t in
               torch.utils._pytree.tree_leaves(specs))
    assert torch_leaves(specs) \
        == jax_leaves(_jax_model(name, policy).param_specs())


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_cache_specs_match_jax(name):
    got = torch_leaves(_torch_model(name, "fp32").cache_specs(2, 64))
    assert got == jax_leaves(_jax_model(name, "fp32").cache_specs(2, 64))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_abstract_train_state_matches_jax(name, int8):
    ts = torch_steps.TrainStepConfig(opt=AdamWConfig(int8_moments=int8))
    jts = jax_steps.TrainStepConfig(opt=JaxAdamW(int8_moments=int8))
    params, opt = torch_steps.abstract_train_state(
        _torch_model(name, "fp32"), ts)
    jparams, jopt = jax_steps.abstract_train_state(
        _jax_model(name, "fp32"), jts)
    assert torch_leaves(params) == jax_leaves(jparams)
    # the moments' QuantizedBlock nodes name their leaves differently in
    # the two trees (q/scale against flattened indices): shapes in order
    assert _shapes(torch_leaves(opt)) == _shapes(jax_leaves(jopt))
    assert len(torch_leaves(opt)) == (1 + 2 * (1 + int8)
                                      * len(torch_leaves(params)))


def test_abstract_train_state_with_compression():
    from repro.optim.compress import CompressorConfig as JaxComp
    from repro_torch.optim.compress import CompressorConfig
    name = "gemma-2b"
    _, opt = torch_steps.abstract_train_state(
        _torch_model(name, "fp32"),
        torch_steps.TrainStepConfig(compress=CompressorConfig()))
    _, jopt = jax_steps.abstract_train_state(
        _jax_model(name, "fp32"),
        jax_steps.TrainStepConfig(compress=JaxComp()))
    assert _shapes(torch_leaves(opt)) == _shapes(jax_leaves(jopt))


@pytest.mark.parametrize("shape", sorted(JAX_SHAPES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_input_specs_and_skips_match_jax(name, shape):
    cfg, jcfg = get_arch(name), JAX_ARCHS[name]
    spec, jspec = SHAPES[shape], JAX_SHAPES[shape]
    assert (spec.name, spec.seq_len, spec.global_batch, spec.kind,
            spec.tokens_per_step) == (jspec.name, jspec.seq_len,
                                      jspec.global_batch, jspec.kind,
                                      jspec.tokens_per_step)
    ok, reason = shape_applicable(cfg, spec)
    jok, jreason = jax_shape_applicable(jcfg, jspec)
    assert ok == jok and bool(reason) == bool(jreason)
    got = {k: (tuple(v.shape), _dtype(v.dtype), v.device.type)
           for k, v in input_specs(cfg, spec).items()}
    want = {k: (tuple(v.shape), _dtype(v.dtype), "meta")
            for k, v in jax_input_specs(jcfg, jspec).items()}
    assert got == want
