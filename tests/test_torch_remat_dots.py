"""``remat_policy="dots"``: each layer's forward keeps the outputs of its
``dispatch.matmul`` products that the backward reads, and the recompute
takes them from there (``dispatch.RematTape``).  On smoke gemma-2b and
qwen2-moe: the loss and every gradient equal "full"'s bit for bit, the
gradients match JAX's ``dots_with_no_batch_dims_saveable`` within the
train tests' tolerance, the recompute launches no saved product, and
the saved set is the one ``jax.ad_checkpoint.print_saved_residuals``
lists."""
import contextlib
import dataclasses
import io
import re
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.ad_checkpoint import print_saved_residuals

from repro.configs.archs import ARCHS as JAX_ARCHS
from repro.core.memory import DtypePolicy as JaxPolicy
from repro.models import transformer as jax_tfm
from repro.tune import cache as jax_tune_cache
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import tree
from repro_torch.core.memory import F32_POLICY
from repro_torch.kernels import dispatch
from repro_torch.models import transformer as tfm

torch.set_num_threads(1)
ARCHES = ("gemma-2b", "qwen2-moe-a2.7b")
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)     # tests/test_torch_train.py's
B, S = 2, 16
# products a layer's backward reads: q, k, v, o and the MLP's gate and
# up (its down projection only enters the residual sum); a MoE layer
# swaps the MLP for the fp32 router and the shared MLP's gate and up
SAVED = {"gemma-2b": 6, "qwen2-moe-a2.7b": 7}


@pytest.fixture(autouse=True)
def empty_plan_cache(tmp_path, monkeypatch):
    """The JAX side reads no tuned-plan state left by other tests."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "empty.json"))
    jax_tune_cache.preload()
    yield
    monkeypatch.undo()
    jax_tune_cache.preload()


def _batch(cfg):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _loss_and_grads(arch, policy, dt=None, params=None):
    cfg = get_arch(arch).smoke()
    kw = {} if dt is None else {"dt": dt}
    model = tfm.Model(cfg, device="cpu", **kw,
                      opts=tfm.ExecOptions(remat_policy=policy,
                                           xent_chunks=4))
    params = model.init(1) if params is None else params
    flat, rebuild = tree.flatten(params)
    for t in flat:
        t.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with dispatch.stats_scope() as stats:
        loss, _ = model.loss_fn(rebuild(flat), batch)
        grads = torch.autograd.grad(loss, flat)
        routes = stats()
    return loss.detach(), grads, routes, cfg


@pytest.mark.parametrize("arch", ARCHES)
def test_dots_equals_full_bit_for_bit(arch):
    loss_f, grads_f, routes_f, cfg = _loss_and_grads(arch, "full")
    loss_d, grads_d, routes_d, _ = _loss_and_grads(arch, "dots")
    assert torch.equal(loss_f, loss_d)
    assert len(grads_f) == len(grads_d)
    for i, (a, b) in enumerate(zip(grads_f, grads_d)):
        assert torch.equal(a, b), f"gradient leaf {i}"
    # the recompute makes no forward call for a saved product
    saved = SAVED[arch] * cfg.n_layers
    assert ("matmul", "saved") not in routes_f
    assert routes_d[("matmul", "saved")] == saved
    assert routes_d[("matmul", "plain")] \
        == routes_f[("matmul", "plain")] - saved
    for op in ("matmul_bwd", "attention", "attention_bwd",
               "grouped_matmul", "grouped_matmul_bwd"):
        assert routes_d.get((op, "plain")) == routes_f.get((op, "plain"))


@pytest.mark.parametrize("arch", ARCHES)
def test_dots_gradients_match_jax(arch):
    jcfg = dataclasses.replace(JAX_ARCHS[arch].smoke(),
                               dispatch="reference")
    jmodel = jax_tfm.Model(jcfg, dt=JaxPolicy(compute=jnp.float32),
                           opts=jax_tfm.ExecOptions(
                               remat_policy="dots", block_q=8, block_kv=8,
                               xent_chunks=4))
    jparams = jmodel.init(jax.random.key(1))
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss_fn, has_aux=True))(jparams, batch)
    params = params_from_jax(jax.device_get(jparams), "cpu", torch.float32)
    loss, grads, _, _ = _loss_and_grads(arch, "dots", F32_POLICY, params)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = tree.leaves(_sorted(jax.device_get(jgrads)))
    assert len(want) == len(grads)
    for i, (g, w) in enumerate(zip(grads, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   err_msg=f"gradient leaf {i}", **GRAD_TOL)


def _sorted(tree_):
    if isinstance(tree_, dict):
        return {k: _sorted(tree_[k]) for k in sorted(tree_)}
    if isinstance(tree_, (list, tuple)):
        return [_sorted(v) for v in tree_]
    return tree_


RESIDUAL = re.compile(r"^(\w+)\[([\d,]*)\] (.*)$")


def _jax_saved(arch):
    """(dtype, shape) of each residual JAX saves for one smoke layer
    under dots, besides its arguments and constants: the products' outputs
    and the activation's residual of the SwiGLU MLP."""
    cfg = JAX_ARCHS[arch].smoke()
    model = jax_tfm.Model(cfg, opts=jax_tfm.ExecOptions(
        remat_policy="dots", block_q=16, block_kv=16))
    params = model.init(jax.random.key(0))
    kind = cfg.layer_kinds()[0]
    p = params["prefix"][0]
    x = jnp.ones((2, 32, cfg.d_model), jnp.bfloat16)
    pos = jnp.broadcast_to(jnp.arange(32)[None], (2, 32)).astype(jnp.int32)

    def layer(p_, x_):
        out, _ = jax_tfm.layer_apply(p_, cfg=cfg, kind=kind, x=x_,
                                     positions=pos, dt=model.dt,
                                     opts=model.opts)
        return out.sum()
    policy = jax.checkpoint_policies.dots_with_no_batch_dims_saveable
    fn = jax.checkpoint(layer, policy=policy)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        print_saved_residuals(fn, p, x)
    out = Counter()
    for line in buf.getvalue().splitlines():
        m = RESIDUAL.match(line.strip())
        if m and "from the argument" not in m[3] \
                and "from a constant" not in m[3]:
            dims = tuple(int(d) for d in m[2].split(",") if d)
            out[(m[1], dims)] += 1
    return out


def _torch_saved(arch):
    cfg = get_arch(arch).smoke()
    model = tfm.Model(cfg, device="cpu")
    p = model.init(0)["prefix"][0]
    x = torch.ones((2, 32, cfg.d_model), dtype=torch.bfloat16)
    pos = torch.arange(32, dtype=torch.int32)[None].expand(2, 32)
    tape = dispatch.RematTape()
    forward, _ = dispatch.remat_contexts(tape)
    with forward, torch.no_grad():
        tfm.layer_apply(p, cfg, cfg.layer_kinds()[0], x, pos, model.dt,
                        model.opts)
    names = {torch.bfloat16: "bf16", torch.float32: "f32"}
    return Counter((names[t.dtype], tuple(t.shape)) for t in tape.outputs)


@pytest.mark.parametrize("arch", ARCHES)
def test_saved_set_matches_jax_print_saved_residuals(arch):
    got = _torch_saved(arch)
    assert sum(got.values()) == SAVED[arch]
    assert got == _jax_saved(arch)
