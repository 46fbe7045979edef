"""The plain reference against the program at a small size on the CPU,
both in float32: the loss and every gradient of training, and the tokens
served through chunked paged prefill and paged decode."""
import numpy as np
import pytest
import torch

import tiny
from benchlib import check, program, traffic
from benchlib import weights as W
from reference import qwen as ref


def fp32_model(conf):
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.models.transformer import Model
    return Model(program.arch(conf), device="cpu",
                 dt=DtypePolicy(param=torch.float32, compute=torch.float32))


@pytest.mark.parametrize("conf", [tiny.DENSE, tiny.MOE],
                         ids=["dense", "moe"])
def test_loss_and_gradients_match(conf):
    mdl = fp32_model(conf)
    params = program.params(mdl, 2 ** 31 + 3, "cpu")
    cdf = traffic.zipf_cdf(conf["vocab_size"], 1.1, "cpu")
    tok, lab = traffic.train_batch({"batch": 2, "seq_len": 32}, cdf, 5, 1)
    flat = [t for _, t in W.walk(params)]
    for t in flat:
        t.requires_grad_(True)
    lp, _ = mdl.loss_fn(params, {"tokens": tok, "labels": lab})
    gp = torch.autograd.grad(lp, flat)
    leaves = [t.detach().clone().requires_grad_(True) for t in flat]
    w = program.reference_weights(W.rebuild(mdl.param_specs(), leaves), mdl)
    lr = ref.loss(w, tok, lab, ref.spec_of(conf))
    gr = torch.autograd.grad(lr, leaves)
    assert float(lp.detach()) == pytest.approx(float(lr.detach()),
                                             rel=1e-5)
    for (path, _), a, b in zip(W.walk(params), gp, gr):
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-12, path


def test_adamw_steps_match():
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    mix = tiny.TRAIN_MIX
    gen = torch.Generator().manual_seed(0)
    p = [torch.randn(5, 3, generator=gen), torch.randn(7, generator=gen)]
    gs = [[torch.randn(5, 3, generator=gen), torch.randn(7, generator=gen)]
          for _ in range(3)]
    cfg = AdamWConfig(**mix["optimizer"])
    mine = {"a": p[0].clone(), "b": p[1].clone()}
    st = adamw_init(mine, cfg)
    theirs = [t.clone() for t in p]
    m = [torch.zeros_like(t) for t in p]
    v = [torch.zeros_like(t) for t in p]
    for n, g in enumerate(gs, start=1):
        mine, st, _ = adamw_update({"a": g[0], "b": g[1]}, st, mine, cfg)
        ref.adamw_step(theirs, g, m, v, ref.AdamW(**mix["optimizer"]), n)
    assert torch.allclose(mine["a"], theirs[0], rtol=1e-6, atol=1e-9)
    assert torch.allclose(mine["b"], theirs[1], rtol=1e-6, atol=1e-9)


def test_served_tokens_match_through_the_paged_cache():
    from repro_torch.launch.engine import ContinuousEngine
    from repro_torch.launch.loadgen import Request
    from repro_torch.launch.serve import PagedScheduler
    mdl = fp32_model(tiny.DENSE)
    params = program.params(mdl, 41, "cpu")
    sched = PagedScheduler(mdl, params, slots=3, max_len=96, page_size=16,
                           log=None)
    engine = ContinuousEngine(sched, clock="tick", log=None)
    rng = np.random.default_rng(4)
    for i, n in enumerate((5, 37, 70, 16)):
        engine.waiting.append(Request(i, rng.integers(0, 256, n).astype(
            np.int32), 12))
    while engine.step():
        pass
    done = [(r.rid, np.asarray(r.prompt), list(r.out)) for r in engine.done]
    assert len(done) == 4
    got = check.served_gap(tiny.DENSE, program.reference_weights(params, mdl),
                           done, "cpu")
    assert got["sample_tokens"] == 48
    assert got["served_gap_max"] < 1e-4
