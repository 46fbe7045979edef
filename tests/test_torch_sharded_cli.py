"""The sharded train step on two gloo ranks against the JAX package's
one-device step, and the train CLI's host mesh, on the CPU at smoke
widths.

Two steps held to JAX's one-device ``make_train_step`` by the gates of
``tests/_torch_sharded.py``: gemma-2b on (2,1) and (1,2) (MQA: wk and wv
fall back to sharding head_dim over model), rwkv6-7b and
recurrentgemma-9b on (1,2) (the ``.tm.`` and ``.rec.`` rules); on (1,2)
the model axis splits each layer's work (``runtime/model_axis.py``).

The CLI lays its state out on ``make_host_mesh()``: on two ranks that is
(data 1, model 2), which splits no batch rows but splits the work: each
rank runs half of one process's matmul FLOPs, and its losses are one
process's within 1e-5 (row-parallel partial sums and the vocab-parallel
softmax reorder fp32 sums); ``--inject-failures`` there restores every
rank to the saved step and ends with the uninterrupted run's losses.  On one
process every spec replicates and no collective runs: the CLI's losses,
checkpoint bytes and params are those of the unsharded
``make_train_step``, bit for bit.
"""
import concurrent.futures

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import _torch_ranks as ranks
import _torch_sharded as ref
from repro.tune import cache as tune_cache
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS
from repro_torch.core import tree
from repro_torch.core.memory import DtypePolicy
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.models.transformer import ExecOptions, Model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import collectives
from repro_torch.runtime.fault_tolerance import Supervisor
from repro_torch.train.steps import (TrainStepConfig, init_train_state,
                                     make_train_step)

torch.set_num_threads(1)
CASES = {  # name: (arch, mesh, options)
    "gemma-2b-2x1": ("gemma-2b", (2, 1), {}),
    "gemma-2b-1x2": ("gemma-2b", (1, 2), {}),
    "rwkv6-7b-1x2": ("rwkv6-7b", (1, 2), {}),
    "recurrentgemma-9b-1x2": ("recurrentgemma-9b", (1, 2), {}),
}
CLI = ["--arch", "gemma-2b", "--smoke", "--steps", "3", "--batch", "4",
       "--seq", "16", "--device", "cpu", "--log-every", "1",
       "--save-every", "1"]


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
def runs(tmp_path_factory):
    """(each case's inputs, JAX's results, the two ranks' results); the
    gemma-2b cases share their inputs and JAX's run."""
    inputs = {name: ref.case_inputs(spec, seed=20 + i)
              for i, (name, spec) in enumerate(CASES.items())}
    inputs["gemma-2b-1x2"] = dict(inputs["gemma-2b-2x1"], shape=(1, 2))
    base = tmp_path_factory.mktemp("cli")
    argvs = [CLI + ["--ckpt-dir", str(base / "clean")],
             CLI + ["--ckpt-dir", str(base / "faulty"),
                    "--inject-failures", "2"]]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        two = pool.submit(ranks.spawn, ranks.train_worker, 2,
                          tmp_path_factory.mktemp("two"),
                          list(inputs.values()), argvs, None)
        want = {name: ref.jax_reference(CASES[name][0], case)
                for name, case in inputs.items() if name != "gemma-2b-1x2"}
        want["gemma-2b-1x2"] = want["gemma-2b-2x1"]
        got = two.result()
    return inputs, want, got


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_on_two_ranks_matches_jax(name, runs):
    inputs, want, got = runs
    outs = [r["cases"][list(CASES).index(name)] for r in got]
    ref.check_ranks_agree(name, outs)
    ref.check_against_jax(name, inputs[name], outs[0], want[name])
    data = CASES[name][1][0] > 1
    assert outs[0]["batch_axes"] == (("data",) if data else ())


def test_cli_on_two_ranks_restarts_to_the_uninterrupted_losses(runs):
    got = runs[2]
    clean, faulty = got[0]["cli"]
    assert clean["restarts"] == 0 and faulty["restarts"] == 1
    # the failure before step 2 replays it from the step-2 checkpoint
    assert faulty["losses"] == clean["losses"]
    assert got[1]["cli"] == got[0]["cli"]


def test_cli_on_two_ranks_matches_one_process(runs, tmp_path):
    """(1, 2) splits no batch rows but each layer's work: every loss is one
    process's within 1e-5, and each rank runs half of its matmul FLOPs
    (within 1%)."""
    with FlopCounterMode(display=False) as flops:
        one = train_cli.main(CLI + ["--ckpt-dir", str(tmp_path / "one")])
    for rank in runs[2]:
        got = rank["cli"][0]
        for a, b in zip(got["losses"], one):
            assert ref.rel(a, b) <= 1e-5, (got["losses"], one)
        assert 2 * got["matmul_flops"] == pytest.approx(
            ranks.matmul_flops(flops), rel=0.01)


def unsharded_cli(steps, batch, seq, ckpt_dir):
    """The train CLI as it ran before the host mesh: the same model,
    optimizer, data and supervisor on the plain ``make_train_step``."""
    cfg = ARCHS["gemma-2b"].smoke()
    model = Model(cfg, dt=DtypePolicy(), device="cpu",
                  opts=ExecOptions(block_q=min(512, seq),
                                   block_kv=min(512, seq), remat=True))
    ts = TrainStepConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=10,
                                         total_steps=steps))
    step_fn = make_train_step(model, ts)
    params, opt = init_train_state(model, ts, seed=0)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch))
    losses = []

    def one_step(state, step):
        b = {k: torch.from_numpy(v) for k, v in data.batch_at(step).items()}
        p, o, m = step_fn(*state, b)
        return (p, o), m
    sup = Supervisor(CheckpointManager(ckpt_dir, keep=3), save_every=50)
    state, _ = sup.run((params, opt), one_step, steps,
                       on_metrics=lambda s, m: losses.append(
                           float(m["loss"])))
    return losses, state


def test_one_rank_cli_is_bit_identical_to_the_unsharded_step(tmp_path):
    argv = ["--arch", "gemma-2b", "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "32", "--device", "cpu", "--ckpt-dir",
            str(tmp_path / "cli")]
    collectives.reset_collective_counts()
    got = train_cli.main(argv)
    assert collectives.collective_counts() == {}
    want, state = unsharded_cli(3, 2, 32, tmp_path / "plain")
    assert got == want
    a = (tmp_path / "cli" / "step_00000003" / "leaves.pt").read_bytes()
    b = (tmp_path / "plain" / "step_00000003" / "leaves.pt").read_bytes()
    assert a == b
    restored, _, _ = CheckpointManager(tmp_path / "cli").restore(state)
    for x, y in zip(tree.leaves(restored), tree.leaves(state)):
        assert torch.equal(x, y)
