"""The port's sharded train step on four gloo ranks against the JAX
package's one-device step, and elastic resharding, on the CPU at smoke
widths.

JAX's gate (``tests/test_distributed.py::
test_sharded_train_step_matches_single_device``: codeqwen1.5-7b on a
(data, model) mesh, its loss within 1e-4) made stronger: the state is
stored as the shards ``tree_specs`` gives and every leaf is gathered at
its use (``runtime/sharding.TrainSharding``); two steps are held to
JAX's one-device ``make_train_step`` by the gates of
``tests/_torch_sharded.py`` (losses within 1e-5, grad norms, moments
and params gathered, ranks bit-equal).  Cases on (2,2): codeqwen1.5-7b
(JAX's own), also with microbatches 2, with gradient compression and
with int8 moments; qwen2-moe-a2.7b expert-parallel, experts padded to a
multiple of 2, at capacity factor 8.0 (no token dropped on either side).

Elastic: a codeqwen1.5-7b run on (2,2) saves its whole leaves; they come
back bit for bit from ``restore_on_mesh`` on (2,1) (two ranks) and from
the plain manager in this process, with the step; ``reshard_state`` to
(1,4) on the same ranks gives the same leaves, and one more step on
either layout agrees.

The four ranks (``tests/_torch_ranks.py``) run while this process
computes JAX's steps.
"""
import concurrent.futures

import numpy as np
import pytest
import torch

import _torch_ranks as ranks
import _torch_sharded as ref
from repro.tune import cache as tune_cache
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.runtime import sharding

torch.set_num_threads(1)
CASES = {  # name: (arch, mesh, options)
    "codeqwen1.5-7b-2x2": ("codeqwen1.5-7b", (2, 2), {}),
    "codeqwen1.5-7b-2x2-mb2": ("codeqwen1.5-7b", (2, 2),
                               {"microbatches": 2}),
    "codeqwen1.5-7b-2x2-compress": ("codeqwen1.5-7b", (2, 2),
                                    {"compress": True}),
    "codeqwen1.5-7b-2x2-int8": ("codeqwen1.5-7b", (2, 2), {"int8": True}),
    "qwen2-moe-a2.7b-2x2": ("qwen2-moe-a2.7b", (2, 2), {"expert_pad": 2}),
}


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
    """(each case's inputs, JAX's results, the four ranks' results, the
    elastic job)."""
    inputs = {name: ref.case_inputs(spec, seed=10 + i)
              for i, (name, spec) in enumerate(CASES.items())}
    elastic = ref.case_inputs(("codeqwen1.5-7b", (2, 2), {}), seed=99)
    elastic["more"] = ref.batches(100, 1)
    job = {"save": True, "shape": (2, 2), "reshard": (1, 4),
           "dir": str(tmp_path_factory.mktemp("elastic")), "case": elastic}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        four = pool.submit(ranks.spawn, ranks.train_worker, 4,
                           tmp_path_factory.mktemp("four"),
                           list(inputs.values()), [], job)
        want = {name: ref.jax_reference(CASES[name][0], case)
                for name, case in inputs.items()}
        got = four.result()
    return inputs, want, got, job


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_on_four_ranks_matches_jax(name, runs):
    inputs, want, got, _ = runs
    outs = [r["cases"][list(CASES).index(name)] for r in got]
    ref.check_ranks_agree(name, outs)
    ref.check_against_jax(name, inputs[name], outs[0], want[name])
    assert outs[0]["batch_axes"] == ("data",)
    assert outs[0]["collectives"]["all_gather"] > 0


def test_elastic_restore_and_reshard_are_bit_equal(runs, tmp_path):
    _, _, got, job = runs
    saved = got[0]["elastic"]
    want = ref.leaves(saved["saved"])
    for r in got[1:]:
        for (path, a), (_, b) in zip(ref.leaves(r["elastic"]["saved"]),
                                     want):
            assert np.array_equal(a, b), path
    # reshard_state to (1, 4): the same leaves, now split over model only
    for (path, a), (_, b) in zip(ref.leaves(saved["resharded"]), want):
        assert np.array_equal(a, b), path
    specs = sharding.spec_leaves(saved["reshard_specs"])
    assert any("model" in s for s in specs)
    assert not any("data" in s for s in specs)
    for old, new in zip(saved["more_old"], saved["more_new"]):
        assert ref.rel(new["loss"], old["loss"]) <= 1e-5
        assert ref.rel(new["grad_norm"], old["grad_norm"]) <= 1e-5
    # restore_on_mesh on (2, 1): two ranks
    two = ranks.spawn(ranks.train_worker, 2, tmp_path, [], [],
                      dict(job, save=False, shape=(2, 1)))
    for r in two:
        assert r["elastic"]["step"] == ref.STEPS
        for (path, a), (_, b) in zip(ref.leaves(r["elastic"]["state"]),
                                     want):
            assert np.array_equal(a, b), path
    # one process: the plain manager
    state, step, _ = CheckpointManager(job["dir"]).restore(saved["saved"])
    assert step == ref.STEPS
    for (path, a), (_, b) in zip(ref.leaves(state), want):
        assert np.array_equal(a, b), path
