"""The port's stage pipeline (``runtime/pipeline_parallel.py``) and the
collectives it and the sharded step stand on, on four gloo ranks.

``pipeline_apply`` with 4 stages of tanh(x @ w_s) over 8 microbatches of
2 x 16 (``tests/test_distributed.py::
test_pipeline_parallel_matches_sequential``'s case) gives JAX's
``pipeline_apply`` on 4 host devices (``helpers.run_multidevice``) and
the sequential product within rtol 1e-4 / atol 1e-5, on every rank; the
gradient of sum(out * cot) in each stage's weights is the sequential
autograd's; ``bubble_fraction(4, 8)`` is 3/11.  The same ranks check the
collectives: ``reduce_scatter`` has the bits of ``chunk(psum)``,
``gather_shards``' backward is that reduce-scatter, ``ppermute`` sends
to the next rank and ``psum``'s backward is the identity, and
``quantize_shard`` / ``dequantize_shard`` give the whole leaf's blocks,
off (width 96 a rank) and on (256) the 128-wide block edge.
"""
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from helpers import run_multidevice

torch.set_num_threads(1)
S, M, MB, D = 4, 8, 2, 16

JAX_PIPELINE = """
    import jax, jax.numpy as jnp, numpy as np
    from repro.launch.mesh import make_mesh
    from repro.runtime.pipeline_parallel import pipeline_apply
    data = np.load(%(path)r)
    mesh = make_mesh((4,), ("pod",))
    with mesh:
        out = pipeline_apply(lambda p, x: jnp.tanh(x @ p["w"]),
                             {"w": jnp.asarray(data["w"])},
                             jnp.asarray(data["x"]), mesh=mesh,
                             stage_axis="pod")
    np.save(%(out)r, np.asarray(out))
    print("PP-OK")
"""


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(0)
    w = (0.1 * rng.standard_normal((S, D, D))).astype(np.float32)
    x = rng.standard_normal((M, MB, D)).astype(np.float32)
    cot = rng.standard_normal((M, MB, D)).astype(np.float32)
    tmp = tmp_path_factory.mktemp("pipeline")
    np.savez(tmp / "in.npz", w=w, x=x)
    assert "PP-OK" in run_multidevice(JAX_PIPELINE % {
        "path": str(tmp / "in.npz"), "out": str(tmp / "jax.npy")},
        n_devices=4)
    got = ranks.spawn(ranks.pipeline_worker, S, tmp, w, x, cot)
    return w, x, cot, np.load(tmp / "jax.npy"), got


def sequential(w, x):
    for i in range(w.shape[0]):
        x = torch.tanh(x @ w[i])
    return x


def test_pipeline_matches_jax_and_the_sequential_product(case):
    w, x, _, jax_out, got = case
    want = sequential(torch.from_numpy(w), torch.from_numpy(x)).numpy()
    for r in got:
        np.testing.assert_allclose(r["out"], jax_out, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r["out"], want, rtol=1e-4, atol=1e-5)
        assert abs(r["bubble"] - 3 / 11) < 1e-9


def test_pipeline_gradient_is_the_sequential_autograd(case):
    w, x, cot, _, got = case
    wt = torch.from_numpy(w).requires_grad_(True)
    (sequential(wt, torch.from_numpy(x)) * torch.from_numpy(cot)).sum() \
        .backward()
    for s, r in enumerate(got):
        np.testing.assert_allclose(r["dw"][0], wt.grad[s].numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_collectives_keep_rank_order_and_their_transposes(case):
    got = case[-1]
    for rank, r in enumerate(got):
        assert r["reduce_scatter_bits"] and r["gather_shards_grad_bits"]
        assert r["ppermute_from"] == (rank - 1) % S
        np.testing.assert_array_equal(r["psum_grad"], np.full(3, 2.0))


def test_quantize_shard_gives_the_whole_leafs_blocks(case):
    for r in case[-1]:
        for width in r["quantize"]:
            assert width == {"q": True, "scale": True, "dequantized": True}
